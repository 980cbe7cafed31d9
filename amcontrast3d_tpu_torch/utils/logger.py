"""Experiment directories and logging (↔ ``amcontrast3d_tpu/utils/logger.py``,
copied).

Mirrors the contract of ``openpoints/utils/logger.py:36-169``: colored rank-0
console logging plus a per-process log file, and run directories of the form
``<root>/<task>/<tags>-<timestamp>-<uuid>/checkpoint``.
"""
from __future__ import annotations

import logging
import os
import shutil
import sys
import time
import uuid
from pathlib import Path

_LOG_FORMAT = "%(asctime)s [%(levelname)s] %(message)s"


def setup_logger_dist(output: str = None, rank: int = 0, name: str = "") -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    logger.propagate = False
    for h in list(logger.handlers):
        logger.removeHandler(h)

    formatter = logging.Formatter(_LOG_FORMAT, datefmt="%m/%d %H:%M:%S")
    if rank == 0:
        ch = logging.StreamHandler(stream=sys.stdout)
        ch.setLevel(logging.INFO)
        ch.setFormatter(formatter)
        logger.addHandler(ch)

    if output is not None:
        if output.endswith(".txt") or output.endswith(".log"):
            filename = output
        else:
            filename = os.path.join(output, "log.txt")
        if rank > 0:
            filename = filename + f".rank{rank}"
        os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
        fh = logging.FileHandler(filename)
        fh.setLevel(logging.INFO)
        fh.setFormatter(formatter)
        logger.addHandler(fh)

    # route the root logger too, so `logging.info` works as in the reference
    root = logging.getLogger()
    root.setLevel(logging.INFO)
    for h in list(root.handlers):
        root.removeHandler(h)
    for h in logger.handlers:
        root.addHandler(h)
    return logger


def generate_exp_directory(cfg, exp_name=None, expid=None, run_name=None) -> None:
    """Create ``cfg.run_dir`` / ``cfg.ckpt_dir`` / ``cfg.log_path``."""
    if run_name is None:
        if expid is None:
            expid = time.strftime("%Y%m%d-%H%M%S") + "-" + str(uuid.uuid4())[:8]
        if isinstance(exp_name, (list, tuple)):
            exp_name = "-".join(exp_name)
        run_name = "-".join([str(x) for x in [exp_name, expid] if x])
    cfg.run_name = run_name
    cfg.run_dir = os.path.join(cfg.root_dir, cfg.get("log_dir", ""), run_name)
    cfg.ckpt_dir = os.path.join(cfg.run_dir, "checkpoint")
    cfg.log_path = os.path.join(cfg.run_dir, run_name + ".log")
    cfg.csv_path = os.path.join(cfg.run_dir, run_name + ".csv")
    Path(cfg.ckpt_dir).mkdir(parents=True, exist_ok=True)


def write_to_csv(oa, macc, miou, ious, best_epoch, cfg, write_header=True,
                 area=5) -> None:
    """Append one results row to ``cfg.csv_path`` (↔ ``write_to_csv``,
    main_AA.py:37-48): method, area, OA/mACC/mIoU, per-class IoUs,
    best_epoch, run dir, wandb link."""
    import csv

    ious_table = [f"{float(v):.2f}" for v in ious]
    classes = list(cfg.get("classes", None) or
                   [f"class{i}" for i in range(len(ious_table))])
    header = (["method", "Area", "OA", "mACC", "mIoU"] + classes +
              ["best_epoch", "log_path", "wandb link"])
    wandb_cfg = cfg.get("wandb", {}) or {}
    link = "-"
    if dict(wandb_cfg).get("use_wandb"):
        try:
            import wandb
            link = wandb.run.get_url() if wandb.run is not None else "-"
        except Exception:
            link = "-"
    data = ([cfg.get("cfg_basename", "run"), str(area), f"{float(oa):.2f}",
             f"{float(macc):.2f}", f"{float(miou):.2f}"] + ious_table +
            [str(best_epoch), cfg.get("run_dir", "."), link])
    os.makedirs(os.path.dirname(os.path.abspath(cfg.csv_path)), exist_ok=True)
    with open(cfg.csv_path, "a", encoding="UTF8", newline="") as f:
        writer = csv.writer(f)
        if write_header:
            writer.writerow(header)
        writer.writerow(data)


def resume_exp_directory(cfg, pretrained_path: str) -> None:
    """Reuse the run dir that contains ``pretrained_path`` (ckpt_util semantics)."""
    if os.path.basename(os.path.dirname(pretrained_path)) == "checkpoint":
        cfg.run_dir = os.path.dirname(os.path.dirname(pretrained_path))
    else:
        cfg.run_dir = os.path.dirname(pretrained_path)
    cfg.run_name = os.path.basename(cfg.run_dir)
    cfg.ckpt_dir = os.path.join(cfg.run_dir, "checkpoint")
    cfg.log_path = os.path.join(cfg.run_dir, cfg.run_name + ".log")
    cfg.csv_path = os.path.join(cfg.run_dir, cfg.run_name + ".csv")
    Path(cfg.ckpt_dir).mkdir(parents=True, exist_ok=True)
    cfg.wandb = cfg.get("wandb", None) or type(cfg)()
