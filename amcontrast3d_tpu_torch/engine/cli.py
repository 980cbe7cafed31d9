"""CLI bootstrap of the port.

↔ ``amcontrast3d_tpu/engine/cli.py``; the contract is the reference's
(``README.md:61-84``, ``main_AA.py:806-865``) plus the kind and the device:

    python -m amcontrast3d_tpu_torch.engine.cli --kind aa \\
        --cfg cfgs/s3dis/AMContrast3D-AA.yaml [--device cpu] \\
        [mode=train|resume|finetune…|test|val|val_train] \
        [pretrained_path=…] [any.cfg.key=value ...]

``examples/segmentation/main_AA_torch.py`` and ``main_MM_torch.py`` call
``main_cli("aa")`` / ``main_cli("mm")`` as the JAX mains do.  The run is on
the card unless ``--device cpu`` is given; without a CUDA device it stops.
Every mode but the three eval modes trains (``train``, ``resume`` from a
``latest`` checkpoint in its own run directory, and the finetune family:
``finetune``, ``finetune_encoder``, ``…freeze_blocks…``, main_AA.py:229-241);
``--profile`` wraps the training in a ``torch.profiler`` trace written to
``<run_dir>/profile/trace.json``.  ``mode=test`` is the whole-scene voting
test, ``mode=val`` / ``val_train`` run ``Runner.validate`` over the split's
loader.
"""
from __future__ import annotations

import argparse
import logging
import os

import torch

from ..utils import (EasyConfig, generate_exp_directory, resume_exp_directory,
                     setup_logger_dist, write_to_csv)
from .runner import Runner, resolve_device


def parse_args(argv=None):
    parser = argparse.ArgumentParser("amcontrast3d_tpu_torch segmentation")
    parser.add_argument("--cfg", type=str, required=True, help="config file")
    parser.add_argument("--kind", type=str, default=None,
                        choices=("base", "aa", "mm"),
                        help="which trainer's model and criterion")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (default; required unless cpu is named) "
                             "or cpu")
    parser.add_argument("--profile", action="store_true", default=False)
    args, opts = parser.parse_known_args(argv)
    return args, opts


def load_cfg(args, opts) -> EasyConfig:
    cfg = EasyConfig()
    cfg.load(args.cfg, recursive=True)
    cfg.update(opts)
    if cfg.get("seed") is None:
        import random
        cfg.seed = random.randint(1, 10000)
    cfg.cfg_basename = os.path.splitext(os.path.basename(args.cfg))[0]
    cfg.cfg_path = args.cfg
    return cfg


def _train_profiled(runner):
    """``runner.train()`` under a ``torch.profiler`` trace of the host and,
    on the card, the device; the trace goes to ``<run_dir>/profile``."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if runner.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    out = os.path.join(runner.cfg.run_dir, "profile")
    os.makedirs(out, exist_ok=True)
    with profile(activities=activities) as prof:
        results = runner.train()
    prof.export_chrome_trace(os.path.join(out, "trace.json"))
    return results


def main_cli(kind: str = None, argv=None):
    args, opts = parse_args(argv)
    kind = args.kind or kind or "aa"
    cfg = load_cfg(args, opts)
    device = resolve_device(args.device)

    mode = cfg.get("mode", "train")
    if mode == "resume" and cfg.get("pretrained_path"):
        resume_exp_directory(cfg, cfg.pretrained_path)
    else:
        tags = [cfg.cfg_basename, f"ngpus{torch.cuda.device_count()}",
                f"seed{cfg.seed}"]
        generate_exp_directory(cfg, exp_name=tags)
    setup_logger_dist(cfg.run_dir, 0, name=cfg.cfg_basename)

    # snapshot the resolved config into the run dir (main_AA.py:847-851)
    import yaml
    with open(os.path.join(cfg.run_dir, "cfg.yaml"), "w") as f:
        yaml.safe_dump(cfg.dict(), f)

    runner = Runner(cfg, kind=kind, device=device)
    # any non-eval mode trains: 'train', 'resume', and the finetune family
    if mode not in ("val", "val_train", "test"):
        results = _train_profiled(runner) if args.profile else runner.train()
        logging.info("Training done: %s",
                     {k: v for k, v in results.items() if k != "timing"})
        results["run_dir"] = cfg.run_dir
        return results
    best_epoch = "-"
    if cfg.get("pretrained_path"):
        epoch = runner.load_pretrained(cfg.pretrained_path)
        best_epoch = epoch if epoch is not None else "-"
    if mode == "test":
        # whole-scene voting test (↔ test_boundary_inner, main_AA.py:516)
        from .evaluate import generate_data_list, test_whole_scenes
        data_list = generate_data_list(cfg)
        results = test_whole_scenes(runner, data_list, cfg)
        logging.info("test: mIoU %.2f mACC %.2f OA %.2f",
                     results["miou"], results["macc"], results["oa"])
        if "boundary" in results:
            logging.info("boundary mIoU/mACC/OA: %s", results["boundary"])
            logging.info("inner mIoU/mACC/OA: %s", results["inner"])
        # results CSV next to the run dir (↔ main_AA.py:224-225,346)
        cfg.csv_path = os.path.join(cfg.run_dir, cfg.run_name + "_test.csv")
        write_to_csv(results["oa"], results["macc"], results["miou"],
                     results["ious"], best_epoch, cfg,
                     area=cfg.dataset.common.get("test_area", 5)
                     if "dataset" in cfg else 5)
        logging.info("save results in %s", cfg.csv_path)
        results["csv_path"], results["run_dir"] = cfg.csv_path, cfg.run_dir
        return results
    from ..data import build_dataloader_from_cfg
    split = "train" if mode == "val_train" else "val"
    loader = build_dataloader_from_cfg(
        cfg.get("val_batch_size", 1), cfg.dataset, cfg.get("dataloader"),
        cfg.get("datatransforms"), split=split, seed=cfg.seed)
    try:
        miou, macc, oa, ious, accs = runner.validate(loader)
    finally:
        loader.close()
    logging.info("%s: mIoU %.2f mACC %.2f OA %.2f", mode, miou, macc, oa)
    return {"miou": miou, "macc": macc, "oa": oa}


if __name__ == "__main__":
    main_cli()
