"""Experiment scalar logging (↔ SummaryWriter + Wandb usage in
main_AA.py:133-135,298-308 and openpoints/utils/wandb.py:30+).

Primary sink is a JSONL scalars file in the run dir (always works headless);
TensorBoard and Weights&Biases are attached when their packages can be
imported; both are optional (↔ ``amcontrast3d_tpu/utils/summary.py``).
"""
from __future__ import annotations

import json
import logging
import os
import time
from typing import Optional


class SummaryWriter:
    def __init__(self, run_dir: Optional[str] = None, use_wandb: bool = False,
                 wandb_cfg=None):
        self.run_dir = run_dir
        self._fh = None
        if run_dir is not None:
            os.makedirs(run_dir, exist_ok=True)
            self._fh = open(os.path.join(run_dir, "scalars.jsonl"), "a")
        self._tb = None
        if run_dir is not None:
            try:
                from torch.utils.tensorboard import SummaryWriter as TBWriter
                self._tb = TBWriter(log_dir=os.path.join(run_dir, "tb"))
            except Exception:
                pass
        self._wandb = None
        if use_wandb:
            try:
                import wandb
                wandb.init(project=(wandb_cfg or {}).get("project", "amcontrast3d"),
                           dir=run_dir)
                self._wandb = wandb
            except Exception:
                logging.warning("wandb requested but unavailable; "
                                "falling back to JSONL scalars")

    def add_scalar(self, tag: str, value, step: int):
        value = float(value)
        if self._fh is not None:
            self._fh.write(json.dumps({"tag": tag, "value": value,
                                       "step": int(step),
                                       "time": time.time()}) + "\n")
            self._fh.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)
        if self._wandb is not None:
            self._wandb.log({tag: value}, step=int(step))

    def close(self):
        if self._fh is not None:
            self._fh.close()
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()


class Wandb:
    """API-compatible shim for the reference ``Wandb.launch`` helper."""

    run = None

    @classmethod
    def launch(cls, cfg, use_wandb: bool = False):
        if not use_wandb:
            return None
        try:
            import wandb
            cls.run = wandb.init(project=cfg.wandb.get("project", "amcontrast3d"),
                                 config=cfg.dict() if hasattr(cfg, "dict") else dict(cfg))
            return cls.run
        except Exception:
            logging.warning("wandb unavailable; continuing without it")
            return None
