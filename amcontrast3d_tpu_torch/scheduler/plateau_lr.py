"""Metric-driven plateau scheduling (↔ ``amcontrast3d_tpu/scheduler/
plateau_lr.py``, itself ↔ torch's ``ReduceLROnPlateau``).

The train step keeps a per-step schedule for the base rate; the plateau
decision follows a validation metric the host sees between epochs.
:class:`PlateauScheduler.step` returns the factor ``current / base`` and the
trainer multiplies every parameter group's rate by it
(``make_train_step``'s ``state["lr_scale"]``): as in the JAX package, where
the factor rescales the whole update, decoupled weight decay included.
"""
from __future__ import annotations

import math


class PlateauScheduler:
    """Host-side ReduceLROnPlateau with torch's 'rel' threshold semantics.

    ``step(metric)`` returns the multiplicative scale (current_lr / base_lr)."""

    def __init__(self, base_lr: float, mode: str = "max",
                 decay_rate: float = 0.1, patience_t: int = 10,
                 threshold: float = 1e-4, cooldown_t: int = 0,
                 lr_min: float = 0.0):
        if mode not in ("max", "min"):
            raise ValueError(f"plateau mode must be max or min, got {mode}")
        self.base_lr = float(base_lr)
        self.lr = float(base_lr)
        self.mode = mode
        self.factor = float(decay_rate)
        self.patience = int(patience_t)
        self.threshold = float(threshold)
        self.cooldown_t = int(cooldown_t)
        self.lr_min = float(lr_min)
        self.best = -math.inf if mode == "max" else math.inf
        self.num_bad_epochs = 0
        self.cooldown_counter = 0

    def _is_better(self, a: float) -> bool:
        # torch threshold_mode='rel'
        if self.mode == "max":
            return a > self.best * (self.threshold + 1.0)
        return a < self.best * (1.0 - self.threshold)

    def step(self, metric: float) -> float:
        if self._is_better(metric):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        if self.num_bad_epochs > self.patience:
            self.lr = max(self.lr * self.factor, self.lr_min)
            self.cooldown_counter = self.cooldown_t
            self.num_bad_epochs = 0
        return self.lr / self.base_lr

    @property
    def scale(self) -> float:
        return self.lr / self.base_lr

    def state_dict(self):
        return {"best": self.best, "lr": self.lr,
                "num_bad_epochs": self.num_bad_epochs,
                "cooldown_counter": self.cooldown_counter}

    def load_state_dict(self, sd):
        self.best = sd["best"]
        self.lr = sd.get("lr", self.lr)
        self.num_bad_epochs = sd.get("num_bad_epochs", 0)
        self.cooldown_counter = sd.get("cooldown_counter", 0)
