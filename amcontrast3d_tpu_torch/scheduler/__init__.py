"""Learning-rate schedules, stepped per epoch.

↔ ``amcontrast3d_tpu/scheduler/__init__.py`` for ``cosine`` (with
warmup), the S3DIS recipe's schedule.  ``build_scheduler_from_cfg(cfg)``
returns ``(lr_fn, epochs)``, ``lr_fn(epoch)`` a float; the train step
reads it per step through :func:`as_step_schedule`.  The other schedules
of the JAX package are not ported yet.
"""
from __future__ import annotations

import math
from typing import Callable, Tuple


def build_scheduler_from_cfg(cfg) -> Tuple[Callable[[int], float], int]:
    cfg = dict(cfg)
    name = str(cfg.get("sched", "cosine")).lower()
    if name != "cosine":
        raise NotImplementedError(f"scheduler {name} is not ported")
    epochs = int(cfg.get("epochs", 100))
    lr = float(cfg.get("lr", 1e-3))
    min_lr = float(cfg.get("min_lr", 1e-5) or 0.0)
    warmup_epochs = int(cfg.get("warmup_epochs", 0) or 0)
    warmup_lr = float(cfg.get("warmup_lr", 1e-6) or 1e-6)

    def lr_fn(epoch) -> float:
        e = float(epoch)
        if warmup_epochs > 0 and e < warmup_epochs:
            return warmup_lr + (lr - warmup_lr) * e / warmup_epochs
        t = min(max(e / max(epochs, 1), 0.0), 1.0)
        return min_lr + 0.5 * (lr - min_lr) * (1.0 + math.cos(math.pi * t))

    return lr_fn, epochs


def as_step_schedule(lr_fn: Callable, steps_per_epoch: int,
                     start_epoch: int = 1) -> Callable[[int], float]:
    """Per-step schedule with per-epoch granularity: step s uses
    ``lr_fn(start_epoch + s // steps_per_epoch)``."""
    def sched(step: int) -> float:
        return lr_fn(start_epoch + step // max(steps_per_epoch, 1))
    return sched
