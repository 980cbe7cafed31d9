"""Learning-rate schedules, stepped per epoch.

↔ ``amcontrast3d_tpu/scheduler/__init__.py``: ``cosine`` (the S3DIS
recipe), ``multistep`` (the ScanNet recipe: [70, 90] × 0.1), ``step``,
``poly``, ``tanh`` and ``plateau``, each with linear warmup.
``build_scheduler_from_cfg(cfg)`` returns ``(lr_fn, epochs)``,
``lr_fn(epoch)`` a Python float; the train step reads it per step through
:func:`as_step_schedule`.  The JAX package evaluates the same formulas in
float32, so the two agree to about 1e-6 relative.  For ``plateau`` the
base rate is constant after warmup and ``lr_fn.plateau`` holds the
:class:`~.plateau_lr.PlateauScheduler` whose scale the trainer applies.
"""
from __future__ import annotations

import math
from typing import Callable, Tuple

from .plateau_lr import PlateauScheduler


def build_scheduler_from_cfg(cfg) -> Tuple[Callable[[int], float], int]:
    cfg = dict(cfg)
    name = str(cfg.get("sched", "cosine")).lower()
    epochs = int(cfg.get("epochs", 100))
    lr = float(cfg.get("lr", 1e-3))
    min_lr = float(cfg.get("min_lr", 1e-5) or 0.0)
    warmup_epochs = int(cfg.get("warmup_epochs", 0) or 0)
    warmup_lr = float(cfg.get("warmup_lr", 1e-6) or 1e-6)
    decay_rate = float(cfg.get("decay_rate", 0.1) or 0.1)

    def with_warmup(fn):
        def sched(epoch) -> float:
            e = float(epoch)
            if warmup_epochs > 0 and e < warmup_epochs:
                return warmup_lr + (lr - warmup_lr) * e / warmup_epochs
            return fn(e)
        return sched

    def progress(e: float) -> float:
        return min(max(e / max(epochs, 1), 0.0), 1.0)

    if name == "cosine":
        def fn(e):
            return min_lr + 0.5 * (lr - min_lr) * (
                1.0 + math.cos(math.pi * progress(e)))
    elif name in ("multistep", "multisteplr"):
        milestones = sorted(cfg.get("decay_epochs",
                                    cfg.get("milestones", [30, 60])))

        def fn(e):
            return lr * decay_rate ** sum(e >= m for m in milestones)
    elif name == "step":
        decay_epochs = float(cfg.get("decay_epochs", 30))

        def fn(e):
            return lr * decay_rate ** math.floor(e / decay_epochs)
    elif name == "poly":
        power = float(cfg.get("power", 0.9))

        def fn(e):
            return (lr - min_lr) * (1.0 - progress(e)) ** power + min_lr
    elif name == "tanh":
        lb, ub = float(cfg.get("lb", -7.0)), float(cfg.get("ub", 3.0))

        def fn(e):
            return min_lr + 0.5 * (lr - min_lr) * (
                1.0 - math.tanh(lb + (ub - lb) * progress(e)))
    elif name in ("plateau", "plateau_lr"):
        # metric-driven: the base rate is constant after warmup; the decay
        # is a factor the trainer puts on it between epochs
        sched = with_warmup(lambda e: lr)
        # the JAX package reads the direction from ``mode``, the key that
        # also names the CLI's run mode (train, resume, ...), and stops on
        # an assertion whenever that is set: here ``mode`` counts only when
        # it is a direction, and ``plateau_mode`` names it outright
        direction = cfg.get("plateau_mode") or cfg.get("mode")
        sched.plateau = PlateauScheduler(
            base_lr=lr,
            mode=direction if direction in ("max", "min") else "max",
            decay_rate=decay_rate,
            patience_t=int(cfg.get("patience_epochs",
                                   cfg.get("patience_t", 10))),
            threshold=float(cfg.get("threshold", 1e-4)),
            cooldown_t=int(cfg.get("cooldown_epochs", cfg.get("cooldown_t", 0))),
            lr_min=min_lr)
        return sched, epochs
    else:
        raise ValueError(f"scheduler {name} not supported")
    return with_warmup(fn), epochs


def as_step_schedule(lr_fn: Callable, steps_per_epoch: int,
                     start_epoch: int = 1) -> Callable[[int], float]:
    """Per-step schedule with per-epoch granularity: step s uses
    ``lr_fn(start_epoch + s // steps_per_epoch)``."""
    def sched(step: int) -> float:
        return lr_fn(start_epoch + step // max(steps_per_epoch, 1))
    return sched
