"""Optimizer factory and the global-norm gradient clip.

↔ ``amcontrast3d_tpu/optim/__init__.py`` for ``adamw``, the optimizer of
the S3DIS recipe: ``torch.optim.AdamW`` with the reference's
weight-decay filtering (decay only on parameters with ndim > 1, two
parameter groups), betas (0.9, 0.999), eps 1e-8.  That is optax's
``adamw`` in exact arithmetic: both apply ``lr·(m̂/(√v̂ + eps) + wd·θ)``.
The other optimizers of the JAX factory are not ported yet.

Frozen parameters (↔ ``Runner._freeze_labels`` with optax's
``multi_transform`` and ``set_to_zero``): :func:`freeze_parameters_` turns
``requires_grad`` off for the parameters a regular expression names, before
the optimizer is built, so they get no gradient, count nothing towards the
clip's global norm, and get no update and no weight decay.
"""
from __future__ import annotations

import re
from typing import Iterable, List, Optional

import torch
from torch import nn


def build_optimizer_from_cfg(cfg, model: nn.Module,
                             lr: float = None) -> torch.optim.Optimizer:
    """cfg keys: NAME (``adamw``), weight_decay, betas/opt_betas, eps, lr.
    The learning rate of each step is set by the train step from its
    schedule; ``lr`` (or cfg.lr) is only the initial value."""
    cfg = dict(cfg) if cfg is not None else {}
    name = str(cfg.get("NAME", "adamw")).lower()
    if name != "adamw":
        raise NotImplementedError(f"optimizer {name} is not ported")
    weight_decay = float(cfg.get("weight_decay", 0.0) or 0.0)
    eps = float(cfg.get("eps", 1e-8) or 1e-8)
    betas = cfg.get("betas", cfg.get("opt_betas", None)) or (0.9, 0.999)
    if lr is None:
        lr = float(cfg.get("lr", 1e-3))
    decay, no_decay = [], []
    for p in model.parameters():
        if p.requires_grad:
            (decay if p.ndim > 1 else no_decay).append(p)
    groups = [{"params": decay, "weight_decay": weight_decay},
              {"params": no_decay, "weight_decay": 0.0}]
    return torch.optim.AdamW(groups, lr=lr, betas=tuple(betas), eps=eps)


def freeze_pattern(cfg) -> Optional[str]:
    """The regular expression of the parameters to freeze: ``cfg.freeze_re``,
    or ``encoder/.*block`` when the mode names ``freeze_blocks``
    (↔ main_AA.py:239-241), else None."""
    pattern = cfg.get("freeze_re")
    if pattern is None and "freeze_blocks" in str(cfg.get("mode", "")):
        pattern = r"encoder/.*block"
    return pattern or None


def freeze_parameters_(model: nn.Module, pattern: Optional[str]) -> List[str]:
    """Turn ``requires_grad`` off for every parameter whose path, written
    with ``/`` as in the JAX package (``encoder/enc1_block1/...``), the
    pattern finds.  Returns the frozen names."""
    if not pattern:
        return []
    rx = re.compile(pattern)
    frozen = []
    for name, p in model.named_parameters():
        if rx.search(name.replace(".", "/")):
            p.requires_grad_(False)
            frozen.append(name)
    return frozen


@torch.no_grad()
def clip_by_global_norm_(params: Iterable[torch.Tensor],
                         max_norm: float) -> None:
    """Scale the gradients in place as ``optax.clip_by_global_norm``:
    ``g / ‖g‖ · max_norm`` when ``‖g‖ ≥ max_norm`` (no ``+1e-6`` as in
    torch's ``clip_grad_norm_``), unchanged otherwise.  No host sync."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    clip = norm >= max_norm
    divisor = torch.where(clip, norm, torch.ones_like(norm))
    factor = torch.where(clip, torch.full_like(norm, max_norm),
                         torch.ones_like(norm))
    torch._foreach_div_(grads, divisor)
    torch._foreach_mul_(grads, factor)
