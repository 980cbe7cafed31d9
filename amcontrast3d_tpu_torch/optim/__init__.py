"""Optimizer factory and the global-norm gradient clip.

↔ ``amcontrast3d_tpu/optim/__init__.py``.  ``adamw``, the optimizer of
the S3DIS recipe, is ``torch.optim.AdamW`` with the reference's
weight-decay filtering (decay only on parameters with ndim > 1, two
parameter groups), betas (0.9, 0.999), eps 1e-8: optax's ``adamw`` in
exact arithmetic, as both apply ``lr·(m̂/(√v̂ + eps) + wd·θ)``.  Every other
name of the JAX factory's table (and ``adamw`` under ``layer_decay`` or a
``lookahead_`` prefix) is an :class:`optim.extras.Chain` over optax's rule
with the factory's arguments (:func:`optax_rule`).  ``adahessian``
(:mod:`optim.adahessian`) is such a chain too; its rule takes the step's
Hutchinson diagonal (``optimizer.step(hess=...)``), which
``engine.train.make_train_step(needs_hessian=True)`` computes.
:func:`needs_hessian` names the optimizers that take it.

Frozen parameters (↔ ``Runner._freeze_labels`` with optax's
``multi_transform`` and ``set_to_zero``): :func:`freeze_parameters_` turns
``requires_grad`` off for the parameters a regular expression names, before
the optimizer is built, so they get no gradient, count nothing towards the
clip's global norm, and get no update and no weight decay.
"""
from __future__ import annotations

import re
from typing import Callable, Dict, Iterable, List, Optional

import torch
from torch import nn

from . import extras
from .adahessian import adahessian, hutchinson_diag, rademacher_like
from .extras import Chain, Rule


def needs_hessian(cfg) -> bool:
    """Whether the optimizer of ``cfg`` takes the Hutchinson diagonal: a
    name ending in ``adahessian`` (↔ the JAX runner's
    ``opt_name.endswith("adahessian")``, ``engine/runner.py:124``)."""
    cfg = dict(cfg) if cfg is not None else {}
    return str(cfg.get("NAME", "adamw")).lower().endswith("adahessian")


def _decay_then(weight_decay: float, rule: Rule) -> Rule:
    """optax's chain of a coupled L2 term (``add_decayed_weights`` under
    the ``ndim > 1`` mask) ahead of ``rule``, where ``weight_decay`` is
    set."""
    if not weight_decay:
        return rule
    return lambda p, g, st, lr: rule(p, extras._decayed(p, g, weight_decay),
                                     st, lr)


def _then_rate(rule: Rule, weight_decay: float = 0.0,
               trust: bool = False) -> Rule:
    """``rule``, then (optax's ``lamb`` and ``adamw``) the decoupled decay
    under the mask, (``lamb``) the trust ratio, and the rate with its
    sign."""
    def chained(p, g, st, lr):
        u = extras._decayed(p, rule(p, g, st, lr), weight_decay)
        if trust:
            u = extras._trust_ratio(p, u)
        return -lr * u
    return chained


def optax_rule(cfg: Dict) -> Callable[[str], Rule]:
    """The rule of each parameter (by name) of the JAX factory's optimizer
    for ``cfg`` (↔ ``build_optimizer_from_cfg``, ``optim/__init__.py:39-133``
    of the JAX package): the ``lookahead_`` prefix, ``layer_decay`` for
    0 < ``layer_decay`` < 1 (``num_layers``, default 12), and the name
    table with the factory's defaults and coupled L2."""
    cfg = dict(cfg)
    name = str(cfg.get("NAME", "adamw")).lower()
    weight_decay = float(cfg.get("weight_decay", 0.0) or 0.0)
    momentum = float(cfg.get("momentum", 0.9) or 0.9)
    eps = float(cfg.get("eps", 1e-8) or 1e-8)
    betas = cfg.get("betas", cfg.get("opt_betas", None))
    b1, b2 = (betas if betas is not None else (0.9, 0.999))
    if name.startswith("lookahead_"):
        base = optax_rule({**cfg, "NAME": name[len("lookahead_"):]})
        alpha = float(cfg.get("lookahead_alpha", 0.5))
        k = int(cfg.get("lookahead_k", 6))
        return lambda n: extras.lookahead(base(n), alpha=alpha, k=k)
    layer_decay = float(cfg.get("layer_decay", 0.0) or 0.0)
    if 0.0 < layer_decay < 1.0:
        base = optax_rule({k: v for k, v in cfg.items() if k != "layer_decay"})
        num_layers = int(cfg.get("num_layers", 12))
        return lambda n: extras.scaled(base(n), extras.layer_decay_scale(
            n, layer_decay, num_layers))

    def rate(rule: Rule) -> Rule:
        return lambda p, g, st, lr: -lr * rule(p, g, st, lr)

    if name == "adamw":
        rule = _then_rate(extras.scale_by_adam(b1, b2, eps), weight_decay)
    elif name == "adam":
        rule = _decay_then(weight_decay,
                           rate(extras.scale_by_adam(b1, b2, eps)))
    elif name in ("sgd", "momentum"):
        nesterov = bool(cfg.get("nesterov", True))

        def sgd(p, g, st, lr):
            return -lr * extras._trace(st, g, momentum, nesterov)
        rule = _decay_then(weight_decay, sgd)
    elif name == "radam":
        rule = _decay_then(weight_decay,
                           rate(extras.scale_by_radam(b1, b2, eps)))
    elif name == "adabelief":
        rule = _decay_then(weight_decay,
                           rate(extras.scale_by_belief(b1, b2, eps)))
    elif name == "adafactor":
        rule = extras.adafactor(weight_decay or None)
    elif name == "lamb":
        rule = _then_rate(extras.scale_by_adam(b1, b2, eps), weight_decay,
                          trust=True)
    elif name == "lars":
        def lars(p, g, st, lr):
            u = extras._trust_ratio(p, extras._decayed(p, g, weight_decay),
                                    coefficient=0.001)
            return extras._trace(st, -lr * u, momentum, False)
        rule = lars
    elif name in ("nadam", "nadamw"):
        rule = _decay_then(weight_decay, rate(
            extras.scale_by_adam(b1, b2, eps, nesterov=True)))
    elif name in ("novograd", "nvnovograd"):
        rule = rate(extras.scale_by_novograd(b1, b2, eps, weight_decay))
    elif name in ("rmsprop", "rmsprop_tf"):
        rms = extras.scale_by_rms(float(cfg.get("alpha", 0.9)), eps)

        def rmsprop(p, g, st, lr):
            return extras._trace(st, -lr * rms(p, g, st, lr), momentum, False)
        rule = _decay_then(weight_decay, rmsprop)
    elif name == "lion":
        rule = _then_rate(extras.scale_by_lion(), weight_decay)
    elif name == "adamp":
        rule = extras.adamp(b1, b2, eps, weight_decay,
                            delta=float(cfg.get("delta", 0.1)),
                            wd_ratio=float(cfg.get("wd_ratio", 0.01)),
                            nesterov=bool(cfg.get("nesterov", True)))
    elif name == "sgdp":
        rule = extras.sgdp(momentum, float(cfg.get("dampening", 0.0)),
                           weight_decay, bool(cfg.get("nesterov", True)), eps,
                           delta=float(cfg.get("delta", 0.1)),
                           wd_ratio=float(cfg.get("wd_ratio", 0.1)))
    elif name in ("madgrad", "madgradw"):
        rule = extras.madgrad(momentum, weight_decay,
                              float(cfg["eps"]) if "eps" in cfg else 1e-6,
                              decoupled_decay=name == "madgradw")
    elif name == "adahessian":
        # no coupled L2: the JAX factory returns the rule unchained
        rule = adahessian(b1, b2, eps, weight_decay,
                          float(cfg.get("hessian_power", 1.0)))
    else:
        raise ValueError(f"optimizer {name} is not supported")
    return lambda n: rule


def build_optimizer_from_cfg(cfg, model: nn.Module,
                             lr: float = None) -> torch.optim.Optimizer:
    """cfg keys: NAME (default ``adamw``), weight_decay, betas/opt_betas,
    eps, momentum, lr, and each optimizer's own (``nesterov``, ``alpha``,
    ``delta``, ``wd_ratio``, ``dampening``, ``lookahead_alpha``,
    ``lookahead_k``, ``layer_decay``, ``num_layers``, ``hessian_power``).
    The learning rate
    of each step is set by the train step from its schedule; ``lr`` (or
    cfg.lr) is only the initial value."""
    cfg = dict(cfg) if cfg is not None else {}
    if lr is None:
        lr = float(cfg.get("lr", 1e-3))
    name = str(cfg.get("NAME", "adamw")).lower()
    layer_decay = float(cfg.get("layer_decay", 0.0) or 0.0)
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    if name != "adamw" or 0.0 < layer_decay < 1.0:
        return Chain(named, optax_rule(cfg), lr)
    weight_decay = float(cfg.get("weight_decay", 0.0) or 0.0)
    eps = float(cfg.get("eps", 1e-8) or 1e-8)
    betas = cfg.get("betas", cfg.get("opt_betas", None)) or (0.9, 0.999)
    decay = [p for _, p in named if p.ndim > 1]
    no_decay = [p for _, p in named if p.ndim <= 1]
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
