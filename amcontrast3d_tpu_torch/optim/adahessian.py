"""AdaHessian: the Hutchinson estimate of the Hessian diagonal and the
update rule it feeds.

↔ ``amcontrast3d_tpu/optim/adahessian.py``.  The JAX package takes each
``H z`` with one ``jax.jvp`` through the gradient function
(forward-over-reverse); the port takes it as the reference torch
Adahessian does (its ``set_hessian``): the gradients with
``create_graph=True``, then a second ``torch.autograd.grad`` of them
along the probes (reverse-over-reverse).  ``H`` is symmetric, so both give
the same ``H z``.  Every custom autograd function the step runs has a
second-order rule (a kernel on the card, a plain twin on the CPU) or
raises on a second-order pass, so no term of ``H z`` is dropped.

:func:`adahessian` is the update rule as an :mod:`optim.extras` rule that
takes the diagonal as ``hess=`` (``Chain.step(hess=...)``), in float32 as
optax's: EMAs of the gradient and of hess², bias corrections in float32,
``hessian_power`` on the denominator, and the decoupled decay under the
factory's mask (``ndim > 1``).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from . import extras


def rademacher_like(params: Sequence[torch.Tensor],
                    generator: Optional[torch.Generator] = None
                    ) -> List[torch.Tensor]:
    """A ±1 probe of each parameter's shape, dtype and device, drawn from
    ``generator`` (on the parameters' device) in the parameters' order."""
    return [torch.randint(0, 2, p.shape, generator=generator, device=p.device,
                          dtype=torch.int8).to(p.dtype).mul_(2).sub_(1)
            for p in params]


def hutchinson_diag(grads: Sequence[torch.Tensor],
                    params: Sequence[torch.Tensor],
                    probes: Sequence[Sequence[torch.Tensor]]
                    ) -> List[torch.Tensor]:
    """``z ⊙ (H z)`` of each parameter, averaged over the probe sets in
    ``probes`` (each a list of ±1 tensors, one a parameter).  ``grads``
    must come from ``torch.autograd.grad(loss, params, create_graph=True)``;
    a gradient with no graph (it does not depend on the parameters) gives
    a zero diagonal.  The graph is kept until the last probe set."""
    live = [i for i, g in enumerate(grads) if g is not None and g.requires_grad]
    acc = [torch.zeros_like(p) for p in params]
    for n, zs in enumerate(probes):
        hz = torch.autograd.grad([grads[i] for i in live],
                                 [params[i] for i in live],
                                 grad_outputs=[zs[i] for i in live],
                                 retain_graph=n + 1 < len(probes),
                                 allow_unused=True)
        for i, h in zip(live, hz):
            if h is not None:
                acc[i].add_(h * zs[i])
    if len(probes) > 1:
        acc = [a / len(probes) for a in acc]
    return acc


def adahessian(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
               weight_decay: float = 0.0, hessian_power: float = 1.0
               ) -> extras.Rule:
    """The rule of ``amcontrast3d_tpu/optim/adahessian.py::adahessian``::

        m ← β₁·m + (1−β₁)·g          v ← β₂·v + (1−β₂)·hess²
        u ← −(lr/bc₁)·m / ((v/bc₂)^(k/2) + eps) − lr·wd·p·[ndim > 1]

    ``hess`` (the parameter's Hutchinson diagonal) is required."""
    k2 = hessian_power / 2.0

    def rule(p, g, st: Dict, lr, hess=None):
        if hess is None:
            raise ValueError("adahessian needs the Hutchinson Hessian "
                             "diagonal: optimizer.step(hess=...)")
        m = st.get("exp_avg", torch.zeros_like(g))
        v = st.get("exp_hessian_diag_sq", torch.zeros_like(g))
        st["exp_avg"] = m = b1 * m + (1 - b1) * g
        st["exp_hessian_diag_sq"] = v = b2 * v + (1 - b2) * hess * hess
        t = extras._count(st)
        bc1 = extras._bias_correction(b1, t)
        bc2 = extras._bias_correction(b2, t)
        u = -(lr / bc1) * m / ((v / bc2) ** k2 + eps)
        if weight_decay and p.ndim > 1:
            u = u - lr * weight_decay * p
        return u
    return rule
