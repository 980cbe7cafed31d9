"""Per-point ambiguity of the Ambiguity Estimation Framework (AEF).

↔ ``amcontrast3d_tpu/ops/ambiguity.py`` (``ambiguity_from_stats``,
``ambiguity_function``).  Plain PyTorch, no kernel.

* ``mask_num = n_pos``; ``maxc = max(mask_num)`` over the whole batch;
* hard ambiguity ``|mask_num − maxc| / maxc``;
* boundary points (0 < mask_num < maxc) take the soft value
  ``1 / (1 + e^(β·(cc⁺ − cc⁻)))`` with class compactness ``cc± = n± / d±``,
  where d± sums squared (Method2), rooted (Method3) or constant-5
  (Method1) neighbour distances.
"""
from __future__ import annotations

from typing import Optional

import torch

_EPS = 1e-12


def ambiguity_from_stats(n_pos: torch.Tensor, n_neg: torch.Tensor,
                         d_pos: torch.Tensor, d_neg: torch.Tensor,
                         ccbeta: float = 0.04, method1: bool = False,
                         k_cap: Optional[float] = None) -> torch.Tensor:
    """Ambiguity from reduced neighbourhood statistics (all (...,) f32).

    ``k_cap``: for threshold neighbourhoods, the reference's K-slot size
    ``nsample − 1``; counts are clamped to it (``n_pos ≤ K``,
    ``n_neg = K − n_pos``) so that a superset point cannot raise the
    batch-global ``maxc``."""
    if k_cap is not None:
        n_pos = torch.clamp_max(n_pos, k_cap)
        n_neg = k_cap - n_pos
    mask_num = n_pos
    maxc = torch.clamp_min(mask_num.max(), 1.0)
    a_hard = (mask_num - maxc).abs() / maxc
    boundary = (mask_num > 0) & (mask_num < maxc)
    if method1:
        d_pos = torch.full_like(n_pos, 5.0)
        d_neg = torch.full_like(n_neg, 5.0)
    cc_pos = n_pos / torch.clamp_min(d_pos, _EPS)
    cc_neg = n_neg / torch.clamp_min(d_neg, _EPS)
    a_soft = 1.0 / (1.0 + torch.exp(ccbeta * (cc_pos - cc_neg)))
    return torch.where(boundary, a_soft, a_hard).float()


def ambiguity_function(posmask: torch.Tensor, dd: torch.Tensor,
                       cctype: str = "Method2",
                       ccbeta: float = 0.04) -> torch.Tensor:
    """posmask (..., K) bool, dd (..., K) squared neighbour distances
    → a (...,) f32."""
    K = posmask.shape[-1]
    pm = posmask.float()
    n_pos = pm.sum(-1)
    n_neg = K - n_pos
    if cctype == "Method1":
        d_pos = d_neg = torch.zeros_like(n_pos)
    elif cctype == "Method2":
        d_pos = (pm * dd).sum(-1)
        d_neg = ((1.0 - pm) * dd).sum(-1)
    elif cctype == "Method3":
        dr = torch.sqrt(dd.abs() + _EPS)
        d_pos = (pm * dr).sum(-1)
        d_neg = ((1.0 - pm) * dr).sum(-1)
    else:
        raise ValueError(f"unknown cctype {cctype}")
    return ambiguity_from_stats(n_pos, n_neg, d_pos, d_neg, ccbeta,
                                method1=cctype == "Method1")
