"""Masked refinement of high-ambiguity decoder features (AMContrast3D++).

↔ ``amcontrast3d_tpu/models/refine.py``.  Functional (no parameters), on
dense (B, N, C) tensors, clouds kept separate:

* CrossMask — for every point, the feature of its minimum-ambiguity kNN
  neighbour (``fusion='MIN'``) or the mean over the K slots of the
  zero-ambiguity neighbours' features (``'MIN_ALL0'``): one fused op,
  :func:`amcontrast3d_tpu_torch.ops.refine.dual_masks_cross`, exact (the
  JAX package's kNN-and-gather branch);
* SelfMask — the points with ``threshold ≤ a ≤ threshold_max``;
* update ``f_new = f·¬S + Cross·S``, blended ``f ← γ·f_new + (1−γ)·f``;
  the refine rate is the percentage of points updated.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops.refine import dual_masks_cross
from ..ops.spatial import SortedCloud


def dual_masks(p: torch.Tensor, f: torch.Tensor, a: torch.Tensor,
               nsample_k: int, fusion: str, threshold: float,
               threshold_max: float, gamma: float,
               cloud: Optional[SortedCloud] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """p (B, N, 3), f (B, N, C), a (B, N) → (refined f, refine rate %).
    Gradients reach ``f`` only: the masks are discrete in ``a``.
    ``cloud``: the layout of ``p``, where the caller holds it."""
    cross = dual_masks_cross(p.contiguous(), f.contiguous(),
                             a.detach().contiguous(), nsample_k, fusion,
                             cloud)
    self_mask = (a >= threshold) & (a <= threshold_max)
    rate = self_mask.float().mean() * 100.0
    s = self_mask[..., None].to(f.dtype)
    f_new = f * (1.0 - s) + cross * s
    return gamma * f_new + (1.0 - gamma) * f, rate


def map_sum(f: torch.Tensor, a_map: torch.Tensor) -> torch.Tensor:
    """f + a_map."""
    return f + a_map


def map_multiply(f: torch.Tensor, a_map: torch.Tensor) -> torch.Tensor:
    """f ⊙ a_map."""
    return f * a_map


def multiply(f: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """f ⊙ a, a (B, N)."""
    return f * a[..., None]


def consistency_regularization(e1: torch.Tensor,
                               e2: torch.Tensor) -> torch.Tensor:
    """Jensen–Shannon divergence of two embeddings, softmax over axis 0
    (unused in training)."""
    p1, p2 = torch.softmax(e1, 0), torch.softmax(e2, 0)
    m = 0.5 * (p1 + p2)
    logm = torch.log(torch.clamp_min(m, 1e-12))
    kl1 = (m * (logm - torch.log_softmax(e1, 0))).sum() / e1.shape[0]
    kl2 = (m * (logm - torch.log_softmax(e2, 0))).sum() / e2.shape[0]
    return 0.5 * (kl1 + kl2)
