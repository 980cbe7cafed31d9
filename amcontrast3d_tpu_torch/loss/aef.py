"""AEF label propagation and per-stage neighbourhoods.

↔ ``amcontrast3d_tpu/loss/aef.py``.  Stage features are dense
(B, N_s, C) and clouds stay separate, as there.  The kNN is the port's
exact :func:`amcontrast3d_tpu_torch.ops.knn.knn` (direct-form d², ties to
the lowest index), the JAX exact backend's semantics.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops import knn

NSTRIDE = (4, 4, 4, 4)  # MarginContrast.py:59


def one_hot_labels(target: torch.Tensor, num_classes: int,
                   ignore_index: Optional[int] = None) -> torch.Tensor:
    """target (B, N0) int → (B, N0, ncls[+1]) float one-hot; with
    ``ignore_index`` an extra virtual class takes the ignored points."""
    if ignore_index is not None:
        num_classes = num_classes + 1
        target = torch.where(target == ignore_index, num_classes - 1, target)
    return F.one_hot(target.long(), num_classes).float()


def gather_int(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N) int, idx (B, M, K) → (B, M, K)."""
    B, M, K = idx.shape
    return torch.gather(x, 1, idx.reshape(B, M * K).long()).view(B, M, K)


def subscene_labels(labels0: torch.Tensor, p0: torch.Tensor,
                    p_stage: torch.Tensor, stage_i: int) -> torch.Tensor:
    """Soft labels of a subsampled stage: the mean one-hot over the
    ``kr = prod(NSTRIDE[:i])`` nearest stage-0 points.  labels0 (B, N0,
    ncls) one-hot, p0 (B, N0, 3), p_stage (B, N_s, 3) → (B, N_s, ncls);
    stage 0 returns labels0."""
    if stage_i == 0:
        return labels0
    kr = 1
    for s in NSTRIDE[:stage_i]:
        kr *= s
    ncls = labels0.shape[-1]
    idx, _ = knn(p0, p_stage, kr)
    neigh = gather_int(labels0.argmax(-1), idx)              # (B, N_s, kr)
    return F.one_hot(neigh, ncls).float().mean(-2)


def stage_neighborhood(p: torch.Tensor, labels: torch.Tensor, nsample: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """kNN(nsample) without the self slot → (idx (B,N,K), posmask (B,N,K),
    dd (B,N,K) squared neighbour distances), K = nsample − 1."""
    idx, d2 = knn(p, p, nsample)
    idx, dd = idx[..., 1:], d2[..., 1:]
    lab = labels.argmax(-1)
    posmask = lab[..., None] == gather_int(lab, idx)
    return idx, posmask, dd
