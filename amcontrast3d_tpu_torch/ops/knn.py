"""Exact k-nearest neighbours and ball query over batched point clouds.

↔ ``amcontrast3d_tpu/ops/knn.py``: ``knn`` is the exact ``_knn_jnp`` (the
twin that ``three_nn`` needs; no kernel in this slice) and ``ball_query``
the reference-exact ``_ball_query_jnp``.  The ball-query kernel
(``csrc/ball_query.cu``) replaces ``ops/knn_pallas.py::_ball_kernel_value``.

Distances are in the direct form ``(dx·dx + dy·dy) + dz·dz`` (the form of
the Pallas kernels), not the JAX plain path's ``|q|² + |s|² − 2q·s`` matmul
form: the kernel and its twin round alike, so their results agree bit for
bit on the card.  Against the JAX matmul form a support point may flip
membership only where its d² lies within float32 rounding of r².
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ._build import launch

_INF = 1e10
# query rows per (B, tile, N) distance block of the plain paths
_KNN_TILE = 2048
_BALL_TILE = 1024


def pairwise_d2(query: torch.Tensor, support: torch.Tensor) -> torch.Tensor:
    """query (B, M, 3), support (B, N, 3) → (B, M, N) squared distances,
    each rounded as ``(dx·dx + dy·dy) + dz·dz``."""
    (qx, qy, qz), (sx, sy, sz) = query.unbind(-1), support.unbind(-1)
    dx = qx[:, :, None] - sx[:, None, :]
    dy = qy[:, :, None] - sy[:, None, :]
    dz = qz[:, :, None] - sz[:, None, :]
    return (dx * dx + dy * dy) + dz * dz


def knn(support: torch.Tensor, query: torch.Tensor,
        k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN of ``query`` among ``support``.

    Returns idx (B, M, k) int32 in ascending distance, ties to the lowest
    index (as ``lax.top_k``), and their d² (B, M, k) f32.  For k > N the
    extra slots hold index 0 at d² = 1e10, as in the JAX package."""
    B, N, _ = support.shape
    kk = min(k, N)
    arange = torch.arange(N, device=support.device)
    idx_tiles, d2_tiles = [], []
    for s in range(0, query.shape[1], _KNN_TILE):
        d2 = pairwise_d2(query[:, s:s + _KNN_TILE], support)
        # one int64 key per pair orders by (d², index): d² ≥ +0, whose
        # float bits order as integers, and the index breaks ties
        key = d2.view(torch.int32).to(torch.int64).bitwise_left_shift_(32)
        key.bitwise_or_(arange)
        idx = torch.topk(key, kk, dim=-1, largest=False, sorted=True).indices
        del key
        vals = torch.gather(d2, -1, idx)
        if k > N:
            idx = torch.cat([idx, idx.new_zeros((*idx.shape[:2], k - N))], -1)
            vals = torch.cat([vals, vals.new_full((*vals.shape[:2], k - N),
                                                  _INF)], -1)
        idx_tiles.append(idx.to(torch.int32))
        d2_tiles.append(vals)
    return torch.cat(idx_tiles, 1), torch.cat(d2_tiles, 1)


def _radius2(radius: float) -> float:
    """r² rounded once to float32, as the JAX paths compare against it."""
    return float(np.float32(radius * radius))


def _check(support: torch.Tensor, query: torch.Tensor, k: int) -> None:
    for name, t in (("support", support), ("query", query)):
        if t.dim() != 3 or t.shape[-1] != 3:
            raise ValueError(f"{name} must be (B, n, 3), got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if support.shape[0] != query.shape[0] or support.device != query.device:
        raise ValueError("support and query differ in batch size or device")
    if k < 1:
        raise ValueError(f"k must be positive, got {k}")


def ball_query_plain(support: torch.Tensor, query: torch.Tensor, radius: float,
                     k: int) -> torch.Tensor:
    """Plain PyTorch ball query (``ball_query_gpu.cu:15-51`` semantics).

    The first ``k`` support indices in index order with d² < r²; missing
    slots are padded with the first hit, or 0 when the ball is empty.
    Returns (B, M, k) int32."""
    _check(support, query, k)
    B, N, _ = support.shape
    r2 = _radius2(radius)
    arange = torch.arange(N, device=support.device)
    out = []
    for s in range(0, query.shape[1], _BALL_TILE):
        inside = pairwise_d2(query[:, s:s + _BALL_TILE], support) < r2
        # priority = index inside the ball, N + index outside: the k
        # smallest priorities are the first k hits, then sentinels ≥ N
        prio = torch.where(inside, arange, arange + N)
        if k > N:
            prio = torch.cat([prio, prio.new_full((*prio.shape[:2], k - N),
                                                  2 * N)], -1)
        sel = torch.topk(prio, k, dim=-1, largest=False, sorted=True).values
        first = sel[..., :1]
        pad = torch.where(first < N, first, 0)
        out.append(torch.where(sel < N, sel, pad).to(torch.int32))
    return torch.cat(out, 1)


def ball_query(support: torch.Tensor, query: torch.Tensor, radius: float,
               k: int) -> torch.Tensor:
    """support (B, N, 3), query (B, M, 3) f32 → idx (B, M, k) int32.

    A CUDA tensor goes through the ``csrc/ball_query.cu`` kernel; a CPU
    tensor through :func:`ball_query_plain`."""
    if support.device.type == "cpu" and query.device.type == "cpu":
        return ball_query_plain(support, query, radius, k)
    _check(support, query, k)
    if (support.device.type != "cuda" or not support.is_contiguous()
            or not query.is_contiguous()):
        raise ValueError("ball-query kernel needs contiguous CUDA tensors, "
                         f"got {support.device}")
    B, N, _ = support.shape
    M = query.shape[1]
    out = torch.empty(B, M, k, dtype=torch.int32, device=query.device)
    launch("amc3d_ball_query", support.data_ptr(), query.data_ptr(),
           out.data_ptr(), B, N, M, k, _radius2(radius),
           torch.cuda.current_stream(query.device).cuda_stream)
    ball_query.launches += 1
    return out


ball_query.launches = 0
