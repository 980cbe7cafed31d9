"""Exact k-nearest neighbours and ball query over batched point clouds.

↔ ``amcontrast3d_tpu/ops/knn.py``: ``knn`` is the exact ``_knn_jnp`` and
``ball_query`` the reference-exact ``_ball_query_jnp``.  The kNN kernel
(``csrc/knn.cu``) replaces ``ops/knn_pallas.py::_knn_kernel`` and is exact,
where the TPU kernel is approximate by design; the ball-query kernel
(``csrc/ball_query.cu``) replaces ``ops/knn_pallas.py::_ball_kernel_value``.

Above ``_BIG_N`` support points (the JAX package's gate of the same name,
``knn_pallas.py:179``) both go to a kernel that scans only the chunks of a
spatially sorted support that can matter: ``csrc/knn_big.cu`` replaces
``_knn_kernel_big`` and ``csrc/ball_query_big.cu`` replaces
``_ball_kernel_value_big``.  They return exactly what the small-cloud
kernels and the plain twins return; the sort ahead of them is
``ops/spatial.py``.

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

from . import spatial
from ._build import launch

_INF = 1e10
# query rows per (B, tile, N) distance block of the plain paths, cut down
# where B·tile·N would pass _TILE_ELEMENTS (a whole room as one cloud)
_KNN_TILE = 2048
_BALL_TILE = 1024
_TILE_ELEMENTS = 2 ** 28
# more support points than this go to the chunk-skipping kernels
_BIG_N = 32768


def _tile_rows(rows: int, B: int, N: int) -> int:
    return max(1, min(rows, _TILE_ELEMENTS // max(B * N, 1)))


def pairwise_d2(query: torch.Tensor, support: torch.Tensor) -> torch.Tensor:
    """query (B, M, 3), support (B, N, 3) → (B, M, N) squared distances,
    each rounded as ``(dx·dx + dy·dy) + dz·dz``."""
    (qx, qy, qz), (sx, sy, sz) = query.unbind(-1), support.unbind(-1)
    dx = qx[:, :, None] - sx[:, None, :]
    dy = qy[:, :, None] - sy[:, None, :]
    dz = qz[:, :, None] - sz[:, None, :]
    return (dx * dx + dy * dy) + dz * dz


def knn_plain(support: torch.Tensor, query: torch.Tensor,
              k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch exact kNN of ``query`` among ``support``.

    Returns idx (B, M, k) int32 in ascending distance, ties to the lowest
    index (as ``lax.top_k``), and their d² (B, M, k) f32.  For k > N the
    extra slots hold index 0 at d² = 1e10, as in the JAX package."""
    B, N, _ = support.shape
    kk = min(k, N)
    arange = torch.arange(N, device=support.device)
    idx_tiles, d2_tiles = [], []
    tile = _tile_rows(_KNN_TILE, B, N)
    for s in range(0, query.shape[1], tile):
        d2 = pairwise_d2(query[:, s:s + tile], support)
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


# the most neighbours the kernel keeps per query (4 registers a lane)
KNN_MAX_K = 128


def knn(support: torch.Tensor, query: torch.Tensor,
        k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """support (B, N, 3), query (B, M, 3) f32 → idx (B, M, k) int32 and d²
    (B, M, k) f32, exactly as :func:`knn_plain` returns them.  No gradient.

    A CUDA tensor goes through the ``csrc/knn.cu`` kernel for
    N ≤ ``_BIG_N`` = 32768 support points and through :func:`knn_big`
    above that (k ≤ 128 both); a CPU tensor through :func:`knn_plain`."""
    if support.device.type == "cpu" and query.device.type == "cpu":
        return knn_plain(support, query, k)
    if support.shape[1] > _BIG_N:
        return knn_big(support, query, k)
    return knn_small(support, query, k)


def _check_cuda(name: str, support: torch.Tensor, query: torch.Tensor,
                k: int) -> None:
    _check(support, query, k)
    if (support.device.type != "cuda" or not support.is_contiguous()
            or not query.is_contiguous()):
        raise ValueError(f"{name} kernel needs contiguous CUDA tensors, got "
                         f"{support.device}")
    if k > KNN_MAX_K:
        raise ValueError(f"{name} kernel takes k ≤ {KNN_MAX_K}, got {k}")


def knn_small(support: torch.Tensor, query: torch.Tensor,
              k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`knn` through the ``csrc/knn.cu`` kernel, which scans the whole
    support for every query (any N; CUDA tensors only)."""
    _check_cuda("kNN", support, query, k)
    B, N, _ = support.shape
    M = query.shape[1]
    idx = torch.empty(B, M, k, dtype=torch.int32, device=query.device)
    d2 = torch.empty(B, M, k, dtype=torch.float32, device=query.device)
    launch("amc3d_knn", support.data_ptr(), query.data_ptr(), idx.data_ptr(),
           d2.data_ptr(), B, N, M, k,
           torch.cuda.current_stream(query.device).cuda_stream)
    knn.launches += 1
    return idx, d2


knn.launches = 0


def knn_big(support: torch.Tensor, query: torch.Tensor,
            k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`knn` through the ``csrc/knn_big.cu`` kernel: the support is
    sorted along a Morton curve (``ops/spatial.py``) and a query scans only
    the 64-point chunks whose box can hold one of its k nearest.  Any N;
    a CPU tensor goes through :func:`knn_plain`."""
    if support.device.type == "cpu" and query.device.type == "cpu":
        return knn_plain(support, query, k)
    _check_cuda("large-cloud kNN", support, query, k)
    B, N, _ = support.shape
    M = query.shape[1]
    cloud = spatial.sort_support(support)
    order, home = spatial.query_order(query, cloud)
    idx = torch.empty(B, M, k, dtype=torch.int32, device=query.device)
    d2 = torch.empty(B, M, k, dtype=torch.float32, device=query.device)
    launch("amc3d_knn_big", cloud.packed.data_ptr(), cloud.boxes.data_ptr(),
           query.data_ptr(), order.data_ptr(), home.data_ptr(), idx.data_ptr(),
           d2.data_ptr(), B, N, M, k,
           torch.cuda.current_stream(query.device).cuda_stream)
    knn_big.launches += 1
    return idx, d2


knn_big.launches = 0


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
    tile = _tile_rows(_BALL_TILE, B, N)
    for s in range(0, query.shape[1], tile):
        inside = pairwise_d2(query[:, s:s + tile], support) < r2
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

    A CUDA tensor goes through the ``csrc/ball_query.cu`` kernel for
    N ≤ ``_BIG_N`` = 32768 support points (or k > 128) and through
    :func:`ball_query_big` above that; a CPU tensor through
    :func:`ball_query_plain`."""
    if support.device.type == "cpu" and query.device.type == "cpu":
        return ball_query_plain(support, query, radius, k)
    if support.shape[1] > _BIG_N and k <= KNN_MAX_K:
        return ball_query_big(support, query, radius, k)
    return ball_query_small(support, query, radius, k)


def ball_query_small(support: torch.Tensor, query: torch.Tensor, radius: float,
                     k: int) -> torch.Tensor:
    """:func:`ball_query` through the ``csrc/ball_query.cu`` kernel, which
    scans the support in index order for every query (any N and k; CUDA
    tensors only)."""
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


def ball_query_big(support: torch.Tensor, query: torch.Tensor, radius: float,
                   k: int) -> torch.Tensor:
    """:func:`ball_query` through the ``csrc/ball_query_big.cu`` kernel:
    the support is sorted along a Morton curve (``ops/spatial.py``), a
    query scans only the 64-point chunks whose box reaches into its ball
    and keeps the k smallest original indices among the hits.  Any N,
    k ≤ 128; a CPU tensor goes through :func:`ball_query_plain`."""
    if support.device.type == "cpu" and query.device.type == "cpu":
        return ball_query_plain(support, query, radius, k)
    _check_cuda("large-cloud ball-query", support, query, k)
    B, N, _ = support.shape
    M = query.shape[1]
    cloud = spatial.sort_support(support)
    order, _ = spatial.query_order(query, cloud)
    out = torch.empty(B, M, k, dtype=torch.int32, device=query.device)
    launch("amc3d_ball_query_big", cloud.packed.data_ptr(),
           cloud.boxes.data_ptr(), query.data_ptr(), order.data_ptr(),
           out.data_ptr(), B, N, M, k, _radius2(radius),
           torch.cuda.current_stream(query.device).cuda_stream)
    ball_query_big.launches += 1
    return out


ball_query_big.launches = 0
