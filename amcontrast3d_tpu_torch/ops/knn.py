"""Exact k-nearest neighbours and ball query over batched point clouds.

↔ ``amcontrast3d_tpu/ops/knn.py``: ``knn`` is the exact ``_knn_jnp`` and
``ball_query`` the reference-exact ``_ball_query_jnp``.  The kNN kernel
(``csrc/knn.cu``) replaces ``ops/knn_pallas.py::_knn_kernel`` and is exact,
where the TPU kernel is approximate by design; the ball-query kernel
(``csrc/ball_query.cu``) replaces ``ops/knn_pallas.py::_ball_kernel_value``.

Both kernels read the support sorted along a Morton curve in 64-point
chunks with boxes (``ops/spatial.py``) and scan only the chunks that can
hold a neighbour or reach into a ball (a block of 8 queries lists the
chunks once, each warp tests the list 32 boxes at a time), at any N: they
also replace ``_knn_kernel_big`` and ``_ball_kernel_value_big``, which the
JAX package takes above its gate ``_BIG_N`` (``knn_pallas.py:179``,
``:360``), since on the H100 each is as fast below that size and faster
above it (PERF.md).  A caller that already holds the support's
:class:`spatial.SortedCloud` hands it in (``cloud=``), so a stage cloud is
sorted once a forward; without it the wrapper sorts.  When the queries are
the support itself, the kernels read their order (and the kNN its home
chunks) from the layout itself; the ball query also takes the queries'
own layout (``query_cloud=``) as their order.  All return exactly what the
plain twins return.

Distances are in the direct form ``(dx·dx + dy·dy) + dz·dz`` (the form of
the Pallas kernels), not the JAX plain path's ``|q|² + |s|² − 2q·s`` matmul
form: the kernel and its twin round alike, so their results agree bit for
bit on the card.  Against the JAX matmul form a support point may flip
membership only where its d² lies within float32 rounding of r².

The neighbour-selection backend (``set_knn_backend``, default from
``AMC3D_KNN_BACKEND``) is process-wide, as in the JAX package.  ``approx``
routes the contrast loss and the stage labels to the TPU's own
threshold selection (``ops/contrast.py``: ``contrast_reductions_selfk``,
``label_vote``); ``knn`` itself stays exact in every mode.  ``auto`` means
``exact`` here: the JAX package's ``auto`` means approx on a TPU only.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

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


_BACKENDS = ("auto", "exact", "approx")
_KNN_BACKEND = "auto"


def set_knn_backend(backend: str) -> None:
    """'auto' | 'exact' | 'approx' (↔ ``amcontrast3d_tpu/ops/knn.py:51``)."""
    global _KNN_BACKEND
    if backend not in _BACKENDS:
        raise ValueError(f"kNN backend must be one of {_BACKENDS}, got {backend!r}")
    _KNN_BACKEND = backend


def use_approx() -> bool:
    """Whether the loss takes the TPU's threshold selection (``approx``)."""
    return _KNN_BACKEND == "approx"


set_knn_backend(os.environ.get("AMC3D_KNN_BACKEND", "auto"))


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


def knn_plain(support: torch.Tensor, query: torch.Tensor, k: int,
              cloud: Optional[spatial.SortedCloud] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch exact kNN of ``query`` among ``support``.

    Returns idx (B, M, k) int32 in ascending distance, ties to the lowest
    index (as ``lax.top_k``), and their d² (B, M, k) f32.  For k > N the
    extra slots hold index 0 at d² = 1e10, as in the JAX package.  It takes
    :func:`knn`'s arguments; a layout (``cloud``) changes nothing here."""
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


# the most neighbours one launch of a kNN kernel keeps per query (4
# registers a lane); a larger k takes ceil(k / 128) launches, each keeping
# the next slots after the previous launch's last (d², index) pair
KNN_MAX_K = 128


def knn(support: torch.Tensor, query: torch.Tensor, k: int,
        cloud: Optional[spatial.SortedCloud] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """support (B, N, 3), query (B, M, 3) f32 → idx (B, M, k) int32 and d²
    (B, M, k) f32, exactly as :func:`knn_plain` returns them.  No gradient.

    A CUDA tensor goes through the ``csrc/knn.cu`` kernel in ⌈k / 128⌉
    launches, over ``cloud`` (the support's :func:`spatial.sort_support`
    or :func:`spatial.sort_stages`, refused for another tensor; sorted here
    when not given); a CPU tensor through :func:`knn_plain`."""
    if cloud is not None:
        spatial.check_layout(cloud, support)
    if support.device.type == "cpu" and query.device.type == "cpu":
        return knn_plain(support, query, k)
    _check_cuda("kNN", support, query, k)
    B, N, _ = support.shape
    M = query.shape[1]
    if cloud is None:
        cloud = spatial.sort_support(support)
    # the kernel reads the support's own order when the queries are the
    # support; else the tensors must live until the launches are queued
    ordered = () if spatial.is_self(support, query) else \
        spatial.query_order(query, cloud)
    order, home = (t.data_ptr() for t in ordered) if ordered else (0, 0)
    idx = torch.empty(B, M, k, dtype=torch.int32, device=query.device)
    d2 = torch.empty(B, M, k, dtype=torch.float32, device=query.device)
    _passes("amc3d_knn", knn,
            (cloud.packed.data_ptr(), cloud.boxes.data_ptr(), query.data_ptr(),
             order, home), (B, N, M), idx, d2)
    return idx, d2


knn.launches = 0


def _check_cuda(name: str, support: torch.Tensor, query: torch.Tensor,
                k: int) -> None:
    _check(support, query, k)
    if (support.device.type != "cuda" or not support.is_contiguous()
            or not query.is_contiguous()):
        raise ValueError(f"{name} kernel needs contiguous CUDA tensors, got "
                         f"{support.device}")


def _passes(name: str, counted, inputs: tuple, sizes: tuple,
            idx: torch.Tensor, d2: torch.Tensor) -> None:
    """Launch ``name`` once for every 128 slots of the (B, M, k) outputs:
    the slots first … first + 127 of each row, after the pair in slot
    first − 1; ``inputs`` are the input pointers, ``sizes`` (B, N, M)."""
    k = idx.shape[-1]
    stream = torch.cuda.current_stream(idx.device).cuda_stream
    for first in range(0, k, KNN_MAX_K):
        launch(name, *inputs, idx.data_ptr() + 4 * first,
               d2.data_ptr() + 4 * first, *sizes, min(KNN_MAX_K, k - first),
               k, first, stream)
        counted.launches += 1


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
                     k: int, cloud: Optional[spatial.SortedCloud] = None,
                     query_cloud: Optional[spatial.SortedCloud] = None
                     ) -> torch.Tensor:
    """Plain PyTorch ball query (``ball_query_gpu.cu:15-51`` semantics).

    The first ``k`` support indices in index order with d² < r²; missing
    slots are padded with the first hit, or 0 when the ball is empty.
    Returns (B, M, k) int32.  It takes :func:`ball_query`'s arguments; the
    layouts (``cloud``, ``query_cloud``) change nothing here."""
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
               k: int, cloud: Optional[spatial.SortedCloud] = None,
               query_cloud: Optional[spatial.SortedCloud] = None
               ) -> torch.Tensor:
    """support (B, N, 3), query (B, M, 3) f32 → idx (B, M, k) int32,
    exactly as :func:`ball_query_plain` returns it.  No gradient.

    A CUDA tensor goes through the ``csrc/ball_query.cu`` kernel in
    ⌈k / 128⌉ launches, at any N, over ``cloud`` (the support's
    :func:`spatial.sort_support` or :func:`spatial.sort_stages`, refused
    for another tensor; sorted here when not given).  The queries are
    worked on in the support's own order when they are the support, else in
    the order of ``query_cloud`` (the queries' own layout, refused for
    another tensor) or, without it, of :func:`spatial.query_order`.  A CPU
    tensor goes through :func:`ball_query_plain`."""
    if cloud is not None:
        spatial.check_layout(cloud, support)
    if query_cloud is not None:
        spatial.check_layout(query_cloud, query)
    if support.device.type == "cpu" and query.device.type == "cpu":
        return ball_query_plain(support, query, radius, k)
    _check_cuda("ball-query", support, query, k)
    B, N, _ = support.shape
    M = query.shape[1]
    if cloud is None:
        cloud = spatial.sort_support(support)
    # the tensors must live until the launches are queued
    order = None
    if spatial.is_self(support, query):
        ordered = cloud.packed
    elif query_cloud is not None:
        ordered = query_cloud.packed
    else:
        ordered, order = None, spatial.query_order(query, cloud)[0]
    out = torch.empty(B, M, k, dtype=torch.int32, device=query.device)
    stream = torch.cuda.current_stream(query.device).cuda_stream
    for first in range(0, k, KNN_MAX_K):
        launch("amc3d_ball_query", cloud.packed.data_ptr(),
               cloud.boxes.data_ptr(),
               0 if ordered is None else ordered.data_ptr(), query.data_ptr(),
               0 if order is None else order.data_ptr(), out.data_ptr(), B, N,
               M, min(KNN_MAX_K, k - first), k, first, _radius2(radius),
               stream)
        ball_query.launches += 1
    return out


ball_query.launches = 0
