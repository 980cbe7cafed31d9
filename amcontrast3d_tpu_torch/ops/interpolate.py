"""3-NN inverse-distance feature interpolation (decoder upsampling).

↔ ``amcontrast3d_tpu/ops/interpolate.py`` (``three_nn``,
``three_interpolate``, ``three_interpolation``) and the fused TPU kernels
``ops/interpolate_pallas.py::_interp_kernel`` and its VJP
``::_interp_bwd_kernel``, ported as ``csrc/interpolate.cu``, the VJP for
large query sets ``::_interp_bwd_big_kernel``, ported as
``csrc/interpolate_bwd_big.cu``, and the three kernels of the forward for
large supports (``::_interp_thr_seed_kernel``, ``::_interp_thr_kernel``,
``::_interp_acc_big_kernel``), ported as one kernel,
``csrc/interpolate_big.cu``.  Weights are ``1/(√d² + 1e-8)``, normalised
over the 3 nearest coarse points.

Both forward kernels read the coarse cloud's Morton-sorted layout
(``ops/spatial.py``), the fine points taken along their own curve; a
caller that holds both stage clouds' layouts (the decoder: the forward
sorts its stage clouds once) hands them in (``cloud=`` the coarse one,
``query_cloud=`` the fine one), else the wrapper sorts.  The listed scan
gives a fine point a warp, the large-shape kernel a lane; which one takes
a call is the port's own rule, read on the card (:func:`forward_is_big`).
The scatter VJP walks the fine points in the order the forward took them,
so the neighbours of a block's points share coarse rows; the deterministic
VJP walks the coarse rows in their layout's order (:func:`backward_is_big`
picks between them).

Semantics follow the JAX plain path (``interpolate.py:42-57``): exactly
three neighbours, ties to the lowest index.  The TPU kernel instead
averages every neighbour whose d² ties the 3rd (a 4th point may enter);
the two agree wherever the 3rd-nearest d² is unique.

The result is differentiable in the coarse features only (as the TPU
kernel's VJP): the backward adds ``w·g`` into the 3 neighbours' rows.  The
backward is differentiable once more (the adahessian step's Hessian-vector
product): it is linear in ``g``, and its VJP is the weighted sum at the
saved indices and weights, :func:`three_interpolation_gather` (the
``amc3d_three_interpolate_gather`` kernel of ``csrc/interpolate.cu``); a
third order raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import spatial
from ._autograd import last_order
from ._build import launch
from .group import group_points
from .knn import knn, knn_plain
from .spatial import check_order as _check_order, index_bits as _index_bits


def three_nn(unknown: torch.Tensor, known: torch.Tensor, plain: bool = False
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """unknown (B, N, 3), known (B, M, 3) → (dist (B, N, 3), idx (B, N, 3)),
    by :func:`knn` or, with ``plain``, by ``knn_plain`` on any device."""
    idx, d2 = (knn_plain if plain else knn)(known, unknown, 3)
    return torch.sqrt(torch.clamp_min(d2, 0.0)), idx


def three_interpolate(features: torch.Tensor, idx: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """features (B, M, C), idx/weight (B, N, 3) → (B, N, C), summed as
    ``(f0·w0 + f1·w1) + f2·w2``."""
    nb = group_points(features, idx)                      # (B, N, 3, C)
    w = weight[..., None]
    return (nb[:, :, 0] * w[:, :, 0] + nb[:, :, 1] * w[:, :, 1]) \
        + nb[:, :, 2] * w[:, :, 2]


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """The plain twins take CPU tensors; every other device a kernel."""
    return all(t.device.type == "cpu" for t in tensors)


def three_interpolation_weights(unknown_xyz: torch.Tensor,
                                known_xyz: torch.Tensor
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(idx (B, N1, 3) int32, weight (B, N1, 3)) of the plain path: the
    indices and weights the forward kernel keeps for the backward."""
    dist, idx = three_nn(unknown_xyz, known_xyz, plain=True)
    recip = torch.reciprocal(dist + 1e-8)
    norm = (recip[..., 0:1] + recip[..., 1:2]) + recip[..., 2:3]
    return idx, recip / norm


def _forward_plain(p1, p2, f2):
    idx, w = three_interpolation_weights(p1, p2)
    return three_interpolate(f2, idx, w), idx, w


def _check_layouts(p1, p2, cloud, query_cloud) -> None:
    """Raises unless ``cloud`` (when given) is the layout of the coarse
    points ``p2`` and ``query_cloud`` that of the fine points ``p1``."""
    if cloud is not None:
        spatial.check_layout(cloud, p2)
    if query_cloud is not None:
        spatial.check_layout(query_cloud, p1)


# Which forward kernel takes a call: the port's own rule, read on the card
# (PERF.md §6, the interpolation gate table of
# ``tools/profile_big_kernels.py --gates``: both kernels at every decoder
# stage of the S3DIS and ScanNet steps, of PointNet++'s
# eval forward, of two clouds of 22000 points and of room subclouds from
# 106496 to 311296 points).  The lane-a-point kernel of
# ``csrc/interpolate_big.cu`` took the stages of coarse width 64 to 256
# with at least 22000 fine points a call (kernel device time 0.129 against
# 0.313 ms at the S3DIS step's fp0, 0.224 against 0.765 at a 221184-point
# subcloud's, 0.104 against 0.157 at PointNet++'s fp0 (C 64), 0.070
# against 0.077 at the S3DIS step's fp1 of 4 x 6000 fine points, 0.065
# against 0.071 at 4 x 5500, 0.062 against 0.069 at one cloud's 22000; it
# lost at a uniform 311296-point cloud's fp1, 0.182 against 0.158, where
# the room-like one reads 0.110 against 0.255, and at PointNet++'s fp1 of
# 2 x 6000 points, 0.058 against 0.041), the listed scan of
# ``csrc/interpolate.cu`` every stage of 512 or 1024 (0.022 against 0.047
# ms at the S3DIS step's fp2): a warp writes its 32 rows, which wide rows
# and few points leave to too few warps.  Between 12000 and 22000 fine
# points a call nothing was read, and the listed scan keeps it.
BIG_FORWARD_CHANNELS = 256
BIG_FORWARD_POINTS = 22000


def forward_is_big(b: int, n1: int, n2: int, c: int) -> bool:
    """Whether a forward of ``b`` clouds of ``n1`` fine points from ``n2``
    coarse points of ``c`` channels goes to :func:`three_interpolation_big`
    (``c`` ≤ BIG_FORWARD_CHANNELS and ``b·n1`` ≥ BIG_FORWARD_POINTS; the
    card's table in PERF.md §6); else the listed scan takes it.  A
    PointNeXt decoder's fp0 and fp1 go there at every recipe's crop and
    room bucket, fp2 and fp3 (C = 512, 1024) never; ``n2`` does not
    enter."""
    return c <= BIG_FORWARD_CHANNELS and b * n1 >= BIG_FORWARD_POINTS


def _check_forward(p1, p2, f2) -> None:
    tensors = (p1, p2, f2)
    B, N1, _ = p1.shape
    _, N2, C = f2.shape
    if p1.shape != (B, N1, 3) or p2.shape != (B, N2, 3) or f2.shape[0] != B:
        raise ValueError("shapes must be (B,N1,3), (B,N2,3), (B,N2,C); got "
                         f"{[tuple(t.shape) for t in tensors]}")
    for t in tensors:
        if (t.dtype != torch.float32 or t.device.type != "cuda"
                or t.device != p1.device or not t.is_contiguous()):
            raise ValueError("interpolation kernel needs contiguous float32 "
                             f"tensors on one CUDA device, got {t.dtype} on "
                             f"{t.device} contiguous={t.is_contiguous()}")


def _forward_kernel(p1, p2, f2, keep: bool, cloud=None, query_cloud=None):
    """Launch the forward kernel :func:`forward_is_big` names; with ``keep``
    it also returns the (B, N1, 3) neighbour indices and weights for the
    backward.  Returns (out, idx, w, order, rows): ``order`` the fine points
    in the order the kernel took them, ``rows`` the coarse points in their
    layout's order (the backward kernels walk them so)."""
    _check_forward(p1, p2, f2)
    big = forward_is_big(p1.shape[0], p1.shape[1], f2.shape[1], f2.shape[2])
    return _launch_forward(big, p1, p2, f2, keep, cloud, query_cloud)


def _fine_order(p1, cloud, query_cloud):
    """(order (B, N1) int32, home (B, N1) int32 or None): the fine points in
    the order the kernels take them.  From the fine layout, the index bits
    of its sorted points (a view, 4 elements apart), each point's home
    chunk then found in the kernel; without it, from
    :func:`spatial.query_order` in the coarse layout's frame."""
    if query_cloud is not None:
        return _index_bits(query_cloud), None
    return spatial.query_order(p1, cloud)


def _launch_forward(big: bool, p1, p2, f2, keep, cloud, query_cloud,
                    visits=None):
    """One launch of the forward kernel (``big``: ``csrc/interpolate_big.cu``,
    else ``csrc/interpolate.cu``; both read the same arguments) over
    ``cloud`` and the fine points in ``query_cloud``'s order, each sorted
    here when not given."""
    B, N1, _ = p1.shape
    _, N2, C = f2.shape
    if cloud is None:
        cloud = spatial.sort_support(p2)
    order, home = _fine_order(p1, cloud, query_cloud)
    out = torch.empty(B, N1, C, dtype=torch.float32, device=p1.device)
    idx = w = None
    if keep:
        idx = torch.empty(B, N1, 3, dtype=torch.int32, device=p1.device)
        w = torch.empty(B, N1, 3, dtype=torch.float32, device=p1.device)
    # the frame's rows are views (a sort_stages frame holds lo and scale in
    # one row of 4), so the kernel takes their strides
    args = (cloud.packed.data_ptr(), cloud.boxes.data_ptr(),
            cloud.codes.data_ptr(), cloud.lo.data_ptr(), cloud.lo.stride(0),
            cloud.scale.data_ptr(), cloud.scale.stride(0), p1.data_ptr(),
            order.data_ptr(), order.stride(1),
            None if home is None else home.data_ptr(), f2.data_ptr(),
            out.data_ptr(), idx.data_ptr() if keep else None,
            w.data_ptr() if keep else None)
    stream = torch.cuda.current_stream(p1.device).cuda_stream
    if big:
        launch("amc3d_three_interpolate_big", *args,
               None if visits is None else visits.data_ptr(), B, N1, N2, C,
               stream)
        three_interpolation_big.launches += 1
    else:
        launch("amc3d_three_interpolate", *args, B, N1, N2, C, stream)
        three_interpolation.launches += 1
    return out, idx, w, order, _index_bits(cloud)


def three_interpolation_small(p1: torch.Tensor, p2: torch.Tensor,
                              f2: torch.Tensor, keep: bool = False,
                              cloud: Optional[spatial.SortedCloud] = None,
                              query_cloud: Optional[spatial.SortedCloud] = None):
    """(out, idx, w) as :func:`three_interpolation_big` returns them, through
    the listed scan of ``csrc/interpolate.cu`` over ``cloud`` (the layout of
    ``p2``), the fine points in the order of ``query_cloud`` (the layout of
    ``p1``); each is refused for another tensor and sorted here when not
    given.  Any shape; CUDA tensors only."""
    _check_layouts(p1, p2, cloud, query_cloud)
    _check_forward(p1, p2, f2)
    return _launch_forward(False, p1, p2, f2, keep, cloud, query_cloud)[:3]


def three_interpolation_big(p1: torch.Tensor, p2: torch.Tensor,
                            f2: torch.Tensor, keep: bool = False,
                            visits: Optional[torch.Tensor] = None,
                            cloud: Optional[spatial.SortedCloud] = None,
                            query_cloud: Optional[spatial.SortedCloud] = None):
    """p1 (B, N1, 3), p2 (B, N2, 3), f2 (B, N2, C) f32 → (out (B, N1, C),
    idx, w): the interpolation through the ``csrc/interpolate_big.cu``
    kernel, the same bits as ``csrc/interpolate.cu``: a lane a fine point,
    a block 256 of them along the fine layout's curve, the coarse chunks
    near them scanned from shared memory.  ``cloud`` (the layout of ``p2``)
    and ``query_cloud`` (that of ``p1``) are refused for another tensor and
    sorted here when not given.  With ``keep`` also the (B, N1, 3) indices
    and weights, else None.  ``visits``, a zeroed (1,) int64 CUDA tensor,
    gains the chunks the warps scanned.  A CPU tensor goes through the
    plain path."""
    _check_layouts(p1, p2, cloud, query_cloud)
    if _on_cpu(p1, p2, f2):
        out, idx, w = _forward_plain(p1, p2, f2)
        return (out, idx, w) if keep else (out, None, None)
    _check_forward(p1, p2, f2)
    return _launch_forward(True, p1, p2, f2, keep, cloud, query_cloud,
                           visits)[:3]


three_interpolation_big.launches = 0


def three_interpolation_backward_plain(grad: torch.Tensor, idx: torch.Tensor,
                                       weight: torch.Tensor, n2: int,
                                       order: Optional[torch.Tensor] = None,
                                       rows: Optional[torch.Tensor] = None
                                       ) -> torch.Tensor:
    """Plain VJP: grad (B, N1, C), idx/weight (B, N1, 3) → df2 (B, N2, C),
    ``df2[idx[i, k]] += weight[i, k]·grad[i]`` by ``index_add_``.  It takes
    :func:`three_interpolation_backward`'s arguments; ``order`` and ``rows``
    change nothing here."""
    B, N1, C = grad.shape
    rows = (idx.long() + n2 * torch.arange(B, device=idx.device)[:, None, None])
    contrib = weight[..., None] * grad[:, :, None, :]          # (B, N1, 3, C)
    df2 = torch.zeros(B * n2, C, dtype=grad.dtype, device=grad.device)
    df2.index_add_(0, rows.reshape(-1), contrib.reshape(-1, C))
    return df2.view(B, n2, C)


# Which VJP kernel takes a call: the port's own rule, read on the card
# (PERF.md §6, the interpolation gate table of
# ``tools/profile_big_kernels.py --gates``, kernel device time with the
# memsets).  The deterministic kernel of
# ``csrc/interpolate_bwd_big.cu`` won or tied at every stage of coarse width
# 128 or 256 with at least 22000 fine points a call (0.044 against 0.046 ms
# at the S3DIS step's fp0, 0.058 against 0.059 at the ScanNet step's, 0.098
# against 0.105 at a 221184-point subcloud's, 0.017 against 0.022 at the
# S3DIS step's fp1, 0.016 against 0.022 at 4 x 5500, 0.013 against 0.014 at
# one cloud's 22000), and the scatter of ``csrc/interpolate.cu`` (float
# atomics, so not the same bits run to run) won at 1024 everywhere, at 512
# at the steps (0.013 against 0.016 ms at the S3DIS step's fp2) and at 64
# (0.017 against 0.020 at PointNet++'s fp0 of 2 x 24000 points: a warp a
# row leaves half its lanes idle).  Below 22000 fine points a call the two
# lie within 2 us of each other either way (0.0099 against 0.0113 ms at
# PointNet++'s fp1 of 2 x 6000, 0.0117 against 0.0110 at one cloud's fp1
# of 5500), and the scatter keeps it.
BIG_BACKWARD_MIN_CHANNELS = 128
BIG_BACKWARD_CHANNELS = 256
BIG_BACKWARD_POINTS = 22000
_BWD_BIN = 64   # csrc/interpolate_bwd_big.cu::kBin: entries a row's bin holds


def backward_is_big(b: int, n1: int, n2: int, c: int) -> bool:
    """Whether a VJP of ``b`` clouds of ``n1`` fine points onto ``n2``
    coarse points of ``c`` channels goes to
    :func:`three_interpolation_backward_big` (BIG_BACKWARD_MIN_CHANNELS ≤
    ``c`` ≤ BIG_BACKWARD_CHANNELS and ``b·n1`` ≥ BIG_BACKWARD_POINTS; the
    card's table in PERF.md §6), so a PointNeXt train step's fp0 and
    fp1 give the same bits every run; else the scatter takes it.  ``n2``
    does not enter."""
    return (BIG_BACKWARD_MIN_CHANNELS <= c <= BIG_BACKWARD_CHANNELS
            and b * n1 >= BIG_BACKWARD_POINTS)


def _check_backward(grad, idx, weight):
    tensors = (grad, idx, weight)
    B, N1, C = grad.shape
    if idx.shape != (B, N1, 3) or weight.shape != (B, N1, 3):
        raise ValueError("shapes must be (B,N1,C), (B,N1,3), (B,N1,3); got "
                         f"{[tuple(t.shape) for t in tensors]}")
    for t, dtype in zip(tensors, (torch.float32, torch.int32, torch.float32)):
        if (t.dtype != dtype or t.device.type != "cuda"
                or t.device != grad.device or not t.is_contiguous()):
            raise ValueError("interpolation backward kernel needs contiguous "
                             f"CUDA tensors, got {t.dtype} on {t.device}")


def three_interpolation_backward(grad: torch.Tensor, idx: torch.Tensor,
                                 weight: torch.Tensor, n2: int,
                                 order: Optional[torch.Tensor] = None,
                                 rows: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """grad (B, N1, C) f32, idx (B, N1, 3) i32, weight (B, N1, 3) f32
    → df2 (B, N2, C).  A CUDA tensor goes through
    :func:`three_interpolation_backward_big` where :func:`backward_is_big`
    says so (``rows``: the coarse points in the order its warps take them)
    and through :func:`three_interpolation_backward_small` otherwise
    (``order``: the fine points in the order the forward took them); a CPU
    tensor through the plain twin."""
    if _on_cpu(grad, idx, weight):
        return three_interpolation_backward_plain(grad, idx, weight, n2)
    B, N1, C = grad.shape
    if backward_is_big(B, N1, n2, C):
        return three_interpolation_backward_big(grad, idx, weight, n2, rows)
    return three_interpolation_backward_small(grad, idx, weight, n2, order)


def three_interpolation_backward_small(grad: torch.Tensor, idx: torch.Tensor,
                                       weight: torch.Tensor, n2: int,
                                       order: Optional[torch.Tensor] = None
                                       ) -> torch.Tensor:
    """:func:`three_interpolation_backward` through the scatter kernel of
    ``csrc/interpolate.cu``: blocks of 64 fine points taken in ``order``
    ((B, N1) int32, each row a permutation of its fine points, as
    :func:`three_interpolation_small` took them; rows N1 elements apart, a
    stride within a row allowed) or, without it, in the caller's order, each
    block's coarse rows summed in shared memory and added into df2 once
    (float atomics across blocks; any shape, CUDA tensors only)."""
    _check_backward(grad, idx, weight)
    B, N1, C = grad.shape
    _check_order(order, B, N1, grad.device, "order")
    df2 = torch.empty(B, n2, C, dtype=torch.float32, device=grad.device)
    launch("amc3d_three_interpolate_backward", grad.data_ptr(),
           idx.data_ptr(), weight.data_ptr(),
           None if order is None else order.data_ptr(),
           1 if order is None else order.stride(1), df2.data_ptr(), B, N1,
           n2, C, torch.cuda.current_stream(grad.device).cuda_stream)
    three_interpolation_backward.launches += 1
    return df2


def three_interpolation_backward_big(grad: torch.Tensor, idx: torch.Tensor,
                                     weight: torch.Tensor, n2: int,
                                     rows: Optional[torch.Tensor] = None
                                     ) -> torch.Tensor:
    """:func:`three_interpolation_backward` through the deterministic kernel
    of ``csrc/interpolate_bwd_big.cu``: the triples inverted into per-row
    lists, then a warp a coarse row sums ``w·g`` over its list in ascending
    (query, slot) order and writes the row once, so the result is the same
    bits every run and a row no query selects is 0.  ``rows``: (B, N2)
    int32, each row a permutation of the coarse points (their layout's
    order: neighbouring rows share fine points), rows N2 elements apart, a
    stride within a row allowed; or None (index order).  Any shape; a CPU
    tensor goes through the plain twin, whose ``index_add_`` sums each row
    in the same order on the CPU."""
    if _on_cpu(grad, idx, weight):
        return three_interpolation_backward_plain(grad, idx, weight, n2)
    _check_backward(grad, idx, weight)
    B, N1, C = grad.shape
    _check_order(rows, B, n2, grad.device, "rows")
    df2 = torch.empty(B, n2, C, dtype=torch.float32, device=grad.device)
    # the counts and two cursors (to 16 bytes), the bins, and per entry its
    # place in the spill, the gather and the sorted lists (two ints each)
    # and its spilled row
    work = torch.empty(-(-(B * n2 + 2) // 4) * 4 + B * n2 * 2 * _BWD_BIN
                       + 7 * B * 3 * N1, dtype=torch.int32, device=grad.device)
    launch("amc3d_three_interpolate_backward_big", grad.data_ptr(),
           idx.data_ptr(), weight.data_ptr(),
           None if rows is None else rows.data_ptr(),
           1 if rows is None else rows.stride(1), work.data_ptr(),
           df2.data_ptr(), B, N1, n2, C,
           torch.cuda.current_stream(grad.device).cuda_stream)
    three_interpolation_backward_big.launches += 1
    return df2


def three_interpolation_gather_plain(u: torch.Tensor, idx: torch.Tensor,
                                     weight: torch.Tensor) -> torch.Tensor:
    """Plain twin of :func:`three_interpolation_gather`: u (B, N2, C), idx
    / weight (B, N1, 3) → (B, N1, C), summed as the forward's
    ``(u0·w0 + u1·w1) + u2·w2``."""
    return three_interpolate(u, idx, weight)


def three_interpolation_gather(u: torch.Tensor, idx: torch.Tensor,
                               weight: torch.Tensor) -> torch.Tensor:
    """The VJP of :func:`three_interpolation_backward` in its incoming
    gradient (the interpolation's second order): u (B, N2, C) f32, the
    cotangent of df2, and the forward's idx (B, N1, 3) int32 in [0, N2)
    and weight (B, N1, 3) f32 → (B, N1, C), each fine point's weighted sum
    of its three rows of u.  A CUDA tensor goes through the
    ``amc3d_three_interpolate_gather`` kernel of ``csrc/interpolate.cu``
    (the twin's rounding); a CPU tensor through the plain twin."""
    if _on_cpu(u, idx, weight):
        return three_interpolation_gather_plain(u, idx, weight)
    B, N2, C = u.shape
    N1 = idx.shape[1]
    if (u.dim() != 3 or idx.shape != (B, N1, 3)
            or weight.shape != (B, N1, 3)):
        raise ValueError("shapes must be (B,N2,C), (B,N1,3), (B,N1,3); got "
                         f"{[tuple(t.shape) for t in (u, idx, weight)]}")
    for t, dtype in zip((u, idx, weight),
                        (torch.float32, torch.int32, torch.float32)):
        if (t.dtype != dtype or t.device.type != "cuda"
                or t.device != u.device or not t.is_contiguous()):
            raise ValueError("interpolation gather kernel needs contiguous "
                             f"CUDA tensors, got {t.dtype} on {t.device}")
    out = torch.empty(B, N1, C, dtype=torch.float32, device=u.device)
    launch("amc3d_three_interpolate_gather", u.data_ptr(), idx.data_ptr(),
           weight.data_ptr(), out.data_ptr(), B, N1, N2, C,
           torch.cuda.current_stream(u.device).cuda_stream)
    three_interpolation_gather.launches += 1
    return out


class _ThreeInterpolationBackward(torch.autograd.Function):
    """The VJP of the interpolation as a function of its incoming gradient
    (a kernel, or the plain twin with ``plain``), differentiable once: its
    VJP is :func:`three_interpolation_gather` (or its twin) at the saved
    indices and weights."""

    @staticmethod
    def forward(ctx, grad, idx, w, n2: int, order, rows, plain: bool):
        ctx.save_for_backward(idx, w)
        ctx.plain = plain
        if plain:
            return three_interpolation_backward_plain(grad, idx, w, n2)
        return three_interpolation_backward(grad, idx, w, n2, order, rows)

    @staticmethod
    @last_order("the interpolation's second order")
    def backward(ctx, u):
        idx, w = ctx.saved_tensors
        gather = (three_interpolation_gather_plain if ctx.plain
                  else three_interpolation_gather)
        return (gather(u.contiguous(), idx, w),) + (None,) * 6


class _ThreeInterpolation(torch.autograd.Function):
    """Forward by the kernel (or the plain twin), backward by the backward
    kernel (or its plain twin) in the orders the forward took the fine
    points and the coarse layout holds its points; gradients reach the
    features only."""

    @staticmethod
    def forward(ctx, p1, p2, f2, plain: bool, cloud, query_cloud):
        order = rows = None
        if plain:
            out, idx, w = _forward_plain(p1, p2, f2)
        else:
            out, idx, w, order, rows = _forward_kernel(p1, p2, f2, True, cloud,
                                                       query_cloud)
        ctx.save_for_backward(idx, w, order, rows)
        ctx.n2, ctx.plain = f2.shape[1], plain
        return out

    @staticmethod
    def backward(ctx, grad):
        idx, w, order, rows = ctx.saved_tensors
        df2 = _ThreeInterpolationBackward.apply(grad.contiguous(), idx, w,
                                                ctx.n2, order, rows, ctx.plain)
        return None, None, df2, None, None, None


def _needs_grad(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


def three_interpolation_plain(unknown_xyz: torch.Tensor, known_xyz: torch.Tensor,
                              known_feat: torch.Tensor,
                              cloud: Optional[spatial.SortedCloud] = None,
                              query_cloud: Optional[spatial.SortedCloud] = None
                              ) -> torch.Tensor:
    """Plain PyTorch interpolation of coarse features onto fine points,
    with the plain VJP when the features need a gradient.  It takes
    :func:`three_interpolation`'s arguments; the layouts change nothing
    here."""
    if _needs_grad(known_feat):
        return _ThreeInterpolation.apply(unknown_xyz, known_xyz, known_feat,
                                         True, None, None)
    return _forward_plain(unknown_xyz, known_xyz, known_feat)[0]


def three_interpolation(unknown_xyz: torch.Tensor, known_xyz: torch.Tensor,
                        known_feat: torch.Tensor,
                        cloud: Optional[spatial.SortedCloud] = None,
                        query_cloud: Optional[spatial.SortedCloud] = None
                        ) -> torch.Tensor:
    """unknown (B, N1, 3), known (B, N2, 3), features (B, N2, C), all f32
    → (B, N1, C).

    A CUDA tensor goes through one forward kernel (selection and weighted
    sum in one pass, nothing materialised): the lane-a-point kernel of
    :func:`three_interpolation_big` where :func:`forward_is_big` says so,
    else the listed scan of :func:`three_interpolation_small`, both over
    ``cloud`` (the layout of ``known_xyz``), the fine points in the order of
    ``query_cloud`` (the layout of ``unknown_xyz``), each refused for
    another tensor, on the CPU too, and sorted here when not given.  When
    the features need a gradient the kernel also keeps the indices and
    weights, and :func:`three_interpolation_backward` carries the gradient
    to the features.  A CPU tensor goes through
    :func:`three_interpolation_plain`."""
    _check_layouts(unknown_xyz, known_xyz, cloud, query_cloud)
    tensors = (unknown_xyz, known_xyz, known_feat)
    if _on_cpu(*tensors):
        return three_interpolation_plain(*tensors)
    if _needs_grad(known_feat):
        return _ThreeInterpolation.apply(unknown_xyz, known_xyz, known_feat,
                                         False, cloud, query_cloud)
    return _forward_kernel(unknown_xyz, known_xyz, known_feat, False, cloud,
                           query_cloud)[0]


three_interpolation.launches = 0
three_interpolation_backward.launches = 0
three_interpolation_backward_big.launches = 0
three_interpolation_gather.launches = 0
