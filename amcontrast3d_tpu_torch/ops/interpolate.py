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

The forward kernel is a listed scan over the coarse cloud's Morton-sorted
layout (``ops/spatial.py``), the fine points taken along their own curve;
a caller that holds both stage clouds' layouts (the decoder: the forward
sorts its stage clouds once) hands them in (``cloud=`` the coarse one,
``query_cloud=`` the fine one), else the wrapper sorts.  The backward
walks the fine points in the order the forward took them, so the
neighbours of a block's points share coarse rows.

Semantics follow the JAX plain path (``interpolate.py:42-57``): exactly
three neighbours, ties to the lowest index.  The TPU kernel instead
averages every neighbour whose d² ties the 3rd (a 4th point may enter);
the two agree wherever the 3rd-nearest d² is unique.

The result is differentiable in the coarse features only (as the TPU
kernel's VJP): the backward adds ``w·g`` into the 3 neighbours' rows.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import spatial
from ._build import launch
from .group import group_points
from .knn import knn, knn_plain


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


# The JAX package keeps the forward's coarse buffer [f | 1 | x y z] resident
# while it fits this budget, and sends larger ones to its three kernels for
# large supports (``interpolate_pallas.py::_interp_fwd_impl``); the port
# keeps the same rule.  Its chunk of coarse rows (``CS``) pads the buffer.
_SUP_BUDGET = 48 * 1024 * 1024
_SUP_CHUNK = 512


def forward_is_big(n2: int, c: int) -> bool:
    """Whether a forward from ``n2`` coarse points of ``c`` channels goes to
    the chunk-pruned kernel: the coarse buffer, padded to 128-float rows and
    to a multiple of the chunk, exceeds 48 MiB.  The decoder's fp0 does from
    the 221184 bucket up ((55296, 128) does, (49152, 128) not), fp1 from
    the 622592 bucket ((38912, 256) does)."""
    n_pad = (-(-n2 // _SUP_CHUNK) * _SUP_CHUNK if n2 > _SUP_CHUNK
             else -(-n2 // 256) * 256)
    lanes = -(-(c + 4) // 128) * 128
    return n_pad * lanes * 4 > _SUP_BUDGET


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
    """Launch the forward kernel (:func:`three_interpolation_big` where
    :func:`forward_is_big` says so, else the listed scan of
    ``csrc/interpolate.cu``); with ``keep`` it also returns the (B, N1, 3)
    neighbour indices and weights for the backward.  Returns (out, idx, w,
    order): ``order`` the fine points in the order the listed scan took
    them (None after the big kernel)."""
    _check_forward(p1, p2, f2)
    if forward_is_big(f2.shape[1], f2.shape[2]):
        return (*three_interpolation_big(p1, p2, f2, keep), None)
    return _listed(p1, p2, f2, keep, cloud, query_cloud)


def _fine_order(p1, cloud, query_cloud):
    """(order (B, N1) int32, home (B, N1) int32 or None): the fine points in
    the order the kernels take them.  From the fine layout, the index bits
    of its sorted points (a view, 4 elements apart), each point's home
    chunk then found in the kernel; without it, from
    :func:`spatial.query_order` in the coarse layout's frame."""
    if query_cloud is not None:
        return query_cloud.packed.view(torch.int32)[..., 3], None
    return spatial.query_order(p1, cloud)


def _listed(p1, p2, f2, keep, cloud, query_cloud):
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
    launch("amc3d_three_interpolate", cloud.packed.data_ptr(),
           cloud.boxes.data_ptr(), cloud.codes.data_ptr(),
           cloud.lo.data_ptr(), cloud.lo.stride(0), cloud.scale.data_ptr(),
           cloud.scale.stride(0), p1.data_ptr(), order.data_ptr(),
           order.stride(1), None if home is None else home.data_ptr(),
           f2.data_ptr(), out.data_ptr(), idx.data_ptr() if keep else None,
           w.data_ptr() if keep else None, B, N1, N2, C,
           torch.cuda.current_stream(p1.device).cuda_stream)
    three_interpolation.launches += 1
    return out, idx, w, order


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
    return _listed(p1, p2, f2, keep, cloud, query_cloud)[:3]


def three_interpolation_big(p1: torch.Tensor, p2: torch.Tensor,
                            f2: torch.Tensor, keep: bool = False,
                            visits: Optional[torch.Tensor] = None):
    """p1 (B, N1, 3), p2 (B, N2, 3), f2 (B, N2, C) f32 → (out (B, N1, C),
    idx, w): the interpolation through the ``csrc/interpolate_big.cu``
    kernel, the same bits as ``csrc/interpolate.cu``.  The coarse points are
    sorted along a Morton curve into 64-point chunks (``ops/spatial.py``)
    and a fine point scans only the chunks whose box can hold one of its 3
    nearest.  With ``keep`` also the (B, N1, 3) indices and weights, else
    None.  ``visits``, a zeroed (1,) int64 CUDA tensor, gains the chunks
    scanned.  A CPU tensor goes through the plain path."""
    if _on_cpu(p1, p2, f2):
        out, idx, w = _forward_plain(p1, p2, f2)
        return (out, idx, w) if keep else (out, None, None)
    _check_forward(p1, p2, f2)
    B, N1, _ = p1.shape
    _, N2, C = f2.shape
    cloud = spatial.sort_support(p2)
    order, home = spatial.query_order(p1, cloud)
    out = torch.empty(B, N1, C, dtype=torch.float32, device=p1.device)
    idx = w = None
    if keep:
        idx = torch.empty(B, N1, 3, dtype=torch.int32, device=p1.device)
        w = torch.empty(B, N1, 3, dtype=torch.float32, device=p1.device)
    launch("amc3d_three_interpolate_big", cloud.packed.data_ptr(),
           cloud.boxes.data_ptr(), p1.data_ptr(), order.data_ptr(),
           home.data_ptr(), f2.data_ptr(), out.data_ptr(),
           idx.data_ptr() if keep else None, w.data_ptr() if keep else None,
           None if visits is None else visits.data_ptr(), B, N1, N2, C,
           torch.cuda.current_stream(p1.device).cuda_stream)
    three_interpolation_big.launches += 1
    return out, idx, w


three_interpolation_big.launches = 0


def three_interpolation_backward_plain(grad: torch.Tensor, idx: torch.Tensor,
                                       weight: torch.Tensor, n2: int,
                                       order: Optional[torch.Tensor] = None
                                       ) -> torch.Tensor:
    """Plain VJP: grad (B, N1, C), idx/weight (B, N1, 3) → df2 (B, N2, C),
    ``df2[idx[i, k]] += weight[i, k]·grad[i]`` by ``index_add_``.  It takes
    :func:`three_interpolation_backward`'s arguments; ``order`` changes
    nothing here."""
    B, N1, C = grad.shape
    rows = (idx.long() + n2 * torch.arange(B, device=idx.device)[:, None, None])
    contrib = weight[..., None] * grad[:, :, None, :]          # (B, N1, 3, C)
    df2 = torch.zeros(B * n2, C, dtype=grad.dtype, device=grad.device)
    df2.index_add_(0, rows.reshape(-1), contrib.reshape(-1, C))
    return df2.view(B, n2, C)


# The JAX package keeps the backward's query buffer [g | x y z thr wsum]
# resident while it fits this budget, and sends larger ones to its
# query-chunked kernel (``interpolate_pallas.py::_interp_bwd``); the port
# keeps the same rule.  The budget is that package's: where the two kernels
# of this card cross over is measured by ``chip_smoke.py`` and not acted on.
_QBUF_BUDGET = 32 * 1024 * 1024
_TQ = 256


def backward_is_big(n1: int, c: int) -> bool:
    """Whether a backward over ``n1`` fine points and ``c`` channels goes to
    the support-owned kernel: the query buffer, padded to 128-float rows and
    a multiple of the query tile, exceeds 32 MiB.  (64000, 128) does; the
    S3DIS recipe's largest, (24000, 128), does not."""
    tq = min(_TQ, -(-n1 // 8) * 8)
    lanes = -(-(c + 5) // 128) * 128
    return -(-n1 // tq) * tq * lanes * 4 > _QBUF_BUDGET


def _check_backward(grad, idx, weight, order=None):
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
    if order is not None and (
            order.shape != (B, N1) or order.dtype != torch.int32
            or order.device != grad.device or order.stride(1) < 1
            or (B > 1 and order.stride(0) != N1 * order.stride(1))):
        raise ValueError(f"order must be a ({B}, {N1}) int32 tensor on "
                         f"{grad.device} with rows N1 elements apart, got "
                         f"{tuple(order.shape)} {order.dtype} on {order.device} "
                         f"strides {order.stride()}")


def three_interpolation_backward(grad: torch.Tensor, idx: torch.Tensor,
                                 weight: torch.Tensor, n2: int,
                                 order: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """grad (B, N1, C) f32, idx (B, N1, 3) i32, weight (B, N1, 3) f32
    → df2 (B, N2, C).  A CUDA tensor goes through
    :func:`three_interpolation_backward_big` where :func:`backward_is_big`
    says so and through :func:`three_interpolation_backward_small`
    otherwise (``order``: the fine points in the order the forward took
    them); a CPU tensor through the plain twin."""
    if _on_cpu(grad, idx, weight):
        return three_interpolation_backward_plain(grad, idx, weight, n2)
    if backward_is_big(grad.shape[1], grad.shape[2]):
        return three_interpolation_backward_big(grad, idx, weight, n2)
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
    _check_backward(grad, idx, weight, order)
    B, N1, C = grad.shape
    df2 = torch.empty(B, n2, C, dtype=torch.float32, device=grad.device)
    launch("amc3d_three_interpolate_backward", grad.data_ptr(),
           idx.data_ptr(), weight.data_ptr(),
           None if order is None else order.data_ptr(),
           1 if order is None else order.stride(1), df2.data_ptr(), B, N1,
           n2, C, torch.cuda.current_stream(grad.device).cuda_stream)
    three_interpolation_backward.launches += 1
    return df2


def three_interpolation_backward_big(grad: torch.Tensor, idx: torch.Tensor,
                                     weight: torch.Tensor,
                                     n2: int) -> torch.Tensor:
    """:func:`three_interpolation_backward` through the support-owned kernel
    of ``csrc/interpolate_bwd_big.cu``: a block owns a chunk of coarse rows,
    walks the (idx, weight) triples in query order and sums its hits in that
    order, so the result is the same bits every run.  Any shape with
    C ≤ 11264; a CPU tensor goes through the plain twin."""
    if _on_cpu(grad, idx, weight):
        return three_interpolation_backward_plain(grad, idx, weight, n2)
    _check_backward(grad, idx, weight)
    B, N1, C = grad.shape
    df2 = torch.empty(B, n2, C, dtype=torch.float32, device=grad.device)
    launch("amc3d_three_interpolate_backward_big", grad.data_ptr(),
           idx.data_ptr(), weight.data_ptr(), df2.data_ptr(), B, N1, n2, C,
           torch.cuda.current_stream(grad.device).cuda_stream)
    three_interpolation_backward_big.launches += 1
    return df2


class _ThreeInterpolation(torch.autograd.Function):
    """Forward by the kernel (or the plain twin), backward by the backward
    kernel (or its plain twin) in the order the forward took the fine
    points; gradients reach the features only."""

    @staticmethod
    def forward(ctx, p1, p2, f2, plain: bool, cloud, query_cloud):
        order = None
        if plain:
            out, idx, w = _forward_plain(p1, p2, f2)
        else:
            out, idx, w, order = _forward_kernel(p1, p2, f2, True, cloud,
                                                 query_cloud)
        ctx.save_for_backward(idx, w, order)
        ctx.n2, ctx.plain = f2.shape[1], plain
        return out

    @staticmethod
    def backward(ctx, grad):
        idx, w, order = ctx.saved_tensors
        bwd = (three_interpolation_backward_plain if ctx.plain
               else three_interpolation_backward)
        return (None, None, bwd(grad.contiguous(), idx, w, ctx.n2, order),
                None, None, None)


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

    A CUDA tensor goes through the listed scan of ``csrc/interpolate.cu``
    (selection and weighted sum in one pass, nothing materialised) over
    ``cloud`` (the layout of ``known_xyz``), the fine points in the order of
    ``query_cloud`` (the layout of ``unknown_xyz``), each refused for
    another tensor, on the CPU too, and sorted here when not given; or
    through :func:`three_interpolation_big` where :func:`forward_is_big`
    says so.  When the features need a gradient the kernel also keeps the
    indices and weights, and the backward kernel scatters into the
    features.  A CPU tensor goes through :func:`three_interpolation_plain`."""
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
