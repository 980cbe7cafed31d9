"""The CrossMask feature of the masked refinement (AMContrast3D++).

↔ ``amcontrast3d_tpu/ops/contrast_pallas.py::dual_masks_cross`` and its TPU
kernels ``_refine_fwd_kernel`` and ``_refine_bwd_kernel``, ported as
``csrc/refine.cu``.  For every point, over the ``k − 1`` slots of its exact
kNN among its own cloud with the first slot dropped
(``models/refine.py:52-69`` of the JAX package):

* ``MIN``      — the feature row of the slot with the least ambiguity,
  ties to the first slot in ascending-distance order (``argmin``);
* ``MIN_ALL0`` — the sum of the rows whose ambiguity is ≤ 0, over k − 1.

The TPU kernel admits a superset at d² ties and averages argmin ties; the
port is exact and equals it wherever the minimum is unique.  The result is
differentiable in the features only: the backward scatters ``scale·g`` into
the selected rows (``sel``: the chosen index (B, N, 1) for MIN, the member
indices (B, N, k − 1) with −1 where a > 0 for MIN_ALL0).  The backward
is differentiable once more (the adahessian step's Hessian-vector
product): it is linear in ``g``, and its VJP gathers the selected rows,
:func:`refine_cross_gather` (the ``amc3d_refine_cross_gather`` kernel of
``csrc/refine.cu``); a third order raises.

The forward kernel's kNN is ``csrc/knn.cu``'s listed scan over the stage
cloud's Morton-sorted layout (``spatial.SortedCloud``): a caller that holds
it hands it in (``cloud=``, the decoder the layouts the encoder sorted),
else the wrapper sorts.  The plain twins accept a layout and ignore it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import spatial
from ._autograd import last_order
from ._build import launch
from .group import gather_points, group_points
from .interpolate import _needs_grad, _on_cpu
from .knn import KNN_MAX_K, knn_plain

_FUSIONS = {"MIN": True, "MIN_ALL0": False}


def _fusion_min(fusion: str) -> bool:
    if fusion not in _FUSIONS:
        raise ValueError(f"unknown fusion {fusion}")
    return _FUSIONS[fusion]


def _check(p, f, a, k: int) -> None:
    B, N, _ = f.shape
    if p.shape != (B, N, 3) or a.shape != (B, N):
        raise ValueError("shapes must be (B,N,3), (B,N,C), (B,N); got "
                         f"{[tuple(t.shape) for t in (p, f, a)]}")
    if k < 2:
        raise ValueError(f"k counts the point itself and must be ≥ 2, got {k}")


def refine_cross_plain(p: torch.Tensor, f: torch.Tensor, a: torch.Tensor,
                       k: int, fusion: str,
                       cloud: Optional[spatial.SortedCloud] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch CrossMask feature: (cross (B, N, C), sel) by the exact
    kNN, an ambiguity gather and a feature gather (a layout, ``cloud``,
    changes nothing here)."""
    _check(p, f, a, k)
    fusion_min = _fusion_min(fusion)
    idx = knn_plain(p, p, k)[0][..., 1:]                        # (B, N, K)
    na = group_points(a[..., None], idx)[..., 0]
    if fusion_min:
        good = na.argmin(-1, keepdim=True)
        sel = torch.gather(idx, -1, good)                       # (B, N, 1)
        return gather_points(f, sel[..., 0]), sel
    zero = na <= 0
    cross = (group_points(f, idx) * zero[..., None].to(f.dtype)).sum(2) \
        / float(k - 1)
    return cross, torch.where(zero, idx, -1)


def refine_cross(p: torch.Tensor, f: torch.Tensor, a: torch.Tensor, k: int,
                 fusion: str, keep: bool = False,
                 cloud: Optional[spatial.SortedCloud] = None
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """p (B, N, 3), f (B, N, C), a (B, N), all f32; k counts the point
    itself → (cross (B, N, C), sel int32 or None).  No gradient:
    :func:`dual_masks_cross` is the differentiable entry.

    A CUDA tensor goes through the forward kernel of ``csrc/refine.cu``
    (2 ≤ k ≤ 128) over ``cloud``, the layout of ``p`` (refused for another
    tensor; sorted here when not given), and writes ``sel`` only with
    ``keep``; a CPU tensor goes through :func:`refine_cross_plain`."""
    if cloud is not None:
        spatial.check_layout(cloud, p)
    tensors = (p, f, a)
    if _on_cpu(*tensors):
        return refine_cross_plain(p, f, a, k, fusion)
    _check(p, f, a, k)
    fusion_min = _fusion_min(fusion)
    for t in tensors:
        if (t.dtype != torch.float32 or t.device.type != "cuda"
                or t.device != f.device or not t.is_contiguous()):
            raise ValueError("refine kernel needs contiguous float32 tensors "
                             f"on one CUDA device, got {t.dtype} on "
                             f"{t.device} contiguous={t.is_contiguous()}")
    if k > KNN_MAX_K:
        raise ValueError(f"refine kernel takes k ≤ {KNN_MAX_K}, got {k}")
    B, N, C = f.shape
    if cloud is None:
        cloud = spatial.sort_support(p)
    out = torch.empty(B, N, C, dtype=torch.float32, device=f.device)
    sel = None
    if keep:
        sel = torch.empty(B, N, 1 if fusion_min else k - 1, dtype=torch.int32,
                          device=f.device)
    launch("amc3d_refine_cross", cloud.packed.data_ptr(),
           cloud.boxes.data_ptr(), f.data_ptr(), a.data_ptr(), out.data_ptr(),
           sel.data_ptr() if keep else None, B, N, C, k, int(fusion_min),
           torch.cuda.current_stream(f.device).cuda_stream)
    refine_cross.launches += 1
    return out, sel


def refine_cross_backward_plain(grad: torch.Tensor, sel: torch.Tensor,
                                scale: float) -> torch.Tensor:
    """Plain VJP: grad (B, N, C), sel (B, N, S) → df (B, N, C),
    ``df[sel[i, t]] += scale·grad[i]`` for ``sel ≥ 0`` by ``index_add_``."""
    B, N, C = grad.shape
    S = sel.shape[-1]
    rows = sel.long() + N * torch.arange(B, device=sel.device)[:, None, None]
    valid = (sel >= 0).reshape(-1)
    src = torch.arange(B * N, device=sel.device).repeat_interleave(S)[valid]
    df = torch.zeros(B * N, C, dtype=grad.dtype, device=grad.device)
    df.index_add_(0, rows.reshape(-1)[valid],
                  (grad * scale).reshape(B * N, C)[src])
    return df.view(B, N, C)


def _check_backward(grad: torch.Tensor, sel: torch.Tensor) -> None:
    """Raises unless the backward kernel takes (grad, sel): (B, N, C) and
    (B, N, S) with B·N ≥ 1, C ≥ 1 and 1 ≤ S ≤ 127 (the forward's selection:
    1 for MIN, k − 1 ≤ 127 for MIN_ALL0)."""
    if grad.dim() != 3 or sel.dim() != 3 or sel.shape[:2] != grad.shape[:2]:
        raise ValueError("shapes must be (B,N,C), (B,N,S); got "
                         f"{tuple(grad.shape)}, {tuple(sel.shape)}")
    B, N, C = grad.shape
    if B * N < 1 or C < 1 or not 1 <= sel.shape[-1] <= KNN_MAX_K - 1:
        raise ValueError(f"refine backward kernel takes B·N ≥ 1, C ≥ 1 and "
                         f"1 ≤ S ≤ {KNN_MAX_K - 1} slots, got "
                         f"{tuple(grad.shape)}, {tuple(sel.shape)}")


def _check_cuda_tensors(grad: torch.Tensor, sel: torch.Tensor) -> None:
    dev = grad.device
    if (dev.type != "cuda" or sel.device != dev or grad.dtype != torch.float32
            or sel.dtype != torch.int32 or not grad.is_contiguous()
            or not sel.is_contiguous()):
        raise ValueError("refine backward kernel needs contiguous CUDA "
                         f"tensors, float32 grad and int32 sel, got "
                         f"{grad.dtype} on {dev}, {sel.dtype} on {sel.device}")


def refine_cross_backward(grad: torch.Tensor, sel: torch.Tensor,
                          scale: float) -> torch.Tensor:
    """grad (B, N, C) f32, sel (B, N, S) int32 → df (B, N, C).  A CUDA
    tensor goes through the backward kernel of ``csrc/refine.cu`` (a row a
    group of lanes, vector reductions where C % 4 == 0; its C entry point
    zeroes df on the stream ahead of it); a CPU tensor through the plain
    twin."""
    if _on_cpu(grad, sel):
        return refine_cross_backward_plain(grad, sel, scale)
    _check_backward(grad, sel)
    _check_cuda_tensors(grad, sel)
    B, N, C = grad.shape
    df = torch.empty_like(grad)
    launch("amc3d_refine_cross_backward", grad.data_ptr(), sel.data_ptr(),
           df.data_ptr(), B, N, C, sel.shape[-1], float(scale),
           torch.cuda.current_stream(grad.device).cuda_stream)
    refine_cross_backward.launches += 1
    return df


def refine_cross_gather_plain(u: torch.Tensor, sel: torch.Tensor,
                              scale: float) -> torch.Tensor:
    """Plain twin of :func:`refine_cross_gather`: the selected rows summed
    slot by slot, in slot order, then scaled."""
    acc = torch.zeros_like(u)
    for t in range(sel.shape[-1]):
        col = sel[..., t]
        rows = gather_points(u, col.clamp_min(0))
        acc = acc + torch.where((col >= 0)[..., None], rows, 0.0)
    return acc * scale


def refine_cross_gather(u: torch.Tensor, sel: torch.Tensor,
                        scale: float) -> torch.Tensor:
    """The VJP of :func:`refine_cross_backward` in its incoming gradient
    (the CrossMask's second order): u (B, N, C) f32, the cotangent of df,
    sel (B, N, S) int32 → (B, N, C), ``scale · Σ_t u[sel[i, t]]`` over the
    slots with ``sel ≥ 0``.  A CUDA tensor goes through the
    ``amc3d_refine_cross_gather`` kernel of ``csrc/refine.cu`` (the twin's
    order and rounding); a CPU tensor through the plain twin."""
    if _on_cpu(u, sel):
        return refine_cross_gather_plain(u, sel, scale)
    _check_backward(u, sel)
    _check_cuda_tensors(u, sel)
    B, N, C = u.shape
    out = torch.empty_like(u)
    launch("amc3d_refine_cross_gather", u.data_ptr(), sel.data_ptr(),
           out.data_ptr(), B, N, C, sel.shape[-1], float(scale),
           torch.cuda.current_stream(u.device).cuda_stream)
    refine_cross_gather.launches += 1
    return out


class _DualMasksCrossBackward(torch.autograd.Function):
    """The CrossMask's VJP as a function of its incoming gradient (the
    kernel, or the plain twin with ``plain``), differentiable once: its VJP
    is :func:`refine_cross_gather` (or its twin) at the saved selection."""

    @staticmethod
    def forward(ctx, grad, sel, scale: float, plain: bool):
        ctx.save_for_backward(sel)
        ctx.scale, ctx.plain = scale, plain
        bwd = refine_cross_backward_plain if plain else refine_cross_backward
        return bwd(grad, sel, scale)

    @staticmethod
    @last_order("the CrossMask's second order")
    def backward(ctx, u):
        sel, = ctx.saved_tensors
        gather = refine_cross_gather_plain if ctx.plain else refine_cross_gather
        return gather(u.contiguous(), sel, ctx.scale), None, None, None


class _DualMasksCross(torch.autograd.Function):
    """Forward and VJP by the kernels, or by the plain twins (``plain``);
    gradients reach the features only."""

    @staticmethod
    def forward(ctx, p, f, a, k, fusion, plain, cloud):
        if plain:
            cross, sel = refine_cross_plain(p, f, a, k, fusion)
        else:
            cross, sel = refine_cross(p, f, a, k, fusion, keep=True,
                                      cloud=cloud)
        ctx.save_for_backward(sel)
        ctx.scale = 1.0 if _fusion_min(fusion) else 1.0 / (k - 1)
        ctx.plain = plain
        return cross

    @staticmethod
    def backward(ctx, grad):
        sel, = ctx.saved_tensors
        df = _DualMasksCrossBackward.apply(grad.contiguous(), sel, ctx.scale,
                                           ctx.plain)
        return (None, df) + (None,) * 5


def dual_masks_cross_plain(p: torch.Tensor, f: torch.Tensor, a: torch.Tensor,
                           k: int, fusion: str,
                           cloud: Optional[spatial.SortedCloud] = None
                           ) -> torch.Tensor:
    """:func:`dual_masks_cross` by the plain twins on any device (a layout,
    ``cloud``, changes nothing here)."""
    if _needs_grad(f):
        return _DualMasksCross.apply(p, f, a, k, fusion, True, None)
    return refine_cross_plain(p, f, a, k, fusion)[0]


def dual_masks_cross(p: torch.Tensor, f: torch.Tensor, a: torch.Tensor, k: int,
                     fusion: str, cloud: Optional[spatial.SortedCloud] = None
                     ) -> torch.Tensor:
    """p (B, N, 3), f (B, N, C), a (B, N) ambiguity, all f32; ``k`` counts
    the point itself (the kNN(p, p, k) layout, first slot dropped)
    → CrossMask feature (B, N, C), differentiable in ``f`` only.

    CUDA tensors run the kernels of ``csrc/refine.cu`` over ``cloud``, the
    layout of ``p`` (refused for another tensor; sorted in the forward when
    not given; nothing but the output and, when a gradient is needed, the
    selection is written); CPU tensors the plain twins."""
    if cloud is not None:
        spatial.check_layout(cloud, p)
    if _on_cpu(p, f, a):
        return dual_masks_cross_plain(p, f, a, k, fusion)
    if _needs_grad(f):
        return _DualMasksCross.apply(p, f, a, k, fusion, False, cloud)
    return refine_cross(p, f, a, k, fusion, cloud=cloud)[0]


refine_cross.launches = 0
refine_cross_backward.launches = 0
refine_cross_gather.launches = 0
