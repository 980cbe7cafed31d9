"""3-NN inverse-distance feature interpolation (decoder upsampling).

↔ ``amcontrast3d_tpu/ops/interpolate.py`` (``three_nn``,
``three_interpolate``, ``three_interpolation``) and the fused TPU kernels
``ops/interpolate_pallas.py::_interp_kernel`` and its VJP
``::_interp_bwd_kernel``, ported as ``csrc/interpolate.cu``.  Weights are
``1/(√d² + 1e-8)``, normalised over the 3 nearest coarse points.

Semantics follow the JAX plain path (``interpolate.py:42-57``): exactly
three neighbours, ties to the lowest index.  The TPU kernel instead
averages every neighbour whose d² ties the 3rd (a 4th point may enter);
the two agree wherever the 3rd-nearest d² is unique.

The result is differentiable in the coarse features only (as the TPU
kernel's VJP): the backward scatters ``w·g`` into the 3 neighbours' rows.
"""
from __future__ import annotations

from typing import Tuple

import torch

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


def _forward_kernel(p1, p2, f2, keep: bool):
    """Launch the forward kernel; with ``keep`` it also returns the
    (B, N1, 3) neighbour indices and weights for the backward."""
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
    out = torch.empty(B, N1, C, dtype=torch.float32, device=p1.device)
    idx = w = None
    if keep:
        idx = torch.empty(B, N1, 3, dtype=torch.int32, device=p1.device)
        w = torch.empty(B, N1, 3, dtype=torch.float32, device=p1.device)
    launch("amc3d_three_interpolate", p1.data_ptr(), p2.data_ptr(),
           f2.data_ptr(), out.data_ptr(), idx.data_ptr() if keep else None,
           w.data_ptr() if keep else None, B, N1, N2, C,
           torch.cuda.current_stream(p1.device).cuda_stream)
    three_interpolation.launches += 1
    return out, idx, w


def three_interpolation_backward_plain(grad: torch.Tensor, idx: torch.Tensor,
                                       weight: torch.Tensor,
                                       n2: int) -> torch.Tensor:
    """Plain VJP: grad (B, N1, C), idx/weight (B, N1, 3) → df2 (B, N2, C),
    ``df2[idx[i, k]] += weight[i, k]·grad[i]`` by ``index_add_``."""
    B, N1, C = grad.shape
    rows = (idx.long() + n2 * torch.arange(B, device=idx.device)[:, None, None])
    contrib = weight[..., None] * grad[:, :, None, :]          # (B, N1, 3, C)
    df2 = torch.zeros(B * n2, C, dtype=grad.dtype, device=grad.device)
    df2.index_add_(0, rows.reshape(-1), contrib.reshape(-1, C))
    return df2.view(B, n2, C)


def three_interpolation_backward(grad: torch.Tensor, idx: torch.Tensor,
                                 weight: torch.Tensor, n2: int) -> torch.Tensor:
    """grad (B, N1, C) f32, idx (B, N1, 3) i32, weight (B, N1, 3) f32
    → df2 (B, N2, C).  A CUDA tensor goes through the backward kernel of
    ``csrc/interpolate.cu``; a CPU tensor through the plain twin."""
    tensors = (grad, idx, weight)
    if _on_cpu(*tensors):
        return three_interpolation_backward_plain(grad, idx, weight, n2)
    B, N1, C = grad.shape
    if idx.shape != (B, N1, 3) or weight.shape != (B, N1, 3):
        raise ValueError("shapes must be (B,N1,C), (B,N1,3), (B,N1,3); got "
                         f"{[tuple(t.shape) for t in tensors]}")
    for t, dtype in zip(tensors, (torch.float32, torch.int32, torch.float32)):
        if (t.dtype != dtype or t.device.type != "cuda"
                or t.device != grad.device or not t.is_contiguous()):
            raise ValueError("interpolation backward kernel needs contiguous "
                             f"CUDA tensors, got {t.dtype} on {t.device}")
    df2 = torch.zeros(B, n2, C, dtype=torch.float32, device=grad.device)
    launch("amc3d_three_interpolate_backward", grad.data_ptr(),
           idx.data_ptr(), weight.data_ptr(), df2.data_ptr(), B, N1, n2, C,
           torch.cuda.current_stream(grad.device).cuda_stream)
    three_interpolation_backward.launches += 1
    return df2


class _ThreeInterpolation(torch.autograd.Function):
    """Forward by the kernel (or the plain twin), backward by the backward
    kernel (or its plain twin); gradients reach the features only."""

    @staticmethod
    def forward(ctx, p1, p2, f2, plain: bool):
        if plain:
            out, idx, w = _forward_plain(p1, p2, f2)
        else:
            out, idx, w = _forward_kernel(p1, p2, f2, keep=True)
        ctx.save_for_backward(idx, w)
        ctx.n2, ctx.plain = f2.shape[1], plain
        return out

    @staticmethod
    def backward(ctx, grad):
        idx, w = ctx.saved_tensors
        bwd = (three_interpolation_backward_plain if ctx.plain
               else three_interpolation_backward)
        return None, None, bwd(grad.contiguous(), idx, w, ctx.n2), None


def _needs_grad(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


def three_interpolation_plain(unknown_xyz: torch.Tensor, known_xyz: torch.Tensor,
                              known_feat: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch interpolation of coarse features onto fine points,
    with the plain VJP when the features need a gradient."""
    if _needs_grad(known_feat):
        return _ThreeInterpolation.apply(unknown_xyz, known_xyz, known_feat,
                                         True)
    return _forward_plain(unknown_xyz, known_xyz, known_feat)[0]


def three_interpolation(unknown_xyz: torch.Tensor, known_xyz: torch.Tensor,
                        known_feat: torch.Tensor) -> torch.Tensor:
    """unknown (B, N1, 3), known (B, N2, 3), features (B, N2, C), all f32
    → (B, N1, C).

    A CUDA tensor goes through the fused ``csrc/interpolate.cu`` kernel
    (selection and weighted sum in one pass, nothing materialised; when the
    features need a gradient it also keeps the indices and weights, and the
    backward kernel scatters into the features); a CPU tensor through
    :func:`three_interpolation_plain`."""
    tensors = (unknown_xyz, known_xyz, known_feat)
    if _on_cpu(*tensors):
        return three_interpolation_plain(*tensors)
    if _needs_grad(known_feat):
        return _ThreeInterpolation.apply(unknown_xyz, known_xyz, known_feat,
                                         False)
    return _forward_kernel(unknown_xyz, known_xyz, known_feat, keep=False)[0]


three_interpolation.launches = 0
three_interpolation_backward.launches = 0
