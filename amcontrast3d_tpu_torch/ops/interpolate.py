"""3-NN inverse-distance feature interpolation (decoder upsampling).

↔ ``amcontrast3d_tpu/ops/interpolate.py`` (``three_nn``,
``three_interpolate``, ``three_interpolation``) and the fused TPU kernel
``ops/interpolate_pallas.py::_interp_kernel``, ported as
``csrc/interpolate.cu``.  Weights are ``1/(√d² + 1e-8)``, normalised over
the 3 nearest coarse points.

Semantics follow the JAX plain path (``interpolate.py:42-57``): exactly
three neighbours, ties to the lowest index.  The TPU kernel instead
averages every neighbour whose d² ties the 3rd (a 4th point may enter);
the two agree wherever the 3rd-nearest d² is unique.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ._build import launch
from .group import group_points
from .knn import knn


def three_nn(unknown: torch.Tensor, known: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """unknown (B, N, 3), known (B, M, 3) → (dist (B, N, 3), idx (B, N, 3))."""
    idx, d2 = knn(known, unknown, 3)
    return torch.sqrt(torch.clamp_min(d2, 0.0)), idx


def three_interpolate(features: torch.Tensor, idx: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """features (B, M, C), idx/weight (B, N, 3) → (B, N, C), summed as
    ``(f0·w0 + f1·w1) + f2·w2``."""
    nb = group_points(features, idx)                      # (B, N, 3, C)
    w = weight[..., None]
    return (nb[:, :, 0] * w[:, :, 0] + nb[:, :, 1] * w[:, :, 1]) \
        + nb[:, :, 2] * w[:, :, 2]


def three_interpolation_plain(unknown_xyz: torch.Tensor, known_xyz: torch.Tensor,
                              known_feat: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch interpolation of coarse features onto fine points."""
    dist, idx = three_nn(unknown_xyz, known_xyz)
    recip = torch.reciprocal(dist + 1e-8)
    norm = (recip[..., 0:1] + recip[..., 1:2]) + recip[..., 2:3]
    return three_interpolate(known_feat, idx, recip / norm)


def three_interpolation(unknown_xyz: torch.Tensor, known_xyz: torch.Tensor,
                        known_feat: torch.Tensor) -> torch.Tensor:
    """unknown (B, N1, 3), known (B, N2, 3), features (B, N2, C), all f32
    → (B, N1, C).

    A CUDA tensor goes through the fused ``csrc/interpolate.cu`` kernel
    (selection and weighted sum in one pass, nothing materialised); a CPU
    tensor through :func:`three_interpolation_plain`."""
    tensors = (unknown_xyz, known_xyz, known_feat)
    if all(t.device.type == "cpu" for t in tensors):
        return three_interpolation_plain(*tensors)
    B, N1, _ = unknown_xyz.shape
    _, N2, C = known_feat.shape
    if (unknown_xyz.shape != (B, N1, 3) or known_xyz.shape != (B, N2, 3)
            or known_feat.shape[0] != B):
        raise ValueError("shapes must be (B,N1,3), (B,N2,3), (B,N2,C); got "
                         f"{[tuple(t.shape) for t in tensors]}")
    for t in tensors:
        if (t.dtype != torch.float32 or t.device.type != "cuda"
                or t.device != unknown_xyz.device or not t.is_contiguous()):
            raise ValueError("interpolation kernel needs contiguous float32 "
                             f"tensors on one CUDA device, got {t.dtype} on "
                             f"{t.device} contiguous={t.is_contiguous()}")
    out = torch.empty(B, N1, C, dtype=torch.float32, device=known_feat.device)
    launch("amc3d_three_interpolate", unknown_xyz.data_ptr(),
           known_xyz.data_ptr(), known_feat.data_ptr(), out.data_ptr(),
           B, N1, N2, C, torch.cuda.current_stream(out.device).cuda_stream)
    three_interpolation.launches += 1
    return out


three_interpolation.launches = 0
