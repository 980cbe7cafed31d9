"""Furthest point sampling.

↔ ``amcontrast3d_tpu/ops/fps.py`` (plain path ``_furthest_point_sample_lax``)
and ``ops/fps_pallas.py::_fps_kernel`` (the batched TPU kernel), ported as
``csrc/fps.cu``.  Semantics of both: the first pick is index 0, a running
min-distance buffer starts at 1e10, each step takes the argmax with ties
to the lowest index, and d² is ``(dx·dx + dy·dy) + dz·dz``.
"""
from __future__ import annotations

import torch

from ._build import launch

# the kernel's min-distance buffer is N floats of a block's 227 KB of
# shared memory
MAX_KERNEL_N = 56 * 1024


def _check(xyz: torch.Tensor, npoint: int) -> None:
    if xyz.dim() != 3 or xyz.shape[-1] != 3:
        raise ValueError(f"xyz must be (B, N, 3), got {tuple(xyz.shape)}")
    if xyz.dtype != torch.float32:
        raise TypeError(f"xyz must be float32, got {xyz.dtype}")
    if not 1 <= npoint <= xyz.shape[1]:
        raise ValueError(f"fps npoint={npoint} not in [1, N={xyz.shape[1]}]")


def furthest_point_sample_plain(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """Plain PyTorch FPS on any device: xyz (B, N, 3) f32 → (B, npoint) int32."""
    _check(xyz, npoint)
    B, N, _ = xyz.shape
    x, y, z = xyz.unbind(-1)
    rows = torch.arange(B, device=xyz.device)
    out = torch.zeros(B, npoint, dtype=torch.int64, device=xyz.device)
    mind = torch.full((B, N), 1e10, dtype=torch.float32, device=xyz.device)
    last = torch.zeros(B, dtype=torch.int64, device=xyz.device)
    for j in range(1, npoint):
        lp = xyz[rows, last]                                     # (B, 3)
        dx, dy, dz = x - lp[:, 0:1], y - lp[:, 1:2], z - lp[:, 2:3]
        mind = torch.minimum(mind, (dx * dx + dy * dy) + dz * dz)
        last = torch.argmax(mind, dim=1)      # first maximal index on ties
        out[:, j] = last
    return out.to(torch.int32)


def furthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """xyz (B, N, 3) f32 → idx (B, npoint) int32, first index always 0.

    A CUDA tensor goes through the ``csrc/fps.cu`` kernel (one block per
    cloud); a CPU tensor through :func:`furthest_point_sample_plain`."""
    if xyz.device.type == "cpu":
        return furthest_point_sample_plain(xyz, npoint)
    _check(xyz, npoint)
    if xyz.device.type != "cuda" or not xyz.is_contiguous():
        raise ValueError("fps kernel needs a contiguous CUDA tensor, got "
                         f"{xyz.device} contiguous={xyz.is_contiguous()}")
    B, N, _ = xyz.shape
    if N > MAX_KERNEL_N:
        raise ValueError(f"fps kernel keeps N floats in shared memory: "
                         f"N={N} > {MAX_KERNEL_N}")
    out = torch.empty(B, npoint, dtype=torch.int32, device=xyz.device)
    launch("amc3d_fps", xyz.data_ptr(), out.data_ptr(), B, N, npoint,
           torch.cuda.current_stream(xyz.device).cuda_stream)
    furthest_point_sample.launches += 1
    return out


furthest_point_sample.launches = 0
