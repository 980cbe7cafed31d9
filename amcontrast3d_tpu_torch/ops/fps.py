"""Furthest point sampling.

↔ ``amcontrast3d_tpu/ops/fps.py`` (plain path ``_furthest_point_sample_lax``)
and ``ops/fps_pallas.py``: ``_fps_kernel`` (the batched TPU kernel), ported
as ``csrc/fps.cu``, and ``_fps_kernel_r8`` (the kernel every B == 1 call
reaches: one whole room), ported as ``csrc/fps_b1.cu``.  The dispatch is
that of ``fps_pallas.py::furthest_point_sample_pallas``: B == 1 goes to the
whole-room kernel, B > 1 to the batched one; a batch whose clouds exceed
the batched kernel's shared memory (N > 57344: the ScanNet recipe's 2 ×
64000) goes to the cluster kernel of ``csrc/fps_b1.cu``, one cluster a
cloud.  Semantics of all: the first
pick is index 0, a running min-distance buffer starts at 1e10, each step
takes the argmax with ties to the lowest index, and d² is
``(dx·dx + dy·dy) + dz·dz``.
"""
from __future__ import annotations

import functools

import torch

from ._build import launch, load_library

# the batched kernel's min-distance buffer is N floats of a block's 227 KB
# of shared memory
MAX_KERNEL_N = 56 * 1024
# the whole-room kernels keep 16 bytes a point in shared memory, this many
# points on each multiprocessor (csrc/fps_b1.cu::kMaxBlockPoints)
B1_POINTS_PER_SM = 14336
# the most points its cluster kernel takes: 16 blocks of 512 threads that
# keep 20 points each in registers (csrc/fps_b1.cu)
B1_CLUSTER_POINTS = 16 * 512 * 20


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


def _check_cuda(xyz: torch.Tensor) -> None:
    if xyz.device.type != "cuda" or not xyz.is_contiguous():
        raise ValueError("fps kernel needs a contiguous CUDA tensor, got "
                         f"{xyz.device} contiguous={xyz.is_contiguous()}")


@functools.lru_cache(maxsize=None)
def _cluster_fits(device_index: int) -> bool:
    """Whether the card can hold the cluster kernel's 16 blocks at once."""
    with torch.cuda.device(device_index):
        clusters = load_library().amc3d_fps_b1_clusters()
    if clusters < 0:
        raise RuntimeError(f"amc3d_fps_b1_clusters: CUDA error {-clusters}")
    return clusters >= 1


def _fps_b1_cluster(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """The cluster kernel of ``csrc/fps_b1.cu``: per cloud one thread-block
    cluster of 16 blocks that exchange their winners through distributed
    shared memory, all clouds of the batch in one launch.  N ≤ 16 × 512 × 20
    = 163840, on a card that holds the cluster."""
    B, N, _ = xyz.shape
    if N > B1_CLUSTER_POINTS or not _cluster_fits(xyz.device.index):
        raise ValueError(f"the cluster fps kernel takes N ≤ "
                         f"{B1_CLUSTER_POINTS} on a card that holds such "
                         f"a cluster, got N={N}")
    out = torch.empty(B, npoint, dtype=torch.int32, device=xyz.device)
    launch("amc3d_fps_b1_cluster", xyz.data_ptr(), out.data_ptr(), B, N,
           npoint, torch.cuda.current_stream(xyz.device).cuda_stream)
    furthest_point_sample_b1.launches += 1
    return out


def _fps_b1_grid(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """The grid kernel of ``csrc/fps_b1.cu``: a cooperative launch over all
    multiprocessors that meets in device memory.  N up to 14336 points on
    each, 1.89 M on 132."""
    N = xyz.shape[1]
    sms = torch.cuda.get_device_properties(xyz.device).multi_processor_count
    if N > sms * B1_POINTS_PER_SM:
        raise ValueError(f"the whole-room fps kernel keeps the cloud in "
                         f"shared memory: N={N} > {sms} x {B1_POINTS_PER_SM}")
    out = torch.empty(1, npoint, dtype=torch.int32, device=xyz.device)
    # per pick a slot for the winner and a count of the blocks that are in
    best = torch.zeros(npoint, dtype=torch.int64, device=xyz.device)
    arrived = torch.zeros(npoint, dtype=torch.int32, device=xyz.device)
    launch("amc3d_fps_b1", xyz.data_ptr(), out.data_ptr(), best.data_ptr(),
           arrived.data_ptr(), N, npoint,
           torch.cuda.current_stream(xyz.device).cuda_stream)
    furthest_point_sample_b1.launches += 1
    return out


def _check_b1(xyz: torch.Tensor, npoint: int) -> None:
    _check(xyz, npoint)
    _check_cuda(xyz)
    if xyz.shape[0] != 1:
        raise ValueError(f"the whole-room fps kernel takes one cloud, "
                         f"got B={xyz.shape[0]}")


def furthest_point_sample_b1(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """One cloud, xyz (1, N, 3) f32 → idx (1, npoint) int32, picks
    identical to :func:`furthest_point_sample_plain`.

    A CUDA tensor goes through one of the two kernels of ``csrc/fps_b1.cu``:
    the cluster kernel where the cloud and the card allow it, else the grid
    kernel.  A CPU tensor goes through the plain path."""
    if xyz.device.type == "cpu":
        return furthest_point_sample_plain(xyz, npoint)
    _check_b1(xyz, npoint)
    if xyz.shape[1] <= B1_CLUSTER_POINTS and _cluster_fits(xyz.device.index):
        return _fps_b1_cluster(xyz, npoint)
    return _fps_b1_grid(xyz, npoint)


furthest_point_sample_b1.launches = 0


def furthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """xyz (B, N, 3) f32 → idx (B, npoint) int32, first index always 0.

    A CUDA tensor with B == 1 goes through
    :func:`furthest_point_sample_b1`, one with B > 1 through the
    ``csrc/fps.cu`` kernel (one block per cloud, N ≤ 57344).  Larger clouds
    in a batch go through the cluster kernel of ``csrc/fps_b1.cu`` in one
    launch (N ≤ 163840), and beyond that, or on a card without such
    clusters, one cloud after the other through its grid kernel; both count
    on ``furthest_point_sample_b1.launches``.  A CPU tensor goes through
    :func:`furthest_point_sample_plain`."""
    if xyz.device.type == "cpu":
        return furthest_point_sample_plain(xyz, npoint)
    _check(xyz, npoint)
    B, N, _ = xyz.shape
    if B == 1:
        return furthest_point_sample_b1(xyz, npoint)
    _check_cuda(xyz)
    if N > MAX_KERNEL_N:
        if N <= B1_CLUSTER_POINTS and _cluster_fits(xyz.device.index):
            return _fps_b1_cluster(xyz, npoint)
        return torch.cat([_fps_b1_grid(xyz[b:b + 1], npoint)
                          for b in range(B)])
    out = torch.empty(B, npoint, dtype=torch.int32, device=xyz.device)
    launch("amc3d_fps", xyz.data_ptr(), out.data_ptr(), B, N, npoint,
           torch.cuda.current_stream(xyz.device).cuda_stream)
    furthest_point_sample.launches += 1
    return out


furthest_point_sample.launches = 0
