"""Furthest point sampling.

↔ ``amcontrast3d_tpu/ops/fps.py`` (plain path ``_furthest_point_sample_lax``)
and ``ops/fps_pallas.py``: ``_fps_kernel`` (the batched TPU kernel), ported
as ``csrc/fps.cu``, and the two kernels a B == 1 call (one whole room)
reaches, ``_fps_kernel_r8`` and ``_fps_kernel_pruned`` (the chunk-pruned
one).  The port serves a B == 1 cloud with one cluster of ``csrc/fps.cu``'s
kernel where the cloud fits one (to 163840 points), above that with the
chunk-pruned kernel of ``csrc/fps_pruned.cu`` where :func:`fps_is_pruned`
says so or the cloud exceeds the grid kernel, else with the grid kernel of
``csrc/fps.cu``; its gate is its own, read off the card.  B > 1 goes to the batched kernel (the JAX
package's batched pruned path is off by default, a measured loser on the
TPU).  The batched kernel and the whole-room cluster path are one kernel,
``csrc/fps_cluster.cuh``: a thread-block cluster of S blocks a cloud, the
points in registers, every cloud of the batch in one launch, S from the
batch and the cloud (:func:`fps_cluster_size`).  Semantics of all: the
first pick is index 0, a running min-distance buffer starts at 1e10, each
step takes the argmax with ties to the lowest index, and d² is
``(dx·dx + dy·dy) + dz·dz``.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import torch

from . import spatial
from ._build import launch, load_library

# the whole-room grid kernel keeps 16 bytes a point in shared memory, this
# many points on each multiprocessor (csrc/fps.cu::fps_grid::kMaxBlockPoints)
B1_POINTS_PER_SM = 14336
# csrc/fps_cluster.cuh: blocks of 512 threads that keep up to 20 points each
# in registers, clusters of 1 to 16 blocks; a cloud above 16 × 512 × 20
# points goes to the grid kernel
CLUSTER_THREADS, THREAD_POINTS = 512, 20
CLUSTER_SIZES = (1, 2, 4, 8, 16)
CLUSTER_POINTS = CLUSTER_SIZES[-1] * CLUSTER_THREADS * THREAD_POINTS
# (S, the least N from which the batched kernel takes clusters of S blocks),
# read off the card at B = 4 (tools/profile_fps.py, PERF.md §6): one block
# is fastest to 4096 points, 4 blocks at 6000, 8 from 8192 to 16384, 16 from
# 20480; each gate lies between two measured sizes.  Two blocks are never
# the fastest; they serve batches too large for more.
CLUSTER_GATES = ((16, 18432), (8, 7168), (4, 5120), (1, 1))
# the pruned kernel's cluster keeps 4 chunk records a lane: 16 blocks of 512
# threads, chunks of 64 points (csrc/fps_pruned.cu)
PRUNED_MAX_POINTS = 16 * 512 * 4 * spatial.CHUNK
# a B == 1 cloud goes to the chunk-pruned kernel above what one cluster of
# csrc/fps.cu's kernel holds, where the picks are at least this share of the
# cloud; below it the grid kernel's sweep is faster, the chunk-pruned
# kernel's first picks visiting most chunks (read off the card between 1/64,
# where the pruned kernel is faster at 221184 to 1.2 M points, and 1/146,
# where it is slower; PERF.md §6)
PRUNED_MIN_SHARE = 0.01


def fps_is_pruned(B: int, N: int, npoint: int) -> bool:
    """Whether a (B, N) cloud sampled to ``npoint`` goes to the chunk-pruned
    kernel: one cloud of more than one cluster's points (163840), of which
    at least :data:`PRUNED_MIN_SHARE` are picked.  The port's own gate,
    read off the card; the JAX package's is N ≥ 262144."""
    return B == 1 and N > CLUSTER_POINTS and npoint >= PRUNED_MIN_SHARE * N


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


def fps_cluster_size(B: int, N: int, clusters: Dict[int, int]
                     ) -> Optional[int]:
    """The cluster size S of the batched kernel for B clouds of N points on
    a card that holds ``clusters[S]`` clusters of S blocks at once, or None:
    the grid kernel, cloud by cloud (N above 16 × 512 × 20, or a card that
    holds no cluster large enough).

    S starts at the gate of N (:data:`CLUSTER_GATES`) and halves while the
    card cannot hold B such clusters at once (a batch in two waves takes
    twice as long), but never below the least S whose blocks hold N
    points."""
    need = next((s for s in CLUSTER_SIZES
                 if N <= s * CLUSTER_THREADS * THREAD_POINTS), None)
    if need is None or clusters.get(need, 0) < 1:
        return None
    s = max(need, next(s for s, least in CLUSTER_GATES if N >= least))
    while s > need and clusters.get(s, 0) < B:
        s //= 2
    return s


@functools.lru_cache(maxsize=None)
def _cluster_capacity(device_index: int) -> Dict[int, int]:
    """{S: how many clusters of S blocks of ``csrc/fps_cluster.cuh`` the
    card holds at once}, read with ``cudaOccupancyMaxActiveClusters``."""
    with torch.cuda.device(device_index):
        lib = load_library()
        counts = {s: lib.amc3d_fps_clusters(s) for s in CLUSTER_SIZES}
    for s, count in counts.items():
        if count < 0:
            raise RuntimeError(f"amc3d_fps_clusters({s}): CUDA error {-count}")
    return counts


@functools.lru_cache(maxsize=None)
def _grid_points(device_index: int) -> int:
    """The most points the grid kernel takes on the card:
    :data:`B1_POINTS_PER_SM` on each multiprocessor."""
    props = torch.cuda.get_device_properties(device_index)
    return props.multi_processor_count * B1_POINTS_PER_SM


def _fps_b1_cluster(xyz: torch.Tensor, npoint: int, s: int) -> torch.Tensor:
    """One cloud through the register-resident kernel of ``csrc/fps.cu``
    (``csrc/fps_cluster.cuh``), one cluster of ``s`` blocks; counted as a
    whole-room launch.  N ≤ s × 512 × 20, on a card that holds such a
    cluster."""
    N = xyz.shape[1]
    if s not in CLUSTER_SIZES or N > s * CLUSTER_THREADS * THREAD_POINTS:
        raise ValueError(f"the cluster fps kernel takes N ≤ {CLUSTER_POINTS} "
                         f"on a card that holds such a cluster, got N={N}, "
                         f"S={s}")
    out = torch.empty(1, npoint, dtype=torch.int32, device=xyz.device)
    launch("amc3d_fps", xyz.data_ptr(), out.data_ptr(), 1, N, npoint, s,
           torch.cuda.current_stream(xyz.device).cuda_stream)
    furthest_point_sample_b1.launches += 1
    return out


def _fps_b1_grid(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """One cloud through the grid kernel of ``csrc/fps.cu``: a cooperative
    launch over all multiprocessors that meets in device memory; counted as
    a whole-room launch.  N up to 14336 points on each, 1.89 M on 132."""
    N = xyz.shape[1]
    if N > _grid_points(xyz.device.index):
        raise ValueError(f"the grid fps kernel keeps the cloud in shared "
                         f"memory: N={N} > {_grid_points(xyz.device.index)}")
    out = torch.empty(1, npoint, dtype=torch.int32, device=xyz.device)
    # per pick a slot for the winner and a count of the blocks that are in
    best = torch.zeros(npoint, dtype=torch.int64, device=xyz.device)
    arrived = torch.zeros(npoint, dtype=torch.int32, device=xyz.device)
    launch("amc3d_fps_grid", xyz.data_ptr(), out.data_ptr(), best.data_ptr(),
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


def furthest_point_sample_pruned(xyz: torch.Tensor, npoint: int,
                                 visits: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """One cloud, xyz (1, N, 3) f32 → idx (1, npoint) int32, picks
    identical to :func:`furthest_point_sample_plain`, through the kernel of
    ``csrc/fps_pruned.cu``: the cloud sorted into 64-point chunks with boxes
    (one :func:`spatial.sort_stages`: two kernels and a sort), one
    thread-block cluster that visits per pick only the chunks whose box may
    hold a point closer to the pick than its min-distance.  Any N up to
    2 M.  ``visits``, a zeroed (1,) int64 CUDA tensor, gains the chunk
    visits of the run.  A CPU tensor goes through the plain path."""
    if xyz.device.type == "cpu":
        return furthest_point_sample_plain(xyz, npoint)
    _check_b1(xyz, npoint)
    N = xyz.shape[1]
    if N > PRUNED_MAX_POINTS:
        raise ValueError(f"the pruned fps kernel takes N ≤ {PRUNED_MAX_POINTS}"
                         f", got N={N}")
    cloud = spatial.sort_stages([xyz])[0]
    mind = torch.empty(N, dtype=torch.float32, device=xyz.device)
    out = torch.empty(1, npoint, dtype=torch.int32, device=xyz.device)
    launch("amc3d_fps_pruned", cloud.packed.data_ptr(), cloud.boxes.data_ptr(),
           xyz.data_ptr(), mind.data_ptr(), out.data_ptr(),
           None if visits is None else visits.data_ptr(), N, npoint,
           torch.cuda.current_stream(xyz.device).cuda_stream)
    furthest_point_sample_pruned.launches += 1
    return out


furthest_point_sample_pruned.launches = 0


def furthest_point_sample_b1(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """One cloud, xyz (1, N, 3) f32 → idx (1, npoint) int32, picks
    identical to :func:`furthest_point_sample_plain`.

    A CUDA tensor goes through :func:`furthest_point_sample_pruned` where
    :func:`fps_is_pruned` says so or the cloud is larger than the grid
    kernel takes, else through one cluster of ``csrc/fps.cu``'s kernel at
    :func:`fps_cluster_size`'s S for B = 1 where the card holds it, else
    through the grid kernel of ``csrc/fps.cu``.  ``launches`` counts the
    last two (``csrc/fps.cu``'s launches for one cloud).  A CPU tensor goes
    through the plain path."""
    if xyz.device.type == "cpu":
        return furthest_point_sample_plain(xyz, npoint)
    _check_b1(xyz, npoint)
    N = xyz.shape[1]
    if fps_is_pruned(1, N, npoint) or (
            N > CLUSTER_POINTS and N > _grid_points(xyz.device.index)):
        return furthest_point_sample_pruned(xyz, npoint)
    s = fps_cluster_size(1, N, _cluster_capacity(xyz.device.index))
    if s is not None:
        return _fps_b1_cluster(xyz, npoint, s)
    return _fps_b1_grid(xyz, npoint)


furthest_point_sample_b1.launches = 0


def _fps_cluster(xyz: torch.Tensor, npoint: int, s: int) -> torch.Tensor:
    """The batched kernel of ``csrc/fps.cu``: one cluster of ``s`` blocks a
    cloud, all clouds in one launch; N ≤ s × 512 × 20."""
    B, N, _ = xyz.shape
    if s not in CLUSTER_SIZES or N > s * CLUSTER_THREADS * THREAD_POINTS:
        raise ValueError(f"the batched fps kernel takes clusters of "
                         f"{CLUSTER_SIZES} blocks of {CLUSTER_THREADS} x "
                         f"{THREAD_POINTS} points, got S={s}, N={N}")
    out = torch.empty(B, npoint, dtype=torch.int32, device=xyz.device)
    launch("amc3d_fps", xyz.data_ptr(), out.data_ptr(), B, N, npoint, s,
           torch.cuda.current_stream(xyz.device).cuda_stream)
    furthest_point_sample.launches += 1
    return out


def furthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """xyz (B, N, 3) f32 → idx (B, npoint) int32, first index always 0.

    A CUDA tensor with B == 1 goes through
    :func:`furthest_point_sample_b1` (and where :func:`fps_is_pruned` says
    so through :func:`furthest_point_sample_pruned`), one with B > 1
    through the ``csrc/fps.cu`` kernel in one launch, one cluster of
    :func:`fps_cluster_size` blocks a cloud (N ≤ 163840).  Beyond that, or
    on a card without such clusters, one cloud after the other goes through
    the grid kernel of ``csrc/fps.cu``, counted on
    ``furthest_point_sample_b1.launches``.  A CPU tensor goes through
    :func:`furthest_point_sample_plain`."""
    if xyz.device.type == "cpu":
        return furthest_point_sample_plain(xyz, npoint)
    _check(xyz, npoint)
    B, N, _ = xyz.shape
    if B == 1:
        return furthest_point_sample_b1(xyz, npoint)
    _check_cuda(xyz)
    s = fps_cluster_size(B, N, _cluster_capacity(xyz.device.index))
    if s is None:
        return torch.cat([_fps_b1_grid(xyz[b:b + 1], npoint)
                          for b in range(B)])
    return _fps_cluster(xyz, npoint, s)


furthest_point_sample.launches = 0


def random_sample(xyz: torch.Tensor, npoint: int,
                  generator: torch.Generator) -> torch.Tensor:
    """Uniform random sampling with replacement (↔ the JAX package's
    ``ops/fps.py::random_sample``): (B, npoint) int32 indices into the N
    points of ``xyz`` (B, N, 3), drawn from ``generator`` (on ``xyz``'s
    device).  No kernel: the JAX package draws them with
    ``jax.random.randint``, no Pallas."""
    B, N, _ = xyz.shape
    return torch.randint(0, N, (B, npoint), generator=generator,
                         device=xyz.device, dtype=torch.int32)
