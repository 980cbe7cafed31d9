"""Spatial order for the large-cloud kernels: Morton sort, chunk boxes,
box lower bounds.

↔ ``amcontrast3d_tpu/ops/contrast_pallas.py``: ``_morton_key`` /
``_morton_sort``, ``_minmax3`` and ``_bbox_lb``, which in the JAX package
are XLA code ahead of the Pallas kernels.  Here they are plain PyTorch
ahead of ``csrc/knn_big.cu`` and ``csrc/ball_query_big.cu``: a cloud's
support points are sorted along a Morton curve and cut into chunks of
``CHUNK`` points, each with its exact bounding box; the kernels skip a
chunk whose box is too far from the query.  (The JAX package's ``_kd_sort``
exists because its chunks are thousands of points wide; 64-point Morton
chunks prune a room well enough, see PERF.md.)
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

# support points per chunk; csrc/chunks.cuh::kChunk
CHUNK = 64
_BITS = 16          # Morton cells per axis: 2^16


def _spread3(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 21 bits of int64 ``v`` to every third bit."""
    v = (v | (v << 32)) & 0x1F00000000FFFF
    v = (v | (v << 16)) & 0x1F0000FF0000FF
    v = (v | (v << 8)) & 0x100F00F00F00F00F
    v = (v | (v << 4)) & 0x10C30C30C30C30C3
    v = (v | (v << 2)) & 0x1249249249249249
    return v


def cloud_frame(p: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """p (B, n, 3) → the cloud's lower corner (B, 1, 3) and the factor
    (B, 1, 1) that maps its largest extent onto the Morton grid."""
    lo = p.amin(1, keepdim=True)
    extent = (p.amax(1, keepdim=True) - lo).amax(-1, keepdim=True)
    scale = (2 ** _BITS - 1) / extent.clamp_min(1e-12)
    return lo, scale


def morton_key(p: torch.Tensor, lo: torch.Tensor,
               scale: torch.Tensor) -> torch.Tensor:
    """p (B, n, 3) → (B, n) int64 Morton codes of the points' cells in the
    frame ``(lo, scale)``; points outside the frame go to its border."""
    cell = ((p - lo) * scale).long().clamp_(0, 2 ** _BITS - 1)
    return ((_spread3(cell[..., 0]) << 2) | (_spread3(cell[..., 1]) << 1)
            | _spread3(cell[..., 2]))


def chunk_boxes(sorted_p: torch.Tensor, chunk: int = CHUNK) -> torch.Tensor:
    """sorted_p (B, n, 3) → (B, ceil(n / chunk), 6): per chunk of ``chunk``
    consecutive points the exact lo x, y, z and hi x, y, z."""
    B, n, _ = sorted_p.shape
    nc = -(-n // chunk)
    if nc * chunk != n:   # fill the last chunk with its own last point
        fill = sorted_p[:, -1:].expand(B, nc * chunk - n, 3)
        sorted_p = torch.cat([sorted_p, fill], 1)
    cells = sorted_p.view(B, nc, chunk, 3)
    return torch.cat([cells.amin(2), cells.amax(2)], -1)


def bbox_lb(q: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """Lower bound on d² between point(s) ``q`` (..., 3) and any point of
    box(es) ``boxes`` (..., 6), broadcast against each other.

    Formed like the kernels' d², ``(gx·gx + gy·gy) + gz·gz`` rounded op by
    op from the per-axis gaps, so in float32 it is never above the d² of a
    point inside the box (subtraction, squaring of a non-negative number
    and addition are monotone under rounding)."""
    gap = torch.maximum(boxes[..., :3] - q, q - boxes[..., 3:]).clamp_min(0)
    gx, gy, gz = gap.unbind(-1)
    return (gx * gx + gy * gy) + gz * gz


class SortedCloud(NamedTuple):
    """A support cloud in the layout the large-cloud kernels read."""
    packed: torch.Tensor   # (B, n, 4) f32: sorted x, y, z; w = bits of the
    #                        point's int32 index in the caller's order
    boxes: torch.Tensor    # (B, ceil(n / CHUNK), 6) f32
    codes: torch.Tensor    # (B, n) int64 sorted Morton codes
    lo: torch.Tensor       # (B, 1, 3) the frame of the codes
    scale: torch.Tensor    # (B, 1, 1)


def sort_support(support: torch.Tensor) -> SortedCloud:
    """support (B, n, 3) f32 → its :class:`SortedCloud`: the points along
    the Morton curve of the cloud's own frame.  The sort is stable, so the
    points of one cell keep their index order."""
    B, n, _ = support.shape
    lo, scale = cloud_frame(support)
    codes, perm = torch.sort(morton_key(support, lo, scale), dim=1, stable=True)
    sorted_p = torch.gather(support, 1, perm[..., None].expand(B, n, 3))
    packed = torch.empty(B, n, 4, dtype=torch.float32, device=support.device)
    packed[..., :3] = sorted_p
    packed.view(torch.int32)[..., 3] = perm.to(torch.int32)
    return SortedCloud(packed, chunk_boxes(sorted_p), codes, lo, scale)


def query_order(query: torch.Tensor,
                cloud: SortedCloud) -> Tuple[torch.Tensor, torch.Tensor]:
    """query (B, m, 3) → (order (B, m) int32, home (B, m) int32): the
    queries' indices along the support's Morton curve, and for each entry
    of ``order`` the chunk of ``cloud`` where that query's code would sit."""
    key = morton_key(query, cloud.lo, cloud.scale)
    skey, order = torch.sort(key, dim=1, stable=True)
    n = cloud.codes.shape[1]
    place = torch.searchsorted(cloud.codes, skey).clamp_(max=n - 1)
    return order.to(torch.int32), (place // CHUNK).to(torch.int32)
