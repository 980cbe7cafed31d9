"""Spatial order for the chunk-pruned kernels: Morton sort, chunk boxes,
box lower bounds.

↔ ``amcontrast3d_tpu/ops/contrast_pallas.py``: ``_morton_key`` /
``_morton_sort``, ``_minmax3`` and ``_bbox_lb``, which in the JAX package
are XLA code ahead of the Pallas kernels.  Here a cloud's support points
are sorted along a Morton curve and cut into chunks of ``CHUNK`` points,
each with its exact bounding box; the kernels (``csrc/knn.cu``,
``csrc/ball_query.cu``, ``csrc/refine.cu``, ``csrc/contrast.cu``, ...)
skip a chunk whose box is too far from the query, or from the box of a
block's queries.  :func:`sort_support` sorts one cloud in plain PyTorch.
A forward's stage clouds are sorted once, together, by :func:`sort_stages`
(``csrc/layout.cu``: three launches and a sort) as soon as the encoder has
sampled them, and each :class:`SortedCloud` is handed to every kernel that
reads it (the encoder's ball queries, the decoder's CrossMask, the loss's
self-kNN, contrast kernels and label propagation from stage 0).  A layout
remembers the tensor it was made from, and the wrappers refuse it for
another.  (The JAX package's ``_kd_sort`` exists because its
chunks are thousands of points wide; 64-point Morton chunks prune a room
well enough, see PERF.md.)
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch

from ._build import launch

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


@functools.lru_cache(maxsize=None)
def _spread_tables(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(:func:`_spread3` of every 16-bit cell coordinate, 512 KiB; the
    shifts (2, 1, 0) of the three axes) on ``device``: a cloud's Morton key
    then takes seven launches instead of fifty."""
    return (_spread3(torch.arange(2 ** _BITS, dtype=torch.int64, device=device)),
            torch.tensor([2, 1, 0], dtype=torch.int64, device=device))


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
    frame ``(lo, scale)``; points outside the frame go to its border.  Each
    16-bit cell coordinate is spread by table."""
    table, shifts = _spread_tables(p.device)
    cell = ((p - lo) * scale).long().clamp_(0, 2 ** _BITS - 1)
    return (table[cell] << shifts).sum(-1)   # the axes' bits are disjoint


def chunk_boxes(sorted_p: torch.Tensor, chunk: int = CHUNK) -> torch.Tensor:
    """sorted_p (B, n, 3) → (B, ceil(n / chunk), 6): per chunk of ``chunk``
    consecutive points the exact lo x, y, z and hi x, y, z."""
    B, n, _ = sorted_p.shape
    nc = -(-n // chunk)
    if nc * chunk != n:   # fill the last chunk with its own last point
        fill = sorted_p[:, -1:].expand(B, nc * chunk - n, 3)
        sorted_p = torch.cat([sorted_p, fill], 1)
    cells = sorted_p.reshape(B, nc, chunk, 3)
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


def chunk_max(sorted_v: torch.Tensor, chunk: int = CHUNK) -> torch.Tensor:
    """sorted_v (B, n) per-point values in a cloud's sorted order → (B,
    ceil(n / chunk)): the largest value of each chunk, cut as
    :func:`chunk_boxes` cuts the points."""
    B, n = sorted_v.shape
    nc = -(-n // chunk)
    if nc * chunk != n:   # fill the last chunk with its own last value
        sorted_v = torch.cat(
            [sorted_v, sorted_v[:, -1:].expand(B, nc * chunk - n)], 1)
    return sorted_v.reshape(B, nc, chunk).amax(2)


class SortedCloud(NamedTuple):
    """A support cloud in the layout the chunk-pruned kernels read."""
    packed: torch.Tensor   # (B, n, 4) f32: sorted x, y, z; w = bits of the
    #                        point's int32 index in the caller's order
    boxes: torch.Tensor    # (B, ceil(n / CHUNK), 6) f32
    codes: torch.Tensor    # (B, n) int64 sorted Morton codes
    lo: torch.Tensor       # (B, 1, 3) the frame of the codes
    scale: torch.Tensor    # (B, 1, 1)
    perm: torch.Tensor     # (B, n) int64: the caller's index of each point
    source: Tuple[int, int]   # the support's (data_ptr, _version)


def _source(support: torch.Tensor) -> Tuple[int, int]:
    # an inference-mode tensor keeps no version counter
    return (support.data_ptr(),
            -1 if support.is_inference() else support._version)


def sort_support(support: torch.Tensor) -> SortedCloud:
    """support (B, n, 3) f32 → its :class:`SortedCloud`: the points along
    the Morton curve of the cloud's own frame.  The sort is stable, so the
    points of one cell keep their index order.  Plain PyTorch on any
    device: the layout of one cloud, and what :func:`sort_stages` gives
    each stage."""
    B, n, _ = support.shape
    lo, scale = cloud_frame(support)
    codes, perm = torch.sort(morton_key(support, lo, scale), dim=1, stable=True)
    sorted_p = torch.gather(support, 1, perm[..., None].expand(B, n, 3))
    index = perm.to(torch.int32).view(torch.float32)[..., None]
    packed = torch.cat([sorted_p, index], -1)
    return SortedCloud(packed, chunk_boxes(sorted_p), codes, lo, scale, perm,
                       _source(support))


# sort_stages: segment s·B + b is cloud b of stage s, and a segment's number
# sits in the bits of its points' keys above the Morton code's
_CODE_BITS = 3 * _BITS


def _segments(b: int, sizes: Tuple[int, ...]) -> Tuple[list, list]:
    """(the first row of each segment and the number of rows, the first
    chunk of each segment and the number of chunks)."""
    rows, chunks = [0], [0]
    for n in sizes:
        for _ in range(b):
            rows.append(rows[-1] + n)
            chunks.append(chunks[-1] + -(-n // CHUNK))
    return rows, chunks


@functools.lru_cache(maxsize=16)
def _segment_tables(b: int, sizes: Tuple[int, ...], device: torch.device
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    rows, chunks = _segments(b, sizes)
    return (torch.tensor(rows, dtype=torch.int64, device=device),
            torch.tensor(chunks, dtype=torch.int32, device=device))


def _check_points(points: torch.Tensor, b: int, sizes: Tuple[int, ...]) -> None:
    if (points.dim() != 2 or points.shape != (b * sum(sizes), 3)
            or points.dtype != torch.float32 or not points.is_contiguous()
            or points.device.type != "cuda"):
        raise ValueError("the layout kernels take the stage clouds as one "
                         f"contiguous ({b * sum(sizes)}, 3) float32 CUDA "
                         f"tensor, got {tuple(points.shape)} {points.dtype} on "
                         f"{points.device}")


def layout_keys_plain(points: torch.Tensor, b: int, sizes: Tuple[int, ...]
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """points (T, 3), the stage clouds of ``sizes`` (each (b, n_s, 3))
    flattened one after another → (keys (T,) int64: each point's Morton
    code in its segment's own :func:`cloud_frame`, the segment's number in
    the bits above it; frame (b·len(sizes), 4) f32: each segment's lower
    corner and scale)."""
    rows, _ = _segments(b, sizes)
    keys, frame = [], []
    for seg, (a, e) in enumerate(zip(rows[:-1], rows[1:])):
        p = points[a:e][None]
        lo, scale = cloud_frame(p)
        keys.append(morton_key(p, lo, scale)[0] | (seg << _CODE_BITS))
        frame.append(torch.cat([lo[0, 0], scale[0, 0]]))
    return torch.cat(keys), torch.stack(frame)


def layout_keys(points: torch.Tensor, b: int, sizes: Tuple[int, ...]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`layout_keys_plain` by the ``csrc/layout.cu`` kernel for a CUDA
    tensor (a block a segment), by the plain twin for a CPU tensor."""
    if points.device.type == "cpu":
        return layout_keys_plain(points, b, sizes)
    _check_points(points, b, sizes)
    rows, _ = _segment_tables(b, sizes, points.device)
    keys = torch.empty(points.shape[0], dtype=torch.int64, device=points.device)
    frame = torch.empty(rows.shape[0] - 1, 4, dtype=torch.float32,
                        device=points.device)
    launch("amc3d_layout_keys", points.data_ptr(), rows.data_ptr(),
           keys.data_ptr(), frame.data_ptr(), rows.shape[0] - 1,
           torch.cuda.current_stream(points.device).cuda_stream)
    layout_keys.launches += 1
    return keys, frame


layout_keys.launches = 0


def layout_pack_plain(points: torch.Tensor, perm: torch.Tensor,
                      skeys: torch.Tensor, b: int, sizes: Tuple[int, ...]
                      ) -> Tuple[torch.Tensor, ...]:
    """points (T, 3) as :func:`layout_keys_plain` takes them, perm and
    skeys (T,) int64 from the stable sort of its keys → (packed (T, 4) f32:
    the sorted points with the bits of their int32 index in their cloud;
    codes (T,) int64: their Morton codes; index (T,) int64: their index in
    their cloud; boxes (chunks, 6) f32: :func:`chunk_boxes` of each
    segment's sorted points)."""
    rows, _ = _segments(b, sizes)
    packed, codes, index, boxes = [], [], [], []
    for a, e in zip(rows[:-1], rows[1:]):
        sorted_p = points[perm[a:e]]
        local = perm[a:e] - a
        packed.append(torch.cat([sorted_p, local.to(torch.int32)
                                 .view(torch.float32)[:, None]], -1))
        codes.append(skeys[a:e] & ((1 << _CODE_BITS) - 1))
        index.append(local)
        boxes.append(chunk_boxes(sorted_p[None])[0])
    return (torch.cat(packed), torch.cat(codes), torch.cat(index),
            torch.cat(boxes))


def layout_pack(points: torch.Tensor, perm: torch.Tensor, skeys: torch.Tensor,
                b: int, sizes: Tuple[int, ...]) -> Tuple[torch.Tensor, ...]:
    """:func:`layout_pack_plain` by the ``csrc/layout.cu`` kernel for a CUDA
    tensor (a block a chunk), by the plain twin for a CPU tensor."""
    if points.device.type == "cpu":
        return layout_pack_plain(points, perm, skeys, b, sizes)
    _check_points(points, b, sizes)
    rows, chunks = _segment_tables(b, sizes, points.device)
    T, nc = points.shape[0], _segments(b, sizes)[1][-1]
    for name, t in (("perm", perm), ("skeys", skeys)):
        if t.shape != (T,) or t.dtype != torch.int64 or not t.is_contiguous() \
                or t.device != points.device:
            raise ValueError(f"{name} must be a contiguous ({T},) int64 tensor "
                             f"on {points.device}, got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")
    dev = points.device
    packed = torch.empty(T, 4, dtype=torch.float32, device=dev)
    codes = torch.empty(T, dtype=torch.int64, device=dev)
    index = torch.empty(T, dtype=torch.int64, device=dev)
    boxes = torch.empty(nc, 6, dtype=torch.float32, device=dev)
    launch("amc3d_layout_pack", points.data_ptr(), perm.data_ptr(),
           skeys.data_ptr(), rows.data_ptr(), chunks.data_ptr(),
           packed.data_ptr(), codes.data_ptr(), index.data_ptr(),
           boxes.data_ptr(), rows.shape[0] - 1, nc,
           torch.cuda.current_stream(dev).cuda_stream)
    layout_pack.launches += 1
    return packed, codes, index, boxes


layout_pack.launches = 0


def sort_stages(stages) -> list:
    """The :class:`SortedCloud` of each stage cloud (B, n_s, 3) f32 of one
    step, exactly what :func:`sort_support` gives each: the clouds go in
    as one array, :func:`layout_keys` gives each point its code in its own
    cloud's frame with the cloud's segment above it, one stable sort orders
    them, and :func:`layout_pack` writes every layout at once.  On the card
    that is three launches and a sort where a sort of each stage is some
    sixty small ops, which a step the host paces feels."""
    b = stages[0].shape[0]
    sizes = tuple(p.shape[1] for p in stages)
    points = torch.cat([p.reshape(-1, 3) for p in stages])
    keys, frame = layout_keys(points, b, sizes)
    skeys, perm = torch.sort(keys, stable=True)
    packed, codes, index, boxes = layout_pack(points, perm, skeys, b, sizes)
    rows, chunks = _segments(b, sizes)
    clouds = []
    for s, (p, n) in enumerate(zip(stages, sizes)):
        r = slice(rows[s * b], rows[(s + 1) * b])
        c = slice(chunks[s * b], chunks[(s + 1) * b])
        f = frame[s * b:(s + 1) * b, None]
        clouds.append(SortedCloud(packed[r].view(b, n, 4),
                                  boxes[c].view(b, -1, 6), codes[r].view(b, n),
                                  f[..., :3], f[..., 3:], index[r].view(b, n),
                                  _source(p)))
    return clouds


def sort_each(clouds) -> list:
    """The :class:`SortedCloud` of each cloud of ``clouds`` (a forward's
    stage clouds) by one :func:`sort_stages` over the distinct tensors
    among them: a stage that repeats the one before shares its layout.
    Made without gradient."""
    distinct = list({id(t): t for t in clouds}.values())
    with torch.no_grad():
        layouts = dict(zip(map(id, distinct), sort_stages(distinct)))
    return [layouts[id(t)] for t in clouds]


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


def index_bits(cloud: SortedCloud) -> torch.Tensor:
    """The (B, n) int32 indices of a layout's points in its sorted order (a
    view, 4 elements apart)."""
    return cloud.packed.view(torch.int32)[..., 3]


def check_order(order, b: int, n: int, device, name: str) -> None:
    """Raises unless ``order`` (None passes) is a (b, n) int32 tensor on
    ``device`` whose rows lie n elements apart (a stride within a row
    allowed), as the kernels that take points in a given order read it."""
    if order is not None and (
            order.shape != (b, n) or order.dtype != torch.int32
            or order.device != device or order.stride(1) < 1
            or (b > 1 and order.stride(0) != n * order.stride(1))):
        raise ValueError(f"{name} must be a ({b}, {n}) int32 tensor on "
                         f"{device} with rows {n} elements apart, got "
                         f"{tuple(order.shape)} {order.dtype} on {order.device} "
                         f"strides {order.stride()}")


def is_self(support: torch.Tensor, query: torch.Tensor) -> bool:
    """Whether ``query`` is ``support`` itself (the same elements), so the
    kernels take the self form of the ordering."""
    return (query.data_ptr() == support.data_ptr()
            and query.shape == support.shape
            and query.stride() == support.stride())


def check_layout(cloud: SortedCloud, support: torch.Tensor) -> None:
    """Raises unless ``cloud`` is the layout of ``support``: made from this
    tensor (its storage and its version, so not from another cloud of the
    same shape, nor from this one before an in-place change) and of its
    shape."""
    B, n, _ = support.shape
    nc = -(-n // CHUNK)
    if (tuple(cloud.packed.shape) != (B, n, 4)
            or tuple(cloud.boxes.shape) != (B, nc, 6)
            or cloud.packed.device != support.device):
        raise ValueError(f"the layout {tuple(cloud.packed.shape)} on "
                         f"{cloud.packed.device} is not one of a support of "
                         f"{tuple(support.shape)} on {support.device}")
    if cloud.source != _source(support):
        raise ValueError("the layout was made from another tensor than this "
                         "support, or before an in-place change to it")
