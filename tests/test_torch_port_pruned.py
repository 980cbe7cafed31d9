"""The chunk-pruned exact kNN (kernel 6, ``csrc/knn.cu``), ball query
(kernels 2 and 8, ``csrc/ball_query.cu``), CrossMask forward (kernel 18,
``csrc/refine.cu``, the kNN's listed scan) and contrast kernels (the
forward, 14, and both halves of the VJP, 15 and 16, ``csrc/contrast.cu``)
on the CPU.

All of them read one Morton-sorted layout of a stage cloud
(``ops/spatial.py``).  Here: the self-query order and home chunk, the
per-chunk maximum of a threshold, the soundness in float32 of every prune
rule (a block's union box against a chunk's box, then a point against the
chunk's box), and a small torch emulation of each kernel's visit schedule
that must return exactly what the dense twin returns.  The kernels
themselves run on the card (``test_torch_port_cuda.py``).
"""
from contextlib import ExitStack
from unittest import mock

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from amcontrast3d_tpu_torch import ops
from amcontrast3d_tpu_torch.ops import contrast as port_contrast
from amcontrast3d_tpu_torch.ops.knn import pairwise_d2
from amcontrast3d_tpu_torch.ops import spatial

CHUNK = spatial.CHUNK
WARPS = 8            # points a block: csrc/chunk_list.cuh::kListWarps
WINDOW = 256         # chunks a list window tests (a test-sized kListChunks)


def _cloud(rng, b, n, kind):
    """Uniform in [0, 4]³, tight Gaussian clusters, or a 1/128 m grid in a
    small cube: duplicate points and d² ties everywhere."""
    if kind == "uniform":
        return torch.from_numpy((rng.rand(b, n, 3) * 4).astype(np.float32))
    if kind == "clustered":
        centres = rng.rand(b, 8, 3) * 4
        pts = np.take_along_axis(centres, rng.randint(0, 8, (b, n))[..., None], 1)
        return torch.from_numpy((pts + 0.05 * rng.randn(b, n, 3)).astype(np.float32))
    return torch.from_numpy((rng.randint(0, 16, (b, n, 3)) / 128).astype(np.float32))


KINDS = ("uniform", "clustered", "grid")


def self_order(cloud):
    """:func:`spatial.query_order` for queries that are the support itself,
    as the kernels read it from the layout: the support's own permutation,
    and each query's home chunk its sorted position // ``CHUNK``."""
    B, n, _ = cloud.packed.shape
    home = torch.arange(n, dtype=torch.int32) // CHUNK
    return cloud.perm.to(torch.int32), home.expand(B, n).contiguous()


def box_box_lb(a, boxes):
    """``csrc/chunks.cuh::box_box_lower_bound``: per axis the gap
    ``max(lo_b − hi_a, lo_a − hi_b, 0)``, squared and summed as
    :func:`spatial.bbox_lb` sums them, between box(es) ``a`` (..., 6) and
    ``boxes`` (..., 6)."""
    gap = torch.maximum(boxes[..., :3] - a[..., 3:],
                        a[..., :3] - boxes[..., 3:]).clamp_min(0)
    gx, gy, gz = gap.unbind(-1)
    return (gx * gx + gy * gy) + gz * gz


def bbox_ub(q, boxes):
    """``csrc/chunks.cuh::box_upper_bound``: per axis the larger of
    |q − lo| and |q − hi|, squared and summed, for point(s) ``q`` (..., 3)."""
    gap = torch.maximum((q - boxes[..., :3]).abs(), (q - boxes[..., 3:]).abs())
    gx, gy, gz = gap.unbind(-1)
    return (gx * gx + gy * gy) + gz * gz


def _order(sup, query, cloud):
    """The queries' order and home chunks, as the kNN kernels take them."""
    if spatial.is_self(sup, query):
        return self_order(cloud)
    return spatial.query_order(query, cloud)


# ---- the layout ---------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", [1, 63, 64, 65, 1000])
def test_self_order_is_query_order_without_a_second_sort(kind, n):
    p = _cloud(np.random.RandomState(n), 2, n, kind)
    cloud = spatial.sort_support(p)
    order, home = self_order(cloud)
    q_order, q_home = spatial.query_order(p, cloud)
    assert order.dtype == home.dtype == torch.int32
    assert order.is_contiguous() and home.is_contiguous()
    # the support's own permutation: the stable sort of the same codes
    assert torch.equal(order, q_order)
    assert torch.equal(home, (torch.arange(n, dtype=torch.int32) // CHUNK)
                       .expand(2, n))
    # query_order takes the first chunk that holds the code: the same chunk
    # unless equal codes straddle a chunk edge, and never a later one
    first = torch.searchsorted(cloud.codes, cloud.codes)
    straddle = (first // CHUNK) != (torch.arange(n) // CHUNK)
    assert torch.equal(q_home[~straddle], home[~straddle])
    assert (q_home <= home).all()
    # the wrappers' dispatch: the same tensor is the self form, a copy is not
    assert spatial.is_self(p, p) and not spatial.is_self(p, p.clone())
    assert not spatial.is_self(p, p[:, :max(n - 1, 0)])


@pytest.mark.parametrize("kind", KINDS)
def test_sort_stages_gives_each_stage_its_layout(kind):
    """One sort for the stage clouds of a step: each layout is exactly what
    :func:`sort_support` gives its stage alone (its own frame, codes, order,
    boxes and index bits), contiguous, and tied to that stage's tensor."""
    rng = np.random.RandomState(11)
    p0 = _cloud(rng, 2, 1100, kind)
    stages = [p0, p0[:, ::4].contiguous(), p0[:, ::16], p0[:, :1]]
    clouds = spatial.sort_stages(stages)
    for p, cloud in zip(stages, clouds):
        spatial.check_layout(cloud, p)
        assert cloud.packed.is_contiguous() and cloud.boxes.is_contiguous()
        assert cloud.perm.is_contiguous() and cloud.codes.is_contiguous()
        want = spatial.sort_support(p)
        for field in ("packed", "boxes", "codes", "lo", "scale", "perm"):
            got, ref = getattr(cloud, field), getattr(want, field)
            assert got.shape == ref.shape and got.dtype == ref.dtype, field
            assert torch.equal(got, ref), field
        assert torch.equal(cloud.packed.view(torch.int32)[..., 3].long(),
                           cloud.perm)
    # the label propagation orders its queries in stage 0's frame
    order, home = spatial.query_order(stages[1], clouds[0])
    assert home.max() < clouds[0].boxes.shape[1]


@pytest.mark.parametrize("b,sizes", [(1, (1,)), (2, (64, 1)), (3, (130, 65, 7)),
                                     (2, (1000, 250, 62, 15))])
def test_layout_twins_segment_by_segment(b, sizes):
    """The twins of the two layout kernels (``csrc/layout.cu``): a segment
    is one cloud of one stage, its keys carry the segment's number above
    the Morton code in the segment's own frame, and the packing cuts every
    segment into its own chunks."""
    rng = np.random.RandomState(len(sizes))
    stages = [_cloud(rng, b, n, "clustered") for n in sizes]
    points = torch.cat([p.reshape(-1, 3) for p in stages])
    keys, frame = spatial.layout_keys(points, b, sizes)
    assert keys.shape == (points.shape[0],) and frame.shape == (b * len(sizes), 4)
    row = 0
    for s, p in enumerate(stages):
        for c in range(b):
            seg, n = s * b + c, p.shape[1]
            lo, scale = spatial.cloud_frame(p[c:c + 1])
            assert torch.equal(frame[seg], torch.cat([lo[0, 0], scale[0, 0]]))
            assert torch.equal(keys[row:row + n] >> 48, torch.full((n,), seg))
            assert torch.equal(keys[row:row + n] & ((1 << 48) - 1),
                               spatial.morton_key(p[c:c + 1], lo, scale)[0])
            row += n
    skeys, perm = torch.sort(keys, stable=True)
    packed, codes, index, boxes = spatial.layout_pack(points, perm, skeys, b, sizes)
    assert boxes.shape == (b * sum(-(-n // CHUNK) for n in sizes), 6)
    assert torch.equal(codes, skeys & ((1 << 48) - 1))
    assert torch.equal(packed[:, :3], points[perm])


def test_a_layout_is_refused_for_another_tensor():
    """A layout holds the tensor it was made from: another cloud of the
    same shape, or this one after an in-place change, is refused by
    :func:`spatial.check_layout` and by every wrapper that takes a layout,
    on the CPU as on the card."""
    rng = np.random.RandomState(3)
    p, other = _cloud(rng, 2, 200, "uniform"), _cloud(rng, 2, 200, "uniform")
    cloud = spatial.sort_support(p)
    spatial.check_layout(cloud, p)
    with pytest.raises(ValueError):
        spatial.check_layout(cloud, other)
    f = torch.nn.functional.normalize(torch.randn(2, 200, 8), dim=-1)
    lab = torch.from_numpy(rng.randint(0, 3, (2, 200)).astype(np.float32))
    kth = ops.knn_plain(other, other, 6)[1][..., -1]
    g4 = torch.randn(2, 200, 4)
    with pytest.raises(ValueError):
        ops.knn(other, other, 6, cloud)
    with pytest.raises(ValueError):
        ops.contrast_reductions(other, f, lab, kth, cloud=cloud)
    with pytest.raises(ValueError):
        ops.contrast_grad_support(other, f, lab, kth, g4, cloud=cloud)
    a = torch.rand(2, 200)
    ilab = lab.int()
    for call in (lambda: ops.ball_query(other, other, 0.2, 8, cloud),
                 lambda: ops.ball_query(p, other, 0.2, 8, cloud, cloud),
                 lambda: ops.dual_masks_cross(other, f, a, 6, "MIN", cloud),
                 lambda: ops.refine_cross(other, f, a, 6, "MIN", cloud=cloud),
                 lambda: ops.contrast_select(other, 6, cloud),
                 lambda: ops.contrast_reductions_selfk(other, f, lab, 6,
                                                       cloud=cloud),
                 lambda: ops.label_vote(other, ilab, p, 6, 3, cloud),
                 lambda: ops.label_vote(p, ilab, other, 6, 3, cloud, cloud)):
        with pytest.raises(ValueError):
            call()
    ops.knn(p, p, 6, cloud)
    ops.ball_query(p, p, 0.2, 8, cloud, cloud)
    ops.dual_masks_cross(p, f, a, 6, "MIN", cloud)
    ops.contrast_select(p, 6, cloud)
    ops.label_vote(p, ilab, p, 6, 3, cloud, cloud)
    p.add_(0.0)   # an in-place change, even one that moves no point
    for call in (lambda: ops.knn(p, p, 6, cloud),
                 lambda: ops.ball_query(p, p, 0.2, 8, cloud),
                 lambda: ops.dual_masks_cross(p, f, a, 6, "MIN", cloud),
                 lambda: ops.contrast_select(p, 6, cloud),
                 lambda: ops.label_vote(p, ilab, p, 6, 3, cloud)):
        with pytest.raises(ValueError):
            call()


@pytest.mark.parametrize("n", [1, 5, 63, 64, 65, 130, 1000])
def test_chunk_max_matches_brute_force(n):
    v = torch.from_numpy(np.random.RandomState(n).randn(3, n).astype(np.float32))
    got = spatial.chunk_max(v)
    nc = -(-n // CHUNK)
    assert got.shape == (3, nc)
    for b in range(3):
        for c in range(nc):
            assert got[b, c] == max(v[b, c * CHUNK:(c + 1) * CHUNK].tolist())


@pytest.mark.parametrize("seed", [0, 1])
def test_morton_key_by_table_is_the_bitwise_interleave(seed):
    """The table-driven key equals the bit-by-bit interleave of the three
    16-bit cell coordinates, on the frame's corners and in between."""
    rng = np.random.RandomState(seed)
    p = torch.from_numpy((rng.rand(2, 500, 3) * 7 - 2).astype(np.float32))
    p[:, :2] = torch.tensor([[-2.0, -2.0, -2.0], [5.0, 5.0, 5.0]])
    lo, scale = spatial.cloud_frame(p)
    cell = ((p - lo) * scale).long().clamp_(0, 2 ** 16 - 1)
    want = torch.zeros(2, 500, dtype=torch.int64)
    for bit in range(16):
        for axis in range(3):
            want |= ((cell[..., axis] >> bit) & 1) << (3 * bit + 2 - axis)
    assert torch.equal(spatial.morton_key(p, lo, scale), want)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", [7, 64, 200])
def test_support_layout_holds_sorted_labels_and_thresholds(kind, n):
    rng = np.random.RandomState(n)
    p = _cloud(rng, 2, n, kind)
    lab = torch.from_numpy(rng.randint(0, 5, (2, n)).astype(np.float32))
    kth = ops.knn_plain(p, p, min(n, 6))[1][..., -1] * (1.0 + 1e-5)
    cloud = spatial.sort_support(p)
    aux, cmax = port_contrast.support_layout(cloud, lab, kth)
    assert aux.shape == (2, n, 2) and aux.dtype == torch.float32
    perm = cloud.perm
    assert torch.equal(aux[..., 0], lab.gather(1, perm))
    assert torch.equal(aux[..., 1], kth.gather(1, perm))
    assert torch.equal(cmax, spatial.chunk_max(kth.gather(1, perm)))


def test_check_layout_refuses_another_clouds_layout():
    p = _cloud(np.random.RandomState(0), 2, 100, "uniform")
    cloud = spatial.sort_support(p)
    spatial.check_layout(cloud, p)
    for other in (p[:, :99], p[:1], p.new_zeros(2, 130, 3)):
        with pytest.raises(ValueError):
            spatial.check_layout(cloud, other)


# ---- soundness of the prune rules in float32 -------------------------------------

_coord = st.floats(-64, 64, width=32, allow_nan=False)
_points = st.lists(st.tuples(_coord, _coord, _coord), min_size=1, max_size=12)


@settings(max_examples=200, deadline=None)
@given(_points, st.tuples(_coord, _coord, _coord))
def test_box_upper_bound_is_never_below_a_true_distance(points, query):
    """In float32, as computed: the upper bound of a box is at or above the
    d² of every point of it, so the k-th nearest lies within the largest
    upper bound of chunks that hold k points (the kNN block's limit)."""
    pts = torch.tensor(points, dtype=torch.float32)[None]
    q = torch.tensor(query, dtype=torch.float32)[None, None]
    box = torch.cat([pts.amin(1), pts.amax(1)], -1)
    assert bbox_ub(q[0, 0], box[0]) >= pairwise_d2(q, pts).max()


@settings(max_examples=200, deadline=None)
@given(_points, _points)
def test_box_box_bound_never_exceeds_a_true_distance(a_pts, b_pts):
    """In float32, as computed: the bound between two boxes is at or below
    the d² of every pair of their points, so a block that skips a chunk
    whose bound is above the largest limit of its queries loses nothing."""
    a = torch.tensor(a_pts, dtype=torch.float32)[None]
    b = torch.tensor(b_pts, dtype=torch.float32)[None]
    box_a = torch.cat([a.amin(1), a.amax(1)], -1)
    box_b = torch.cat([b.amin(1), b.amax(1)], -1)
    lb = box_box_lb(box_a, box_b)[0]
    assert lb <= pairwise_d2(a, b).min()
    # a point is a box of no extent: the point bound is the same number
    assert torch.equal(box_box_lb(torch.cat([a[0, :1], a[0, :1]], -1),
                                          box_b),
                       spatial.bbox_lb(a[0, :1], box_b))


def _block_boxes(pts_sorted):
    """(B, ceil(n / 8), 6): the union box of each 8 consecutive points."""
    B, n, _ = pts_sorted.shape
    return spatial.chunk_boxes(pts_sorted, chunk=WARPS)


def _rank_of(cloud):
    """(B, n) int64: each point's place in the sorted order."""
    perm = cloud.perm
    rank = torch.empty_like(perm)
    rank.scatter_(1, perm, torch.arange(perm.shape[1]).expand_as(perm))
    return rank


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("m_step,k", [(1, 24), (1, 129), (3, 16)])
def test_knn_prune_rules_keep_every_true_neighbour(kind, m_step, k):
    """A query's limit, the largest upper bound to the chunks around its
    home when they hold k points, is never below its final k-th; and for
    every pair (query, one of its k nearest) the chunk that holds the
    neighbour passes the block's test (the union box of the 8 queries
    against the chunk's box, at most the largest limit of the 8) and the
    warp's own (the query against the box, at most its k-th; the running
    k-th a kernel tests against is never below the final one)."""
    rng = np.random.RandomState(7)
    sup = _cloud(rng, 2, 1500, kind)
    query = sup if m_step == 1 else sup[:, ::m_step].contiguous()
    cloud = spatial.sort_support(sup)
    order, home = _order(sup, query, cloud)
    idx, d2 = ops.knn_plain(sup, query, k)
    kth = d2[..., -1]
    B, M = order.shape
    nc = cloud.boxes.shape[1]
    q_sorted = torch.gather(query, 1, order.long()[..., None].expand(B, M, 3))
    # each query's limit from the boxes of its home chunk and the two beside
    lim = torch.full((B, M), float("inf"))
    for b in range(B):
        for r in range(M):
            lo, hi = max(0, int(home[b, r]) - 1), min(nc, int(home[b, r]) + 2)
            if min(1500, hi * CHUNK) - lo * CHUNK >= k:
                lim[b, r] = bbox_ub(q_sorted[b, r], cloud.boxes[b, lo:hi]).max()
    assert (lim >= torch.gather(kth, 1, order.long())).all()
    ub = _block_boxes(q_sorted)                              # (B, M/8, 6)
    limit = spatial.chunk_max(lim, chunk=WARPS)
    rank_q = torch.empty_like(order, dtype=torch.int64)
    rank_q.scatter_(1, order.long(), torch.arange(M).expand(B, M))
    chunk_of = _rank_of(cloud) // CHUNK                      # support → chunk
    nb_chunk = torch.gather(chunk_of, 1, idx.long().reshape(B, -1)).view(B, M, k)
    block = (rank_q // WARPS)[..., None].expand(B, M, k)
    boxes = torch.gather(cloud.boxes, 1,
                         nb_chunk.reshape(B, -1, 1).expand(B, M * k, 6))
    ubox = torch.gather(ub, 1, block.reshape(B, -1, 1).expand(B, M * k, 6))
    blim = torch.gather(limit, 1, block.reshape(B, -1)).view(B, M, k)
    assert (box_box_lb(ubox, boxes).view(B, M, k) <= blim).all()
    own = spatial.bbox_lb(query[:, :, None, :], boxes.view(B, M, k, 6))
    assert (own <= kth[..., None]).all()


@pytest.mark.parametrize("kind", KINDS)
def test_support_prune_rules_keep_every_member(kind):
    """For every member pair of the contrast (``d²_ij ≤ kth_i``, kth the
    k-th nearest d² of ``knn_plain`` with its 1e-5 cushion): the chunk that
    holds query i passes the block's test (the union box of the 8 support
    points j against the chunk's box, at most the chunk's largest
    threshold) and the warp's own (j against the box)."""
    rng = np.random.RandomState(8)
    p = _cloud(rng, 2, 1200, kind)
    kth = ops.knn_plain(p, p, 24)[1][..., -1] * (1.0 + 1e-5)
    cloud = spatial.sort_support(p)
    perm = cloud.perm
    cmax = spatial.chunk_max(kth.gather(1, perm))
    ub = _block_boxes(cloud.packed[..., :3])
    rank = _rank_of(cloud)
    d2 = pairwise_d2(p, p)                          # [b, i, j]
    n = p.shape[1]
    member = (d2 <= kth[..., None]) & ~torch.eye(n, dtype=torch.bool)
    b_i, i, j = member.nonzero(as_tuple=True)
    qchunk = rank[b_i, i] // CHUNK
    box = cloud.boxes[b_i, qchunk]
    assert (box_box_lb(ub[b_i, rank[b_i, j] // WARPS], box)
            <= cmax[b_i, qchunk]).all()
    assert (spatial.bbox_lb(p[b_i, j], box) <= cmax[b_i, qchunk]).all()


def _forward_rows_prune_holds(p, kth):
    """For every member pair (``d²_ij ≤ kth_i``, i ≠ j) of cloud p: the
    chunk that holds j passes the block's test (the union box of the 8
    queries around i in the sorted order against the chunk's box, at most
    the largest threshold of the 8) and the warp's own (i against the box,
    at most kth_i)."""
    cloud = spatial.sort_support(p)
    B, n, _ = p.shape
    ub = _block_boxes(cloud.packed[..., :3])
    limit = spatial.chunk_max(kth.gather(1, cloud.perm), chunk=WARPS)
    rank = _rank_of(cloud)
    member = (pairwise_d2(p, p) <= kth[..., None]) & ~torch.eye(n, dtype=torch.bool)
    b_i, i, j = member.nonzero(as_tuple=True)
    block = rank[b_i, i] // WARPS
    box = cloud.boxes[b_i, rank[b_i, j] // CHUNK]
    assert (box_box_lb(ub[b_i, block], box) <= limit[b_i, block]).all()
    assert (spatial.bbox_lb(p[b_i, i], box) <= kth[b_i, i]).all()
    return len(i)


@pytest.mark.parametrize("kind", KINDS)
def test_forward_rows_prune_rules_keep_every_member(kind):
    """The forward's and the rows half's rules keep every member of the
    contrast, kth the k-th nearest d² of ``knn_plain`` with its 1e-5
    cushion, on uniform, clustered and 1/128 m grid clouds."""
    rng = np.random.RandomState(9)
    p = _cloud(rng, 2, 1200, kind)
    kth = ops.knn_plain(p, p, 24)[1][..., -1] * (1.0 + 1e-5)
    assert _forward_rows_prune_holds(p, kth) >= 2 * 1200 * 23


@settings(max_examples=100, deadline=None)
@given(st.lists(st.tuples(_coord, _coord, _coord), min_size=1, max_size=150),
       st.lists(st.floats(0, 4096, width=32), min_size=150, max_size=150))
def test_forward_rows_prune_rules_hold_for_any_points_and_thresholds(points, thr):
    """In float32, as computed, for any points and any thresholds: no
    member pair is lost to either test."""
    p = torch.tensor(points, dtype=torch.float32)[None]
    kth = torch.tensor(thr[:p.shape[1]], dtype=torch.float32)[None]
    _forward_rows_prune_holds(p, kth)


# ---- each kernel's visit schedule, emulated ----------------------------------------

def _keys(d2_row, idx):
    """(d², index) pairs as one int64 each, ordered as the kernels order."""
    return (d2_row.view(torch.int32).to(torch.int64) << 32) | idx


def _emulate_knn(sup, query, k, window, query_layout=False):
    """``csrc/knn.cu``'s visits, one batch at a time: blocks of 8 queries in
    the support's Morton order (with ``query_layout``, as
    ``csrc/interpolate.cu`` takes them: in the order of the queries' own
    layout, each query's home chunk from its Morton code in the support's
    frame).  The block lists the chunks whose box is
    within the largest upper bound of any query to the chunks around its
    home (when they hold k points) from the union box of the 8, a window of
    chunks at a time; each query then scans its home chunk and the ones
    beside it, and the listed chunks whose box is within its own running
    k-th, testing 32 at a time.  Returns (idx, d2) and the chunks scanned."""
    cloud = spatial.sort_support(sup)
    if query_layout:
        order = spatial.sort_support(query).perm
        home = torch.gather(_home_of(query, cloud), 1, order)
    else:
        order, home = _order(sup, query, cloud)
    B, N, _ = sup.shape
    M = query.shape[1]
    nc = cloud.boxes.shape[1]
    kk = min(k, N)
    perm = cloud.perm
    out_i = torch.zeros(B, M, k, dtype=torch.int32)
    out_d = torch.full((B, M, k), 1e10)
    scanned = 0
    for b in range(B):
        d2 = pairwise_d2(query[b:b + 1], cloud.packed[b:b + 1, :, :3])[0]
        boxes = cloud.boxes[b]
        for r0 in range(0, M, WARPS):
            ranks = range(r0, min(r0 + WARPS, M))
            qs = [int(order[b, r]) for r in ranks]
            best = {qi: torch.empty(0, dtype=torch.int64) for qi in qs}
            near, limit = {}, []
            for r, qi in zip(ranks, qs):
                h = int(home[b, r])
                near[qi] = (h, range(max(0, h - 1), min(nc, h + 2)))
                held = min(N, near[qi][1].stop * CHUNK) - near[qi][1].start * CHUNK
                limit.append(float(bbox_ub(
                    query[b, qi], boxes[near[qi][1].start:near[qi][1].stop]).max())
                    if held >= k else float("inf"))

            def scan(qi, c):
                pos = torch.arange(c * CHUNK, min((c + 1) * CHUNK, N))
                keys = _keys(d2[qi, pos], perm[b, pos])
                best[qi] = torch.cat([best[qi], keys]).sort().values[:kk]

            def kth(qi):
                if len(best[qi]) < kk:
                    return float("inf")
                return float((best[qi][-1] >> 32).to(torch.int32).view(torch.float32))

            pts = query[b, qs]
            ub = torch.cat([pts.amin(0), pts.amax(0)])
            done = set.intersection(*(set(near[qi][1]) for qi in qs))
            for w0 in range(0, nc, window):
                cand = [c for c in range(w0, min(w0 + window, nc)) if c not in done]
                listed = [c for c in cand if box_box_lb(ub, boxes[c]) <= max(limit)]
                for qi in qs:
                    h, around = near[qi]
                    if w0 == 0:
                        for c in [h] + [x for d in range(1, len(around))
                                        for x in (h - d, h + d) if x in around]:
                            scan(qi, c)
                            scanned += 1
                    for g0 in range(0, len(listed), 32):
                        group = [c for c in listed[g0:g0 + 32] if c not in around]
                        lb = {c: float(spatial.bbox_lb(query[b, qi], boxes[c])) for c in group}
                        thr = kth(qi)
                        for c in [c for c in group if lb[c] <= thr]:
                            if lb[c] <= kth(qi):
                                scan(qi, c)
                                scanned += 1
            for qi in qs:
                keys = best[qi]
                out_i[b, qi, :kk] = (keys & 0xFFFFFFFF).to(torch.int32)
                out_d[b, qi, :kk] = (keys >> 32).to(torch.int32).view(torch.float32)
    return out_i, out_d, scanned


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,m_step,k,window", [
    (700, 1, 24, WINDOW), (700, 1, 24, 2), (700, 3, 16, 3), (40, 1, 64, WINDOW),
    (129, 2, 4, 1)])
def test_knn_visit_schedule_returns_the_dense_answer(kind, n, m_step, k, window):
    """The emulated schedule gives ``knn_plain``'s indices and d² exactly
    (k > N pads as the twin does) and, on a cloud of 11 chunks, scans fewer
    chunks than a dense scan would."""
    rng = np.random.RandomState(n + k)
    sup = _cloud(rng, 2, n, kind)
    query = sup if m_step == 1 else sup[:, ::m_step].contiguous()
    got_i, got_d, scanned = _emulate_knn(sup, query, k, window)
    want_i, want_d = ops.knn_plain(sup, query, k)
    assert torch.equal(got_i, want_i)
    assert torch.equal(got_d, want_d)
    dense = 2 * query.shape[1] * -(-n // CHUNK)
    if n >= 700 and kind != "grid":
        assert scanned < dense, (scanned, dense)


def _visits(p, kth, window, own):
    """``csrc/contrast.cu::for_each_member``, one batch at a time: blocks of
    8 points in the sorted order; windows of chunks, each tested once
    against the block's union box and a limit, then the listed ones against
    each point of the block; in each chunk that passes, the exact member
    test per point.  ``own`` (the forward, the rows half): the limits and
    the member test take the point's own threshold (the block: the largest
    of its 8); else (the support half) the other point's (a chunk: its
    largest).  Returns {(b, point): its members in visit order (chunk
    order, then the sorted order within a chunk)}."""
    cloud = spatial.sort_support(p)
    perm = cloud.perm
    B, N, _ = p.shape
    nc = cloud.boxes.shape[1]
    cmax = spatial.chunk_max(kth.gather(1, perm))
    chunk_of = torch.arange(N) // CHUNK
    visits = {}
    for b in range(B):
        sorted_d2 = pairwise_d2(p[b:b + 1], cloud.packed[b:b + 1, :, :3])[0]
        sorted_kth = kth[b, perm[b]]
        for r0 in range(0, N, WARPS):
            ranks = torch.arange(r0, min(r0 + WARPS, N))
            ms = perm[b, ranks]
            pts = p[b, ms]
            ub = torch.cat([pts.amin(0), pts.amax(0)])
            keep = torch.zeros(len(ms), nc, dtype=torch.bool)
            for w0 in range(0, nc, window):
                cand = torch.arange(w0, min(w0 + window, nc))
                lim = kth[b, ms].max() if own else cmax[b, cand]
                listed = cand[~(box_box_lb(ub, cloud.boxes[b, cand]) > lim)]
                lim = kth[b, ms, None] if own else cmax[b, listed][None]
                lb = spatial.bbox_lb(pts[:, None], cloud.boxes[b, listed][None])
                keep[:, listed] = ~(lb > lim)
            thr = kth[b, ms, None] if own else sorted_kth[None]
            member = (keep[:, chunk_of] & (sorted_d2[ms] <= thr)
                      & (torch.arange(N)[None] != ranks[:, None]))
            for m, row in zip(ms.tolist(), member):
                visits[b, m] = perm[b, row.nonzero()[:, 0]]
    return visits


def _pairs(visits, own):
    """The (b, i, j) member pairs of a schedule, i the query."""
    return {(b, m, int(o)) if own else (b, int(o), m)
            for (b, m), mem in visits.items() for o in mem}


def _dense_pairs(p, kth):
    n = p.shape[1]
    member = (pairwise_d2(p, p) <= kth[..., None]) & ~torch.eye(n, dtype=torch.bool)
    return {tuple(int(v) for v in t) for t in member.nonzero()}


def _weights(s, pos, g, tinv, need_s):
    w = torch.where(pos, g[..., 0], g[..., 1]) * torch.exp(s * tinv) * tinv
    return w + torch.where(pos, g[..., 2], g[..., 3]) if need_s else w


def _emulate_support(p, f, lab, kth, g4, tinv, need_s, window):
    """The support kernel's sums over its schedule: df (B, N, C) and the
    member pairs (b, i, j)."""
    visits = _visits(p, kth, window, own=False)
    df = torch.zeros(f.shape)
    for (b, j), mem in visits.items():
        w = _weights(f[b, mem] @ f[b, j], lab[b, mem] == lab[b, j], g4[b, mem],
                     tinv, need_s)
        for t in range(len(mem)):    # chunk order, lane order
            df[b, j] += w[t] * f[b, mem[t]]
    return df, _pairs(visits, own=False)


def _stage_case(kind, n):
    """A cloud of ``kind``, unit features (C = 8), 4 labels, the kNN
    threshold (24 with self, 1e-5 cushion) and incoming gradients."""
    rng = np.random.RandomState(n)
    p = _cloud(rng, 2, n, kind)
    f = torch.nn.functional.normalize(
        torch.from_numpy(rng.randn(2, n, 8).astype(np.float32)), dim=-1)
    lab = torch.from_numpy(rng.randint(0, 4, (2, n)).astype(np.float32))
    kth = ops.knn_plain(p, p, min(n, 24))[1][..., -1] * (1.0 + 1e-5)
    g4 = torch.from_numpy(rng.randn(2, n, 4).astype(np.float32))
    return p, f, lab, kth, g4


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,window,need_s", [(600, WINDOW, True), (600, 3, False),
                                             (70, WINDOW, True), (9, 1, True)])
def test_support_visit_schedule_returns_the_dense_answer(kind, n, window, need_s):
    """The emulated schedule visits exactly the dense member pairs and sums
    to ``contrast_grad_support_plain`` within 1e-5·(1+max|df|) (the order of
    the sums differs)."""
    p, f, lab, kth, g4 = _stage_case(kind, n)
    got, pairs = _emulate_support(p, f, lab, kth, g4, 1 / 0.3, need_s, window)
    assert pairs == _dense_pairs(p, kth)
    want = ops.contrast_grad_support_plain(p, f, lab, kth, g4, 1 / 0.3, need_s)
    err = (got - want).abs().max().item()
    assert err <= 1e-5 * (1 + want.abs().max().item()), err


_QUERY_CASES = [(600, WINDOW, True, False), (600, 3, False, True),
                (70, WINDOW, True, True), (9, 1, False, False)]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,window,need_s,root", _QUERY_CASES)
def test_forward_visit_schedule_returns_the_dense_answer(kind, n, window, need_s,
                                                         root):
    """The forward's emulated schedule visits exactly the dense member pairs;
    its counts and column 8 are ``contrast_forward_plain``'s exactly, its
    sums within 1e-5·(1+max) (the order of the sums differs)."""
    p, f, lab, kth, _ = _stage_case(kind, n)
    tinv = 1 / 0.3
    visits = _visits(p, kth, window, own=True)
    assert _pairs(visits, own=True) == _dense_pairs(p, kth)
    got = torch.zeros(2, n, 9)
    for (b, i), mem in visits.items():
        s = f[b, mem] @ f[b, i]
        e = torch.exp(s * tinv)
        d2 = pairwise_d2(p[b, i][None, None], p[b, mem][None])[0, 0]
        dt = torch.sqrt(d2.abs() + 1e-12) if root else d2
        pos = lab[b, mem] == lab[b, i]
        for col, v in ((0, e), (2, s if need_s else 0 * s),
                       (4, torch.ones_like(s)), (6, dt)):
            got[b, i, col] = torch.where(pos, v, 0.0).sum()
            got[b, i, col + 1] = torch.where(pos, 0.0, v).sum()
        got[b, i, 8] = kth[b, i]
    want = ops.contrast_forward_plain(p, f, lab, kth, tinv, root, need_s, True)
    assert torch.equal(got[..., 4:6], want[..., 4:6])
    assert torch.equal(got[..., 8], want[..., 8])
    for col in (0, 1, 2, 3, 6, 7):
        err = (got[..., col] - want[..., col]).abs().max().item()
        assert err <= 1e-5 * (1 + want[..., col].abs().max().item()), (col, err)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,window,need_s,root", _QUERY_CASES)
def test_rows_visit_schedule_returns_the_dense_answer(kind, n, window, need_s,
                                                      root):
    """The rows half's emulated schedule (the forward's) visits exactly the
    dense member pairs and sums to ``contrast_grad_rows_plain`` within
    1e-5·(1+max|df|)."""
    p, f, lab, kth, g4 = _stage_case(kind, n)
    visits = _visits(p, kth, window, own=True)
    assert _pairs(visits, own=True) == _dense_pairs(p, kth)
    got = torch.zeros(f.shape)
    for (b, i), mem in visits.items():
        w = _weights(f[b, mem] @ f[b, i], lab[b, mem] == lab[b, i], g4[b, i],
                     1 / 0.3, need_s)
        for t in range(len(mem)):    # chunk order, lane order
            got[b, i] += w[t] * f[b, mem[t]]
    want = ops.contrast_grad_rows_plain(p, f, lab, kth, g4, 1 / 0.3, need_s)
    err = (got - want).abs().max().item()
    assert err <= 1e-5 * (1 + want.abs().max().item()), err


def test_forward_twin_sums_members_in_the_kernels_visit_order():
    """``contrast_forward_plain`` sums each point's members one at a time in
    float32, in the forward kernel's visit order (the cloud's Morton curve),
    so a point with thousands of members (fewer than k distinct d²: every
    other point, at a threshold of 3e38) rounds as the kernel does: the
    twin equals the emulated schedule's sequential sums bit for bit, where
    the members' terms are exact (a 1/4 grid, features ±1 at C = 1)."""
    rng = np.random.RandomState(31)
    p = torch.from_numpy((rng.randint(0, 4, (2, 600, 3)) / 4).astype(np.float32))
    f = torch.from_numpy(np.sign(rng.randn(2, 600, 1)).astype(np.float32))
    lab = torch.from_numpy(rng.randint(0, 5, (2, 600)).astype(np.float32))
    for k in (40, 8):            # too few distinct d², then enough
        kth = ops.contrast_select_plain(p, k)
        assert bool((kth > 1e38).all()) == (k == 40)
        tinv = 1 / 0.3
        want = ops.contrast_forward_plain(p, f, lab, kth, tinv, False, True, True)
        visits = _visits(p, kth, WINDOW, own=True)
        for (b, i), mem in visits.items():
            s = (f[b, mem] * f[b, i]).sum(-1)
            terms = (torch.exp(s * tinv), s,
                     pairwise_d2(p[b, i][None, None], p[b, mem][None])[0, 0])
            pos = (lab[b, mem] == lab[b, i]).numpy()
            for col, v in zip((0, 2, 6), terms):
                v = v.numpy()
                for side, keep in ((0, pos), (1, ~pos)):
                    # one float32 add a member in chunk order, lane order
                    # (numpy's accumulate is sequential in the array's
                    # dtype; a member of the other side adds an exact 0)
                    acc = np.add.accumulate(np.concatenate(
                        [np.zeros(1, np.float32),
                         np.where(keep, v, np.float32(0))]))[-1]
                    assert want[b, i, col + side].item() == acc, (k, b, i, col)


# ---- the ball query: prune rules and visit schedule ------------------------------

def _ball_orders(sup, query, form):
    """The order the ball query works the queries in: the support's own
    sorted order (the self form), the queries' own layout (a set
    abstraction, the encoder's), or ``spatial.query_order``."""
    if form == "self":
        return spatial.sort_support(sup).perm
    if form == "query layout":
        return spatial.sort_support(query).perm
    return spatial.query_order(query, spatial.sort_support(sup))[0].long()


def _ball_prune_holds(sup, query, r2, form):
    """For every hit (query i, support j, d² < r², r² a float32): the chunk
    that holds j passes the block's test (the union box of the 8 queries
    around i in the work order against the chunk's box, below r²) and the
    warp's own (i against the box, below r²).  Returns the hits."""
    cloud = spatial.sort_support(sup)
    order = _ball_orders(sup, query, form)
    B, M, _ = query.shape
    q_sorted = torch.gather(query, 1, order[..., None].expand(B, M, 3))
    ub = _block_boxes(q_sorted)
    rank_q = torch.empty_like(order)
    rank_q.scatter_(1, order, torch.arange(M).expand(B, M))
    hit = pairwise_d2(query, sup) < r2
    b_i, i, j = hit.nonzero(as_tuple=True)
    box = cloud.boxes[b_i, _rank_of(cloud)[b_i, j] // CHUNK]
    assert (box_box_lb(ub[b_i, rank_q[b_i, i] // WARPS], box) < r2).all()
    assert (spatial.bbox_lb(query[b_i, i], box) < r2).all()
    return len(i)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("form", ["self", "query layout", "query order"])
def test_ball_query_prune_rules_keep_every_hit(kind, form):
    """The listed ball query's two tests keep every hit, on uniform,
    clustered and 1/128 m grid clouds, with r² at exact tie values (the
    grid's d² themselves, where a point at r² is no hit and one a grid step
    closer is) and between them."""
    rng = np.random.RandomState(12)
    sup = _cloud(rng, 2, 1500, kind)
    query = sup if form == "self" else sup[:, ::3].contiguous()
    d2 = pairwise_d2(query[:, :50], sup).unique()
    ties = [float(d2[len(d2) // 8]), float(d2[len(d2) // 3])]
    hits = 0
    for r2 in ties + [float(np.float32(0.1 * 0.1)), float(np.float32(0.3 * 0.3)),
                      float(np.nextafter(np.float32(ties[0]), np.float32(0)))]:
        hits += _ball_prune_holds(sup, query, r2, form)
    assert hits > 0


@settings(max_examples=100, deadline=None)
@given(st.lists(st.tuples(_coord, _coord, _coord), min_size=1, max_size=120),
       st.floats(0, 8192, width=32))
def test_ball_query_prune_rules_hold_for_any_points_and_radius(points, r2):
    """In float32, as computed, for any points and any r²: no hit is lost
    to either test, in every order of the queries."""
    p = torch.tensor(points, dtype=torch.float32)[None]
    for form in ("self", "query layout", "query order"):
        _ball_prune_holds(p, p if form == "self" else p.flip(1).contiguous(),
                          r2, form)


def _emulate_ball(sup, query, r2, k, window, form):
    """``csrc/ball_query.cu``'s visits, one batch at a time, in passes of
    128 slots: blocks of 8 queries in the work order; a window of chunks at
    a time, each tested once against the block's union box and r², then
    the listed ones against each query; each query keeps the k smallest
    original indices among the hits of the chunks it scans (in a later
    pass only those after the previous pass's last slot, unless that slot
    was padding), pads with the row's first hit, or 0.  Returns the (B, M,
    k) indices and the chunks scanned."""
    cloud = spatial.sort_support(sup)
    order = _ball_orders(sup, query, form)
    B, N, _ = sup.shape
    M = query.shape[1]
    nc = cloud.boxes.shape[1]
    perm = cloud.perm
    out = torch.zeros(B, M, k, dtype=torch.int32)
    scanned = 0
    for first in range(0, k, 128):
        kk = min(128, k - first)
        for b in range(B):
            d2 = pairwise_d2(query[b:b + 1], cloud.packed[b:b + 1, :, :3])[0]
            boxes = cloud.boxes[b]
            for r0 in range(0, M, WARPS):
                qs = order[b, r0:r0 + WARPS].tolist()
                pts = query[b, qs]
                ub = torch.cat([pts.amin(0), pts.amax(0)])
                for qi in qs:
                    row = out[b, qi]
                    pad = int(row[0]) if first else 0
                    more = not first or int(row[first - 1]) != pad
                    kept = []
                    for w0 in range(0, nc, window):
                        listed = [c for c in range(w0, min(w0 + window, nc))
                                  if box_box_lb(ub, boxes[c]) < r2]
                        if not more:
                            continue
                        for c in listed:
                            if spatial.bbox_lb(query[b, qi], boxes[c]) < r2:
                                scanned += 1
                                pos = torch.arange(c * CHUNK, min((c + 1) * CHUNK, N))
                                hit = pos[d2[qi, pos] < r2]
                                kept += [int(perm[b, h]) for h in hit
                                         if not first or int(perm[b, h]) > int(row[first - 1])]
                    kept = sorted(kept)[:kk]
                    if not first:
                        pad = kept[0] if kept else 0
                    row[first:first + kk] = torch.tensor(
                        kept + [pad] * (kk - len(kept)), dtype=torch.int32)
    return out, scanned


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,m_step,r,k,window,form", [
    (700, 1, 0.3, 32, WINDOW, "self"),            # uniform: underfull balls
    (700, 3, 0.5, 16, 2, "query layout"),         # overfull, small windows
    (700, 2, 0.4, 24, WINDOW, "query order"),
    (200, 1, 9.0, 300, WINDOW, "self"),           # k > N: passes, padding
    (300, 1, 9.0, 129, 3, "query layout"),        # a second pass of 1 slot
    (40, 1, 0.2, 64, 1, "self"),                  # N < 64: one chunk
    (129, 2, 1e-4, 8, WINDOW, "query order")])    # near-empty balls
def test_ball_query_visit_schedule_returns_the_dense_answer(kind, n, m_step, r,
                                                            k, window, form):
    """The emulated schedule gives ``ball_query_plain``'s indices exactly:
    the first k hits in index order, the row padded with its first hit, an
    empty ball all 0, k > hits and k > N, duplicate points (the grid), a
    last chunk that is not full; and on a cloud of 11 chunks at a small
    radius it scans fewer chunks than a dense scan would."""
    rng = np.random.RandomState(n + k)
    sup = _cloud(rng, 2, n, kind)
    query = sup if m_step == 1 else sup[:, ::m_step].contiguous()
    query = query.clone() if form != "self" else query
    if form != "self":
        query[:, 0] += 50.0                       # an empty ball
    r2 = float(np.float32(r * r))
    got, scanned = _emulate_ball(sup, query, r2, k, window, form)
    want = ops.ball_query_plain(sup, query, r, k)
    assert torch.equal(got, want)
    if n >= 700 and kind == "uniform" and r < 0.5:
        assert scanned < 2 * query.shape[1] * -(-n // CHUNK), scanned


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,k", [(300, 12), (40, 12), (9, 12), (200, 40)])
def test_crossmask_slots_from_the_listed_scan_are_the_knn(kind, n, k):
    """Kernel 18's self-kNN is kernel 6's listed scan: its slots (the
    emulated schedule, k counting the point itself, k > N padded with index
    0) are ``knn_plain``'s, so the selection that ``refine_cross_plain``
    makes from them (MIN: the slot of least ambiguity, ties to the first;
    MIN_ALL0: the members with a ≤ 0) is the kernel's."""
    rng = np.random.RandomState(n + k)
    p = _cloud(rng, 2, n, kind)
    idx, d2, _ = _emulate_knn(p, p, k, WINDOW)
    want_i, want_d = ops.knn_plain(p, p, k)
    assert torch.equal(idx, want_i) and torch.equal(d2, want_d)
    f = torch.from_numpy(rng.randn(2, n, 5).astype(np.float32))
    a = torch.from_numpy(np.where(rng.rand(2, n) < 0.4, 0.0,
                                  np.round(rng.rand(2, n) * 4) / 4)
                         .astype(np.float32))
    slots = idx[..., 1:].long()
    na = torch.gather(a, 1, slots.reshape(2, -1)).view(slots.shape)
    _, sel_min = ops.refine_cross_plain(p, f, a, k, "MIN")
    assert torch.equal(sel_min[..., 0].long(),
                       torch.gather(slots, -1, na.argmin(-1, keepdim=True))[..., 0])
    _, sel_all0 = ops.refine_cross_plain(p, f, a, k, "MIN_ALL0")
    assert torch.equal(sel_all0.long(), torch.where(na <= 0, slots, -1))


# ---- the interpolation: the listed 3-NN scan and the layout-ordered scatter ------

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n1,n2,outside", [(700, 175, False), (700, 175, True),
                                           (300, 65, False), (200, 64, False),
                                           (50, 3, False), (50, 2, False),
                                           (9, 1, True)])
def test_interpolation_schedule_returns_the_plain_neighbours(kind, n1, n2, outside):
    """Kernel 3's scan is kernel 6's listed scan at k = 3, the fine points
    taken along their own layout's curve, each one's home chunk found from
    its Morton code in the coarse cloud's frame: the emulated schedule
    gives ``knn_plain``'s three neighbours and d² exactly (n2 < 3 padded
    with index 0 at 1e10, as the kernel's fillers), with fine points
    outside the coarse cloud's box too, so the weights are the twin's."""
    rng = np.random.RandomState(n1 + n2)
    p1 = _cloud(rng, 2, n1, kind)
    p2 = p1[:, ::max(1, n1 // n2)][:, :n2].contiguous()
    if outside:   # stretch the fine cloud beyond the coarse box
        p1 = torch.cat([p1, p1 * 1.5 - 0.5], 1)[:, ::2].contiguous()
    idx, d2, _ = _emulate_knn(p2, p1, 3, WINDOW, query_layout=True)
    want_i, want_d = ops.knn_plain(p2, p1, 3)
    assert torch.equal(idx, want_i) and torch.equal(d2, want_d)
    got_i, _ = ops.three_interpolation_weights(p1, p2)
    assert torch.equal(got_i, want_i)


def _emulate_scatter(grad, idx, w, n2, order, points=64):
    """``csrc/interpolate.cu``'s backward: blocks of ``points`` fine points
    taken in ``order``; a block sorts its pairs by (coarse row, rank), sums
    each row's w·g in that order and adds the sum into df2 once.  Returns
    df2 and the rows added (the vector reductions over C / 4)."""
    B, N1, C = grad.shape
    df2 = torch.zeros(B, n2, C)
    added = 0
    for b in range(B):
        for r0 in range(0, N1, points):
            fine = order[b, r0:r0 + points].long()
            rows = idx[b, fine].reshape(-1).long()          # pair t: (t // 3, t % 3)
            rank = torch.arange(len(rows))
            key = rows * len(rows) + rank
            sorted_t = rank[torch.argsort(key)]
            for row in rows[sorted_t].unique_consecutive():
                ts = sorted_t[rows[sorted_t] == row]
                acc = torch.zeros(C)
                for t in ts.tolist():
                    acc = acc + w[b, fine[t // 3], t % 3] * grad[b, fine[t // 3]]
                df2[b, row] += acc
                added += 1
    return df2, added


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n1,c", [(700, 8), (130, 3)])
def test_interpolation_backward_schedule_sums_each_row_once_a_block(kind, n1, c):
    """Kernel 9's scatter: blocks of 64 fine points along the fine layout's
    curve, each coarse row's pairs summed in the block and added once, give
    the twin's ``index_add_`` within 1e-5·(1+max); in the layout's order a
    block's 192 pairs fall on fewer rows than in the caller's order, so the
    reductions fall."""
    rng = np.random.RandomState(n1 + c)
    p1 = _cloud(rng, 2, n1, kind)
    p2 = p1[:, ::4].contiguous()
    idx, w = ops.three_interpolation_weights(p1, p2)
    g = torch.from_numpy(rng.randn(2, n1, c).astype(np.float32))
    want = ops.three_interpolation_backward_plain(g, idx, w, p2.shape[1])
    along = spatial.sort_support(p1).perm
    got, added = _emulate_scatter(g, idx, w, p2.shape[1], along)
    err = (got - want).abs().max()
    assert err <= 1e-5 * (1 + want.abs().max()), err
    caller = torch.arange(n1).expand(2, n1)
    _, added_caller = _emulate_scatter(g, idx, w, p2.shape[1], caller)
    assert added < 3 * 2 * n1
    if n1 >= 700 and kind == "uniform":
        assert added < added_caller, (added, added_caller)


# ---- the selection and the vote: seed, list, passes -----------------------------

_SLACK = np.float32(1.0 + 1e-6)


@settings(max_examples=200, deadline=None)
@given(st.lists(st.tuples(_coord, _coord, _coord), min_size=1, max_size=80),
       st.tuples(_coord, _coord, _coord), st.integers(1, 40),
       st.lists(st.booleans(), min_size=80, max_size=80))
def test_seed_limit_is_never_below_the_true_kth_distinct(points, query, k, keep):
    """The selection's seed limit: the k-th distinct d² over any subset of
    the support that holds k distinct values (the chunks a warp scans
    first) is never below the k-th distinct d² over the whole support, in
    float32 as computed."""
    p = torch.tensor(points, dtype=torch.float32)[None]
    q = torch.tensor(query, dtype=torch.float32)[None, None]
    d2 = pairwise_d2(q, p)[0, 0]
    sub = d2[torch.tensor(keep[:len(points)])].unique()
    if len(sub) >= k:
        want = port_contrast.kth_distinct_plain(p, q, k)[0, 0]
        assert float(np.float32(sub[k - 1]) * _SLACK) >= float(want)


def _home_of(query, cloud):
    """``csrc/vote.cu::home_chunk``: the chunk of the support where each
    query's Morton code in the support's frame would sit (B, M)."""
    key = spatial.morton_key(query, cloud.lo, cloud.scale)
    n = cloud.codes.shape[1]
    place = torch.searchsorted(cloud.codes, key).clamp_(max=n - 1)
    return place // CHUNK


def _seed(d2row, home, kp, done, lo, nc, scans):
    """The seed of one warp in one pass: the home chunk and ``near`` on
    each side, then further out, up to ``reach``, while fewer than kp
    distinct values above lo are kept.  Returns its state (the kept values,
    the last slot: inf until kp are kept), its scan and the chunks it
    scanned, [slo, shi)."""
    state = {"kept": torch.empty(0), "last": float("inf")}

    def scan(c):
        scans[0] += 1
        vals = d2row[c * CHUNK:(c + 1) * CHUNK]
        cand = vals[(vals > lo) & (vals < state["last"])]
        kept = torch.cat([state["kept"], cand]).unique()[:kp]
        state["kept"] = kept
        state["last"] = float(kept[kp - 1]) if len(kept) == kp else float("inf")

    near = 1 + done // CHUNK
    reach = near + 1 + kp // CHUNK
    reach_lo, reach_hi = max(0, home - reach), min(nc, home + reach + 1)

    def more(d):
        return d <= near or state["last"] == float("inf")

    scan(home)
    slo, shi, d = home, home + 1, 1
    while more(d) and (home - d >= reach_lo or home + d < reach_hi):
        if home - d >= reach_lo:
            scan(home - d)
            slo = home - d
        if more(d) and home + d < reach_hi:
            scan(home + d)
            shi = home + d + 1
        d += 1
    return state, scan, (slo, shi)


def _emulate_select(sup, query, k, window, form):
    """``csrc/listed_select.cuh``'s visits, one batch at a time: blocks of
    8 queries in the work order (the support's own sorted order, home its
    place over 64; or the queries' own layout, home from ``_home_of``); in
    each pass of up to 128 values above the previous pass's last, each
    query scans its home chunk and the ones beside it (:func:`_seed`; with
    fewer than kp distinct values its limit is +inf), the block lists a window of
    chunks at a time within the largest limit of its 8 from their union box,
    and each query scans the listed chunks within its own running last
    value, testing 32 at a time.  Returns the thresholds (B, M) in the
    caller's order (× float32(1 + 1e-6), 3e38 for fewer than k distinct),
    the work order and the chunks scanned."""
    cloud = spatial.sort_support(sup)
    B, N, _ = sup.shape
    M = query.shape[1]
    nc = cloud.boxes.shape[1]
    if form == "self":
        order = cloud.perm
        home = (torch.arange(N) // CHUNK).expand(B, N)
    else:
        order = spatial.sort_support(query).perm
        home = torch.gather(_home_of(query, cloud), 1, order)
    out = torch.zeros(B, M)
    scans = [0]
    inf = float("inf")
    for b in range(B):
        d2 = pairwise_d2(query[b:b + 1], cloud.packed[b:b + 1, :, :3])[0]
        boxes = cloud.boxes[b]
        for r0 in range(0, M, WARPS):
            qs = order[b, r0:r0 + WARPS].tolist()
            homes = home[b, r0:r0 + WARPS].tolist()
            pts = query[b, qs]
            ub = torch.cat([pts.amin(0), pts.amax(0)])
            v = {qi: -1.0 for qi in qs}
            for done in range(0, k, 128):
                kp = min(128, k - done)
                seeds = {qi: _seed(d2[qi], h, kp, done, v[qi], nc, scans)
                         for qi, h in zip(qs, homes) if v[qi] != inf}
                limit = max([st_["last"] for st_, _, _ in seeds.values()], default=-1.0)
                done_lo = max([r[0] for _, _, r in seeds.values()], default=0)
                done_hi = min([r[1] for _, _, r in seeds.values()], default=nc)
                for w0 in range(0, nc, window):
                    listed = [c for c in range(w0, min(w0 + window, nc))
                              if not done_lo <= c < done_hi
                              and float(box_box_lb(ub, boxes[c])) < limit]
                    for qi, (state, scan, (slo, shi)) in seeds.items():
                        for g0 in range(0, len(listed), 32):
                            group = [c for c in listed[g0:g0 + 32] if not slo <= c < shi]
                            lb = {c: float(spatial.bbox_lb(query[b, qi], boxes[c]))
                                  for c in group}
                            ballot = [c for c in group if lb[c] < state["last"]]
                            for c in ballot:
                                if lb[c] < state["last"]:
                                    scan(c)
                for qi, (state, _, _) in seeds.items():
                    v[qi] = state["last"]
            for qi in qs:
                val = np.float32(3e38) if v[qi] == inf else np.float32(v[qi])
                out[b, qi] = float(val * _SLACK)
    return out, order, scans[0]


def _emulate_vote(sup, lab, query, k, ncls, window):
    """``csrc/vote.cu``: the selection of :func:`_emulate_select` over the
    support from the queries' own layout, then the count: the block lists a
    window of chunks at a time within the largest threshold of its 8 (not
    above it), each query scans the listed chunks whose bound is not above
    its own threshold and counts the classes of the points at or within it;
    the largest count wins, ties to the lowest class."""
    thr, order, _ = _emulate_select(sup, query, k, window, "query layout")
    cloud = spatial.sort_support(sup)
    B, N, _ = sup.shape
    M = query.shape[1]
    nc = cloud.boxes.shape[1]
    out = torch.zeros(B, M, dtype=torch.int32)
    for b in range(B):
        d2 = pairwise_d2(query[b:b + 1], cloud.packed[b:b + 1, :, :3])[0]
        boxes = cloud.boxes[b]
        labs = lab[b, cloud.perm[b]]
        for r0 in range(0, M, WARPS):
            qs = order[b, r0:r0 + WARPS].tolist()
            pts = query[b, qs]
            ub = torch.cat([pts.amin(0), pts.amax(0)])
            limit = max(float(thr[b, qi]) for qi in qs)
            counts = {qi: torch.zeros(ncls, dtype=torch.int64) for qi in qs}
            for w0 in range(0, nc, window):
                listed = [c for c in range(w0, min(w0 + window, nc))
                          if not float(box_box_lb(ub, boxes[c])) > limit]
                for qi in qs:
                    t = float(thr[b, qi])
                    for c in listed:
                        if float(spatial.bbox_lb(query[b, qi], boxes[c])) > t:
                            continue
                        pos = torch.arange(c * CHUNK, min((c + 1) * CHUNK, N))
                        members = labs[pos[d2[qi, pos] <= thr[b, qi]]].long()
                        counts[qi] += torch.bincount(members, minlength=ncls)
            for qi in qs:
                out[b, qi] = int((counts[qi] == counts[qi].max()).nonzero()[0, 0])
    return out


_SELECT_CASES = [(700, 24, WINDOW), (700, 24, 2), (700, 1, 3), (300, 129, WINDOW),
                 (200, 256, 3), (40, 64, WINDOW), (129, 4, 1)]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,k,window", _SELECT_CASES)
def test_selection_schedule_returns_the_plain_threshold(kind, n, k, window):
    """The emulated listed selection (the seed, the block list with a
    test-sized window, the passes of 128 for k > 128) gives
    ``kth_distinct_plain``'s thresholds bit for bit: duplicate points and d²
    ties (the grid), fewer than k distinct values (n < k, the grid's few
    distinct d² at k = 129 and 256), a last chunk that is not full; on a
    cloud of 11 chunks at k = 24 it scans fewer chunks than a dense scan."""
    rng = np.random.RandomState(n + k)
    p = _cloud(rng, 2, n, kind)
    got, _, scans = _emulate_select(p, p, k, window, "self")
    want = ops.contrast_select_plain(p, k)
    assert torch.equal(got, want)
    if n < k:
        assert (want > 1e38).all()
    if n >= 700 and kind != "grid" and k == 24:
        assert scans < 2 * n * -(-n // CHUNK), scans


_VOTE_CASES = [(700, 4, 4, 13, WINDOW), (700, 16, 16, 13, 2), (600, 3, 64, 5, 3),
               (300, 2, 129, 4, WINDOW), (50, 5, 64, 3, 1)]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,m_step,k,ncls,window", _VOTE_CASES)
def test_vote_schedule_returns_the_plain_labels(kind, n, m_step, k, ncls, window):
    """The emulated listed vote (its selection from the queries' own layout
    and a home found by Morton code, then the count over a second list
    within the block's largest slacked threshold) gives
    ``label_vote_plain``'s labels exactly, and its thresholds are
    ``kth_distinct_plain``'s bit for bit."""
    rng = np.random.RandomState(n + k + m_step)
    sup = _cloud(rng, 2, n, kind)
    query = sup[:, ::m_step].contiguous()
    lab = torch.from_numpy(rng.randint(0, ncls, (2, n)).astype(np.int32))
    thr, _, _ = _emulate_select(sup, query, k, window, "query layout")
    assert torch.equal(thr, port_contrast.kth_distinct_plain(sup, query, k))
    got = _emulate_vote(sup, lab, query, k, ncls, window)
    assert torch.equal(got, ops.label_vote_plain(sup, lab, query, k, ncls))


# ---- the layout through the wrappers on the CPU --------------------------------

def test_wrappers_take_a_layout_and_return_the_plain_answer_on_the_cpu():
    """A given layout changes no result: the CPU path is the dense twin."""
    rng = np.random.RandomState(3)
    p = _cloud(rng, 2, 300, "grid")
    cloud = spatial.sort_support(p)
    q = p[:, ::5].contiguous()
    for query in (p, q):
        want = ops.knn_plain(p, query, 24)
        got = ops.knn(p, query, 24, cloud)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    f = torch.from_numpy(rng.randn(2, 300, 5).astype(np.float32)).requires_grad_()
    lab = torch.from_numpy(rng.randint(0, 3, (2, 300)).astype(np.float32))
    kth = ops.knn_plain(p, p, 24)[1][..., -1] * (1.0 + 1e-5)
    g4 = torch.from_numpy(rng.randn(2, 300, 4).astype(np.float32))
    fd = f.detach()
    for wrapper, plain in ((ops.contrast_grad_support, ops.contrast_grad_support_plain),
                           (ops.contrast_grad_rows, ops.contrast_grad_rows_plain)):
        want = plain(p, fd, lab, kth, g4, 2.0, True)
        assert torch.equal(wrapper(p, fd, lab, kth, g4, 2.0, True, cloud), want)
        assert torch.equal(plain(p, fd, lab, kth, g4, 2.0, True, cloud=cloud), want)
    want = ops.contrast_forward_plain(p, fd, lab, kth, 2.0, True, False, True)
    assert torch.equal(ops.contrast_forward(p, fd, lab, kth, 2.0, True, False,
                                            True, cloud), want)
    assert torch.equal(ops.contrast_forward_plain(p, fd, lab, kth, 2.0, True,
                                                  False, True, cloud=cloud), want)
    for query in (p, q):
        want = ops.ball_query_plain(p, query, 0.1, 16)
        q_cloud = cloud if query is p else spatial.sort_support(query)
        assert torch.equal(ops.ball_query(p, query, 0.1, 16, cloud, q_cloud), want)
        assert torch.equal(ops.ball_query_plain(p, query, 0.1, 16, cloud=cloud,
                                                query_cloud=q_cloud), want)
    a = torch.from_numpy(rng.rand(2, 300).astype(np.float32))
    for fusion in ("MIN", "MIN_ALL0"):
        want = ops.dual_masks_cross_plain(p, fd, a, 12, fusion)
        assert torch.equal(ops.dual_masks_cross(p, fd, a, 12, fusion, cloud), want)
        assert torch.equal(ops.dual_masks_cross_plain(p, fd, a, 12, fusion,
                                                      cloud=cloud), want)
        got, sel = ops.refine_cross(p, fd, a, 12, fusion, cloud=cloud)
        want, sel_p = ops.refine_cross_plain(p, fd, a, 12, fusion, cloud=cloud)
        assert torch.equal(got, want) and torch.equal(sel, sel_p)
    for k in (1, 24, 129):
        want = ops.contrast_select_plain(p, k)
        assert torch.equal(ops.contrast_select(p, k, cloud), want)
        assert torch.equal(ops.contrast_select_plain(p, k, cloud=cloud), want)
    ilab = lab.int()
    q_cloud = spatial.sort_support(q)
    for query, layout in ((q, q_cloud), (p, cloud)):
        want = ops.label_vote_plain(p, ilab, query, 16, 3)
        assert torch.equal(ops.label_vote(p, ilab, query, 16, 3, cloud, layout),
                           want)
        assert torch.equal(ops.label_vote_plain(p, ilab, query, 16, 3, cloud=cloud,
                                                query_cloud=layout), want)
    want = ops.contrast_reductions_selfk_plain(p, fd, lab, 24, 2.0)
    assert torch.equal(ops.contrast_reductions_selfk(p, fd, lab, 24, 2.0,
                                                     cloud=cloud), want)
    gout = torch.from_numpy(rng.randn(2, 300, 9).astype(np.float32))
    out = ops.contrast_reductions(p, f, lab, kth, 2.0, False, True, True,
                                  cloud=cloud)
    (gf,) = torch.autograd.grad(out, f, gout)
    f2 = f.detach().clone().requires_grad_()
    out2 = ops.contrast_reductions_plain(p, f2, lab, kth, 2.0, False, True, True)
    (gf2,) = torch.autograd.grad(out2, f2, gout)
    assert torch.equal(out, out2) and torch.equal(gf, gf2)


def test_the_loss_runs_under_the_plain_ops_with_its_layouts():
    """The plain twins take the wrappers' arguments, layouts included, so
    the plain-ops step (``tools/profile_eval.plain_ops``, the card's
    reference) runs the loss as the kernels' step calls it: same loss."""
    from amcontrast3d_tpu_torch.loss.contrast import contrast_head
    from amcontrast3d_tpu_torch.tools.profile_eval import plain_ops

    rng = np.random.RandomState(5)
    ups = [(_cloud(rng, 2, n, "grid"), torch.from_numpy(
        rng.randn(2, n, 8).astype(np.float32))) for n in (512, 128, 32)]
    target = torch.from_numpy(rng.randint(0, 4, (2, 512)))
    args = dict(nsample=8, temperature=0.3, mu=1.0, nu=0.1, stages_num=3)
    want, _ = contrast_head(ups, target, 4, None, args)
    with plain_ops():
        got, _ = contrast_head(ups, target, 4, None, args)
    assert torch.equal(got, want)


def test_ambiguity_head_approx_hands_each_stage_its_layout():
    """In the approx configuration ``ambiguity_head`` sorts its stage clouds
    once (``sort_stages``) and hands each layout to the selection's
    reductions, as its exact branch hands them to the kNN, and the vote of
    stage i stage 0's layout (``cloud``) and stage i's (``query_cloud``);
    ``contrast_head`` hands the vote the same.  The ambiguity and the loss
    are the ones given no layout, bit for bit."""
    from amcontrast3d_tpu_torch.loss import contrast as pcontrast
    from amcontrast3d_tpu_torch.ops.knn import set_knn_backend

    rng = np.random.RandomState(11)
    ups = [(_cloud(rng, 2, n, "grid"), None) for n in (512, 128, 32)]
    target = torch.from_numpy(rng.randint(0, 4, (2, 512)))
    args = dict(nsample=8, ccbeta=0.04, cctype="Method2", stages_num=3)
    selfk, vote = pcontrast.contrast_reductions_selfk, pcontrast.label_vote
    sorts, given, voted = [], [], []

    def recording_sort(ps):
        sorts.append(len(ps))
        clouds = spatial.sort_stages(ps)
        sorted_.append(clouds)
        return clouds

    def recording_selfk(p, *a, cloud=None):
        spatial.check_layout(cloud, p)
        given.append(cloud)
        return selfk(p, *a, cloud=cloud)

    def recording_vote(p0, lab0, p, k, ncls, cloud=None, query_cloud=None):
        spatial.check_layout(cloud, p0)
        spatial.check_layout(query_cloud, p)
        voted.append((cloud, query_cloud))
        return vote(p0, lab0, p, k, ncls, cloud, query_cloud)

    recording = (mock.patch.object(pcontrast, "sort_stages", recording_sort),
                 mock.patch.object(pcontrast, "contrast_reductions_selfk",
                                   recording_selfk),
                 mock.patch.object(pcontrast, "label_vote", recording_vote),
                 mock.patch.object(pcontrast, "sort_support",
                                   side_effect=AssertionError("a stage sorted alone")))
    bare = (mock.patch.object(pcontrast, "contrast_reductions_selfk",
                              lambda *a, cloud=None: selfk(*a)),
            mock.patch.object(pcontrast, "label_vote",
                              lambda *a, cloud=None, query_cloud=None: vote(*a)))
    feats = [(p, torch.from_numpy(rng.randn(2, p.shape[1], 6).astype(np.float32)))
             for p, _ in ups]
    largs = dict(args, temperature=0.3, mu=1.0, nu=0.1)
    set_knn_backend("approx")
    try:
        want = pcontrast.ambiguity_head(ups, target, 4, None, args)
        want_loss, _ = pcontrast.contrast_head(feats, target, 4, None, largs)
        with ExitStack() as stack:
            for patch in recording:
                stack.enter_context(patch)
            sorted_ = []
            got = pcontrast.ambiguity_head(ups, target, 4, None, args)
            head_clouds = sorted_[0]
            got_loss, _ = pcontrast.contrast_head(feats, target, 4, None, largs)
            loss_clouds = sorted_[1]
        with ExitStack() as stack:
            for patch in bare:
                stack.enter_context(patch)
            unsorted = pcontrast.ambiguity_head(ups, target, 4, None, args)
            unsorted_loss, _ = pcontrast.contrast_head(feats, target, 4, None, largs)
    finally:
        set_knn_backend("auto")
    assert sorts == [3, 3] and len(given) == 6
    assert [(c is head_clouds[0], q is head_clouds[i]) for i, (c, q)
            in enumerate(voted[:2], 1)] == [(True, True)] * 2
    assert [(c is loss_clouds[0], q is loss_clouds[i]) for i, (c, q)
            in enumerate(voted[2:], 1)] == [(True, True)] * 2
    for a, b, c in zip(got, want, unsorted):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert torch.equal(got_loss, want_loss) and torch.equal(got_loss, unsorted_loss)
