"""The large-shape interpolation kernels against the JAX package on the CPU:
the deterministic VJP over per-row lists (TPU kernel 10,
``csrc/interpolate_bwd_big.cu``) through the plain form of its inversion,
the lane-a-point forward (TPU kernels 11-13, ``csrc/interpolate_big.cu``)
through its twin, and the port's own gates between these kernels and the
listed scan and the scatter of ``csrc/interpolate.cu``.

The Pallas originals run in interpret mode with their budgets patched so
that the large-shape kernels take small inputs, as the JAX package's own
tests force them (``tests/test_interpolate_pallas.py``).  Routing is
checked on the meta device with the launcher replaced: off the CPU a
wrapper launches its kernel or raises.  ``test_torch_port_cuda.py`` holds
the CUDA kernels against the twins on the card.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import amcontrast3d_tpu.ops.interpolate_pallas as IP
from amcontrast3d_tpu.ops import interpolate as jinterp
from amcontrast3d_tpu_torch import ops

port_interp = importlib.import_module("amcontrast3d_tpu_torch.ops.interpolate")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _skewed(rng, b, n1, n2, crowd=0):
    """(idx, w) of b clouds: each fine point's 3 distinct coarse rows; the
    first ``crowd`` fine points all hold row 1 in their first slot, and no
    fine point holds row n2 - 1."""
    idx = np.stack([np.stack([rng.choice(n2 - 1, 3, replace=False)
                              for _ in range(n1)]) for _ in range(b)])
    idx[:, :crowd, 0] = 1
    idx[:, :crowd, 1:] = np.where(idx[:, :crowd, 1:] == 1, 0,
                                  idx[:, :crowd, 1:])
    w = rng.rand(b, n1, 3).astype(np.float32)
    return idx.astype(np.int32), (w / w.sum(-1, keepdims=True)).astype(np.float32)


def _lists_by_loop(idx, n2):
    """Per row b·n2 + j, the flat positions b·3·N1 + 3q + s that select it,
    in ascending order, by a loop over the triples."""
    b, n1, _ = idx.shape
    lists = [[] for _ in range(b * n2)]
    for bi in range(b):
        for q in range(n1):
            for s in range(3):
                lists[bi * n2 + idx[bi, q, s]].append(bi * 3 * n1 + 3 * q + s)
    return lists


def invert_triples_plain(idx, n2):
    """The inversion of ``csrc/interpolate_bwd_big.cu`` in plain PyTorch:
    idx (B, N1, 3) → (offsets (B·n2 + 1,) int64, entries (B·3·N1,) int64).
    Row r = b·n2 + j's list is ``entries[offsets[r]:offsets[r + 1]]``: the
    flat positions b·3·N1 + 3·q + slot of the (query, slot) pairs of cloud
    b that select coarse point j, ascending."""
    B, N1, _ = idx.shape
    rows = (idx.long() + n2 * torch.arange(B)[:, None, None]).reshape(-1)
    counts = torch.bincount(rows, minlength=B * n2)
    offsets = torch.zeros(B * n2 + 1, dtype=torch.int64)
    offsets[1:] = torch.cumsum(counts, 0)
    return offsets, torch.sort(rows, stable=True).indices


def backward_over_lists(grad, idx, weight, n2):
    """The plain form of kernel 10: the triples inverted by
    :func:`invert_triples_plain`, then each row's ``w·g`` summed over its
    list in order (``index_add_`` walks them one after another on the CPU,
    so each row's sum is formed in ascending (query, slot) order, as the
    kernel forms it)."""
    B, N1, C = grad.shape
    offsets, entries = invert_triples_plain(idx, n2)
    row_of = torch.repeat_interleave(torch.arange(B * n2), offsets.diff())
    contrib = (weight[..., None] * grad[:, :, None, :]).reshape(-1, C)
    df2 = torch.zeros(B * n2, C, dtype=grad.dtype)
    df2.index_add_(0, row_of, contrib[entries])
    return df2.view(B, n2, C)


# ---- kernel 10: the inversion into per-row lists ----------------------------

@pytest.mark.parametrize("b,n1,n2,crowd", [
    (1, 1, 4, 0), (2, 50, 9, 0), (2, 301, 40, 0), (1, 700, 60, 400),
    (3, 257, 33, 200)])
def test_inversion_lists_each_row_in_query_slot_order(b, n1, n2, crowd):
    """``invert_triples_plain``: row r's entries are the (query, slot) pairs
    that select it, ascending, at ``entries[offsets[r]:offsets[r + 1]]``;
    a row chosen by hundreds of fine points holds them all, and a row no
    point selects is empty.  Exact."""
    rng = np.random.RandomState(n1 + crowd)
    idx, _ = _skewed(rng, b, n1, n2, crowd)
    offsets, entries = invert_triples_plain(_t(idx), n2)
    assert offsets.shape == (b * n2 + 1,) and entries.shape == (b * 3 * n1,)
    want = _lists_by_loop(idx, n2)
    got = [entries[offsets[r]:offsets[r + 1]].tolist() for r in range(b * n2)]
    assert got == want
    assert all(len(got[bi * n2 + n2 - 1]) == 0 for bi in range(b))
    if crowd:
        assert all(len(got[bi * n2 + 1]) >= crowd for bi in range(b))


@pytest.mark.parametrize("b,n1,n2,c,crowd", [
    (1, 1, 1, 1, 0), (2, 1031, 257, 12, 0), (3, 500, 70, 200, 300),
    (1, 900, 31, 7, 600), (2, 64, 300, 128, 0)])
def test_lists_vjp_is_the_plain_twin_bit_for_bit(b, n1, n2, c, crowd):
    """The plain form of kernel 10 (each row summed over its list in
    order): the same bits as ``three_interpolation_backward_plain``'s
    ``index_add_`` (the same order of summation), which
    ``three_interpolation_backward_big`` takes for CPU tensors, within
    1e-5·(1+max) of a float64 sum, and a row no fine point selects is
    exactly 0."""
    rng = np.random.RandomState(n1 + c)
    if n2 > 3:
        idx, w = _skewed(rng, b, n1, n2, crowd)
    else:
        idx = rng.randint(0, n2, (b, n1, 3)).astype(np.int32)
        w = rng.rand(b, n1, 3).astype(np.float32)
    g = rng.randn(b, n1, c).astype(np.float32)
    got = ops.three_interpolation_backward_big(_t(g), _t(idx), _t(w), n2)
    assert torch.equal(got, backward_over_lists(
        _t(g), _t(idx), _t(w), n2))
    assert torch.equal(got, ops.three_interpolation_backward_plain(
        _t(g), _t(idx), _t(w), n2))
    want = np.zeros((b, n2, c))
    for bi in range(b):
        np.add.at(want[bi], idx[bi].reshape(-1),
                  (w[bi][..., None].astype(np.float64) * g[bi][:, None]
                   ).reshape(-1, c))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * (1 + np.abs(want).max()))
    if n2 > 3:
        assert not got[:, n2 - 1].any()


def _clear_of_ties(rng, n1, n2, side=3.0):
    """Fine points whose 3rd and 4th nearest coarse d² differ by 1e-3
    relative (the TPU's cushion then admits no 4th neighbour)."""
    p2 = (rng.rand(1, n2, 3) * side).astype(np.float32)
    keep = np.zeros((0, 3), np.float32)
    while len(keep) < n1:
        cand = (rng.rand(2 * n1, 3) * side).astype(np.float32)
        d2 = np.sort(((cand[:, None].astype(np.float64) - p2[0][None]) ** 2
                      ).sum(-1), -1)
        keep = np.concatenate([keep, cand[d2[:, 3] > d2[:, 2] * (1 + 1e-3)]])
    return keep[None, :n1], p2


@pytest.mark.parametrize("n1,n2,qb", [(1100, 700, 512), (2100, 90, 1024)])
def test_lists_vjp_matches_the_chunked_pallas_kernel(monkeypatch, n1, n2, qb):
    """The plain form of kernel 10 on the triples of the port's forward
    against the gradient of ``three_interpolation_fused`` through the JAX
    package's query-chunked VJP (``_interp_bwd_big_kernel``, interpret
    mode; the query buffer's budget and block patched as
    ``tests/test_interpolate_pallas.py`` patches them): 1e-5.  At 2100 →
    90 each coarse row is chosen by some 70 fine points."""
    monkeypatch.setattr(IP, "_QBUF_VMEM_BUDGET", 1)   # the chunked kernel
    monkeypatch.setattr(IP, "_QB", qb)                 # several query blocks
    rng = np.random.RandomState(n1)
    p1, p2 = _clear_of_ties(rng, n1, n2)
    f2 = rng.randn(1, n2, 12).astype(np.float32)
    g = rng.randn(1, n1, 12).astype(np.float32)

    def loss(f_, p1_, p2_, g_):
        return jnp.sum(IP.three_interpolation_fused(p1_, p2_, f_, True) * g_)

    want = np.asarray(jax.grad(loss)(jnp.asarray(f2), jnp.asarray(p1),
                                     jnp.asarray(p2), jnp.asarray(g)))
    idx, w = ops.three_interpolation_weights(_t(p1), _t(p2))
    got = ops.three_interpolation_backward_big(_t(g), idx, w, n2).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ---- kernels 11-13: the lane-a-point forward --------------------------------

def _tie_grid(rng, b, n1, n2):
    """Fine and coarse points on a 1/8 grid of a 2-unit cube: d² is exact
    in float32 and ties at the 3rd neighbour are everywhere."""
    cells = np.stack(np.meshgrid(*[np.arange(16)] * 3, indexing="ij"), -1
                     ).reshape(-1, 3) / 8.0
    p1 = np.stack([cells[rng.choice(len(cells), n1, replace=False)]
                   for _ in range(b)]).astype(np.float32)
    p2 = np.stack([cells[rng.choice(len(cells), n2, replace=False)]
                   for _ in range(b)]).astype(np.float32)
    return p1, p2


@pytest.mark.parametrize("b,n1,n2,grid", [(1, 1500, 300, True),
                                          (2, 2000, 500, True),
                                          (1, 1800, 4100, False)])
def test_forward_twin_matches_the_pallas_big_path(monkeypatch, b, n1, n2, grid):
    """``three_interpolation_big`` (its twin on the CPU) against the JAX
    package's large-support path (``_interp_fwd_big``: the seed, threshold
    and accumulation kernels, interpret mode, forced with a 1-byte budget)
    on grids where d² ties at the 3rd neighbour are common, and on a
    uniform cloud: every row whose 4 nearest d² are distinct within the
    TPU's cushion within 1e-5·(1+max|out|) (there the two rules pick the
    same three); on the grids, where d² is exact in every form, every row
    against the JAX plain path, which breaks ties as the port does, to
    1e-5·(1+max|out|)."""
    monkeypatch.setattr(IP, "_SUP_VMEM_BUDGET", 1)
    rng = np.random.RandomState(n1 + n2)
    if grid:
        p1, p2 = _tie_grid(rng, b, n1, n2)
    else:
        p1 = (rng.rand(b, n1, 3) * 3).astype(np.float32)
        p2 = (rng.rand(b, n2, 3) * 3).astype(np.float32)
    f2 = rng.randn(b, n2, 12).astype(np.float32)
    out, idx, w = ops.three_interpolation_big(_t(p1), _t(p2), _t(f2), keep=True)
    got = out.numpy()
    tol = 1e-5 * (1 + np.abs(got).max())
    big = np.asarray(IP.three_interpolation_fused(
        jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(f2), True))
    d2 = ops.knn_plain(_t(p2), _t(p1), 4)[1].numpy()
    clear = (np.diff(d2, axis=-1) > 0).all(-1) & (d2[..., 3] > d2[..., 2] * (1 + 2e-6))
    assert clear.sum() > 0.05 * clear.size
    np.testing.assert_allclose(got[clear], big[clear], rtol=0, atol=tol)
    if grid:
        assert (~clear).sum() > 0.05 * clear.size   # ties were in play
        plain = np.asarray(jinterp.three_interpolation(
            jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(f2)))
        np.testing.assert_allclose(got, plain, rtol=0, atol=tol)


# ---- the port's gates, read on the card -------------------------------------

# (b, n1, n2, c, forward big, backward big) of every decoder stage the
# gates were read at (PERF.md §6): the S3DIS and ScanNet steps,
# clouds of 22000 points and subclouds of the room buckets (PointNeXt: fp0
# and fp1 go to both large-shape kernels, fp2 and fp3 to neither, save one
# 22000-point cloud's fp1 of 5500 points), and PointNet++'s eval forward
# (coarse widths 64 ... 512: its fp0 to the lane-a-point forward, but C 64
# keeps the scatter)
_STAGES = [(b, n // 4 ** s, n // 4 ** (s + 1), 128 * 2 ** s,
            s < 2 and b * n // 4 ** s >= 22000,
            s < 2 and b * n // 4 ** s >= 22000)
           for b, n in ((4, 24000), (2, 64000), (4, 22000), (1, 22000),
                        (1, 106496), (1, 155648), (1, 221184), (1, 311296))
           for s in range(4)] + [
    (2, 24000, 6000, 64, True, False), (2, 6000, 1500, 128, False, False),
    (2, 1500, 375, 256, False, False), (2, 375, 93, 512, False, False)]


@pytest.mark.parametrize("b,n1,n2,c,fwd,bwd", _STAGES + [
    # both sides of 22000 fine points a call and of 128 and 256 channels
    (1, 21999, 5500, 128, False, False), (1, 22000, 5500, 128, True, True),
    (2, 10999, 3000, 256, False, False), (2, 11000, 3000, 256, True, True),
    (1, 10 ** 6, 250000, 256, True, True),
    (1, 10 ** 6, 250000, 257, False, False),
    (1, 64000, 16000, 127, True, False), (1, 64000, 16000, 1, True, False),
    (3, 1, 1, 1, False, False)])
def test_forward_and_backward_gates_are_the_cards_rule(b, n1, n2, c, fwd, bwd):
    """``forward_is_big``: the lane-a-point forward takes a call of coarse
    width ≤ 256 with at least 22000 fine points over its clouds;
    ``backward_is_big``: the per-row-lists VJP the same calls of width 128
    to 256; whatever ``n2``."""
    assert ops.forward_is_big(b, n1, n2, c) == fwd
    assert ops.backward_is_big(b, n1, n2, c) == bwd
    assert port_interp.BIG_FORWARD_CHANNELS == 256
    assert port_interp.BIG_BACKWARD_POINTS == 22000


def test_gates_read_no_environment():
    """The gates are plain rules of the module: no switch reaches them."""
    import inspect
    source = inspect.getsource(port_interp)
    assert "environ" not in source and "getenv" not in source


def _no_stream(monkeypatch):
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: type("S", (), {"cuda_stream": 0}))


@pytest.mark.parametrize("b,n1,n2,c,with_rows", [
    (2, 64000, 16000, 128, True), (4, 24000, 6000, 128, False),
    (1, 221184, 55296, 128, True), (4, 6000, 1500, 256, True)])
def test_backward_routes_by_the_rule_and_hands_on_the_coarse_order(
        monkeypatch, b, n1, n2, c, with_rows):
    """Off the CPU the VJP goes where ``backward_is_big`` says: the
    per-row-lists kernel gets the coarse rows' order (a strided view of a
    layout's index bits) and int32 scratch for the counts, bins, spill,
    gather and sorted lists; one launch, counted once, with the C entry
    point's argument count."""
    from amcontrast3d_tpu_torch.ops import _build
    calls = []
    monkeypatch.setattr(port_interp, "launch",
                        lambda name, *a: calls.append((name, a)))
    _no_stream(monkeypatch)
    real = torch.empty
    made = []

    def empty(*shape, **kw):
        made.append((shape, kw.get("dtype")))
        return real(*shape, **kw)

    g = torch.empty(b, n1, c, device="meta")
    idx = torch.empty(b, n1, 3, dtype=torch.int32, device="meta")
    w = torch.empty(b, n1, 3, device="meta")
    rows = (torch.empty(b, n2, 4, dtype=torch.int32, device="meta")[..., 3]
            if with_rows else None)
    monkeypatch.setattr(port_interp.torch, "empty", empty)
    monkeypatch.setattr(port_interp, "_check_backward", lambda *t: None)
    monkeypatch.setattr(port_interp, "_check_order", lambda *t: None)
    monkeypatch.setattr(ops.three_interpolation_backward_big, "launches", 0)
    ops.three_interpolation_backward(g, idx, w, n2, None, rows)
    (name, args), = calls
    assert name == "amc3d_three_interpolate_backward_big"
    assert len(args) == len(_build._SIGNATURES[name])
    assert ops.three_interpolation_backward_big.launches == 1
    assert args[4] == (4 if with_rows else 1)      # the rows' stride
    assert args[-5:-1] == (b, n1, n2, c)
    scratch = [s for s, dt in made if dt == torch.int32]
    assert scratch == [(-(-(b * n2 + 2) // 4) * 4 + b * n2 * 2 * 64
                        + 7 * b * 3 * n1,)]


@pytest.mark.parametrize("big", [True, False])
def test_forward_launches_with_the_entry_points_arguments(monkeypatch, big):
    """Both forward kernels take the layouts' arguments; the lane-a-point
    kernel adds its chunk-visit counter.  Each launch is counted on its own
    wrapper, and the autograd path keeps the coarse layout's order for the
    VJP."""
    from amcontrast3d_tpu_torch.ops import _build, spatial
    calls = []
    monkeypatch.setattr(port_interp, "launch",
                        lambda name, *a: calls.append((name, a)))
    _no_stream(monkeypatch)
    rng = np.random.RandomState(5)
    p1 = _t((rng.rand(1, 300, 3) * 2).astype(np.float32))
    p2 = p1[:, ::4].contiguous()
    cloud, query_cloud = spatial.sort_stages([p1, p2])[::-1]
    f2 = torch.zeros(1, 75, 8)
    counter = ops.three_interpolation_big if big else ops.three_interpolation
    monkeypatch.setattr(counter, "launches", 0)
    out, idx, w, order, rows = port_interp._launch_forward(
        big, p1, p2, f2, True, cloud, query_cloud)
    (name, args), = calls
    assert name == ("amc3d_three_interpolate_big" if big
                    else "amc3d_three_interpolate")
    assert len(args) == len(_build._SIGNATURES[name])
    assert counter.launches == 1
    assert torch.equal(order.long(), query_cloud.perm)
    assert torch.equal(rows.long(), cloud.perm)
