"""The whole-scene rungs from the 221184 bucket up, against the JAX package
on the CPU: the chunk-pruned FPS (TPU kernel 5), the large-support 3-NN
interpolation (TPU kernels 11-13), their dispatch rules, kNN beyond 128
neighbours, and the PointNet++ cfg.

The Pallas originals run in interpret mode with their chunk sizes forced
small, as the JAX package's own tests force them
(``tests/test_fps_pallas.py``, ``tests/test_interpolate_pallas.py``); the
port's wrappers take their plain twins here (CPU tensors), and
``test_torch_port_cuda.py`` holds the CUDA kernels against those twins on
the card.  Routing is checked on the meta device with the launchers
replaced: off the CPU a wrapper launches its kernel or raises.
"""
import importlib
from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import amcontrast3d_tpu.ops.fps_pallas as FP
import amcontrast3d_tpu.ops.interpolate_pallas as IP
from amcontrast3d_tpu.ops.knn import _knn_jnp
from amcontrast3d_tpu_torch import ops
from amcontrast3d_tpu_torch.ops import spatial

port_fps = importlib.import_module("amcontrast3d_tpu_torch.ops.fps")
port_interp = importlib.import_module("amcontrast3d_tpu_torch.ops.interpolate")
port_knn = importlib.import_module("amcontrast3d_tpu_torch.ops.knn")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _cloud(rng, b, n, duplicated=False):
    """Uniform in [0, 5]³; ``duplicated``: a tenth of the points repeat
    others (as the bucket padding repeats real points)."""
    pts = (rng.rand(b, n, 3) * 5).astype(np.float32)
    if duplicated:
        rep = rng.randint(0, n, (b, n // 10))
        for i in range(b):
            pts[i, rng.randint(0, n, n // 10)] = pts[i, rep[i]]
    return pts


# ---- kernel 5: the chunk-pruned FPS ----------------------------------------

@pytest.mark.parametrize("n,npoint,ragged,duplicated", [
    (3000, 600, False, False), (3000, 600, False, True),
    (2791, 300, True, False), (2791, 300, True, True)])
def test_pruned_fps_twin_matches_the_pallas_pruned_sampler(
        monkeypatch, n, npoint, ragged, duplicated):
    """``_fps_b1_pruned`` with 512-point chunks (several skip per pick), and
    ragged N split over calls of 64 picks: picks identical to the port's
    pruned wrapper (its twin here) and to the plain FPS."""
    monkeypatch.setattr(FP, "_PRUNE_CS", 512)
    if ragged:
        monkeypatch.setattr(FP, "_B1_OPS_BUDGET", 1.0)
        monkeypatch.setattr(FP, "_TO", 64)
    xyz = _cloud(np.random.RandomState(n + duplicated), 1, n, duplicated)
    planes = jnp.asarray(xyz).transpose(2, 0, 1)
    want = np.asarray(FP._fps_b1_pruned(planes[0], planes[1], planes[2], n,
                                        npoint, True))
    got = ops.furthest_point_sample_pruned(_t(xyz), npoint).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        ops.furthest_point_sample_plain(_t(xyz), npoint).numpy(), want)


def _keys(v: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """Whole keys as the kernels form them: the float bits of a
    min-distance ≥ 0 above ~index (``csrc/cluster.cuh::make_key``)."""
    return (v.view(torch.int32).to(torch.int64) << 32) | (0xFFFFFFFF - index)


_GROUP = 32   # chunks a group of the one-block phase (tools/fps_handover.cu)


def _emulate_pruned(xyz: np.ndarray, npoint: int, handover: int = 0):
    """The schedule of ``csrc/fps_pruned.cu`` in plain PyTorch, one pick at
    a time: the cloud sorted into 64-point chunks with boxes (the layout
    ``sort_stages`` makes), each chunk's whole key; per pick every chunk's
    box is tested against the pick and its key's min-distance, the chunks
    that pass are visited (their min-distances lowered, their keys taken
    again), and the pick is the largest whole key.  With ``handover`` > 0,
    the schedule of ``tools/fps_handover.cu``: after the first pick that
    visits fewer than ``handover`` chunks (pick J - 1), the picks from J on
    test groups of 32 consecutive chunks first (the union of their boxes
    against the largest key among them) and only the chunks of the groups
    that pass.  Returns the picks, the chunk visits and J (npoint where the
    wide phase took every pick)."""
    p = _t(xyz)
    cloud = spatial.sort_stages([p])[0]
    pts = cloud.packed[0, :, :3]
    index = cloud.packed[0, :, 3].contiguous().view(torch.int32).to(torch.int64)
    boxes = cloud.boxes[0]
    n, nc = pts.shape[0], boxes.shape[0]
    chunk = torch.arange(n) // spatial.CHUNK
    group = torch.arange(nc) // _GROUP
    ng = int(group[-1]) + 1
    gbox = torch.cat([
        torch.full((ng, 3), float("inf")).scatter_reduce(
            0, group[:, None].expand(nc, 3), boxes[:, :3], "amin"),
        torch.full((ng, 3), -float("inf")).scatter_reduce(
            0, group[:, None].expand(nc, 3), boxes[:, 3:], "amax")], 1)
    mind = torch.full((n,), 1e10, dtype=torch.float32)

    def chunk_keys():
        return torch.full((nc,), -1, dtype=torch.int64).scatter_reduce(
            0, chunk, _keys(mind, index), "amax")

    def value_of(key):
        return (key >> 32).to(torch.int32).view(torch.float32)

    ckey = chunk_keys()
    out, visits, first_narrow = [0], 0, npoint
    last = p[0, 0]
    for j in range(1, npoint):
        need = spatial.bbox_lb(last, boxes) < value_of(ckey)
        if j >= first_narrow:
            gkey = torch.full((ng,), -1, dtype=torch.int64).scatter_reduce(
                0, group, ckey, "amax")
            passed = spatial.bbox_lb(last, gbox) < value_of(gkey)
            # a group that fails holds no chunk that passes: nothing lost
            assert not bool((need & ~passed[group]).any())
            need = need & passed[group]
        visits += int(need.sum())
        if handover > 0 and first_narrow == npoint and need.sum() < handover:
            first_narrow = j + 1
        at = need[chunk]
        d = pts[at] - last
        mind[at] = torch.minimum(mind[at],
                                 (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1])
                                 + d[:, 2] * d[:, 2])
        ckey = chunk_keys()
        pick = int(0xFFFFFFFF - (int(ckey.max()) & 0xFFFFFFFF))
        out.append(pick)
        last = p[0, pick]
    return np.array(out, dtype=np.int32), visits, first_narrow


def _room_grid(rng, n):
    """A room-like cloud on a 1/128 m grid: the faces of a 2 x 1.5 x 1 m
    box and a solid block, a tenth of the points repeating others (as the
    bucket padding repeats real points), and many d² ties."""
    face = rng.rand(n, 3) * [2, 1.5, 1]
    axis = rng.randint(0, 3, n)
    face[np.arange(n), axis] = rng.randint(0, 2, n) * np.array([2, 1.5, 1])[axis]
    solid = rng.rand(n // 4, 3) * [0.5, 0.4, 0.3] + [0.7, 0.5, 0]
    pts = np.round(np.concatenate([face[: n - len(solid)], solid]) * 128) / 128
    pts[rng.randint(0, n, n // 10)] = pts[rng.randint(0, n, n // 10)]
    return pts[rng.permutation(n)][None].astype(np.float32)


_CLOUDS = {"grid": lambda: _room_grid(np.random.RandomState(5), 2600),
           "uniform": lambda: _cloud(np.random.RandomState(6), 1, 2600)}
_PALLAS_PICKS = {}


def _pallas_picks(name: str, npoint: int) -> np.ndarray:
    """``_fps_b1_pruned`` in interpret mode with 512-point chunks (several
    skip per pick), once per cloud."""
    if name not in _PALLAS_PICKS:
        saved = FP._PRUNE_CS
        FP._PRUNE_CS = 512
        try:
            planes = jnp.asarray(_CLOUDS[name]()).transpose(2, 0, 1)
            _PALLAS_PICKS[name] = np.asarray(FP._fps_b1_pruned(
                planes[0], planes[1], planes[2], planes.shape[-1], npoint,
                True))[0]
        finally:
            FP._PRUNE_CS = saved
    return _PALLAS_PICKS[name]


@pytest.mark.parametrize("cloud", sorted(_CLOUDS))
@pytest.mark.parametrize("npoint", [1, 2, 97, 650])
def test_pruned_schedule_matches_pallas_and_plain(cloud, npoint):
    """The chunk-pruned FPS's schedule (chunk tests against the pick and
    each chunk's largest min-distance, whole-key argmax) gives picks
    identical to the Pallas pruned sampler and to the plain FPS, on a
    1/128 m grid with repeated points and on a uniform cloud, at npoint 1,
    2 and beyond; once the first picks (which visit every chunk) are past,
    most chunks are skipped."""
    xyz = _CLOUDS[cloud]()
    got, visits, _ = _emulate_pruned(xyz, npoint)
    np.testing.assert_array_equal(got, _pallas_picks(cloud, 650)[:npoint])
    np.testing.assert_array_equal(
        got, ops.furthest_point_sample_plain(_t(xyz), npoint)[0].numpy())
    nc = -(-xyz.shape[1] // spatial.CHUNK)
    assert visits == nc * (npoint - 1) or npoint > 2
    assert npoint < 97 or visits <= 0.5 * nc * (npoint - 1)


@pytest.mark.parametrize("cloud", sorted(_CLOUDS))
@pytest.mark.parametrize("handover", [1, 8, 32, 10 ** 6])
def test_handover_schedule_matches_pallas_and_plain(cloud, handover):
    """The two-phase schedule of ``tools/fps_handover.cu`` (the wide phase
    to pick J - 1, then groups of 32 chunks tested before their chunks)
    gives picks identical to the Pallas pruned sampler and to the plain FPS
    at every handover pick J: never (1: every pick visits a chunk), late
    (8, 32) and right after the first pick (10⁶), on a 1/128 m grid with
    repeated points and on a uniform cloud."""
    xyz = _CLOUDS[cloud]()
    npoint = 650
    got, _, first_narrow = _emulate_pruned(xyz, npoint, handover)
    np.testing.assert_array_equal(got, _pallas_picks(cloud, npoint))
    np.testing.assert_array_equal(
        got, ops.furthest_point_sample_plain(_t(xyz), npoint)[0].numpy())
    if handover == 1:
        assert first_narrow == npoint
    elif handover == 10 ** 6:
        assert first_narrow == 2
    else:
        assert 2 < first_narrow < npoint


# ---- kernels 11-13: the large-support interpolation -------------------------

def _explained_by_ties(d2: np.ndarray) -> np.ndarray:
    """Per row of the 4 nearest d² (ascending): whether the TPU kernels may
    take a 4th neighbour there.  Two of the 4 are equal (``_top3_rows``
    drops tied copies in one extraction round, so the 3rd value it finds
    lies beyond the true 3rd), or the 4th lies within the cushion of the
    threshold ``thr·(1+1e-6)`` (``_interp_fwd_big``), with float32 rounding
    of the product."""
    tied = (np.diff(d2, axis=-1) == 0).any(-1)
    cushion = d2[:, 3] <= d2[:, 2] * (1 + 2e-6)
    return tied | cushion


@pytest.mark.parametrize("b,n1,tq", [(1, 1200, None), (2, 3300, 1024)])
def test_big_interp_twin_against_the_pallas_big_path(monkeypatch, b, n1, tq):
    """The JAX package's large-support path (seed, threshold and
    accumulation kernels; forced with a 1-byte budget) against the port's
    large-support wrapper (its twin here): rows within 1e-5·(1+max|out|) for
    ≥ 99.5 % of rows, and every other row explained by the TPU's tie rule
    (the port takes exactly 3 neighbours, the TPU every point within the
    cushioned 3rd d²).  Then, with several query tiles, the VJP:
    ``jax.grad`` of the big path against the port's backward on the big
    forward's saved triples, ≥ 99 % of rows within 1e-3 as the JAX
    package's own test holds it."""
    monkeypatch.setattr(IP, "_SUP_VMEM_BUDGET", 1)
    if tq is not None:
        monkeypatch.setattr(IP, "_BIG_TQ", tq)
    rng = np.random.RandomState(n1)
    p1 = (rng.rand(b, n1, 3) * 3).astype(np.float32)
    p2 = (rng.rand(b, 4100, 3) * 3).astype(np.float32)
    f2 = rng.randn(b, 4100, 12).astype(np.float32)
    tgt = rng.randn(b, n1, 12).astype(np.float32)
    want = np.asarray(IP.three_interpolation_fused(
        jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(f2), True))
    out, idx, w = ops.three_interpolation_big(_t(p1), _t(p2), _t(f2), keep=True)
    got = out.numpy()
    tol = 1e-5 * (1 + np.abs(got).max())
    close = (np.abs(got - want) <= tol).all(-1)
    assert close.mean() >= 0.995, f"{1 - close.mean():.4f} rows differ"
    d2 = ops.knn_plain(_t(p2), _t(p1), 4)[1].numpy()
    assert _explained_by_ties(d2[~close]).all()
    np.testing.assert_array_equal(
        ops.three_interpolation_plain(_t(p1), _t(p2), _t(f2)).numpy(), got)
    if tq is None:
        return
    g_jax = np.asarray(jax.grad(lambda f: jnp.sum((IP.three_interpolation_fused(
        jnp.asarray(p1), jnp.asarray(p2), f, True) - tgt) ** 2))(
            jnp.asarray(f2)))
    g_port = ops.three_interpolation_backward(
        _t(2 * (got - tgt)), idx, w, 4100).numpy()
    rows = np.isclose(g_port, g_jax, rtol=1e-3, atol=1e-3).all(-1)
    assert rows.mean() >= 0.99, f"{1 - rows.mean():.4f} gradient rows differ"


# ---- the dispatch rules -----------------------------------------------------

def test_dispatch_rules_equal_the_jax_expressions():
    """``forward_is_big`` against the JAX package's own expression
    (``interpolate_pallas.py:567-568``) over a grid around each crossing.
    (The FPS gate is the port's own: the next test.)"""
    for n2 in (1, 255, 256, 257, 512, 513, 38911, 38912, 49151, 49152, 49153,
               49664, 55296, 77824, 155648, 307200):
        for c in (1, 124, 125, 128, 252, 253, 256, 512, 1024):
            want = IP._buf_vmem_bytes(IP._shapes_sup(n2)[0], c) \
                > IP._SUP_VMEM_BUDGET
            assert ops.forward_is_big(n2, c) == want, (n2, c)
    assert ops.forward_is_big(55296, 128) and not ops.forward_is_big(49152, 128)
    assert ops.forward_is_big(38912, 256)


def test_port_fps_gate_prunes_every_room_stage_the_jax_rule_prunes():
    """``fps_is_pruned`` is the port's own gate, read off the card (the JAX
    package's, ``fps_pallas.py:529-533`` at its default, is N ≥ 262144): B
    == 1 above one cluster's 163840 points where at least
    ``PRUNED_MIN_SHARE`` of them are picked, over a grid around each
    crossing; every room stage (N → N / 4) the JAX rule prunes, the port
    prunes too, and both send B > 1 to the batched kernel."""
    assert FP._PRUNED == "auto"
    share = port_fps.PRUNED_MIN_SHARE
    for B in (1, 2, 3):
        for N in (1, 65535, 65536, 163840, 163841, 200000, 262143, 262144,
                  262145, 311296, 1228800):
            for npoint in (1, 4096, N // 64, N // 4, N):
                npoint = max(npoint, 1)
                want = B == 1 and N > 163840 and npoint >= share * N
                assert ops.fps_is_pruned(B, N, npoint) == want, (B, N, npoint)
            jax_b1 = B == 1 and N >= FP._PRUNED_MIN_N and N >= 2 * FP._PRUNE_CS
            assert not jax_b1 or ops.fps_is_pruned(B, N, N // 4), (B, N)
    assert ops.fps_is_pruned(1, 163841, 40961)
    assert not ops.fps_is_pruned(1, 163840, 40960)
    assert ops.fps_is_pruned(1, 1200000, 12000)
    assert not ops.fps_is_pruned(1, 1200000, 11999)
    assert not ops.fps_is_pruned(2, 10 ** 6, 10 ** 5)


def _no_stream(monkeypatch):
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: type("S", (), {"cuda_stream": 0}))


_H100 = {1: 132, 2: 66, 4: 30, 8: 15, 16: 7}
_NONE = {1: 0, 2: 0, 4: 0, 8: 0, 16: 0}


@pytest.mark.parametrize("n,npoint,capacity,want", [
    # every stage of the rooms' buckets, N → N / 4
    (106496, 26624, _H100, "cluster"), (155648, 38912, _H100, "cluster"),
    (221184, 55296, _H100, "pruned"), (311296, 77824, _H100, "pruned"),
    (77824, 19456, _H100, "cluster"), (608, 152, _H100, "cluster"),
    # both sides of one cluster's 163840 points, and of the share of picks
    (163840, 40960, _H100, "cluster"), (163841, 40961, _H100, "pruned"),
    (1200000, 12000, _H100, "pruned"), (1200000, 11999, _H100, "grid"),
    (1200000, 4096, _H100, "grid"), (2097152, 524288, _H100, "pruned"),
    # both sides of what the grid kernel holds (132 x 14336 points): above
    # it the pruned kernel takes any share of picks
    (1892352, 4096, _H100, "grid"), (1892353, 4096, _H100, "pruned"),
    (2000000, 4096, _H100, "pruned"), (2097152, 1, _H100, "pruned"),
    # a card without clusters large enough
    (163840, 40960, _NONE, "grid"), (2432, 608, _NONE, "grid")])
def test_whole_room_fps_routes_by_the_rule(monkeypatch, n, npoint, capacity,
                                           want):
    """B == 1 goes to a cluster of ``csrc/fps.cu``'s kernel where the card
    holds one large enough for the cloud (to 163840 points); above, to the
    chunk-pruned kernel where at least ``PRUNED_MIN_SHARE`` of the points
    are picked or the cloud exceeds the grid kernel, else to
    ``csrc/fps.cu``'s grid kernel."""
    calls = []
    monkeypatch.setattr(port_fps, "_check_cuda", lambda xyz: None)
    monkeypatch.setattr(port_fps, "_grid_points", lambda index: 132 * 14336)
    monkeypatch.setattr(port_fps, "_cluster_capacity", lambda index: capacity)
    for name in ("pruned", "grid", "cluster"):
        target = "furthest_point_sample_pruned" if name == "pruned" \
            else f"_fps_b1_{name}"
        monkeypatch.setattr(port_fps, target,
                            lambda xyz, npoint, *s, _n=name: calls.append(_n))
    port_fps.furthest_point_sample(torch.empty(1, n, 3, device="meta"), npoint)
    assert calls == [want]


@pytest.mark.parametrize("n,s", [(608, 1), (2432, 1), (9728, 8), (38912, 16),
                                 (163840, 16)])
def test_whole_room_cluster_launch_takes_the_dispatch_cluster_size(
        monkeypatch, n, s):
    """A whole-room stage below 163840 points launches ``csrc/fps.cu``'s
    kernel for one cloud at ``fps_cluster_size``'s S for B = 1 (one block
    to 5119 points), counted as a whole-room launch; the pruned kernel's
    wrapper sorts the cloud with the layout kernels and launches once."""
    calls = []
    monkeypatch.setattr(port_fps, "_check_cuda", lambda xyz: None)
    monkeypatch.setattr(port_fps, "_cluster_capacity", lambda index: _H100)
    monkeypatch.setattr(port_fps, "launch",
                        lambda name, *a: calls.append((name, a)))
    _no_stream(monkeypatch)
    before = ops.furthest_point_sample_b1.launches
    out = ops.furthest_point_sample_b1(torch.empty(1, n, 3, device="meta"), 16)
    assert out.shape == (1, 16)
    assert ops.furthest_point_sample_b1.launches == before + 1
    assert [(name, a[2:6]) for name, a in calls] == [("amc3d_fps", (1, n, 16, s))]


@pytest.mark.parametrize("n2,c,want", [(55296, 128, "big"),
                                       (49152, 128, "small"),
                                       (38912, 256, "big")])
def test_interpolation_routes_by_the_rule(monkeypatch, n2, c, want):
    calls = []
    monkeypatch.setattr(port_interp, "_check_forward", lambda *a: None)
    # the listed kernel's launch (``three_interpolation_small`` without the
    # dispatch) also returns the order it took the fine points in
    for name, patched, result in (("big", "three_interpolation_big", (None,) * 3),
                                  ("small", "_listed", (None,) * 4)):
        monkeypatch.setattr(
            port_interp, patched,
            lambda *a, _n=name, _r=result: calls.append(_n) or _r)
    port_interp.three_interpolation(
        torch.empty(1, 4 * n2, 3, device="meta"),
        torch.empty(1, n2, 3, device="meta"),
        torch.empty(1, n2, c, device="meta"))
    assert calls == [want]


@pytest.mark.parametrize("k,want", [(24, [(24, 24, 0)]),
                                    (128, [(128, 128, 0)]),
                                    (129, [(128, 129, 0), (1, 129, 128)]),
                                    (300, [(128, 300, 0), (128, 300, 128),
                                           (44, 300, 256)])])
@pytest.mark.parametrize("big", [False, True])
def test_knn_takes_k_in_passes_of_128(monkeypatch, k, want, big):
    """⌈k/128⌉ launches, each writing its slots of the (B, M, k) rows at
    their offset, after the previous pass's last slot; the launch count
    follows them.  A support of any size (``big``: one point more) takes
    the same kernel."""
    calls = []
    monkeypatch.setattr(port_knn, "_check_cuda", lambda *a: None)
    monkeypatch.setattr(port_knn, "launch",
                        lambda name, *a: calls.append((name, a)))
    _no_stream(monkeypatch)
    sup = torch.empty(1, 101 if big else 100, 3, device="meta")
    q = torch.empty(1, 7, 3, device="meta")
    # the kernel reads a sorted support and the queries' order
    monkeypatch.setattr(port_knn.spatial, "sort_support", lambda s: type(
        "C", (), {"packed": s, "boxes": s})())
    monkeypatch.setattr(port_knn.spatial, "query_order",
                        lambda query, cloud: (query, query))
    before = ops.knn.launches
    idx, d2 = ops.knn(sup, q, k)
    assert idx.shape == d2.shape == (1, 7, k)
    assert ops.knn.launches == before + len(want)
    assert [c[0] for c in calls] == ["amc3d_knn"] * len(want)
    # (k of the pass, row length, first slot), and the outputs' offsets
    assert [c[1][-4:-1] for c in calls] == want
    n_in = 5      # support, boxes, query, order, home
    offsets = [c[1][n_in] - idx.data_ptr() for c in calls]
    assert offsets == [4 * first for *_, first in want]


@pytest.mark.parametrize("k,want", [(1, [(1, 1, 0)]), (32, [(32, 32, 0)]),
                                    (129, [(128, 129, 0), (1, 129, 128)]),
                                    (300, [(128, 300, 0), (128, 300, 128),
                                           (44, 300, 256)])])
@pytest.mark.parametrize("form", ["self", "query layout", "query order"])
def test_ball_query_takes_k_in_passes_of_128(monkeypatch, k, want, form):
    """The ball query launches ``csrc/ball_query.cu`` ⌈k/128⌉ times at any
    N, each pass writing its slots of the (B, M, k) rows after the previous
    pass's; the queries in the support's own order (the self form), in
    their own layout's, or by ``query_order``; the launch count follows."""
    calls = []
    monkeypatch.setattr(port_knn, "_check_cuda", lambda *a: None)
    monkeypatch.setattr(port_knn, "launch",
                        lambda name, *a: calls.append((name, a)))
    _no_stream(monkeypatch)
    sup = torch.empty(1, 40000, 3, device="meta")
    q = sup if form == "self" else torch.empty(1, 7, 3, device="meta")
    # layouts whose tensors the launches must name (host tensors: the
    # launch is recorded, not made)
    layouts = {name: type("C", (), {"packed": torch.empty(4), "boxes": torch.empty(4)})()
               for name in ("support", "query")}
    monkeypatch.setattr(port_knn.spatial, "sort_support",
                        lambda s: layouts["support"])
    monkeypatch.setattr(port_knn.spatial, "check_layout", lambda c, t: None)
    order = torch.empty(1, 7, dtype=torch.int32)
    monkeypatch.setattr(port_knn.spatial, "query_order",
                        lambda query, cloud: (order, order))
    q_cloud = layouts["query"] if form == "query layout" else None
    before = ops.ball_query.launches
    out = ops.ball_query(sup, q, 0.1, k, None, q_cloud)
    assert out.shape == (1, q.shape[1], k)
    assert ops.ball_query.launches == before + len(want)
    assert [c[0] for c in calls] == ["amc3d_ball_query"] * len(want)
    # (k of the pass, row length, first slot) and r² rounded to float32
    assert [c[1][-5:-2] for c in calls] == want
    assert all(c[1][-2] == port_knn._radius2(0.1) for c in calls)
    # the queries: sorted points (self: the support's layout; else their
    # own) with no order, or the query tensor and its order
    packed, boxes, qsorted, _, qorder = calls[0][1][:5]
    assert (packed, boxes) == (layouts["support"].packed.data_ptr(),
                               layouts["support"].boxes.data_ptr())
    if form == "query order":
        assert (qsorted, qorder) == (0, order.data_ptr())
    else:
        ordered = layouts["support" if form == "self" else "query"]
        assert (qsorted, qorder) == (ordered.packed.data_ptr(), 0)
    assert all(c[1][5] == out.data_ptr() for c in calls)


def test_off_the_cpu_the_new_wrappers_raise_rather_than_fall_back():
    meta = torch.empty(1, 300000, 3, device="meta")
    with pytest.raises(ValueError):
        ops.furthest_point_sample_pruned(meta, 8)
    with pytest.raises(ValueError):
        ops.three_interpolation_big(meta, meta[:, :1000],
                                    torch.empty(1, 1000, 8, device="meta"))
    with pytest.raises(ValueError):
        ops.knn(meta[:, :50], meta[:, :50], 300)
    assert ops.furthest_point_sample_pruned.launches == 0
    assert ops.three_interpolation_big.launches == 0


@pytest.mark.parametrize("n,k", [(600, 256), (200, 300)])
def test_knn_beyond_128_matches_jax(n, k):
    """k above one launch's slots, and k > N (index 0 at 1e10 past N), on a
    1/128 grid where d² is exact in both forms: the JAX exact kNN's indices
    and d²."""
    rng = np.random.RandomState(n)
    sup = (np.round(rng.rand(2, n, 3) * 256) / 128).astype(np.float32)
    q = sup[:, ::3].copy()
    got_i, got_d = ops.knn(_t(sup), _t(q), k)
    want_i, want_d = _knn_jnp(jnp.asarray(sup), jnp.asarray(q), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))


# ---- the PointNet++ cfg -----------------------------------------------------

def test_pointnet2_cfg_builds_and_matches_jax():
    """``cfgs/s3dis/pointnet++.yaml`` (BaseSeg over PointNet2Encoder /
    PointNet2Decoder), narrowed, with the JAX weights and random batch
    statistics carried over: logits within 1e-4·(1+max)."""
    from amcontrast3d_tpu.models import build_model_from_cfg as jax_build
    from amcontrast3d_tpu.utils import EasyConfig as JaxConfig
    from amcontrast3d_tpu_torch.models import (PointNet2Decoder,
                                               PointNet2Encoder,
                                               build_model_from_cfg)
    from amcontrast3d_tpu_torch.utils import EasyConfig
    from amcontrast3d_tpu_torch.utils.convert import from_jax_variables

    path, narrow = "cfgs/s3dis/pointnet++.yaml", ["model.encoder_args.width=8",
                                                   "model.encoder_args.layers=2"]
    cj, cp = JaxConfig(), EasyConfig()
    for cfg in (cj, cp):
        cfg.load(path, recursive=True)
        cfg.update(narrow)
    rng = np.random.RandomState(5)
    pos = (np.round(rng.rand(1, 512, 3) * 256) / 128).astype(np.float32)
    x = rng.rand(1, 512, 4).astype(np.float32)
    jm = jax_build(cj.model)
    # jitted: eagerly, flax's init and apply take seconds an op
    variables = jax.tree_util.tree_map(np.array, dict(jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.asarray(pos), jnp.asarray(x))))
    for leaf, draw in (("mean", lambda s: 0.1 * rng.randn(*s)),
                       ("var", lambda s: 0.5 + rng.rand(*s))):
        for path_, arr in _leaves(variables["batch_stats"]):
            if path_[-1] == leaf:
                arr[...] = draw(arr.shape)
    want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(pos),
                                        jnp.asarray(x)))
    model = build_model_from_cfg(cp.model)
    assert isinstance(model.encoder, PointNet2Encoder)
    assert isinstance(model.decoder, PointNet2Decoder)
    model.load_state_dict(from_jax_variables(variables), strict=True)
    model.eval()
    with torch.no_grad():
        got = model(_t(pos), _t(x)).numpy()
    assert got.shape == want.shape == (1, 512, 13)
    err = np.abs(got - want).max()
    assert err <= 1e-4 * (1 + np.abs(want).max()), err


def _leaves(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value
