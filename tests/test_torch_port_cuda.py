"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Skips without a CUDA device.  Imports neither JAX nor the JAX package, so
it runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
"""
import numpy as np
import pytest
import torch

from amcontrast3d_tpu_torch import ops


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda", 0)


def _cloud(rng, b, n, clustered):
    if not clustered:
        return (rng.rand(b, n, 3) * 4).astype(np.float32)
    centres = rng.rand(b, 16, 3) * 4
    pts = np.take_along_axis(centres, rng.randint(0, 16, (b, n))[..., None], 1)
    return (pts + 0.05 * rng.randn(b, n, 3)).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("clustered", [False, True])
def test_kernels_match_plain(cuda_device, clustered):
    rng = np.random.RandomState(12)
    xyz = torch.from_numpy(_cloud(rng, 4, 6000, clustered)).to(cuda_device)
    idx = ops.furthest_point_sample(xyz, 1500)
    np.testing.assert_array_equal(
        idx.cpu().numpy(), ops.furthest_point_sample_plain(xyz, 1500).cpu().numpy())
    q = ops.gather_points(xyz, idx).contiguous()
    for r, k in ((0.2, 32), (0.4, 32), (1.6, 40)):
        np.testing.assert_array_equal(
            ops.ball_query(xyz, q, r, k).cpu().numpy(),
            ops.ball_query_plain(xyz, q, r, k).cpu().numpy())
    for c in (3, 96, 200):      # C below, at and above the block width
        f = torch.from_numpy(rng.randn(4, 1500, c).astype(np.float32)).to(cuda_device)
        got = ops.three_interpolation(xyz, q, f)
        want = ops.three_interpolation_plain(xyz, q, f)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        assert err <= 1e-5 * (1 + want.abs().max().item())


@pytest.mark.cuda
def test_kernels_small_and_ragged(cuda_device):
    """k > N, fewer queries than a block, and N not a multiple of a tile."""
    rng = np.random.RandomState(13)
    sup = torch.from_numpy(_cloud(rng, 2, 4, False)).to(cuda_device)
    np.testing.assert_array_equal(
        ops.ball_query(sup, sup, 1.6, 32).cpu().numpy(),
        ops.ball_query_plain(sup, sup, 1.6, 32).cpu().numpy())
    xyz = torch.from_numpy(_cloud(rng, 3, 1030, False)).to(cuda_device)
    np.testing.assert_array_equal(
        ops.furthest_point_sample(xyz, 257).cpu().numpy(),
        ops.furthest_point_sample_plain(xyz, 257).cpu().numpy())
    q = xyz[:, :5].contiguous()
    f = torch.from_numpy(rng.randn(3, 5, 7).astype(np.float32)).to(cuda_device)
    got = ops.three_interpolation(xyz, q, f)
    want = ops.three_interpolation_plain(xyz, q, f)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-5 * (1 + want.abs().max().item())


def _close(got, want, tol):
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    assert err <= tol * (1 + want.abs().max().item()), err


def _check_interp_backward(xyz, q, f):
    """Forward kernel with kept indices/weights, then the backward kernel,
    against the plain twins (atomics: summation order varies, 1e-5)."""
    g = torch.randn(xyz.shape[0], xyz.shape[1], f.shape[-1], device=f.device,
                    generator=torch.Generator(f.device).manual_seed(0))
    fk = f.clone().requires_grad_()
    fp = f.clone().requires_grad_()
    out_k = ops.three_interpolation(xyz, q, fk)
    out_p = ops.three_interpolation_plain(xyz, q, fp)
    _close(out_k.detach(), out_p.detach(), 1e-5)
    out_k.backward(g)
    out_p.backward(g)
    _close(fk.grad, fp.grad, 1e-5)


def _stage(rng, dev, b, n, c, clustered, nsample=24):
    p = torch.from_numpy(_cloud(rng, b, n, clustered)).to(dev)
    f = torch.nn.functional.normalize(
        torch.from_numpy(rng.randn(b, n, c).astype(np.float32)).to(dev), dim=-1)
    lab = torch.from_numpy(rng.randint(0, 13, (b, n)).astype(np.float32)).to(dev)
    kth = ops.knn(p, p, nsample)[1][..., -1] * (1.0 + 1e-5)
    return p, f, lab, kth.contiguous()


def _check_contrast(p, f, lab, kth, root, need_s):
    """Kernels #14-16 against their twins: counts and column 8 identical,
    sums within 1e-5·(1+max), each VJP half within 1e-4·(1+max)."""
    tinv = 1 / 0.3
    got = ops.contrast_forward(p, f, lab, kth, tinv, root, need_s, True)
    want = ops.contrast_forward_plain(p, f, lab, kth, tinv, root, need_s, True)
    torch.cuda.synchronize()
    assert torch.equal(got[..., 4:6], want[..., 4:6])
    assert torch.equal(got[..., 8], want[..., 8])
    for col in (0, 1, 2, 3, 6, 7):
        _close(got[..., col], want[..., col], 1e-5)
    g4 = torch.randn(*f.shape[:2], 4, device=f.device,
                     generator=torch.Generator(f.device).manual_seed(1))
    _close(ops.contrast_grad_rows(p, f, lab, kth, g4, tinv, need_s),
           ops.contrast_grad_rows_plain(p, f, lab, kth, g4, tinv, need_s), 1e-4)
    _close(ops.contrast_grad_support(p, f, lab, kth, g4, tinv, need_s),
           ops.contrast_grad_support_plain(p, f, lab, kth, g4, tinv, need_s), 1e-4)
    fk, fp = f.clone().requires_grad_(), f.clone().requires_grad_()
    gout = torch.randn(*f.shape[:2], 9, device=f.device,
                       generator=torch.Generator(f.device).manual_seed(2))
    ops.contrast_reductions(p, fk, lab, kth, tinv, root, need_s).backward(gout)
    ops.contrast_reductions_plain(p, fp, lab, kth, tinv, root, need_s).backward(gout)
    _close(fk.grad, fp.grad, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("clustered", [False, True])
def test_train_kernels_match_plain(cuda_device, clustered):
    """Interpolation VJP and the contrast kernels at widths of the train
    step (N 1500 / 375, C 256 / 512), on uniform and clustered clouds."""
    rng = np.random.RandomState(14)
    xyz = torch.from_numpy(_cloud(rng, 4, 6000, clustered)).to(cuda_device)
    q = ops.gather_points(xyz, ops.furthest_point_sample(xyz, 1500)).contiguous()
    for c in (3, 96, 256):
        f = torch.from_numpy(rng.randn(4, 1500, c).astype(np.float32)).to(cuda_device)
        _check_interp_backward(xyz, q, f)
    for n, c in ((1500, 256), (375, 512)):
        _check_contrast(*_stage(rng, cuda_device, 4, n, c, clustered), False, False)


@pytest.mark.cuda
@pytest.mark.parametrize("n,c,root,need_s", [
    (25, 3, True, True),        # N just above nsample, C below a warp
    (1030, 32, False, True),    # N not a multiple of a tile
    (2049, 200, True, False),   # C not a multiple of 32, two support tiles
])
def test_train_kernels_small_and_ragged(cuda_device, n, c, root, need_s):
    rng = np.random.RandomState(n)
    for clustered in (False, True):
        _check_contrast(*_stage(rng, cuda_device, 3, n, c, clustered), root, need_s)
    xyz = torch.from_numpy(_cloud(rng, 3, n, False)).to(cuda_device)
    q = xyz[:, : max(n // 4, 3)].contiguous()
    f = torch.from_numpy(rng.randn(3, q.shape[1], c).astype(np.float32)).to(cuda_device)
    _check_interp_backward(xyz, q, f)


def _knn_equal(sup, q, k):
    got_i, got_d = ops.knn(sup, q, k)
    want_i, want_d = ops.knn_plain(sup, q, k)
    torch.cuda.synchronize()
    assert got_i.dtype == torch.int32 and got_i.shape == want_i.shape
    bad = int((got_i != want_i).sum())
    assert bad == 0, f"{bad} of {got_i.numel()} indices differ"
    assert torch.equal(got_d, want_d)


@pytest.mark.cuda
@pytest.mark.parametrize("clustered", [False, True])
def test_knn_kernel_matches_plain(cuda_device, clustered):
    """Kernel #6 against ``knn_plain``: indices and d² identical, at every k
    the paths use, with M ≠ N, and on a grid cloud full of d² ties and
    duplicate points (ties go to the lowest index)."""
    rng = np.random.RandomState(15)
    sup = torch.from_numpy(_cloud(rng, 3, 6000, clustered)).to(cuda_device)
    q = sup[:, ::4].contiguous()
    for k in (1, 3, 4, 12, 16, 24, 33, 64, 100):
        _knn_equal(sup, q, k)
    _knn_equal(sup, sup, 24)
    grid = torch.from_numpy((rng.randint(0, 12, (2, 3000, 3)) / 4)
                            .astype(np.float32)).to(cuda_device)
    for k in (3, 24, 64):
        _knn_equal(grid, grid, k)


@pytest.mark.cuda
def test_knn_kernel_small_and_ragged(cuda_device):
    """N not a multiple of the tile, M = 1, k = 1, k = 64, k > N; k above
    the kernel's maximum and a non-contiguous tensor raise."""
    rng = np.random.RandomState(16)
    sup = torch.from_numpy(_cloud(rng, 2, 1030, False)).to(cuda_device)
    for m, k in ((1, 1), (1, 64), (5, 24), (1030, 3)):
        _knn_equal(sup, sup[:, :m].contiguous(), k)
    tiny = torch.from_numpy(_cloud(rng, 2, 7, False)).to(cuda_device)
    for k in (1, 7, 8, 24, 64, 128):
        _knn_equal(tiny, tiny, k)
    with pytest.raises(ValueError):
        ops.knn(sup, sup, 129)
    with pytest.raises(ValueError):
        ops.knn(sup, sup.transpose(0, 1)[:, :2].transpose(0, 1)[:, ::2], 3)


def _ambiguity(rng, b, n, ties):
    """Continuous in (0, 1), or with many exact zeros and repeated values."""
    a = rng.rand(b, n).astype(np.float32)
    if ties:
        a = np.where(rng.rand(b, n) < 0.4, 0.0, np.round(a * 4) / 4)
    return a.astype(np.float32)


def _check_refine(dev, rng, b, n, c, k, clustered=False):
    """Kernels #18 and #19 against their twins: MIN a row copy (identical),
    MIN_ALL0 within 1e-5·(1+max); the VJP (float atomics) within
    1e-5·(1+max|df|) of the twin's ``index_add_`` and of autograd through
    the gather form."""
    p = torch.from_numpy(_cloud(rng, b, n, clustered)).to(dev)
    f = torch.from_numpy(rng.randn(b, n, c).astype(np.float32)).to(dev)
    g = torch.from_numpy(rng.randn(b, n, c).astype(np.float32)).to(dev)
    for ties in (False, True):
        a = torch.from_numpy(_ambiguity(rng, b, n, ties)).to(dev)
        for fusion in ("MIN", "MIN_ALL0"):
            got, sel = ops.refine_cross(p, f, a, k, fusion, keep=True)
            want, sel_p = ops.refine_cross_plain(p, f, a, k, fusion)
            torch.cuda.synchronize()
            assert torch.equal(sel, sel_p), (fusion, ties)
            if fusion == "MIN":
                assert torch.equal(got, want)
            else:
                _close(got, want, 1e-5)
            assert torch.equal(ops.refine_cross(p, f, a, k, fusion)[0], got)
            fk = f.clone().requires_grad_()
            fp = f.clone().requires_grad_()
            fa = f.clone().requires_grad_()
            ops.dual_masks_cross(p, fk, a, k, fusion).backward(g)
            ops.dual_masks_cross_plain(p, fp, a, k, fusion).backward(g)
            # autograd through the gather form of the JAX plain path
            idx = ops.knn_plain(p, p, k)[0][..., 1:]
            na = ops.group_points(a[..., None], idx)[..., 0]
            if fusion == "MIN":
                gi = torch.gather(idx, -1, na.argmin(-1, keepdim=True))[..., 0]
                ref = ops.gather_points(fa, gi)
            else:
                ref = (ops.group_points(fa, idx)
                       * (na <= 0)[..., None].float()).mean(2)
            ref.backward(g)
            _close(fk.grad, fp.grad, 1e-5)
            _close(fk.grad, fa.grad, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("clustered", [False, True])
def test_refine_kernels_match_plain(cuda_device, clustered):
    """At decoder widths of the MM path (N 1500 / C 256, N 375 / C 512),
    k = 12."""
    rng = np.random.RandomState(17)
    for n, c in ((1500, 256), (375, 512)):
        _check_refine(cuda_device, rng, 4, n, c, 12, clustered)


@pytest.mark.cuda
@pytest.mark.parametrize("n,c,k", [
    (5, 3, 12),        # N < k: the padded slots index point 0
    (1030, 33, 2),     # one slot; N not a multiple of the tile
    (2049, 200, 40),   # two registers a lane; C not a multiple of 32
    (300, 7, 100),     # four registers a lane
])
def test_refine_kernels_small_and_ragged(cuda_device, n, c, k):
    _check_refine(cuda_device, np.random.RandomState(n), 2, n, c, k)
    p = torch.zeros(1, 8, 3, device=cuda_device)
    f = torch.zeros(1, 8, 4, device=cuda_device)
    a = torch.zeros(1, 8, device=cuda_device)
    with pytest.raises(ValueError):
        ops.dual_masks_cross(p, f, a, 1, "MIN")
    with pytest.raises(ValueError):
        ops.dual_masks_cross(p, f, a, 129, "MIN")
    with pytest.raises(ValueError):
        ops.dual_masks_cross(p, f, a, 4, "MAX")
    with pytest.raises(ValueError):
        ops.dual_masks_cross(p, f.transpose(1, 2).contiguous().transpose(1, 2),
                             a, 4, "MIN")


def _room(rng, n, dup=0.05):
    """A room-like cloud: points on the six faces of a 6 x 5 x 3 m box and
    in two solid boxes, snapped to a 0.04 m grid, a share of them repeated
    (as bucket padding repeats real points)."""
    face = rng.rand(n, 3) * [6, 5, 3]
    axis = rng.randint(0, 3, n)
    side = rng.randint(0, 2, n) * np.array([6, 5, 3])[axis]
    face[np.arange(n), axis] = side + 0.01 * rng.randn(n)
    solid = rng.rand(n // 5, 3) * [1.0, 0.8, 0.7] + [2, 2, 0]
    pts = np.concatenate([face[: n - len(solid)], solid])
    pts = np.floor(pts / 0.04) * 0.04 + 0.02
    rep = rng.randint(0, n, int(n * dup))
    pts[rng.randint(0, n, len(rep))] = pts[rep]
    return pts[rng.permutation(n)][None].astype(np.float32)


_FPS_B1_KERNELS = (ops.fps._fps_b1_grid, ops.fps._fps_b1_cluster)


def _equal(got, want):
    torch.cuda.synchronize()
    assert torch.equal(got, want), int((got != want).sum())


@pytest.mark.cuda
@pytest.mark.parametrize("n,npoint", [(1, 1), (7, 7), (1030, 257), (5000, 5000),
                                      (40001, 3000), (150001, 1200)])
def test_fps_b1_matches_plain(cuda_device, n, npoint):
    """The whole-room FPS at odd sizes: one point, npoint = N, N not a
    multiple of anything, one block and many: picks identical."""
    rng = np.random.RandomState(n)
    xyz = torch.from_numpy(_cloud(rng, 1, n, n % 2 == 0)).to(cuda_device)
    before = ops.furthest_point_sample_b1.launches
    got = ops.furthest_point_sample(xyz, npoint)      # B == 1 dispatches
    assert ops.furthest_point_sample_b1.launches == before + 1
    want = ops.furthest_point_sample_plain(xyz, npoint)
    _equal(got, want)
    for kernel in _FPS_B1_KERNELS:       # both kernels take these sizes
        _equal(kernel(xyz, npoint), want)


@pytest.mark.cuda
def test_fps_b1_ties_and_duplicates(cuda_device):
    """All points equal (every pick is a tie that index 0 wins), and a
    gridded room with duplicates."""
    same = torch.ones(1, 3000, 3, device=cuda_device)
    room = torch.from_numpy(_room(np.random.RandomState(3), 20000)).to(cuda_device)
    for kernel in _FPS_B1_KERNELS:
        _equal(kernel(same, 50), ops.furthest_point_sample_plain(same, 50))
        _equal(kernel(room, 5000), ops.furthest_point_sample_plain(room, 5000))
    with pytest.raises(ValueError):
        ops.furthest_point_sample_b1(room.expand(2, -1, -1).contiguous(), 10)


@pytest.mark.cuda
def test_fps_b1_above_the_cluster_takes_the_grid(cuda_device):
    """More points than one cluster keeps go to the grid kernel; asking for
    the cluster there raises."""
    rng = np.random.RandomState(9)
    xyz = torch.from_numpy(_cloud(rng, 1, 16 * 512 * 20 + 1, False)).to(cuda_device)
    _equal(ops.furthest_point_sample_b1(xyz, 300),
           ops.furthest_point_sample_plain(xyz, 300))
    with pytest.raises(ValueError):
        ops.fps._fps_b1_cluster(xyz, 300)


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", [(1, 1), (5, 3), (63, 63), (65, 200),
                                 (4099, 1031), (32769, 4000), (32767, 4000)])
def test_big_knn_and_ball_query_match_plain(cuda_device, n, m):
    """The chunk-skipping kernels at odd sizes, with k below and above N,
    just above and below the 32768 gate: identical to the twins and to the
    small-cloud kernels."""
    rng = np.random.RandomState(n + m)
    sup = torch.from_numpy(_cloud(rng, 2, n, n % 2 == 1)).to(cuda_device)
    q = torch.from_numpy(_cloud(rng, 2, m, False)).to(cuda_device)
    q[:, : min(m, n) // 2] = sup[:, : min(m, n) // 2]   # queries on the support
    for k in (1, 24, 33, 128):
        want_i, want_d = ops.knn_plain(sup, q, k)
        for fn in (ops.knn_big, ops.knn_small):
            got_i, got_d = fn(sup, q, k)
            _equal(got_i, want_i)
            _equal(got_d, want_d)
    for r, k in ((0.05, 32), (0.3, 32), (0.3, 70), (9.0, 16)):
        want = ops.ball_query_plain(sup, q, r, k)
        _equal(ops.ball_query_big(sup, q, r, k), want)
        _equal(ops.ball_query_small(sup, q, r, k), want)
    # the dispatch follows the gate
    counts = (ops.knn_big.launches, ops.ball_query_big.launches)
    ops.knn(sup, q, 3)
    ops.ball_query(sup, q, 0.2, 8)
    big = int(n > 32768)
    assert (ops.knn_big.launches, ops.ball_query_big.launches) == \
        (counts[0] + big, counts[1] + big)


@pytest.mark.cuda
def test_big_kernels_room_duplicates_and_empty_balls(cuda_device):
    """A gridded room with repeated points (ties in d² at every distance),
    all points equal, and queries far from the support (empty balls)."""
    rng = np.random.RandomState(5)
    room = torch.from_numpy(_room(rng, 40000)).to(cuda_device)
    q = room[:, ::4].contiguous()
    for k in (12, 24):
        want_i, want_d = ops.knn_plain(room, q, k)
        got_i, got_d = ops.knn_big(room, q, k)
        _equal(got_i, want_i)
        _equal(got_d, want_d)
    for r in (0.1, 0.2):
        _equal(ops.ball_query_big(room, q, r, 32),
               ops.ball_query_plain(room, q, r, 32))
    far = q + 50.0
    got = ops.ball_query_big(room, far, 0.1, 32)
    _equal(got, torch.zeros_like(got))
    same = torch.ones(1, 700, 3, device=cuda_device)
    _equal(ops.ball_query_big(same, same, 0.1, 32),
           ops.ball_query_plain(same, same, 0.1, 32))
    want_i, want_d = ops.knn_plain(same, same, 24)
    got_i, got_d = ops.knn_big(same, same, 24)
    _equal(got_i, want_i)
    _equal(got_d, want_d)


# ---------------------------------------------------------------------------
# the interpolation VJP for large query sets, and the ScanNet recipe's shapes
# ---------------------------------------------------------------------------

def _triples(rng, dev, b, n1, n2, c):
    """Saved (idx, weight) of a forward and an incoming gradient."""
    idx = torch.from_numpy(rng.randint(0, n2, (b, n1, 3)).astype(np.int32)).to(dev)
    w = torch.from_numpy(rng.rand(b, n1, 3).astype(np.float32)).to(dev)
    w = (w / w.sum(-1, keepdim=True)).contiguous()
    g = torch.from_numpy(rng.randn(b, n1, c).astype(np.float32)).to(dev)
    return g, idx, w


@pytest.mark.cuda
@pytest.mark.parametrize("b,n1,n2,c", [
    (1, 1, 1, 1), (2, 1031, 257, 12), (3, 5000, 70, 200), (1, 300, 900, 128),
    (2, 4099, 1000, 300), (1, 2000, 50, 11264)])
def test_interp_backward_big_matches_plain_and_itself(cuda_device, b, n1, n2, c):
    """The support-owned backward at sizes that are a multiple of no tile,
    with C below and above the block width and at its limit: within
    1e-5·(1+max) of the twin (same order of summation, other rounding of
    nothing: the bound is the twin's own atomics on the card), bit-identical
    over two runs, and a support row no query selects is exactly 0."""
    rng = np.random.RandomState(n1 + c)
    g, idx, w = _triples(rng, cuda_device, b, n1, n2, c)
    idx[idx == n2 // 2] = 0                      # row n2 // 2 is never selected
    before = ops.three_interpolation_backward_big.launches
    got = ops.three_interpolation_backward_big(g, idx, w, n2)
    again = ops.three_interpolation_backward_big(g, idx, w, n2)
    assert ops.three_interpolation_backward_big.launches == before + 2
    want = ops.three_interpolation_backward_plain(g, idx, w, n2)
    _close(got, want, 1e-5)
    assert torch.equal(got, again)
    if n2 > 1:
        assert not got[:, n2 // 2].any()
    _close(ops.three_interpolation_backward_small(g, idx, w, n2), want, 1e-5)


@pytest.mark.cuda
def test_interp_backward_dispatch_follows_the_gate(cuda_device):
    """(N1, C) = (64000, 128) goes to the support-owned kernel, (24000, 128)
    to the scatter kernel, through the autograd function as well."""
    rng = np.random.RandomState(4)
    big, small = (ops.three_interpolation_backward_big,
                  ops.three_interpolation_backward)
    for n1, is_big in ((64000, True), (24000, False)):
        p1 = torch.from_numpy(_cloud(rng, 1, n1, False)).to(cuda_device)
        p2 = p1[:, ::4].contiguous()
        f = torch.from_numpy(rng.randn(1, p2.shape[1], 128).astype(np.float32)
                             ).to(cuda_device).requires_grad_()
        counts = (big.launches, small.launches)
        out = ops.three_interpolation(p1, p2, f)
        out.backward(torch.ones_like(out))
        assert (big.launches, small.launches) == \
            (counts[0] + is_big, counts[1] + (not is_big))
        fp = f.detach().clone().requires_grad_()
        outp = ops.three_interpolation_plain(p1, p2, fp)
        outp.backward(torch.ones_like(outp))
        _close(f.grad, fp.grad, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,npoint", [(2, 64000, 16000), (3, 57345, 700),
                                        (2, 163841, 300)])
def test_batched_fps_above_the_shared_memory_limit(cuda_device, b, n, npoint):
    """B > 1 with more points a cloud than the batched kernel's shared
    memory holds: one cluster a cloud in one launch (or, above the cluster's
    163840 points, the grid kernel cloud by cloud), picks identical to the
    twin; the clouds differ, so a kernel that sampled one cloud B times
    would fail."""
    rng = np.random.RandomState(n)
    xyz = torch.from_numpy(_cloud(rng, b, n, True)).to(cuda_device)
    counts = (ops.furthest_point_sample.launches,
              ops.furthest_point_sample_b1.launches)
    got = ops.furthest_point_sample(xyz, npoint)
    want = ops.furthest_point_sample_plain(xyz, npoint)
    _equal(got, want)
    assert ops.furthest_point_sample.launches == counts[0]
    assert ops.furthest_point_sample_b1.launches == \
        counts[1] + (1 if n <= 163840 else b)


@pytest.mark.cuda
def test_batched_fps_below_the_limit_keeps_its_kernel(cuda_device):
    rng = np.random.RandomState(8)
    xyz = torch.from_numpy(_cloud(rng, 2, 57344, False)).to(cuda_device)
    counts = (ops.furthest_point_sample.launches,
              ops.furthest_point_sample_b1.launches)
    _equal(ops.furthest_point_sample(xyz, 200),
           ops.furthest_point_sample_plain(xyz, 200))
    assert (ops.furthest_point_sample.launches,
            ops.furthest_point_sample_b1.launches) == (counts[0] + 1, counts[1])


@pytest.mark.cuda
def test_large_cloud_kernels_at_batch_two(cuda_device):
    """The ScanNet recipe's shapes, B = 2 clouds that differ: the loss's
    self-kNN (64000², k = 24), the stage-0 ball query (16000 queries,
    r = 0.05, k = 32) and a label propagation (k = 4): identical to the
    twins, so the sort and the boxes are per cloud."""
    rng = np.random.RandomState(21)
    sup = torch.from_numpy(np.concatenate(
        [_room(rng, 64000), _room(rng, 64000) * 0.5 + 1.0])).to(cuda_device)
    q = sup[:, ::4].contiguous()
    for query, k in ((sup, 24), (q, 4)):
        want_i, want_d = ops.knn_plain(sup, query, k)
        got_i, got_d = ops.knn(sup, query, k)
        _equal(got_i, want_i)
        _equal(got_d, want_d)
    before = ops.ball_query_big.launches
    _equal(ops.ball_query(sup, q, 0.05, 32),
           ops.ball_query_plain(sup, q, 0.05, 32))
    assert ops.ball_query_big.launches == before + 1


@pytest.mark.cuda
def test_contrast_kernels_at_64000_points(cuda_device):
    """N² = 4.1e9 is past 2³¹: forward, rows and support against their
    twins at (2, 64000, 64), with an ignored label (-100) among the
    classes."""
    rng = np.random.RandomState(22)
    p, f, lab, kth = _stage(rng, cuda_device, 2, 64000, 64, True)
    lab[:, ::7] = -100.0
    _check_contrast(p, f, lab, kth, 0, True)
