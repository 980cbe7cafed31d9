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
