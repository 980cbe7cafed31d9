"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Skips without a CUDA device.  Imports neither JAX nor the JAX package, so
it runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
"""
import numpy as np
import pytest
import torch

from amcontrast3d_tpu_torch import ops
from amcontrast3d_tpu_torch.ops import spatial


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


def _check_contrast(p, f, lab, kth, root, need_s, cloud=None):
    """Kernels #14-16 against their twins: counts and column 8 identical,
    sums within 1e-5·(1+max), each VJP half within 1e-4·(1+max); each
    chunk-pruned kernel over ``cloud`` (the layout of ``p``, made here when
    not given) and over its own sort gives the same bits."""
    tinv = 1 / 0.3
    if cloud is None:
        cloud = spatial.sort_support(p)
    fwd = (p, f, lab, kth, tinv, root, need_s, True)
    got = ops.contrast_forward(*fwd, cloud=cloud)
    want = ops.contrast_forward_plain(*fwd)
    torch.cuda.synchronize()
    assert torch.equal(got[..., 4:6], want[..., 4:6])
    assert torch.equal(got[..., 8], want[..., 8])
    for col in (0, 1, 2, 3, 6, 7):
        _close(got[..., col], want[..., col], 1e-5)
    _equal(ops.contrast_forward(*fwd), got)
    g4 = torch.randn(*f.shape[:2], 4, device=f.device,
                     generator=torch.Generator(f.device).manual_seed(1))
    grad = (p, f, lab, kth, g4, tinv, need_s)
    for kernel, plain in ((ops.contrast_grad_rows, ops.contrast_grad_rows_plain),
                          (ops.contrast_grad_support, ops.contrast_grad_support_plain)):
        df = kernel(*grad, cloud)
        _close(df, plain(*grad), 1e-4)
        _equal(kernel(*grad), df)
    fk, fp = f.clone().requires_grad_(), f.clone().requires_grad_()
    gout = torch.randn(*f.shape[:2], 9, device=f.device,
                       generator=torch.Generator(f.device).manual_seed(2))
    ops.contrast_reductions(p, fk, lab, kth, tinv, root, need_s,
                            cloud=cloud).backward(gout)
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
    """``ops.knn`` sorting for itself and over the support's given layout
    (the self form when ``q`` is ``sup``): identical to ``knn_plain``."""
    want_i, want_d = ops.knn_plain(sup, q, k)
    for cloud in (None, spatial.sort_support(sup)):
        got_i, got_d = ops.knn(sup, q, k, cloud)
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
    _knn_equal(sup, sup, 24)              # the self form
    _knn_equal(sup, sup.clone(), 24)      # the same points, sorted again
    grid = torch.from_numpy((rng.randint(0, 12, (2, 3000, 3)) / 4)
                            .astype(np.float32)).to(cuda_device)
    for k in (3, 24, 64):
        _knn_equal(grid, grid, k)
    # a 1/128 m grid: d² ties at every k-th, equal Morton codes across
    # chunk edges; the label propagation's shape, M ≠ N over p0's layout
    fine = torch.from_numpy((rng.randint(0, 24, (2, 24000, 3)) / 128)
                            .astype(np.float32)).to(cuda_device)
    for k in (24, 129):
        _knn_equal(fine, fine, k)
    cloud0 = spatial.sort_support(fine)
    for s, k in ((1, 4), (2, 16), (3, 64)):
        q = fine[:, ::4 ** s].contiguous()
        want_i, want_d = ops.knn_plain(fine, q, k)
        got_i, got_d = ops.knn(fine, q, k, cloud0)
        _equal(got_i, want_i)
        _equal(got_d, want_d)


@pytest.mark.cuda
def test_knn_kernel_small_and_ragged(cuda_device):
    """N not a multiple of the tile, M = 1, k = 1, k = 64, k > N; k above
    one launch's 128 slots takes passes; a non-contiguous tensor raises."""
    rng = np.random.RandomState(16)
    sup = torch.from_numpy(_cloud(rng, 2, 1030, False)).to(cuda_device)
    for m, k in ((1, 1), (1, 64), (5, 24), (1030, 3)):
        _knn_equal(sup, sup[:, :m].contiguous(), k)
    tiny = torch.from_numpy(_cloud(rng, 2, 7, False)).to(cuda_device)
    for k in (1, 7, 8, 24, 64, 128, 129, 300):
        _knn_equal(tiny, tiny, k)
    # N below a chunk, one past it, not a multiple of it; every point the same
    for n in (37, 65, 1000):
        few = torch.from_numpy(_cloud(rng, 2, n, True)).to(cuda_device)
        for k in (1, 24, 64, 129, n + 3):
            _knn_equal(few, few, k)
        _knn_equal(few, few[:, ::3].contiguous(), 16)
    same = torch.full((2, 300, 3), 0.25, device=cuda_device)
    for k in (1, 24, 129, 301):
        _knn_equal(same, same, k)
    before = ops.knn.launches
    _knn_equal(sup, sup, 129)
    assert ops.knn.launches == before + 4      # two passes, with and without a layout
    with pytest.raises(ValueError):
        ops.knn(sup, sup.transpose(0, 1)[:, :2].transpose(0, 1)[:, ::2], 3)
    with pytest.raises(ValueError):     # the layout of another cloud
        ops.knn(sup, sup, 3, spatial.sort_support(sup[:, :1000].contiguous()))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["grid", "coincident", "clustered"])
@pytest.mark.parametrize("n", [1, 37, 64, 65, 1000, 6000])
def test_contrast_support_kernel_ties_tiny_and_repeatable(cuda_device, kind, n):
    """Kernel #16 on clouds full of d² ties (a 1/128 m grid, every point the
    same) and at N below, at and above one chunk: within 1e-4·(1+max|df|)
    of its twin, the same bits over two runs, and over a given layout."""
    rng = np.random.RandomState(n)
    if kind == "grid":
        pts = rng.randint(0, 16, (2, n, 3)) / 128
    elif kind == "coincident":
        pts = np.full((2, n, 3), 0.5)
    else:
        pts = _cloud(rng, 2, n, True)
    p = torch.from_numpy(pts.astype(np.float32)).to(cuda_device)
    f = torch.nn.functional.normalize(torch.from_numpy(
        rng.randn(2, n, 64).astype(np.float32)).to(cuda_device), dim=-1)
    lab = torch.from_numpy(rng.randint(0, 4, (2, n)).astype(np.float32)).to(cuda_device)
    kth = (ops.knn(p, p, 24)[1][..., -1] * (1.0 + 1e-5)).contiguous()
    g4 = torch.from_numpy(rng.randn(2, n, 4).astype(np.float32)).to(cuda_device)
    want = ops.contrast_grad_support_plain(p, f, lab, kth, g4, 1 / 0.3, True)
    before = ops.contrast_grad_support.launches
    first = ops.contrast_grad_support(p, f, lab, kth, g4, 1 / 0.3, True)
    _close(first, want, 1e-4)
    _equal(ops.contrast_grad_support(p, f, lab, kth, g4, 1 / 0.3, True), first)
    _equal(ops.contrast_grad_support(p, f, lab, kth, g4, 1 / 0.3, True,
                                     spatial.sort_support(p)), first)
    assert ops.contrast_grad_support.launches == before + 3


@pytest.mark.cuda
@pytest.mark.parametrize("b,sizes,kind", [
    (4, (24000, 6000, 1500, 375), "uniform"), (2, (64000, 16000, 4000, 1000), "grid"),
    (3, (130, 65, 7, 1), "clustered"), (1, (37,), "coincident")])
def test_layout_kernels_match_their_twins(cuda_device, b, sizes, kind):
    """The stage layouts by ``csrc/layout.cu`` (keys, one sort, packing):
    each kernel's outputs identical to its twin's on the same inputs, and
    every layout identical to ``sort_support`` of its stage alone; then the
    support kernel's sorted (label, threshold) and chunk maxima."""
    rng = np.random.RandomState(len(sizes) + b)
    stages = []
    for n in sizes:
        if kind == "grid":
            pts = rng.randint(0, 40, (b, n, 3)) / 128
        elif kind == "coincident":
            pts = np.full((b, n, 3), 0.5)
        else:
            pts = _cloud(rng, b, n, kind == "clustered")
        stages.append(torch.from_numpy(pts.astype(np.float32)).to(cuda_device))
    points = torch.cat([p.reshape(-1, 3) for p in stages])
    before = (spatial.layout_keys.launches, spatial.layout_pack.launches)
    keys, frame = spatial.layout_keys(points, b, sizes)
    want = spatial.layout_keys_plain(points, b, sizes)
    _equal(keys, want[0])
    _equal(frame, want[1])
    skeys, perm = torch.sort(keys, stable=True)
    got = spatial.layout_pack(points, perm, skeys, b, sizes)
    for g, w in zip(got, spatial.layout_pack_plain(points, perm, skeys, b, sizes)):
        _equal(g, w)
    assert (spatial.layout_keys.launches, spatial.layout_pack.launches) == \
        (before[0] + 1, before[1] + 1)
    for p, cloud in zip(stages, spatial.sort_stages(stages)):
        spatial.check_layout(cloud, p)
        ref = spatial.sort_support(p)
        for field in ("packed", "boxes", "codes", "lo", "scale", "perm"):
            _equal(getattr(cloud, field), getattr(ref, field))
        n = p.shape[1]
        lab = torch.from_numpy(rng.randint(0, 13, (b, n)).astype(np.float32)).to(cuda_device)
        kth = torch.from_numpy(rng.rand(b, n).astype(np.float32)).to(cuda_device)
        before = ops.contrast.support_layout.launches
        aux, cmax = ops.contrast.support_layout(cloud, lab, kth)
        want_aux, want_cmax = ops.contrast.support_layout_plain(cloud, lab, kth)
        _equal(aux, want_aux)
        _equal(cmax, want_cmax)
        assert ops.contrast.support_layout.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["uniform", "clustered", "grid"])
def test_contrast_kernels_over_the_stage_layouts(cuda_device, kind):
    """Kernels #14-16 at a S3DIS step's four stages (B = 4, 24000 → 375
    points, C = 64 … 512), each over its layout from the one sort of the
    four (``sort_stages``) as the loss hands it, and the launches: one a
    call, the sorted columns once a forward."""
    rng = np.random.RandomState(31)
    ns = (24000, 6000, 1500, 375)
    if kind == "grid":
        stages = [torch.from_numpy((rng.randint(0, 40, (4, n, 3)) / 128)
                                   .astype(np.float32)).to(cuda_device) for n in ns]
    else:
        stages = [torch.from_numpy(_cloud(rng, 4, n, kind == "clustered"))
                  .to(cuda_device) for n in ns]
    for p, cloud, c in zip(stages, spatial.sort_stages(stages), (64, 128, 256, 512)):
        f = torch.nn.functional.normalize(torch.from_numpy(
            rng.randn(4, p.shape[1], c).astype(np.float32)).to(cuda_device), dim=-1)
        lab = torch.from_numpy(rng.randint(0, 13, (4, p.shape[1]))
                               .astype(np.float32)).to(cuda_device)
        kth = (ops.knn(p, p, 24, cloud)[1][..., -1] * (1.0 + 1e-5)).contiguous()
        _check_contrast(p, f, lab, kth, False, False, cloud)
        counts = lambda: (ops.contrast_forward.launches, ops.contrast_grad_rows.launches,
                          ops.contrast_grad_support.launches,
                          ops.contrast.support_layout.launches)
        before = counts()
        ops.contrast_reductions(p, f.clone().requires_grad_(), lab, kth,
                                cloud=cloud).sum().backward()
        assert counts() == tuple(x + d for x, d in zip(before, (1, 1, 1, 1)))


@pytest.mark.cuda
@pytest.mark.parametrize("distinct", ["enough", "too few"])
def test_contrast_kernels_on_the_selection_at_one_channel(cuda_device, distinct):
    """Kernels #14 and #15 at C = 1 on the selection's thresholds, as
    ``ambiguity_head`` calls them; with fewer than k distinct d² a point's
    threshold is 3e38·(1+1e-6), every other point is a member and its block
    lists every chunk (5000 points: float32 sums over 4999 members, which
    the forward's twin takes in the kernel's order, within its 1e-5)."""
    rng = np.random.RandomState(32)
    # a 1/4 grid: 19 distinct d², exact in float32
    n, cells, k = (5000, 32, 24) if distinct == "enough" else (5000, 4, 40)
    p = torch.from_numpy(_grid_cloud(rng, 2, n, cells)).to(cuda_device)
    thr = ops.contrast_select(p, k)
    assert (thr > 1e38).all() == (distinct == "too few")
    lab = torch.from_numpy(rng.randint(0, 5, (2, n)).astype(np.float32)).to(cuda_device)
    for f in (torch.zeros(2, n, 1, device=cuda_device),     # as the head
              torch.from_numpy(np.sign(rng.randn(2, n, 1)).astype(np.float32))
              .to(cuda_device)):
        _check_contrast(p, f, lab, thr, False, True)


@pytest.mark.cuda
def test_a_layout_of_another_cloud_is_refused_on_the_card(cuda_device):
    """A layout made from another cloud of the same shape, or from this one
    before an in-place change, raises in every wrapper that reads one."""
    rng = np.random.RandomState(21)
    p, other = (torch.from_numpy(_cloud(rng, 2, 3000, False)).to(cuda_device)
                for _ in range(2))
    cloud = spatial.sort_stages([p])[0]
    f = torch.nn.functional.normalize(torch.from_numpy(
        rng.randn(2, 3000, 32).astype(np.float32)).to(cuda_device), dim=-1)
    lab = torch.zeros(2, 3000, device=cuda_device)
    kth = (ops.knn(other, other, 24)[1][..., -1] * (1.0 + 1e-5)).contiguous()
    g4 = torch.from_numpy(rng.randn(2, 3000, 4).astype(np.float32)).to(cuda_device)
    a = torch.zeros(2, 3000, device=cuda_device)
    ilab = lab.int()
    for call in (lambda: ops.knn(other, other, 24, cloud),
                 lambda: ops.knn(other, other[:, :99].contiguous(), 24, cloud),
                 lambda: ops.ball_query(other, other, 0.2, 32, cloud),
                 lambda: ops.ball_query(p, other, 0.2, 32, cloud, cloud),
                 lambda: ops.refine_cross(other, f, a, 12, "MIN", cloud=cloud),
                 lambda: ops.dual_masks_cross(other, f, a, 12, "MIN_ALL0",
                                              cloud),
                 lambda: ops.contrast_grad_support(other, f, lab, kth, g4,
                                                   cloud=cloud),
                 lambda: ops.contrast_grad_rows(other, f, lab, kth, g4,
                                                cloud=cloud),
                 lambda: ops.contrast_forward(other, f, lab, kth, cloud=cloud),
                 lambda: ops.contrast_reductions(other, f, lab, kth, cloud=cloud),
                 lambda: ops.contrast_select(other, 24, cloud),
                 lambda: ops.contrast_reductions_selfk(other, f, lab, 24,
                                                       cloud=cloud),
                 lambda: ops.label_vote(other, ilab, p, 16, 3, cloud),
                 lambda: ops.label_vote(p, ilab, other, 16, 3, cloud, cloud),
                 lambda: ops.three_interpolation(p, other, f, cloud),
                 lambda: ops.three_interpolation(other, p, f, cloud, cloud),
                 lambda: ops.three_interpolation_small(p, other, f, False,
                                                       cloud)):
        with pytest.raises(ValueError):
            call()
    ops.three_interpolation(p, p, f, cloud, cloud)
    ops.knn(p, p, 24, cloud)
    ops.ball_query(p, p, 0.2, 32, cloud)
    ops.refine_cross(p, f, a, 12, "MIN", cloud=cloud)
    ops.contrast_select(p, 24, cloud)
    ops.label_vote(p, ilab, p, 16, 3, cloud, cloud)
    p.mul_(1.0)
    for call in (lambda: ops.knn(p, p, 24, cloud),
                 lambda: ops.ball_query(p, p, 0.2, 32, cloud),
                 lambda: ops.refine_cross(p, f, a, 12, "MIN", cloud=cloud),
                 lambda: ops.contrast_select(p, 24, cloud),
                 lambda: ops.label_vote(p, ilab, p, 16, 3, cloud),
                 lambda: ops.three_interpolation(p, p, f, cloud, cloud)):
        with pytest.raises(ValueError):
            call()


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
    cloud = spatial.sort_stages([p])[0]
    for ties in (False, True):
        a = torch.from_numpy(_ambiguity(rng, b, n, ties)).to(dev)
        for fusion in ("MIN", "MIN_ALL0"):
            got, sel = ops.refine_cross(p, f, a, k, fusion, keep=True,
                                        cloud=cloud)
            want, sel_p = ops.refine_cross_plain(p, f, a, k, fusion)
            torch.cuda.synchronize()
            assert torch.equal(sel, sel_p), (fusion, ties)
            if fusion == "MIN":
                assert torch.equal(got, want)
            else:
                _close(got, want, 1e-5)
            # sorting for itself, and again: the same bits
            assert torch.equal(ops.refine_cross(p, f, a, k, fusion)[0], got)
            _equal(ops.refine_cross(p, f, a, k, fusion, cloud=cloud)[0], got)
            fk = f.clone().requires_grad_()
            fp = f.clone().requires_grad_()
            fa = f.clone().requires_grad_()
            ops.dual_masks_cross(p, fk, a, k, fusion, cloud).backward(g)
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
@pytest.mark.parametrize("kind", ["uniform", "clustered", "grid"])
def test_refine_forward_over_the_stage_layouts(cuda_device, kind):
    """Kernel #18 at the four decoder shapes of a S3DIS step (B = 4,
    24000 / C 64 → 375 / C 512), each stage over its layout from one
    ``sort_stages``, as the decoder runs it: the selection and the MIN rows
    identical to the twin, MIN_ALL0 within 1e-5·(1+max), the same bits
    twice; one launch a call."""
    rng = np.random.RandomState(18)
    ns = (24000, 6000, 1500, 375)
    if kind == "grid":
        stages = [torch.from_numpy((rng.randint(0, 40, (4, n, 3)) / 128)
                                   .astype(np.float32)).to(cuda_device) for n in ns]
    else:
        stages = [torch.from_numpy(_cloud(rng, 4, n, kind == "clustered"))
                  .to(cuda_device) for n in ns]
    for p, cloud, c in zip(stages, spatial.sort_stages(stages), (64, 128, 256, 512)):
        n = p.shape[1]
        f = torch.from_numpy(rng.randn(4, n, c).astype(np.float32)).to(cuda_device)
        for ties in (False, True):
            a = torch.from_numpy(_ambiguity(rng, 4, n, ties)).to(cuda_device)
            for fusion in ("MIN", "MIN_ALL0"):
                before = ops.refine_cross.launches
                got, sel = ops.refine_cross(p, f, a, 12, fusion, keep=True,
                                            cloud=cloud)
                assert ops.refine_cross.launches == before + 1
                want, sel_p = ops.refine_cross_plain(p, f, a, 12, fusion)
                _equal(sel, sel_p)
                if fusion == "MIN":
                    _equal(got, want)
                else:
                    _close(got, want, 1e-5)
                again, sel2 = ops.refine_cross(p, f, a, 12, fusion, keep=True,
                                               cloud=cloud)
                _equal(again, got)
                _equal(sel2, sel)


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


def _fps_b1_cluster(xyz, npoint):
    """One cloud through a cluster of ``csrc/fps.cu``'s kernel at the
    dispatch's cluster size."""
    s = ops.fps.fps_cluster_size(
        1, xyz.shape[1], ops.fps._cluster_capacity(xyz.device.index))
    return ops.fps._fps_b1_cluster(xyz, npoint, s)


_FPS_B1_KERNELS = (ops.fps._fps_b1_grid, _fps_b1_cluster)


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
        ops.fps._fps_b1_cluster(xyz, 300, 16)


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", [(1, 1), (5, 3), (63, 63), (65, 200),
                                 (4099, 1031), (32769, 4000), (32767, 4000),
                                 (70001, 3000)])
def test_big_knn_and_ball_query_match_plain(cuda_device, n, m):
    """The chunk-skipping kernels at odd sizes, with k below and above N and
    above one launch's 128 slots, on both sides of the JAX package's 32768
    gate, and past the 65536 points one list window holds: identical to
    the twins, the ball query sorting for itself and over the support's
    given layout, with the queries' own layout and without."""
    rng = np.random.RandomState(n + m)
    sup = torch.from_numpy(_cloud(rng, 2, n, n % 2 == 1)).to(cuda_device)
    q = torch.from_numpy(_cloud(rng, 2, m, False)).to(cuda_device)
    q[:, : min(m, n) // 2] = sup[:, : min(m, n) // 2]   # queries on the support
    for k in (1, 24, 33, 128):
        want_i, want_d = ops.knn_plain(sup, q, k)
        got_i, got_d = ops.knn(sup, q, k)
        _equal(got_i, want_i)
        _equal(got_d, want_d)
    sup_cloud, q_cloud = spatial.sort_stages([sup, q])
    for r, k in ((0.05, 32), (0.3, 32), (0.3, 70), (9.0, 16), (9.0, 200)):
        want = ops.ball_query_plain(sup, q, r, k)
        _equal(ops.ball_query(sup, q, r, k), want)
        _equal(ops.ball_query(sup, q, r, k, sup_cloud), want)
        _equal(ops.ball_query(sup, q, r, k, sup_cloud, q_cloud), want)
    # one kernel each at every N: a launch a call (the ball query a launch
    # for every 128 slots)
    counts = (ops.knn.launches, ops.ball_query.launches)
    ops.knn(sup, q, 3)
    ops.ball_query(sup, q, 0.2, 8)
    ops.ball_query(sup, q, 0.2, 129)
    assert (ops.knn.launches, ops.ball_query.launches) == \
        (counts[0] + 1, counts[1] + 3)


@pytest.mark.cuda
def test_big_kernels_room_duplicates_and_empty_balls(cuda_device):
    """A gridded room with repeated points (ties in d² at every distance),
    all points equal, and queries far from the support (empty balls)."""
    rng = np.random.RandomState(5)
    room = torch.from_numpy(_room(rng, 40000)).to(cuda_device)
    q = room[:, ::4].contiguous()
    for k in (12, 24):
        want_i, want_d = ops.knn_plain(room, q, k)
        got_i, got_d = ops.knn(room, q, k)
        _equal(got_i, want_i)
        _equal(got_d, want_d)
    for r in (0.1, 0.2):
        _equal(ops.ball_query(room, q, r, 32),
               ops.ball_query_plain(room, q, r, 32))
    far = q + 50.0
    got = ops.ball_query(room, far, 0.1, 32)
    _equal(got, torch.zeros_like(got))
    same = torch.ones(1, 700, 3, device=cuda_device)
    _equal(ops.ball_query(same, same, 0.1, 32),
           ops.ball_query_plain(same, same, 0.1, 32))
    want_i, want_d = ops.knn_plain(same, same, 24)
    got_i, got_d = ops.knn(same, same, 24)
    _equal(got_i, want_i)
    _equal(got_d, want_d)


def _ball_query_stages(rng, dev, b, n, radius, kind):
    """The eight ball queries of a PointNeXt encoder over a cloud of
    (b, n): stage s samples a quarter of s − 1 by FPS; per stage the set
    abstraction's (support s − 1, queries s, its radius) and the blocks'
    shared one (s, s, the radius doubled), with every stage's layout from
    one ``sort_stages``, as the encoder hands them on."""
    if kind == "grid":
        pts = (rng.randint(0, 40, (b, n, 3)) / 128).astype(np.float32)
    else:
        pts = _cloud(rng, b, n, kind == "clustered")
    stages = [torch.from_numpy(pts).to(dev)]
    for _ in range(4):
        prev = stages[-1]
        stages.append(ops.gather_points(prev, ops.furthest_point_sample(
            prev, prev.shape[1] // 4)).contiguous())
    layouts = spatial.sort_stages(stages)
    calls = []
    for s in range(1, 5):
        r = radius * 2 ** (s - 1)
        calls.append((stages[s - 1], stages[s], r, layouts[s - 1], layouts[s]))
        calls.append((stages[s], stages[s], 2 * r, layouts[s], layouts[s]))
    return calls


@pytest.mark.cuda
@pytest.mark.parametrize("recipe,b,n,radius", [("s3dis", 4, 24000, 0.1),
                                               ("scannet", 2, 64000, 0.05)])
@pytest.mark.parametrize("kind", ["uniform", "clustered", "grid"])
def test_ball_query_at_the_stage_shapes(cuda_device, recipe, b, n, radius, kind):
    """Kernels #2 and #8 as one listed kernel at the eight (M, N, r) of a
    S3DIS and a ScanNet step, over the stages' layouts: indices identical
    to the twin at k = 1, 16, 32 and 128, the same bits twice and without
    the layouts; one launch a call."""
    rng = np.random.RandomState(n + len(kind))
    for sup, q, r, cloud, q_cloud in _ball_query_stages(
            rng, cuda_device, b, n, radius, kind):
        for k in (1, 16, 32, 128):
            want = ops.ball_query_plain(sup, q, r, k)
            before = ops.ball_query.launches
            got = ops.ball_query(sup, q, r, k, cloud, q_cloud)
            assert ops.ball_query.launches == before + 1
            _equal(got, want)
            _equal(ops.ball_query(sup, q, r, k, cloud, q_cloud), got)
            if k == 32:
                _equal(ops.ball_query(sup, q, r, k), got)


@pytest.mark.cuda
@pytest.mark.parametrize("n,pairs", [
    (155648, ((0, 1, 0.1), (1, 1, 0.2), (1, 2, 0.2))),
    (221184, ((0, 1, 0.05),)), (311296, ((0, 1, 0.05),))])
def test_ball_query_at_the_room_pairs(cuda_device, n, pairs):
    """The whole-scene test's ball queries whose support passes 32768 points
    (the JAX package's large-cloud kernel #8): a room-like cloud with
    repeated points at the buckets 155648 (S3DIS, 0.04 m) and 221184 /
    311296 (ScanNet, 0.02 m), stages by FPS, identical to the twin."""
    rng = np.random.RandomState(n % 1000)
    room = _room(rng, n)
    if n > 155648:
        room = room * 0.5
    stages = [torch.from_numpy(room).to(cuda_device)]
    for _ in range(2):
        prev = stages[-1]
        stages.append(ops.gather_points(prev, ops.furthest_point_sample(
            prev, prev.shape[1] // 4)).contiguous())
    layouts = spatial.sort_stages(stages)
    for si, qi, r in pairs:
        sup, q = stages[si], stages[qi]
        want = ops.ball_query_plain(sup, q, r, 32)
        _equal(ops.ball_query(sup, q, r, 32, layouts[si], layouts[qi]), want)
        _equal(ops.ball_query(sup, q, r, 32), want)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 16, 32, 128, 129, 200, 256, 300])
def test_ball_query_room_duplicates_empty_balls_and_passes(cuda_device, k):
    """A gridded room with repeated points, queries far from it (empty
    balls: 0 in every slot), all points equal, and balls that hold more
    than 128 points, fewer, exactly 128 and none: k beyond one launch's
    128 slots takes passes, each after the previous pass's last hit."""
    rng = np.random.RandomState(k)
    room = torch.from_numpy(_room(rng, 20000)).to(cuda_device)
    q = room[:, ::5].contiguous()
    cloud = spatial.sort_support(room)
    for r in (0.1, 0.3, 1.0):
        _equal(ops.ball_query(room, q, r, k, cloud),
               ops.ball_query_plain(room, q, r, k))
    _equal(ops.ball_query(room, room, 0.2, k, cloud),
           ops.ball_query_plain(room, room, 0.2, k))
    far = q + 50.0
    got = ops.ball_query(room, far, 0.1, k, cloud)
    _equal(got, torch.zeros_like(got))
    same = torch.ones(2, 300, 3, device=cuda_device)
    _equal(ops.ball_query(same, same, 0.1, k), ops.ball_query_plain(same, same, 0.1, k))
    # 128 points in the ball and 72 outside it, in a shuffled index order
    line = torch.zeros(1, 200, 3, device=cuda_device)
    line[0, :, 0] = torch.from_numpy(rng.permutation(200).astype(np.float32)) / 100
    centre = torch.zeros(1, 1, 3, device=cuda_device)
    for r in (1.275, 1.285):     # the ball holds 128 points, then 129
        _equal(ops.ball_query(line, centre, r, k),
               ops.ball_query_plain(line, centre, r, k))


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
    (2, 4099, 1000, 300), (1, 2000, 50, 11264), (2, 64000, 16000, 128),
    (1, 4099, 1031, 200), (2, 3001, 997, 7), (1, 5, 3, 4)])
def test_interp_backward_big_matches_plain_and_itself(cuda_device, b, n1, n2, c):
    """The per-row-lists backward at sizes that are a multiple of no tile,
    with C below and above a warp's float4 width, odd, and large, rows of
    hundreds of entries (70 and 50 coarse rows: they spill past a bin):
    within 1e-5·(1+max) of the twin (the same order of summation; the twin
    scatters with float atomics on the card), bit-identical over two runs
    and with the coarse rows taken in another order, within 1e-5·(1+max) of
    the twin summed in the kernel's order on the CPU, and a support row no
    query selects is exactly 0."""
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
    # the rows in a shuffled order, as a strided view (a layout's index bits)
    perm = torch.stack([torch.randperm(n2, generator=torch.Generator()
                                       .manual_seed(i)) for i in range(b)])
    rows = torch.zeros(b, n2, 4, dtype=torch.int32)
    rows[..., 3] = perm.to(torch.int32)
    rows = rows.to(cuda_device)[..., 3]
    assert torch.equal(ops.three_interpolation_backward_big(g, idx, w, n2, rows),
                       got)
    # on the CPU the twin's index_add_ sums each row in (query, slot) order
    ordered = ops.three_interpolation_backward_plain(g.cpu(), idx.cpu(),
                                                     w.cpu(), n2)
    _close(got.cpu(), ordered, 1e-5)
    if n2 > 1:
        assert not got[:, n2 // 2].any()
    _close(ops.three_interpolation_backward_small(g, idx, w, n2), want, 1e-5)


@pytest.mark.cuda
def test_interp_backward_dispatch_follows_the_gate(cuda_device):
    """(N1, C) = (64000, 128) goes to the per-row-lists kernel, (16000,
    128) and (64000, 512) to the scatter kernel (``backward_is_big``),
    through the autograd function as well."""
    rng = np.random.RandomState(4)
    big, small = (ops.three_interpolation_backward_big,
                  ops.three_interpolation_backward)
    for n1, c, is_big in ((64000, 128, True), (16000, 128, False),
                          (64000, 512, False)):
        assert ops.backward_is_big(1, n1, n1 // 4, c) == is_big
        p1 = torch.from_numpy(_cloud(rng, 1, n1, False)).to(cuda_device)
        p2 = p1[:, ::4].contiguous()
        f = torch.from_numpy(rng.randn(1, p2.shape[1], c).astype(np.float32)
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


def _interp_stages(rng, dev, b, n, kind):
    """The S3DIS step's stage clouds (n, n / 4, ... by FPS): uniform in
    [0, 4]³, clustered, or on a 1/128 m grid (d² ties at every 3rd)."""
    if kind == "grid":
        p = (rng.randint(0, 256, (b, n, 3)) / 128).astype(np.float32)
    else:
        p = _cloud(rng, b, n, kind == "clustered")
    stages = [torch.from_numpy(p).to(dev)]
    for _ in range(4):
        prev = stages[-1]
        idx = ops.furthest_point_sample(prev, prev.shape[1] // 4)
        stages.append(ops.gather_points(prev, idx).contiguous())
    return stages


def _check_listed_interp(p1, p2, f2, cloud=None, query_cloud=None):
    """Kernel 3 against the twin: indices identical, weights and output
    within 1e-5·(1+max); one launch; the same bits with and without the
    layouts and over two runs; the gradient through the kernel pair within
    1e-5·(1+max|df2|) of the twin's."""
    before = ops.three_interpolation.launches
    out, idx, w = ops.three_interpolation_small(p1, p2, f2, True, cloud,
                                                query_cloud)
    assert ops.three_interpolation.launches == before + 1
    want_i, want_w = ops.three_interpolation_weights(p1, p2)
    _equal(idx, want_i)
    _close(w, want_w, 1e-5)
    _close(out, ops.three_interpolation_plain(p1, p2, f2), 1e-5)
    again = ops.three_interpolation_small(p1, p2, f2, True)
    for got, ref in zip(again, (out, idx, w)):
        _equal(got, ref)
    _equal(ops.three_interpolation(p1, p2, f2, cloud, query_cloud), out)
    g = torch.randn(p1.shape[0], p1.shape[1], f2.shape[-1], device=f2.device,
                    generator=torch.Generator(f2.device).manual_seed(1))
    fk = f2.clone().requires_grad_()
    fp = f2.clone().requires_grad_()
    ops.three_interpolation(p1, p2, fk, cloud, query_cloud).backward(g)
    ops.three_interpolation_plain(p1, p2, fp).backward(g)
    _close(fk.grad, fp.grad, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["uniform", "clustered", "grid"])
@pytest.mark.parametrize("layouts", [True, False])
def test_listed_interpolation_at_the_stage_shapes(cuda_device, kind, layouts):
    """The four decoder stages of a S3DIS step at B = 4 (24000 → 6000 →
    1500 → 375 → 93, coarse C 128 … 1024), over the layouts of one
    ``sort_stages`` as the decoder hands them on, or sorting for itself."""
    rng = np.random.RandomState(31)
    stages = _interp_stages(rng, cuda_device, 4, 24000, kind)
    clouds = spatial.sort_stages(stages) if layouts else [None] * 5
    for s, c in zip(range(1, 5), (128, 256, 512, 1024)):
        p1, p2 = stages[s - 1], stages[s]
        f2 = torch.from_numpy(rng.randn(4, p2.shape[1], c).astype(np.float32)
                              ).to(cuda_device)
        _check_listed_interp(p1, p2, f2, clouds[s], clouds[s - 1])


@pytest.mark.cuda
@pytest.mark.parametrize("n2", [1, 2, 3, 64, 65, 700])
@pytest.mark.parametrize("form", ["duplicates", "outside"])
def test_listed_interpolation_few_points_duplicates_and_outside(cuda_device, n2,
                                                                form):
    """n2 < 3 (fillers: index 0 at 1e10), a chunk and one point more;
    coarse points repeated (d² ties between indices), or fine points far
    outside the coarse cloud's box (their home chunk at its border); C not
    a multiple of 4 (scalar rows) and one that is."""
    rng = np.random.RandomState(n2)
    p2 = torch.from_numpy(_cloud(rng, 2, n2, False)).to(cuda_device)
    if form == "duplicates":
        p2[:, n2 // 2:] = p2[:, : n2 - n2 // 2].clone()
        p1 = torch.from_numpy(_cloud(rng, 2, 4 * n2 + 3, False)).to(cuda_device)
    else:
        p1 = torch.from_numpy(_cloud(rng, 2, 4 * n2 + 3, False) * 3 - 4
                              ).to(cuda_device)
    p1 = p1.contiguous()
    p2 = p2.contiguous()
    clouds = spatial.sort_stages([p1, p2])
    for c in (3, 64):
        f2 = torch.from_numpy(rng.randn(2, n2, c).astype(np.float32)).to(cuda_device)
        _check_listed_interp(p1, p2, f2)
        _check_listed_interp(p1, p2, f2, clouds[1], clouds[0])


@pytest.mark.cuda
@pytest.mark.parametrize("b,n1,n2,c", [
    (1, 1, 1, 1), (2, 1031, 257, 12), (3, 5000, 70, 200), (1, 300, 900, 128),
    (4, 24000, 6000, 128), (2, 4099, 1000, 131), (4, 375, 93, 1024)])
def test_listed_interpolation_backward_matches_index_add_and_itself(cuda_device,
                                                                   b, n1, n2, c):
    """Kernel 9 in the fine layout's order (a stride-4 view of its index
    bits), in ``query_order``'s and in the caller's: within 1e-5·(1+max) of
    ``index_add_`` and of a second run of itself; a coarse row no fine point
    selects is exactly 0; one launch a call."""
    rng = np.random.RandomState(n1 + c)
    p1 = torch.from_numpy(_cloud(rng, b, n1, False)).to(cuda_device)
    p2 = p1[:, ::max(1, n1 // n2)][:, :n2].contiguous()
    n2 = p2.shape[1]
    idx, w = ops.three_interpolation_weights(p1, p2)
    idx[idx == n2 // 2] = 0                      # row n2 // 2 is never selected
    g = torch.from_numpy(rng.randn(b, n1, c).astype(np.float32)).to(cuda_device)
    rows = (idx.long() + n2 * torch.arange(b, device=cuda_device)[:, None, None])
    want = torch.zeros(b * n2, c, device=cuda_device).index_add_(
        0, rows.reshape(-1), (w[..., None] * g[:, :, None, :]).reshape(-1, c)
    ).view(b, n2, c)
    layout = spatial.sort_stages([p1])[0]
    for order in (layout.packed.view(torch.int32)[..., 3],
                  spatial.query_order(p1, spatial.sort_support(p2))[0], None):
        before = ops.three_interpolation_backward.launches
        got = ops.three_interpolation_backward_small(g, idx, w, n2, order)
        again = ops.three_interpolation_backward_small(g, idx, w, n2, order)
        assert ops.three_interpolation_backward.launches == before + 2
        _close(got, want, 1e-5)
        _close(again, got, 1e-5)
        if n2 > 1:
            assert not got[:, n2 // 2].any()
    with pytest.raises(ValueError):
        ops.three_interpolation_backward_small(g, idx, w, n2, layout.perm)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["AA", "MM"])
def test_interpolation_launches_a_forward_and_a_step(cuda_device, kind):
    """A forward of the AA or MM model launches the interpolation 4 times
    and the layout kernels once each (the decoder reads the encoder's
    layouts: no sort of its own), a backward the VJP 4 times, as
    ``chip_smoke.py``'s EVAL_LAUNCHES and TRAIN_LAUNCHES count them."""
    from pathlib import Path

    from amcontrast3d_tpu_torch.models.build import (build_model_from_cfg,
                                                     init_weights_)
    from amcontrast3d_tpu_torch.utils.config import EasyConfig

    cfg = EasyConfig()
    cfg.load(str(Path(__file__).resolve().parent.parent / "cfgs" / "s3dis"
                 / f"AMContrast3D-{kind}.yaml"), recursive=True)
    cfg.update(["model.encoder_args.width=16"]
               + (["model.APM_args.feature_dim=[16,32,64,128]"]
                  if kind == "MM" else []))
    model = build_model_from_cfg(cfg.model)
    init_weights_(model, torch.Generator().manual_seed(0))
    model.to(cuda_device)
    rng = np.random.RandomState(3)
    pos = torch.from_numpy(_cloud(rng, 2, 8000, False)).to(cuda_device)
    x = torch.from_numpy(rng.rand(2, 8000, 4).astype(np.float32)).to(cuda_device)
    counted = (ops.three_interpolation, ops.three_interpolation_backward,
               spatial.layout_keys, spatial.layout_pack)
    before = [fn.launches for fn in counted]
    logits = model(pos, x, torch.Generator(cuda_device).manual_seed(0))[0]
    after_forward = [fn.launches - b for fn, b in zip(counted, before)]
    logits.square().mean().backward()
    after_step = [fn.launches - b for fn, b in zip(counted, before)]
    assert after_forward == [4, 0, 1, 1]
    assert after_step == [4, 4, 1, 1]


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,npoint", [(2, 64000, 16000), (3, 57345, 700),
                                        (2, 163841, 300)])
def test_batched_fps_above_the_shared_memory_limit(cuda_device, b, n, npoint):
    """B > 1 with more points a cloud than the old kernel's shared memory
    held: one cluster a cloud of ``csrc/fps.cu`` in one launch (or, above
    the cluster's 163840 points, the grid kernel cloud by cloud), picks
    identical to the twin; the clouds differ, so a kernel that sampled one
    cloud B times would fail."""
    rng = np.random.RandomState(n)
    xyz = torch.from_numpy(_cloud(rng, b, n, True)).to(cuda_device)
    counts = (ops.furthest_point_sample.launches,
              ops.furthest_point_sample_b1.launches)
    got = ops.furthest_point_sample(xyz, npoint)
    want = ops.furthest_point_sample_plain(xyz, npoint)
    _equal(got, want)
    cluster = n <= ops.fps.CLUSTER_POINTS
    assert (ops.furthest_point_sample.launches,
            ops.furthest_point_sample_b1.launches) == \
        (counts[0] + cluster, counts[1] + (0 if cluster else b))


@pytest.mark.cuda
def test_batched_fps_below_the_limit_keeps_its_kernel(cuda_device):
    """On both sides of the old 57344-point gate a batch takes the cluster
    kernel of ``csrc/fps.cu``, one launch, nothing of ``fps_b1.cu``."""
    rng = np.random.RandomState(8)
    for n in (57344, 57345):
        xyz = torch.from_numpy(_cloud(rng, 2, n, False)).to(cuda_device)
        counts = (ops.furthest_point_sample.launches,
                  ops.furthest_point_sample_b1.launches)
        _equal(ops.furthest_point_sample(xyz, 200),
               ops.furthest_point_sample_plain(xyz, 200))
        assert (ops.furthest_point_sample.launches,
                ops.furthest_point_sample_b1.launches) == \
            (counts[0] + 1, counts[1])


def _capacity(device):
    return ops.fps._cluster_capacity(device.index)


@pytest.mark.cuda
@pytest.mark.parametrize("clustered", [False, True])
@pytest.mark.parametrize("n", [24000, 6000, 1500, 375])
def test_batched_fps_at_the_stage_shapes(cuda_device, n, clustered):
    """The four stages of the S3DIS step at B = 4: picks identical to the
    twin, in one launch, on more multiprocessors than clouds where the
    cloud is large enough to want them."""
    rng = np.random.RandomState(n + clustered)
    xyz = torch.from_numpy(_cloud(rng, 4, n, clustered)).to(cuda_device)
    before = ops.furthest_point_sample.launches
    _equal(ops.furthest_point_sample(xyz, n // 4),
           ops.furthest_point_sample_plain(xyz, n // 4))
    assert ops.furthest_point_sample.launches == before + 1
    s = ops.fps.fps_cluster_size(4, n, _capacity(cuda_device))
    assert s is not None and (n < 16384 or s > 1)


def _boundaries():
    """N on both sides of every gate and of what each cluster size holds."""
    ns = {least + d for _, least in ops.fps.CLUSTER_GATES for d in (-1, 0)}
    ns |= {s * 512 * 20 + d for s in ops.fps.CLUSTER_SIZES for d in (0, 1)}
    return sorted(n for n in ns if n >= 1)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [2, 4, 8])
def test_batched_fps_on_both_sides_of_every_boundary(cuda_device, b):
    """At B = 2, 4 and 8 (the remat recipe's batch) and N on each side of
    every gate and cluster capacity: the dispatch's cluster size and every
    cluster size that holds the cloud pick what the twin picks."""
    rng = np.random.RandomState(b)
    capacity = _capacity(cuda_device)
    for n in _boundaries():
        xyz = torch.from_numpy(_cloud(rng, b, n, n % 2 == 1)).to(cuda_device)
        npoint = min(n, 257)
        want = ops.furthest_point_sample_plain(xyz, npoint)
        _equal(ops.furthest_point_sample(xyz, npoint), want)
        for s in ops.fps.CLUSTER_SIZES:
            if n <= s * 512 * 20 and capacity[s] >= 1:
                _equal(ops.fps._fps_cluster(xyz, npoint, s), want)
            else:
                with pytest.raises((ValueError, RuntimeError)):
                    ops.fps._fps_cluster(xyz, npoint, s)


@pytest.mark.cuda
def test_batched_fps_ties_duplicates_and_tiny_clouds(cuda_device):
    """All points equal (index 0 wins every tie), gridded rooms with
    repeated points, fewer points than a block has threads, npoint 1 and
    npoint = N, at every cluster size."""
    rng = np.random.RandomState(4)
    rooms = np.concatenate([_room(rng, 20000) for _ in range(3)])
    cases = [(torch.ones(4, 3000, 3, device=cuda_device), 50),
             (torch.from_numpy(rooms).to(cuda_device), 5000)]
    for n in (1, 2, 7, 600):
        xyz = torch.from_numpy(_cloud(rng, 3, n, False)).to(cuda_device)
        cases += [(xyz, 1), (xyz, n)]
    for xyz, npoint in cases:
        want = ops.furthest_point_sample_plain(xyz, npoint)
        _equal(ops.furthest_point_sample(xyz, npoint), want)
        for s in ops.fps.CLUSTER_SIZES:
            if xyz.shape[1] <= s * 512 * 20:
                _equal(ops.fps._fps_cluster(xyz, npoint, s), want)


def _refine_backward_case(rng, device, b, n, c, slots):
    g = torch.from_numpy(rng.randn(b, n, c).astype(np.float32)).to(device)
    sel = rng.randint(0, n, (b, n, slots)).astype(np.int32)
    if slots > 1:                       # MIN_ALL0: the rows with a > 0 are -1
        sel[rng.rand(b, n, slots) < 0.4] = -1
    return g, torch.from_numpy(sel).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 3, 13, 64, 131, 512])
@pytest.mark.parametrize("slots,scale", [(1, 1.0), (11, 1.0 / 11)])
def test_refine_backward_matches_plain_at_every_width(cuda_device, c, slots,
                                                      scale):
    """The CrossMask VJP (vector reductions where C % 4 == 0, scalar ones
    otherwise) within 1e-5·(1+max|df|) of its twin, for MIN's one slot and
    MIN_ALL0's eleven with −1 entries; then with every point selecting one
    row (its first slot; a point's slots never repeat a row), the hottest
    contention; then on a g that starts off a 16-byte boundary (the scalar
    form)."""
    rng = np.random.RandomState(c + slots)
    g, sel = _refine_backward_case(rng, cuda_device, 2, 1500, c, slots)
    before = ops.refine_cross_backward.launches
    _close(ops.refine_cross_backward(g, sel, scale),
           ops.refine_cross_backward_plain(g, sel, scale), 1e-5)
    one = sel.clone()
    one[..., 0] = 7
    _close(ops.refine_cross_backward(g, one, scale),
           ops.refine_cross_backward_plain(g, one, scale), 1e-5)
    shifted = torch.empty(g.numel() + 1, device=cuda_device)[1:].view(g.shape)
    shifted.copy_(g)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    _close(ops.refine_cross_backward(shifted, sel, scale),
           ops.refine_cross_backward_plain(g, sel, scale), 1e-5)
    assert ops.refine_cross_backward.launches == before + 3


@pytest.mark.cuda
def test_refine_backward_refuses_what_it_cannot_take(cuda_device):
    g, sel = _refine_backward_case(np.random.RandomState(5), cuda_device,
                                   2, 100, 8, 1)
    for bad_g, bad_sel in ((g.double(), sel), (g, sel.long()),
                           (g.transpose(0, 1).contiguous().transpose(0, 1), sel),
                           (g, sel[..., :0]), (g, sel.expand(2, 100, 128))):
        with pytest.raises(ValueError):
            ops.refine_cross_backward(bad_g, bad_sel, 1.0)


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
    before = ops.ball_query.launches
    _equal(ops.ball_query(sup, q, 0.05, 32),
           ops.ball_query_plain(sup, q, 0.05, 32))
    assert ops.ball_query.launches == before + 1


@pytest.mark.cuda
def test_contrast_kernels_at_64000_points(cuda_device):
    """N² = 4.1e9 is past 2³¹: forward, rows and support against their
    twins at (2, 64000, 64), with an ignored label (-100) among the
    classes."""
    rng = np.random.RandomState(22)
    p, f, lab, kth = _stage(rng, cuda_device, 2, 64000, 64, True)
    lab[:, ::7] = -100.0
    _check_contrast(p, f, lab, kth, 0, True)


# ---------------------------------------------------------------------------
# the rungs from the 221184 bucket up: the chunk-pruned FPS, the large-support
# interpolation, and kNN beyond 128 neighbours
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("n,npoint", [(1, 1), (7, 7), (1030, 257), (5000, 5000),
                                      (262143, 700), (263145, 2000)])
def test_fps_pruned_matches_plain_and_the_grid_kernel(cuda_device, n, npoint):
    """The chunk-pruned FPS at odd sizes, on a gridded room with repeated
    points: picks identical to the twin and to the grid kernel; the
    dispatch sends it what ``fps_is_pruned`` names."""
    rng = np.random.RandomState(n)
    xyz = torch.from_numpy(_room(rng, n) if n > 5000 else
                           _cloud(rng, 1, n, n % 2 == 0)).to(cuda_device)
    want = ops.furthest_point_sample_plain(xyz, npoint)
    visits = torch.zeros(1, dtype=torch.int64, device=cuda_device)
    before = ops.furthest_point_sample_pruned.launches
    _equal(ops.furthest_point_sample_pruned(xyz, npoint, visits), want)
    assert ops.furthest_point_sample_pruned.launches == before + 1
    assert 0 < visits.item() or npoint == 1
    _equal(ops.fps._fps_b1_grid(xyz, npoint), want)
    counts = (ops.furthest_point_sample_pruned.launches,
              ops.furthest_point_sample_b1.launches)
    _equal(ops.furthest_point_sample(xyz, npoint), want)
    pruned = int(ops.fps_is_pruned(1, n, npoint))
    assert (ops.furthest_point_sample_pruned.launches,
            ops.furthest_point_sample_b1.launches) == \
        (counts[0] + pruned, counts[1] + 1 - pruned)


@pytest.mark.cuda
def test_fps_pruned_ties(cuda_device):
    """All points equal (every pick is a tie that the lowest index wins),
    and point 0 far from where the sort puts the first chunk."""
    same = torch.ones(1, 300000, 3, device=cuda_device)
    _equal(ops.furthest_point_sample_pruned(same, 40),
           ops.furthest_point_sample_plain(same, 40))
    rng = np.random.RandomState(6)
    xyz = torch.from_numpy(_cloud(rng, 1, 270001, True)).to(cuda_device)
    xyz[0, 0] = torch.tensor([3.9, 3.9, 3.9])
    _equal(ops.furthest_point_sample_pruned(xyz, 1500),
           ops.furthest_point_sample_plain(xyz, 1500))
    with pytest.raises(ValueError):
        ops.furthest_point_sample_pruned(xyz.expand(2, -1, -1).contiguous(), 5)


@pytest.mark.cuda
@pytest.mark.parametrize("bucket", [106496, 155648, 221184, 311296])
def test_whole_room_fps_at_every_stage_of_the_buckets(cuda_device, bucket):
    """A room's subcloud forward samples N → N / 4 four times from its
    bucket: at every stage of the four buckets, on a room-like cloud with
    repeated points, the dispatch's picks are identical to the twin's, one
    whole-room launch each (the chunk-pruned kernel where ``fps_is_pruned``
    says so, with its sort's two layout kernels)."""
    rng = np.random.RandomState(bucket)
    p = torch.from_numpy(_room(rng, bucket)).to(cuda_device)
    for _ in range(4):
        n, npoint = p.shape[1], p.shape[1] // 4
        counts = (ops.furthest_point_sample_pruned.launches,
                  ops.furthest_point_sample_b1.launches,
                  ops.spatial.layout_keys.launches)
        got = ops.furthest_point_sample(p, npoint)
        pruned = int(ops.fps_is_pruned(1, n, npoint))
        assert (ops.furthest_point_sample_pruned.launches,
                ops.furthest_point_sample_b1.launches,
                ops.spatial.layout_keys.launches) == \
            (counts[0] + pruned, counts[1] + 1 - pruned, counts[2] + pruned)
        _equal(got, ops.furthest_point_sample_plain(p, npoint))
        p = ops.gather_points(p, got).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("n,npoint", [(163840, 40960), (163841, 40961),
                                      (200000, 2000), (200000, 1999)])
def test_whole_room_fps_on_both_sides_of_the_gate(cuda_device, n, npoint):
    """Both sides of one cluster's 163840 points and of the least share of
    picks the chunk-pruned kernel takes: picks identical to the twin, from
    the kernel the rule names, and from every kernel that takes the size."""
    rng = np.random.RandomState(n + npoint)
    xyz = torch.from_numpy(_cloud(rng, 1, n, True)).to(cuda_device)
    want = ops.furthest_point_sample_plain(xyz, npoint)
    before = ops.furthest_point_sample_pruned.launches
    _equal(ops.furthest_point_sample_b1(xyz, npoint), want)
    assert ops.furthest_point_sample_pruned.launches == \
        before + int(ops.fps_is_pruned(1, n, npoint))
    _equal(ops.furthest_point_sample_pruned(xyz, npoint), want)
    _equal(ops.fps._fps_b1_grid(xyz, npoint), want)
    if n <= ops.fps.CLUSTER_POINTS:
        _equal(_fps_b1_cluster(xyz, npoint), want)


@pytest.mark.cuda
def test_whole_room_fps_ties_duplicates_and_a_huge_cloud(cuda_device):
    """Above one cluster: every point equal (each pick a tie the lowest
    index wins), a gridded room with repeated points, npoint 1; and
    1.2 M → 4096, which the rule sends to the grid kernel: picks identical
    to the twin from the dispatch and from the chunk-pruned kernel."""
    same = torch.ones(1, 170000, 3, device=cuda_device)
    room = torch.from_numpy(_room(np.random.RandomState(11), 170001)).to(cuda_device)
    for xyz, npoint in ((same, 50), (room, 42500), (room, 1)):
        want = ops.furthest_point_sample_plain(xyz, npoint)
        _equal(ops.furthest_point_sample(xyz, npoint), want)
        _equal(ops.furthest_point_sample_pruned(xyz, npoint), want)
    rng = np.random.RandomState(12)
    huge = torch.from_numpy(_cloud(rng, 1, 1200000, False)).to(cuda_device)
    want = ops.furthest_point_sample_plain(huge, 4096)
    before = ops.furthest_point_sample_b1.launches
    _equal(ops.furthest_point_sample(huge, 4096), want)
    assert ops.furthest_point_sample_b1.launches == before + 1
    _equal(ops.furthest_point_sample_pruned(huge, 4096), want)


@pytest.mark.cuda
def test_whole_room_fps_refused_launches_raise(cuda_device):
    """A launch the kernel refuses raises, with no fallback: the cluster
    kernel at a cluster size it has no instance for, the pruned kernel
    with more picks than points or beyond its 2 M points."""
    from amcontrast3d_tpu_torch.ops._build import launch
    xyz = torch.rand(1, 1000, 3, device=cuda_device)
    out = torch.empty(1, 10, dtype=torch.int32, device=cuda_device)
    stream = torch.cuda.current_stream(cuda_device).cuda_stream
    with pytest.raises(RuntimeError):
        launch("amc3d_fps", xyz.data_ptr(), out.data_ptr(), 1, 1000, 10, 3,
               stream)
    cloud = ops.spatial.sort_stages([xyz])[0]
    mind = torch.empty(1000, device=cuda_device)
    with pytest.raises(RuntimeError):
        launch("amc3d_fps_pruned", cloud.packed.data_ptr(),
               cloud.boxes.data_ptr(), xyz.data_ptr(), mind.data_ptr(),
               out.data_ptr(), None, 1000, 1001, stream)
    with pytest.raises(ValueError):
        ops.furthest_point_sample_pruned(
            torch.zeros(1, ops.fps.PRUNED_MAX_POINTS + 1, 3, device=cuda_device), 4)
    # the grid kernel beyond 14336 points a multiprocessor
    best = torch.zeros(10, dtype=torch.int64, device=cuda_device)
    arrived = torch.zeros(10, dtype=torch.int32, device=cuda_device)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    with pytest.raises(RuntimeError):
        launch("amc3d_fps_grid", xyz.data_ptr(), out.data_ptr(),
               best.data_ptr(), arrived.data_ptr(),
               sms * ops.fps.B1_POINTS_PER_SM + 1, 10, stream)


@pytest.mark.cuda
def test_whole_room_fps_above_the_grid_kernel_takes_the_pruned_kernel(
        cuda_device):
    """A cloud larger than the grid kernel holds (14336 points a
    multiprocessor) goes to the chunk-pruned kernel whatever share of it is
    picked: picks identical to the twin, one pruned launch."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    n = sms * ops.fps.B1_POINTS_PER_SM + 1
    rng = np.random.RandomState(13)
    xyz = torch.from_numpy(_cloud(rng, 1, n, True)).to(cuda_device)
    assert not ops.fps_is_pruned(1, n, 4096)
    counts = (ops.furthest_point_sample_pruned.launches,
              ops.furthest_point_sample_b1.launches)
    _equal(ops.furthest_point_sample(xyz, 4096),
           ops.furthest_point_sample_plain(xyz, 4096))
    assert (ops.furthest_point_sample_pruned.launches,
            ops.furthest_point_sample_b1.launches) == (counts[0] + 1, counts[1])
    with pytest.raises(ValueError):
        ops.fps._fps_b1_grid(xyz, 4096)


# ---------------------------------------------------------------------------
# tools/fps_handover.cu: the chunk-pruned FPS whose late picks run in one
# block (a measurement tool, not a path of the package)
# ---------------------------------------------------------------------------

def _handover(xyz, npoint, handover=None):
    """The handover kernel's picks, and the first pick of its one-block
    phase, held against the twin."""
    from amcontrast3d_tpu_torch.tools import fps_handover
    got, first = fps_handover.furthest_point_sample_handover(
        xyz, npoint, fps_handover.HANDOVER if handover is None else handover)
    _equal(got, ops.furthest_point_sample_plain(xyz, npoint))
    first = int(first.item())
    assert 1 <= first <= npoint or npoint == 1
    return first


@pytest.mark.cuda
@pytest.mark.parametrize("bucket", [106496, 155648, 221184, 311296])
def test_handover_fps_at_every_stage_of_the_buckets(cuda_device, bucket):
    """At every stage of the four buckets (N → N / 4), on a room-like
    cloud with repeated points: picks identical to the twin; the first
    stage hands over to the one block before its last pick."""
    rng = np.random.RandomState(bucket + 1)
    p = torch.from_numpy(_room(rng, bucket)).to(cuda_device)
    for s in range(4):
        npoint = p.shape[1] // 4
        first = _handover(p, npoint)
        assert s > 0 or 2 <= first < npoint
        p = ops.gather_points(p, ops.furthest_point_sample(p, npoint)
                              ).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("handover", [0, 1, 32, 10 ** 6])
def test_handover_fps_on_both_sides_of_the_handover(cuda_device, handover):
    """Handover 0 (the wide kernel alone), 1 (no pick visits no chunk), 32
    and 10⁶ (right after the first pick): the same picks, the one block
    starting where the rule says."""
    rng = np.random.RandomState(14)
    xyz = torch.from_numpy(_room(rng, 60000)).to(cuda_device)
    first = _handover(xyz, 15000, handover)
    if handover in (0, 1):
        assert first == 15000
    elif handover == 10 ** 6:
        assert first == 2
    else:
        assert 2 < first < 15000


@pytest.mark.cuda
def test_handover_fps_ties_duplicates_npoint_1_and_n(cuda_device):
    """Every point equal (each pick a tie the lowest index wins), a gridded
    room with repeated points, npoint 1 and npoint N, point 0 far from the
    first chunk of the sort."""
    same = torch.ones(1, 170000, 3, device=cuda_device)
    _handover(same, 50, 10 ** 6)
    room = torch.from_numpy(_room(np.random.RandomState(15), 170001)).to(cuda_device)
    _handover(room, 42500)
    _handover(room, 1)
    small = torch.from_numpy(_room(np.random.RandomState(16), 5000)).to(cuda_device)
    _handover(small, 5000, 10 ** 6)
    rng = np.random.RandomState(17)
    far = torch.from_numpy(_cloud(rng, 1, 70001, True)).to(cuda_device)
    far[0, 0] = torch.tensor([3.9, 3.9, 3.9])
    _handover(far, 7000)


@pytest.mark.cuda
def test_handover_fps_just_above_one_block_and_a_huge_cloud(cuda_device):
    """The most chunks one block holds (5120: 327680 points) hands over;
    one point more runs the wide kernel alone, as does 1.2 M → 4096: picks
    identical to the twin at all three."""
    from amcontrast3d_tpu_torch.tools import fps_handover
    rng = np.random.RandomState(18)
    n = fps_handover.MAX_POINTS
    xyz = torch.from_numpy(_cloud(rng, 1, n + 1, False)).to(cuda_device)
    assert _handover(xyz[:, :n].contiguous(), 20000, 10 ** 6) == 2
    assert _handover(xyz, 20000, 10 ** 6) == 20000
    huge = torch.from_numpy(_cloud(rng, 1, 1200000, True)).to(cuda_device)
    assert _handover(huge, 4096) == 4096


@pytest.mark.cuda
def test_handover_fps_refused_launches_raise(cuda_device):
    """A launch the kernel refuses raises, with no fallback: more picks
    than points, a handover beyond one block's chunks, a cloud beyond the
    wide kernel's 2 M points; a CPU cloud is refused."""
    from amcontrast3d_tpu_torch.tools import fps_handover
    lib = fps_handover.library("handover")
    xyz = torch.rand(1, 1000, 3, device=cuda_device)
    with pytest.raises(ValueError):
        fps_handover.furthest_point_sample_handover(xyz, 1001)
    with pytest.raises(ValueError):
        fps_handover.furthest_point_sample_handover(xyz.cpu(), 10)
    cloud = ops.spatial.sort_stages([xyz])[0]
    scratch = torch.zeros(fps_handover.MAX_CHUNKS + 1, 4, device=cuda_device)
    out = torch.empty(1, 10, dtype=torch.int32, device=cuda_device)
    stream = torch.cuda.current_stream(cuda_device).cuda_stream
    for n, handover in ((1000, -1), (fps_handover.MAX_POINTS + 1, 32),
                        (fps_handover.WIDE_MAX_POINTS + 1, 0)):
        err = lib.amc3d_fps_handover(
            cloud.packed.data_ptr(), cloud.boxes.data_ptr(), xyz.data_ptr(),
            scratch.data_ptr(), scratch.data_ptr(), scratch.data_ptr(),
            scratch.data_ptr(), out.data_ptr(), None, n, 10, handover, stream)
        assert err != 0, (n, handover)
    with pytest.raises(RuntimeError):
        fps_handover._raise(lib, "amc3d_fps_handover", 1)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n1,n2,c", [(1, 1, 1, 1), (2, 1031, 2, 5),
                                       (2, 4099, 1030, 3), (2, 20001, 5003, 200),
                                       (1, 60000, 15000, 128), (3, 257, 1, 6),
                                       (2, 30000, 7500, 1023)])
def test_interp_big_matches_the_dense_kernel_and_plain(cuda_device, b, n1, n2, c):
    """The lane-a-point interpolation at B = 2 and 3 with clouds that
    differ and ragged sizes, n2 < 3 and C % 4 != 0 among them, sorting for
    itself and over both clouds' layouts: output, indices and weights the
    same bits as the listed kernel's (``csrc/interpolate.cu``), indices
    identical to the twin's, weights and output within 1e-5·(1+max) of the
    twin."""
    rng = np.random.RandomState(n1 + n2)
    p1 = torch.from_numpy(_cloud(rng, b, n1, True)).to(cuda_device)
    p2 = torch.from_numpy(_cloud(rng, b, n2, False)).to(cuda_device)
    p2[:, : min(n1, n2) // 2] = p1[:, : min(n1, n2) // 2]   # coincident points
    f2 = torch.from_numpy(rng.randn(b, n2, c).astype(np.float32)).to(cuda_device)
    before = ops.three_interpolation_big.launches
    out, idx, w = ops.three_interpolation_big(p1, p2, f2, keep=True)
    assert ops.three_interpolation_big.launches == before + 1
    d_out, d_idx, d_w = ops.three_interpolation_small(p1, p2, f2, keep=True)
    _equal(out, d_out)
    _equal(idx, d_idx)
    _equal(w, d_w)
    _equal(ops.three_interpolation_big(p1, p2, f2)[0], d_out)
    fine, coarse = spatial.sort_stages([p1, p2])
    got = ops.three_interpolation_big(p1, p2, f2, True, None, coarse, fine)
    for x, y in zip(got, (out, idx, w)):
        _equal(x, y)
    want_i, want_w = ops.three_interpolation_weights(p1, p2)
    _equal(idx, want_i)
    _close(w, want_w, 1e-5)
    _close(out, ops.three_interpolation_plain(p1, p2, f2), 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("n1,c", [(221184, 128), (311296, 128), (155648, 256)])
def test_interp_big_at_the_rungs(cuda_device, n1, c):
    """The lane-a-point interpolation at the rungs (a room-like cloud with
    repeated points, coarse points from FPS, N2 = N1 / 4), over both
    clouds' layouts as a forward makes them: output, indices and weights
    the same bits as the listed kernel's; indices identical to the twin's,
    output within 1e-5·(1+max|out|) of it; a visit counter that counts."""
    rng = np.random.RandomState(n1)
    p1 = torch.from_numpy(_room(rng, n1)).to(cuda_device)
    n2 = n1 // 4
    p2 = ops.gather_points(p1, ops.furthest_point_sample(p1, n2)).contiguous()
    f2 = torch.from_numpy(rng.randn(1, n2, c).astype(np.float32)).to(cuda_device)
    fine, coarse = spatial.sort_stages([p1, p2])
    visits = torch.zeros(1, dtype=torch.int64, device=cuda_device)
    got = ops.three_interpolation_big(p1, p2, f2, True, visits, coarse, fine)
    want = ops.three_interpolation_small(p1, p2, f2, True, coarse, fine)
    for x, y in zip(got, want):
        _equal(x, y)
    _equal(got[1], ops.three_interpolation_weights(p1, p2)[0])
    _close(got[0], ops.three_interpolation_plain(p1, p2, f2), 1e-5)
    assert 2 * -(-n1 // 32) <= visits.item() < -(-n1 // 32) * -(-n2 // 64)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n1,n2", [(1, 40000, 10000), (2, 24000, 6000),
                                     (1, 3000, 2)])
def test_interp_big_on_a_tie_grid(cuda_device, b, n1, n2):
    """Fine and coarse points on a 1/128 m grid (d² exact, ties at the 3rd
    neighbour everywhere, repeated points): the lane-a-point kernel's
    indices the twin's (ties to the lowest index), its output, indices and
    weights the listed kernel's bits, over the layouts and sorting for
    itself."""
    rng = np.random.RandomState(n1 + b)
    p1 = torch.from_numpy((rng.randint(0, 40, (b, n1, 3)) / 128).astype(
        np.float32)).to(cuda_device)
    p2 = p1[:, rng.permutation(n1)[:n2]].contiguous()
    f2 = torch.from_numpy(rng.randn(b, n2, 20).astype(np.float32)).to(cuda_device)
    fine, coarse = spatial.sort_stages([p1, p2])
    got = ops.three_interpolation_big(p1, p2, f2, True, None, coarse, fine)
    want = ops.three_interpolation_small(p1, p2, f2, True, coarse, fine)
    for x, y in zip(got, want):
        _equal(x, y)
    for x, y in zip(ops.three_interpolation_big(p1, p2, f2, True), want):
        _equal(x, y)
    _equal(got[1], ops.three_interpolation_weights(p1, p2)[0])


@pytest.mark.cuda
def test_interp_big_dispatch_and_gradient(cuda_device):
    """(N1, C) = (221184, 128) goes to the lane-a-point kernel and its VJP
    to the per-row lists, (16000, 128) and (221184, 512) to the listed
    kernel and the scatter (``forward_is_big``, ``backward_is_big``); the
    gradient through either forward's saved triples within
    1e-5·(1+max|df2|) of the twin's."""
    rng = np.random.RandomState(7)
    counters = (ops.three_interpolation_big, ops.three_interpolation,
                ops.three_interpolation_backward_big,
                ops.three_interpolation_backward)
    for n1, c, is_big in ((221184, 128, True), (16000, 128, False),
                          (221184, 512, False)):
        n2 = n1 // 4
        assert ops.forward_is_big(1, n1, n2, c) == is_big
        p1 = torch.from_numpy(_room(rng, n1)).to(cuda_device)
        p2 = p1[:, ::4].contiguous()
        f = torch.from_numpy(rng.randn(1, n2, c).astype(np.float32)
                             ).to(cuda_device).requires_grad_()
        g = torch.from_numpy(rng.randn(1, n1, c).astype(np.float32)
                             ).to(cuda_device)
        counts = [fn.launches for fn in counters]
        out = ops.three_interpolation(p1, p2, f)
        out.backward(g)
        assert [fn.launches - n for fn, n in zip(counters, counts)] == \
            [is_big, not is_big, is_big, not is_big]
        fp = f.detach().clone().requires_grad_()
        outp = ops.three_interpolation_plain(p1, p2, fp)
        outp.backward(g)
        _close(out, outp, 1e-5)
        _close(f.grad, fp.grad, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [6000, 40000])
def test_knn_beyond_128_neighbours(cuda_device, n):
    """k = 129 and 256 through the kNN kernel (passes of 128 slots), on a
    gridded room with repeated points (ties at the seams of the passes):
    indices and d² identical to the twin; k > N pads as the twin does."""
    rng = np.random.RandomState(n)
    sup = torch.from_numpy(_room(rng, n)).to(cuda_device)
    q = sup[:, ::7].contiguous()
    for k in (129, 256):
        want_i, want_d = ops.knn_plain(sup, q, k)
        before = ops.knn.launches
        got_i, got_d = ops.knn(sup, q, k)
        assert ops.knn.launches == before + -(-k // 128)
        _equal(got_i, want_i)
        _equal(got_d, want_d)
    tiny = sup[:, :200].contiguous()
    got_i, got_d = ops.knn(tiny, tiny, 300)
    want_i, want_d = ops.knn_plain(tiny, tiny, 300)
    _equal(got_i, want_i)
    _equal(got_d, want_d)


# ---- the approx configuration and the fused aggregation ----------------------------

def _grid_cloud(rng, b, n, cells=32):
    """Points on a 1/cells grid in [0, 1)³: ties in distance everywhere."""
    return (rng.randint(0, cells, (b, n, 3)) / cells).astype(np.float32)


def _clouds_for_selection(rng, n):
    """Uniform, clustered, a 1/32 grid in a unit cube and a 1/128 m grid
    in a 0.3 m cube (duplicate points and d² ties everywhere)."""
    return {"uniform": _cloud(rng, 2, n, False), "clustered": _cloud(rng, 2, n, True),
            "grid": _grid_cloud(rng, 2, n),
            "grid 1/128": (rng.randint(0, 40, (2, n, 3)) / 128).astype(np.float32)}


SELECT_KS = [1, 4, 16, 24, 64, 128, 129, 256]


@pytest.mark.cuda
@pytest.mark.parametrize("k", SELECT_KS)
def test_contrast_select_matches_plain(cuda_device, k):
    """The listed k-th distinct d² on uniform, clustered and gridded clouds
    (ties, duplicates) of 3000 points (no multiple of 64), k below, at and
    above one pass of 128: identical to the twin, over the cloud's layout
    from ``sort_stages`` and sorting for itself; one launch a call."""
    rng = np.random.RandomState(k)
    for name, pts in _clouds_for_selection(rng, 3000).items():
        p = torch.from_numpy(pts).to(cuda_device)
        want = ops.contrast_select_plain(p, k)
        for cloud in (None, spatial.sort_stages([p])[0]):
            before = ops.contrast_select.launches
            got = ops.contrast_select(p, k, cloud)
            assert ops.contrast_select.launches == before + 1
            _equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n,k", [(1, 1), (5, 12), (40, 300), (33, 24), (130, 129),
                                 (5000, 20), (5000, 300)])
def test_contrast_select_few_points(cuda_device, n, k):
    """N < k (3e38·(1+1e-6)), ragged blocks, and fewer than k distinct
    values in a large cloud (a 1/4 grid holds 19 distinct d²), where every
    chunk is listed: identical to the twin."""
    rng = np.random.RandomState(n)
    p = torch.from_numpy(_grid_cloud(rng, 3, n, 4)).to(cuda_device)
    want = ops.contrast_select_plain(p, k)
    _equal(ops.contrast_select(p, k), want)
    if k > 19:
        assert (want > 1e38).all()


@pytest.mark.cuda
@pytest.mark.parametrize("c,root,need_s", [(1, False, False), (64, True, True),
                                           (200, False, True)])
def test_selfk_reductions_match_plain(cuda_device, c, root, need_s):
    """``contrast_reductions_selfk`` through the selection and the three
    contrast kernels against the plain twins, C = 1 as ``ambiguity_head``
    calls it: threshold and counts identical, sums within 1e-5·(1+max),
    df within 1e-4·(1+max)."""
    rng = np.random.RandomState(c)
    p = torch.from_numpy(_cloud(rng, 2, 2000, True)).to(cuda_device)
    f = torch.nn.functional.normalize(
        torch.from_numpy(rng.randn(2, 2000, c).astype(np.float32)), dim=-1
    ).to(cuda_device)
    lab = torch.from_numpy(rng.randint(0, 5, (2, 2000)).astype(np.float32)).to(cuda_device)
    g = torch.from_numpy(rng.randn(2, 2000, 9).astype(np.float32)).to(cuda_device)
    outs, grads = [], []
    for fn in (ops.contrast_reductions_selfk, ops.contrast_reductions_selfk_plain):
        ft = f.clone().requires_grad_()
        out = fn(p, ft, lab, 24, 1 / 0.3, root, need_s, True)
        out.backward(g)
        outs.append(out.detach())
        grads.append(ft.grad)
    _equal(outs[0][..., 4:6], outs[1][..., 4:6])
    _equal(outs[0][..., 8], outs[1][..., 8])
    for col in (0, 1, 2, 3, 6, 7):
        _close(outs[0][..., col], outs[1][..., col], 1e-5)
    _close(grads[0], grads[1], 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("k", SELECT_KS)
def test_label_vote_matches_plain(cuda_device, k):
    """The listed vote at stage shapes (queries a quarter of the support,
    picked by FPS as the stages are) on the four clouds, 13 and 50 classes:
    labels identical to the twin, over the layouts of ``sort_stages`` (as
    the loss hands them) and sorting for itself; one launch a call."""
    rng = np.random.RandomState(k + 1)
    for name, pts in _clouds_for_selection(rng, 4000).items():
        sup = torch.from_numpy(pts).to(cuda_device)
        q = ops.gather_points(sup, ops.furthest_point_sample(sup, 1000)).contiguous()
        layouts = spatial.sort_stages([sup, q])
        for ncls in (13, 50):
            lab = torch.from_numpy(rng.randint(0, ncls, (2, 4000)).astype(np.int32)
                                   ).to(cuda_device)
            want = ops.label_vote_plain(sup, lab, q, k, ncls)
            for clouds in ((None, None), layouts):
                before = ops.label_vote.launches
                got = ops.label_vote(sup, lab, q, k, ncls, *clouds)
                assert ops.label_vote.launches == before + 1
                _equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,k,ncls", [(5, 3, 12, 4), (1030, 9, 16, 2000),
                                        (300, 300, 64, 1)])
def test_label_vote_small_ragged_and_wide(cuda_device, n, m, k, ncls):
    """Fewer distinct values than k, a ragged block, 2000 classes (the
    histograms need more than 48 KB of shared memory), one class, and
    queries off the support's points."""
    rng = np.random.RandomState(n)
    sup = torch.from_numpy(_grid_cloud(rng, 2, n, 8)).to(cuda_device)
    q = torch.from_numpy(_grid_cloud(rng, 2, m, 8) + np.float32(1 / 16)).to(cuda_device)
    lab = torch.from_numpy(rng.randint(0, ncls, (2, n)).astype(np.int32)).to(cuda_device)
    _equal(ops.label_vote(sup, lab, q, k, ncls),
           ops.label_vote_plain(sup, lab, q, k, ncls))


@pytest.mark.cuda
@pytest.mark.parametrize("recipe,b,n", [("s3dis", 4, 24000), ("scannet", 2, 64000)])
@pytest.mark.parametrize("kind", ["uniform", "clustered", "grid 1/128"])
def test_selection_and_vote_at_the_stage_shapes(cuda_device, recipe, b, n, kind):
    """The listed selection at the four decoder stages (k = 24) and the
    vote at stages 1-3 (k = 4, 16, 64), at the S3DIS and ScanNet steps'
    shapes (stages from FPS), over the stage layouts of one ``sort_stages``
    as the loss hands them on: thresholds and labels identical to the
    twins, one launch a call."""
    rng = np.random.RandomState(n)
    if kind == "grid 1/128":
        pts = (rng.randint(0, 400, (b, n, 3)) / 128).astype(np.float32)
    else:
        pts = _cloud(rng, b, n, kind == "clustered")
    stages = [torch.from_numpy(pts).to(cuda_device)]
    for _ in range(3):
        prev = stages[-1]
        stages.append(ops.gather_points(prev, ops.furthest_point_sample(
            prev, prev.shape[1] // 4)).contiguous())
    layouts = spatial.sort_stages(stages)
    lab = torch.from_numpy(rng.randint(0, 13, (b, n)).astype(np.int32)).to(cuda_device)
    for s, (p, layout) in enumerate(zip(stages, layouts)):
        before = ops.contrast_select.launches
        got = ops.contrast_select(p, 24, layout)
        assert ops.contrast_select.launches == before + 1
        _equal(got, ops.contrast_select_plain(p, 24))
        if s == 0:
            continue
        before = ops.label_vote.launches
        got = ops.label_vote(stages[0], lab, p, 4 ** s, 13, layouts[0], layout)
        assert ops.label_vote.launches == before + 1
        _equal(got, ops.label_vote_plain(stages[0], lab, p, 4 ** s, 13))


def _aggregate_case(rng, dev, n, m, c, r, sign, k=32, b=2, clustered=True):
    """(u, idx, sgn, qp, queries): ball-query slots of ``m`` queries taken
    from ``b`` clouds of ``n`` points (repeat-padded where a ball holds
    fewer than ``k``)."""
    sup = torch.from_numpy(_cloud(rng, b, n, clustered)).to(dev)
    q = sup[:, ::max(1, n // m)][:, :m].contiguous()
    idx = ops.ball_query(sup, q, r, k)
    u = torch.from_numpy(rng.randn(b, n, c).astype(np.float32)).to(dev)
    sgn = {"pos": np.ones(c), "neg": -np.ones(c),
           "mixed": np.where(rng.rand(c) < 0.5, -1.0, 1.0)}[sign]
    qp = torch.from_numpy(rng.randn(b, m, c).astype(np.float32)).to(dev)
    return u, idx, torch.from_numpy(sgn.astype(np.float32)).to(dev), qp, q


def _check_aggregation(u, idx, sgn, qp, order, rng):
    """Both kernels against the twins on one input: ext and the tie count
    identical, su and sq within 1e-5·(1+max), in train and eval mode; du
    (float atomics) within 1e-5·(1+max|du|) with and without the moments;
    one launch a call."""
    b, m, c = qp.shape
    before = ops.aggregate_forward.launches
    got = ops.aggregate_forward(u, idx, sgn, qp, order=order, keep_ties=True)
    assert ops.aggregate_forward.launches == before + 1
    want = ops.aggregate_forward_plain(u, idx, sgn, qp, keep_ties=True)
    _equal(got[0], want[0])
    _close(got[1], want[1], 1e-5)
    _close(got[2], want[2], 1e-5)
    _equal(got[3], want[3])
    ext_eval, su, sq, ties = ops.aggregate_forward(u, idx, sgn, need_stats=False,
                                                   order=order)
    assert su is None and sq is None and ties is None
    _equal(ext_eval, want[0])
    gs = [torch.from_numpy(rng.randn(b, m, c).astype(np.float32)).to(u.device)
          for _ in range(3)]
    before = ops.aggregate_backward.launches
    du = ops.aggregate_backward(u, idx, qp, got[0], got[3], *gs, order=order)
    assert ops.aggregate_backward.launches == before + 1
    _close(du, ops.aggregate_backward_plain(u, idx, qp, got[0], got[3], *gs), 1e-5)
    _close(ops.aggregate_backward(u, idx, None, got[0], got[3], gs[0], order=order),
           ops.aggregate_backward_plain(u, idx, None, got[0], got[3], gs[0]), 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("c,sign,r,k,b,clustered,layout", [
    (1, "neg", 0.05, 32, 2, True, False), (13, "mixed", 0.02, 24, 2, True, True),
    (64, "pos", 0.1, 8, 3, False, True), (128, "mixed", 0.1, 32, 2, True, True),
    (128, "pos", 0.3, 32, 4, False, False), (256, "neg", 0.2, 24, 2, True, True),
    (1024, "mixed", 0.05, 32, 2, True, True), (1024, "pos", 0.4, 8, 2, False, False)])
def test_aggregate_kernels_match_plain(cuda_device, c, sign, r, k, b, clustered,
                                       layout):
    """The fused aggregation's forward and backward against the twins
    (:func:`_check_aggregation`), with the repeat padding of the ball query
    (a small radius leaves balls short of K), dense balls (the clustered
    cloud) and sparse ones, C = 1, 13 (no multiple of 4), 64 to 1024 (one
    to eight channel tiles), K = 8, 24 and 32, B = 2 to 4, both signs and
    mixed ``sgn``, the queries in their layout's order (runs along the
    curve) and in index order."""
    rng = np.random.RandomState(c + k)
    u, idx, sgn, qp, q = _aggregate_case(rng, cuda_device, 3000, 750, c, r, sign,
                                         k, b, clustered)
    order = spatial.index_bits(spatial.sort_support(q)) if layout else None
    _check_aggregation(u, idx, sgn, qp, order, rng)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [13, 128])
def test_aggregate_kernels_read_zero_outside_the_support(cuda_device, c):
    """A slot index outside [0, n) reads 0 (it enters the extremum, its
    ties and the moments as 0) and receives nothing: the twins' answer on
    ``u`` with a zero row appended, the index sent there."""
    rng = np.random.RandomState(40 + c)
    u, idx, sgn, qp, q = _aggregate_case(rng, cuda_device, 2000, 500, c, 0.1,
                                         "mixed")
    n = u.shape[1]
    bad = torch.from_numpy(rng.rand(*idx.shape) < 0.1).to(cuda_device)
    wild = torch.from_numpy(rng.choice([-1, n, n + 7, 2 ** 31 - 1], idx.shape)
                            .astype(np.int32)).to(cuda_device)
    idx = torch.where(bad, wild, idx)
    padded = torch.cat([u, u.new_zeros(u.shape[0], 1, c)], 1)
    inside = torch.where((idx >= 0) & (idx < n), idx, n)
    order = spatial.index_bits(spatial.sort_support(q))
    got = ops.aggregate_forward(u, idx, sgn, qp, order=order, keep_ties=True)
    want = ops.aggregate_forward_plain(padded, inside, sgn, qp, keep_ties=True)
    _equal(got[0], want[0])
    _close(got[1], want[1], 1e-5)
    _close(got[2], want[2], 1e-5)
    _equal(got[3], want[3])
    gs = [torch.from_numpy(rng.randn(*qp.shape).astype(np.float32)).to(cuda_device)
          for _ in range(3)]
    du = ops.aggregate_backward(u, idx, qp, got[0], got[3], *gs, order=order)
    _close(du, ops.aggregate_backward_plain(padded, inside, qp, want[0], want[3],
                                            *gs)[:, :n], 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("train", [True, False])
def test_grouped_slot_reduce_autograd_on_the_card(cuda_device, train):
    """``grouped_slot_reduce`` through both kernels against the plain
    entry, with the query layout and without: outputs and the gradients
    in u and qp within 1e-5·(1+max); in eval mode (no moments) the
    gradient in u alone."""
    rng = np.random.RandomState(5)
    u, idx, sgn, qp, q = _aggregate_case(rng, cuda_device, 2000, 500, 96, 0.05,
                                         "mixed")
    layout = spatial.sort_support(q)
    gs = [torch.from_numpy(rng.randn(2, 500, 96).astype(np.float32)).to(cuda_device)
          for _ in range(3 if train else 1)]
    res = []
    for fn, cloud in ((ops.grouped_slot_reduce, layout),
                      (ops.grouped_slot_reduce, None),
                      (ops.grouped_slot_reduce_plain, None)):
        ut, qt = u.clone().requires_grad_(), qp.clone().requires_grad_()
        outs = fn(ut, idx, sgn, qp=qt if train else None, need_stats=train,
                  query_cloud=cloud)
        sum((o * g).sum() for o, g in zip(outs, gs)).backward()
        res.append([o.detach() for o in outs if o is not None] + [ut.grad]
                   + ([qt.grad] if train else []))
    for got in res[:2]:
        for a, b in zip(got, res[2]):
            _close(a, b, 1e-5)


@pytest.mark.cuda
def test_new_wrappers_raise_on_tensors_they_cannot_take(cuda_device):
    """A CUDA tensor of the wrong dtype or layout raises; nothing falls back
    to the twin."""
    rng = np.random.RandomState(6)
    p = torch.from_numpy(_cloud(rng, 2, 100, False)).to(cuda_device)
    wide = torch.zeros(2, 100, 4, device=cuda_device)
    with pytest.raises(ValueError):
        ops.contrast_select(p.double(), 4)
    with pytest.raises(ValueError):
        ops.contrast_select(wide[..., :3], 4)                 # not contiguous
    lab = torch.zeros(2, 100, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        ops.label_vote(p, lab.long(), p, 4, 3)
    with pytest.raises(ValueError):
        ops.label_vote(wide[..., :3], lab, p, 4, 3)
    with pytest.raises(ValueError):
        ops.label_vote(p, lab, p, 4, ops.contrast.VOTE_MAX_CLASSES + 1)
    u, idx, sgn, qp, q = _aggregate_case(rng, cuda_device, 100, 50, 8, 0.5, "pos")
    with pytest.raises(ValueError):
        ops.aggregate_forward(u, idx.long(), sgn, qp)
    with pytest.raises(ValueError):
        ops.aggregate_forward(u.double(), idx, sgn, qp)
    with pytest.raises(ValueError):
        ops.aggregate_forward(u.transpose(0, 1).contiguous().transpose(0, 1),
                              idx, sgn, qp)
    with pytest.raises(ValueError):                  # another cloud's order
        ops.aggregate_forward(u, idx, sgn, qp,
                              order=spatial.index_bits(spatial.sort_support(u[..., :3].contiguous())))
    with pytest.raises(ValueError):                  # a byte counts the ties
        ops.aggregate_forward(u, idx.repeat(1, 1, 8)[..., :256].contiguous(),
                              sgn, qp, keep_ties=True)
    ext, _, _, ties = ops.aggregate_forward(u, idx, sgn, qp, keep_ties=True)
    strided = ext.transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError):
        ops.aggregate_backward(u, idx, qp, ext, ties, strided)
    with pytest.raises(ValueError):
        ops.aggregate_backward(u, idx, qp, ext, ties.int(), ext)


def _bf16_close(got, want, tol):
    """bfloat16 ``got`` within one bfloat16 ulp of ``want`` (of the larger
    of the two), plus the tolerance tol·(1+max|want|) of the float32 sums
    that both are roundings of."""
    torch.cuda.synchronize()
    g, w = got.float(), want.float()
    big = torch.maximum(g.abs(), w.abs())
    ulp = torch.where(big > 0, torch.exp2(torch.floor(torch.log2(big)) - 7),
                      torch.zeros_like(big))
    bound = ulp + tol * (1 + w.abs().max())
    assert bool(((g - w).abs() <= bound).all()), ((g - w).abs() - bound).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("c,sign,layout", [
    (1, "neg", False), (13, "mixed", True), (64, "pos", True),
    (128, "mixed", True), (256, "neg", False), (1024, "mixed", True)])
def test_aggregate_bf16_kernels_match_plain(cuda_device, c, sign, layout):
    """The bfloat16 forms of both kernels (a bfloat16 ``u``) against the
    twins: ext and the tie count identical (ext the float32 of a bfloat16
    value, also identical to the float32 kernels on ``u.float()``), su and
    sq within 1e-5·(1+max) in train mode, ext identical in eval mode; the
    VJP's float32 accumulator within 1e-5·(1+max|du|) of the twin's, du its
    rounding to bfloat16 exactly and at most one bfloat16 ulp from the
    twin's du, with and without the moments; one launch of the bfloat16
    form a call, none of the float32 form.  C = 1 and 13 take the scalar
    loads, 64 to 1024 the 16-byte (forward) and 8-byte (VJP) ones."""
    rng = np.random.RandomState(100 + c)
    u, idx, sgn, qp, q = _aggregate_case(rng, cuda_device, 3000, 750, c, 0.1,
                                         sign)
    u = u.bfloat16()
    order = spatial.index_bits(spatial.sort_support(q)) if layout else None
    counts = (ops.aggregate_forward.launches, ops.aggregate_forward_bf16.launches,
              ops.aggregate_backward.launches, ops.aggregate_backward_bf16.launches)
    got = ops.aggregate_forward(u, idx, sgn, qp, order=order, keep_ties=True)
    want = ops.aggregate_forward_plain(u, idx, sgn, qp, keep_ties=True)
    assert got[0].dtype == torch.float32
    _equal(got[0], want[0])
    _equal(got[3], want[3])
    _close(got[1], want[1], 1e-5)
    _close(got[2], want[2], 1e-5)
    _equal(ops.aggregate_forward(u, idx, sgn, need_stats=False, order=order)[0],
           want[0])
    _equal(ops.aggregate_forward(u.float(), idx, sgn, qp, order=order,
                                 keep_ties=True)[3], want[3])
    b, m = qp.shape[:2]
    gs = [torch.from_numpy(rng.randn(b, m, c).astype(np.float32)).to(cuda_device)
          for _ in range(3)]
    for args in ((qp, *gs), (None, gs[0])):
        acc = torch.empty(u.shape, dtype=torch.float32, device=cuda_device)
        acc_want = torch.empty_like(acc)
        du = ops.aggregate_backward(u, idx, args[0], got[0], got[3], *args[1:],
                                    order=order, accumulator=acc)
        du_want = ops.aggregate_backward_plain(u, idx, args[0], got[0], got[3],
                                               *args[1:], accumulator=acc_want)
        assert du.dtype == torch.bfloat16
        _close(acc, acc_want, 1e-5)
        _equal(du, acc.bfloat16())
        _bf16_close(du, du_want, 1e-5)
    assert (ops.aggregate_forward.launches, ops.aggregate_forward_bf16.launches,
            ops.aggregate_backward.launches,
            ops.aggregate_backward_bf16.launches) == (
        counts[0] + 1, counts[1] + 2, counts[2], counts[3] + 2)


@pytest.mark.cuda
def test_grouped_slot_reduce_bf16_autograd_on_the_card(cuda_device):
    """``grouped_slot_reduce`` on a bfloat16 ``u`` through the bfloat16
    kernels against the plain entry: float32 outputs identical (ext) and
    within 1e-5·(1+max) (moments); the gradient in ``u`` bfloat16, at most
    one bfloat16 ulp from the plain entry's; the gradient in ``qp`` in
    qp's own dtype (float32 and bfloat16), within 1e-5·(1+max)."""
    rng = np.random.RandomState(7)
    u, idx, sgn, qp, q = _aggregate_case(rng, cuda_device, 2000, 500, 96, 0.05,
                                         "mixed")
    u = u.bfloat16()
    layout = spatial.sort_support(q)
    gs = [torch.from_numpy(rng.randn(2, 500, 96).astype(np.float32)).to(cuda_device)
          for _ in range(3)]
    for qdtype in (torch.float32, torch.bfloat16):
        res = []
        for fn, cloud in ((ops.grouped_slot_reduce, layout),
                          (ops.grouped_slot_reduce_plain, None)):
            ut = u.clone().requires_grad_()
            qt = qp.to(qdtype).clone().requires_grad_()
            outs = fn(ut, idx, sgn, qp=qt, query_cloud=cloud)
            sum((o * g).sum() for o, g in zip(outs, gs)).backward()
            assert ut.grad.dtype == torch.bfloat16 and qt.grad.dtype == qdtype
            res.append([o.detach() for o in outs] + [ut.grad, qt.grad])
        _equal(res[0][0], res[1][0])
        for a, b in zip(res[0][1:3], res[1][1:3]):
            _close(a, b, 1e-5)
        _bf16_close(res[0][3], res[1][3], 1e-5)
        if qdtype == torch.bfloat16:
            _bf16_close(res[0][4], res[1][4], 1e-5)
        else:
            _close(res[0][4], res[1][4], 1e-5)


@pytest.mark.cuda
def test_bf16_forms_raise_on_other_dtypes(cuda_device):
    """The bfloat16 forms take a bfloat16 ``u`` only, the wrappers float32
    or bfloat16; a float32 accumulator goes with a bfloat16 ``u`` only.
    Nothing is upcast or sent to the twin."""
    rng = np.random.RandomState(8)
    u, idx, sgn, qp, q = _aggregate_case(rng, cuda_device, 100, 50, 8, 0.5, "pos")
    with pytest.raises(ValueError):
        ops.aggregate_forward_bf16(u, idx, sgn, qp)
    with pytest.raises(ValueError):
        ops.aggregate_forward(u.half(), idx, sgn, qp)
    ext, _, _, ties = ops.aggregate_forward(u, idx, sgn, qp, keep_ties=True)
    with pytest.raises(ValueError):
        ops.aggregate_backward_bf16(u, idx, qp, ext, ties, ext)
    with pytest.raises(ValueError):
        ops.aggregate_backward(u, idx, qp, ext, ties, ext,
                               accumulator=torch.empty_like(u))
    with pytest.raises(ValueError):   # qp is float32 in both forms
        ops.aggregate_forward(u.bfloat16(), idx, sgn, qp.bfloat16())
