"""The PyTorch port's point ops against the JAX package on the CPU.

Inputs are made with numpy from a seed and fed to both frameworks.  The
port's ops take their plain PyTorch path here (CPU tensors);
``test_torch_port_cuda.py`` holds each CUDA kernel against that plain
path on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amcontrast3d_tpu.ops import ambiguity as jamb
from amcontrast3d_tpu.ops import group as jgroup
from amcontrast3d_tpu.ops import interpolate as jinterp
from amcontrast3d_tpu.ops.contrast_pallas import \
    contrast_reductions as jax_contrast_reductions
from amcontrast3d_tpu.ops.contrast_pallas import \
    dual_masks_cross as jax_dual_masks_cross
from amcontrast3d_tpu.ops.fps import _furthest_point_sample_lax
from amcontrast3d_tpu.ops.fps_pallas import furthest_point_sample_pallas
from amcontrast3d_tpu.ops.interpolate_pallas import three_interpolation_fused
from amcontrast3d_tpu.ops.knn import _ball_query_jnp, _knn_jnp
from amcontrast3d_tpu.ops.knn_pallas import (BIN, _perm, ball_query_pallas,
                                             knn_pallas)
from amcontrast3d_tpu_torch import ops
from amcontrast3d_tpu_torch.ops import interpolate as port_interp
from amcontrast3d_tpu_torch.ops import spatial


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _cloud(rng, b, n, clustered=False):
    """Uniform in [0, 4]³, or a few tight Gaussian clusters (dense balls)."""
    if not clustered:
        return (rng.rand(b, n, 3) * 4).astype(np.float32)
    centres = rng.rand(b, 8, 3) * 4
    pick = rng.randint(0, 8, (b, n))
    pts = np.take_along_axis(centres, pick[..., None], 1)
    return (pts + 0.05 * rng.randn(b, n, 3)).astype(np.float32)


# ---- FPS --------------------------------------------------------------------

@pytest.mark.parametrize("n", [300, 1024])
def test_fps_matches_jax_lax_and_pallas(n):
    rng = np.random.RandomState(n)
    xyz = _cloud(rng, 2, n)
    npoint = n // 4
    got = ops.furthest_point_sample(_t(xyz), npoint).numpy()
    assert got.dtype == np.int32 and got.shape == (2, npoint)
    lax_idx = np.asarray(_furthest_point_sample_lax(jnp.asarray(xyz), npoint))
    pallas_idx = np.asarray(furthest_point_sample_pallas(
        jnp.asarray(xyz), npoint, interpret=True))
    np.testing.assert_array_equal(got, lax_idx)
    np.testing.assert_array_equal(got, pallas_idx)


# ---- ball query ---------------------------------------------------------------

def _near_boundary(sup, q, r):
    """Support points whose float64 d² lies within 1e-6 of r²: the only
    place where the direct and the matmul forms of d² may disagree."""
    d2 = ((q[:, :, None, :].astype(np.float64)
           - sup[:, None, :, :].astype(np.float64)) ** 2).sum(-1)
    return int((np.abs(d2 - r * r) < 1e-6).sum())


@pytest.mark.parametrize("n,m,r,k,clustered", [
    (1024, 256, 0.3, 32, False),
    (1024, 256, 0.25, 8, True),     # overfull balls: the first k in index order
    (4, 4, 1.6, 32, False),        # k > N
])
def test_ball_query_matches_jax_plain(n, m, r, k, clustered):
    rng = np.random.RandomState(n + m)
    sup = _cloud(rng, 2, n, clustered)
    q = np.concatenate([sup[:, : m // 2], _cloud(rng, 2, m - m // 2, clustered)], 1)
    assert _near_boundary(sup, q, r) == 0
    got = ops.ball_query(_t(sup), _t(q), r, k).numpy()
    want = np.asarray(_ball_query_jnp(jnp.asarray(sup), jnp.asarray(q), r, k))
    assert got.dtype == np.int32 and got.shape == (2, m, k)
    np.testing.assert_array_equal(got, want)


def _ball_vs_pallas(layouts: bool):
    """The checks of :func:`test_ball_query_against_pallas_kernel`; with
    ``layouts`` the port's wrapper is handed the support's and the queries'
    layouts (one ``sort_stages``, as the encoder makes them)."""
    rng = np.random.RandomState(7)
    sup = _cloud(rng, 2, 1024)
    q = np.concatenate([sup[:, :128], _cloud(rng, 2, 128)], 1)
    r, k = 0.5, 8
    sup_t, q_t = _t(sup), _t(q)
    given = tuple(spatial.sort_stages([sup_t, q_t])) if layouts else ()
    got = ops.ball_query(sup_t, q_t, r, k, *given).numpy()
    if layouts:
        np.testing.assert_array_equal(got, ops.ball_query(sup_t, q_t, r, k).numpy())
        with pytest.raises(ValueError):      # the layouts of other tensors
            ops.ball_query(q_t, sup_t, r, k, *given)
    tpu = np.asarray(ball_query_pallas(jnp.asarray(sup), jnp.asarray(q), r, k,
                                       interpret=True))
    d2 = ((q[:, :, None] - sup[:, None]) ** 2).sum(-1)
    bin_of = np.argsort(_perm(sup.shape[1])) // BIN
    n_small = n_full = 0
    for b in range(2):
        for i in range(q.shape[1]):
            ball = set(np.flatnonzero(d2[b, i] < r * r).tolist())
            mine, theirs = set(got[b, i].tolist()), set(tpu[b, i].tolist())
            if not ball:
                assert mine == theirs == {0}
            elif len(ball) <= k:
                assert mine == ball
                if np.bincount(bin_of[sorted(ball)]).max() > 2:
                    assert theirs <= ball
                else:
                    assert theirs == ball
                    n_small += 1
            else:
                assert mine <= ball and theirs <= ball
                assert len(mine) == k
                n_full += 1
    assert n_small > 50 and n_full > 100


def test_ball_query_against_pallas_kernel():
    """The TPU kernel returns a k-subset of the ball through a fixed
    permutation; the port returns the first k in index order.  Where the
    ball holds ≤ k points both return the whole ball, unless more than two
    of them share one 128-point bin of the permuted support: the TPU kernel
    keeps the best two per bin, and then returns a subset."""
    _ball_vs_pallas(layouts=False)


def test_ball_query_over_layouts_against_pallas_kernel():
    """The same with the layouts of the support and of the queries handed
    in: the same indices as without them, the same agreement with the TPU
    kernel in interpret mode; a layout of another tensor is refused."""
    _ball_vs_pallas(layouts=True)


# ---- kNN, grouping ----------------------------------------------------------

def test_knn_matches_jax_exact():
    rng = np.random.RandomState(3)
    sup, q = _cloud(rng, 2, 500), _cloud(rng, 2, 100)
    idx, d2 = ops.knn(_t(sup), _t(q), 8)
    jidx, jd2 = _knn_jnp(jnp.asarray(sup), jnp.asarray(q), 8)
    np.testing.assert_allclose(d2.numpy(), np.asarray(jd2), rtol=1e-5, atol=1e-5)
    assert (idx.numpy() == np.asarray(jidx)).mean() > 0.99
    idx4, d24 = ops.knn(_t(sup[:, :4]), _t(q), 6)      # k > N: idx 0 at 1e10
    assert (idx4.numpy()[..., 4:] == 0).all() and (d24.numpy()[..., 4:] == 1e10).all()


def _dyadic_cloud(rng, b, n):
    """Positions on a 1/64 grid in [0, 4)³: every d² is exact in float32 in
    the direct and in the matmul form, and d² ties are common."""
    return (rng.randint(0, 256, (b, n, 3)) / 64).astype(np.float32)


@pytest.mark.parametrize("n,m,k", [(500, 500, 24), (500, 100, 8), (300, 77, 64),
                                   (5, 40, 12)])
def test_knn_plain_matches_jax_on_dyadic_grid(n, m, k):
    """``knn_plain`` (the kernel's twin) against the JAX exact kNN on a
    dyadic grid, M ≠ N and k > N included: indices equal (d² ties go to
    the lowest index in both) and d² equal, no tolerance."""
    rng = np.random.RandomState(n + k)
    sup = _dyadic_cloud(rng, 2, n)
    q = sup if m == n else _dyadic_cloud(rng, 2, m)
    idx, d2 = ops.knn_plain(_t(sup), _t(q), k)
    jidx, jd2 = _knn_jnp(jnp.asarray(sup), jnp.asarray(q), k)
    assert idx.dtype == torch.int32 and idx.shape == (2, m, k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(d2.numpy(), np.asarray(jd2))
    disp_idx, disp_d2 = ops.knn(_t(sup), _t(q), k)    # CPU: the twin
    assert torch.equal(disp_idx, idx) and torch.equal(disp_d2, d2)


def test_knn_plain_against_pallas_kernel():
    """The TPU kernel is approximate by design (best two per 128-wide bin);
    held as the JAX package's own test holds it: ascending order, the point
    itself first, and recall > 0.97 of the exact neighbours."""
    rng = np.random.RandomState(5)
    sup = rng.rand(2, 3000, 3).astype(np.float32)
    q = np.concatenate([sup[:, :150], rng.rand(2, 150, 3).astype(np.float32)], 1)
    idx, d2 = ops.knn_plain(_t(sup), _t(q), 8)
    pidx, pd2 = knn_pallas(jnp.asarray(sup), jnp.asarray(q), 8, interpret=True)
    pidx, pd2 = np.asarray(pidx), np.asarray(pd2)
    assert np.all(np.diff(d2.numpy(), axis=-1) >= 0)
    assert np.all(np.diff(pd2, axis=-1) >= -1e-6)
    np.testing.assert_array_equal(idx.numpy()[:, :150, 0],
                                  np.broadcast_to(np.arange(150), (2, 150)))
    np.testing.assert_array_equal(pidx[:, :150, 0], idx.numpy()[:, :150, 0])
    recall = np.mean([len(set(a) & set(o)) / 8
                      for A, O in zip(pidx, idx.numpy()) for a, o in zip(A, O)])
    assert recall > 0.97
    hit = pidx == idx.numpy()
    np.testing.assert_allclose(pd2[hit], d2.numpy()[hit], rtol=1e-5, atol=1e-6)


def _dual_masks_vs_pallas(fusion: str, layout: bool):
    """The checks of :func:`test_dual_masks_cross_matches_pallas_kernel`;
    with ``layout`` the wrapper is handed the cloud's layout."""
    rng = np.random.RandomState(6)
    b, n, c, k = 2, 300, 16, 8
    p = rng.rand(b, n, 3).astype(np.float32)
    f = rng.randn(b, n, c).astype(np.float32)
    g = rng.randn(b, n, c).astype(np.float32)
    a = rng.rand(b, n).astype(np.float32)
    if fusion == "MIN_ALL0":
        a = np.where(rng.rand(b, n) < 0.4, 0.0, a).astype(np.float32)
    ft = _t(f).requires_grad_()
    p_t = _t(p)
    cloud = spatial.sort_stages([p_t])[0] if layout else None
    got = ops.dual_masks_cross(p_t, ft, _t(a), k, fusion, cloud)
    got.backward(_t(g))
    if layout:
        with pytest.raises(ValueError):      # the layout of another cloud
            ops.dual_masks_cross(p_t.clone(), _t(f), _t(a), k, fusion, cloud)
    cross = lambda f_: jax_dual_masks_cross(jnp.asarray(p), f_, jnp.asarray(a),
                                            k, fusion, interpret=True)
    want, vjp = jax.vjp(cross, jnp.asarray(f))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ft.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]),
                               rtol=1e-5, atol=1e-5)
    # without a gradient the same feature comes back
    plain = ops.dual_masks_cross_plain(_t(p), _t(f), _t(a), k, fusion)
    assert torch.equal(plain, got.detach())


@pytest.mark.parametrize("fusion", ["MIN", "MIN_ALL0"])
def test_dual_masks_cross_matches_pallas_kernel(fusion):
    """``dual_masks_cross_plain`` and its gradient against the TPU kernel in
    interpret mode.  The TPU kernel averages argmin ties and admits d² ties,
    so MIN takes a continuous ambiguity (unique minima) on float positions
    (no d² ties); MIN_ALL0 an ambiguity with exact zeros.  1e-5 on the
    feature and on the gradient (the kernel's 0/1-weight matmul)."""
    _dual_masks_vs_pallas(fusion, layout=False)


@pytest.mark.parametrize("fusion", ["MIN", "MIN_ALL0"])
def test_dual_masks_cross_over_a_layout_matches_pallas_kernel(fusion):
    """The same with the cloud's layout handed in, as the decoder hands the
    encoder's: the same feature and gradient, within the same 1e-5 of the
    TPU kernel; a layout of another tensor is refused."""
    _dual_masks_vs_pallas(fusion, layout=True)


def test_refine_cross_pads_and_selection():
    """N < k: the slots past the cloud index point 0, as the exact kNN pads
    them; the saved selection reproduces the feature and the VJP."""
    rng = np.random.RandomState(8)
    p = _t(_dyadic_cloud(rng, 2, 5))
    f = _t(rng.randn(2, 5, 3).astype(np.float32))
    a = _t(np.array([[0.0, 0.3, 0.2, 0.9, 0.1], [0.5, 0.4, 0.3, 0.2, 0.1]],
                    np.float32))
    cross, sel = ops.refine_cross(p, f, a, 8, "MIN")
    # cloud 0: point 0 (a = 0, the minimum) fills the 3 padded slots of
    # every point, itself included; cloud 1: the minimum is point 4
    assert sel[0, :, 0].tolist() == [0] * 5
    assert sel[1, :4, 0].tolist() == [4] * 4
    assert torch.equal(cross, ops.gather_points(f, sel[..., 0]))
    g = _t(rng.randn(2, 5, 3).astype(np.float32))
    df = ops.refine_cross_backward(g, sel, 1.0)
    np.testing.assert_allclose(df[0, 0].numpy(), g[0].sum(0).numpy(), rtol=1e-6)
    cross0, sel0 = ops.refine_cross(p, f, a, 8, "MIN_ALL0")
    assert sel0.shape == (2, 5, 7) and (sel0[1] == -1).all()
    assert torch.equal(cross0[1], torch.zeros(5, 3))
    with pytest.raises(ValueError):
        ops.refine_cross(p, f, a, 1, "MIN")
    with pytest.raises(ValueError):
        ops.refine_cross(p, f, a, 8, "MAX")


def test_gather_group_clamp_match_jax():
    rng = np.random.RandomState(4)
    x = rng.randn(2, 50, 6).astype(np.float32)
    idx2 = rng.randint(0, 50, (2, 20)).astype(np.int32)
    idx3 = rng.randint(0, 50, (2, 20, 5)).astype(np.int32)
    nv = np.array([30, 50], np.int32)
    np.testing.assert_array_equal(
        ops.gather_points(_t(x), _t(idx2)).numpy(),
        np.asarray(jgroup.gather_points(jnp.asarray(x), jnp.asarray(idx2))))
    np.testing.assert_array_equal(
        ops.group_points(_t(x), _t(idx3)).numpy(),
        np.asarray(jgroup.group_points(jnp.asarray(x), jnp.asarray(idx3))))
    np.testing.assert_array_equal(
        ops.clamp_members_valid(_t(idx3), _t(nv)).numpy(),
        np.asarray(jgroup.clamp_members_valid(jnp.asarray(idx3), jnp.asarray(nv))))
    assert ops.clamp_members_valid(_t(idx3), None) is not None


@pytest.mark.parametrize("ftype", ["dp_fj", "dp_fj_df", "pi_dp_fj_df", "dp_df"])
def test_grouper_and_aggregation_features_match_jax(ftype):
    rng = np.random.RandomState(5)
    sup = _cloud(rng, 2, 200)
    q = sup[:, :50].copy()
    f = rng.randn(2, 200, 6).astype(np.float32)
    args = {"NAME": "ballquery", "radius": 0.6, "nsample": 8, "normalize_dp": True}
    dp, fj = ops.create_grouper(args)(_t(q), _t(sup), _t(f))
    jdp, jfj = jgroup.create_grouper(args)(jnp.asarray(q), jnp.asarray(sup),
                                           jnp.asarray(f))
    np.testing.assert_allclose(dp.numpy(), np.asarray(jdp), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(fj.numpy(), np.asarray(jfj))
    fi = f[:, :50]
    got = ops.get_aggregation_features(_t(q), dp, _t(fi), fj, ftype)
    want = jgroup.get_aggregation_features(jnp.asarray(q), jdp, jnp.asarray(fi),
                                           jfj, ftype)
    assert got.shape[-1] == ops.CHANNEL_MAP[ftype](6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


# ---- interpolation ------------------------------------------------------------

@pytest.mark.parametrize("n1,n2,c", [(500, 120, 16), (1024, 256, 32)])
def test_interpolation_matches_jax_plain(n1, n2, c):
    """Positions on a 1/256 grid: every product and sum of d² is exact in
    float32, so the JAX plain path's ``|q|² + |s|² − 2q·s`` form gives the
    same d² as the port's direct form.  (For arbitrary floats it carries an
    absolute error of a few ulp of |q|², which moves weights by ~1e-5.)"""
    rng = np.random.RandomState(n1)
    p2 = (rng.randint(0, 256, (2, n2, 3)) / 256).astype(np.float32)
    p1 = np.concatenate(
        [p2, (rng.randint(0, 256, (2, n1 - n2, 3)) / 256).astype(np.float32)], 1)
    f2 = rng.randn(2, n2, c).astype(np.float32)
    got = ops.three_interpolation(_t(p1), _t(p2), _t(f2)).numpy()
    assert got.shape == (2, n1, c)
    want = np.asarray(jinterp.three_interpolation(
        jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(f2)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n1,n2,c", [(500, 120, 16), (1024, 256, 32)])
def test_interpolation_matches_pallas_kernel(n1, n2, c):
    """The TPU kernel also takes every neighbour whose d² is within a
    1e-6 relative cushion of the 3rd: held to the port on inputs where the
    3rd-nearest d² is that far from the 4th."""
    rng = np.random.RandomState(n1 + 1)
    p2 = rng.rand(2, n2, 3).astype(np.float32)
    p1 = np.concatenate([p2, rng.rand(2, n1 - n2, 3).astype(np.float32)], 1)
    f2 = rng.randn(2, n2, c).astype(np.float32)
    d2 = np.sort(((p1[:, :, None].astype(np.float64) - p2[:, None]) ** 2).sum(-1), -1)
    assert (d2[..., 3] - d2[..., 2] > 1e-5 * d2[..., 2]).all()
    got = ops.three_interpolation(_t(p1), _t(p2), _t(f2)).numpy()
    tpu = np.asarray(three_interpolation_fused(
        jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(f2), True))
    np.testing.assert_allclose(got, tpu, rtol=1e-5, atol=1e-5)


def test_three_nn_and_interpolate_match_jax():
    rng = np.random.RandomState(11)
    p1, p2 = rng.rand(2, 300, 3).astype(np.float32), rng.rand(2, 60, 3).astype(np.float32)
    dist, idx = ops.three_nn(_t(p1), _t(p2))
    jdist, jidx = jinterp.three_nn(jnp.asarray(p1), jnp.asarray(p2))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(dist.numpy(), np.asarray(jdist), rtol=1e-4, atol=1e-5)
    f = rng.randn(2, 60, 5).astype(np.float32)
    w = rng.rand(2, 300, 3).astype(np.float32)
    np.testing.assert_allclose(
        ops.three_interpolate(_t(f), idx, _t(w)).numpy(),
        np.asarray(jinterp.three_interpolate(jnp.asarray(f), jidx, jnp.asarray(w))),
        rtol=1e-6, atol=1e-6)


def _grid_pair(rng, n1, n2):
    """Fine and coarse positions on a 1/256 grid in [0, 1)³ (exact d² in
    both forms), the coarse points among the fine ones."""
    p2 = (rng.randint(0, 256, (2, n2, 3)) / 256).astype(np.float32)
    p1 = np.concatenate(
        [p2, (rng.randint(0, 256, (2, n1 - n2, 3)) / 256).astype(np.float32)], 1)
    return p1, p2


def _interp_grad(p1, p2, f2, g):
    f2t = _t(f2).requires_grad_()
    out = ops.three_interpolation(_t(p1), _t(p2), f2t)
    out.backward(_t(g))
    return out, f2t.grad.numpy()


@pytest.mark.parametrize("n1,n2,c", [(500, 120, 16), (1024, 256, 32)])
def test_interpolation_gradient_matches_jax_plain(n1, n2, c):
    """The VJP into the coarse features (``index_add_`` of w·g) against
    ``jax.vjp`` of the JAX plain path, to 1e-5."""
    rng = np.random.RandomState(n1 + 2)
    p1, p2 = _grid_pair(rng, n1, n2)
    f2 = rng.randn(2, n2, c).astype(np.float32)
    g = rng.randn(2, n1, c).astype(np.float32)
    out, got = _interp_grad(p1, p2, f2, g)
    assert type(out.grad_fn).__name__ == "_ThreeInterpolationBackward"
    _, vjp = jax.vjp(lambda f: jinterp.three_interpolation(
        jnp.asarray(p1), jnp.asarray(p2), f), jnp.asarray(f2))
    np.testing.assert_allclose(got, np.asarray(vjp(jnp.asarray(g))[0]),
                               rtol=1e-5, atol=1e-5)


def test_interpolation_gradient_matches_pallas_vjp():
    """Against the TPU kernels' VJP (``_interp_bwd_kernel``, interpret
    mode) where the 3rd-nearest d² is unique, to 1e-5."""
    rng = np.random.RandomState(1025)
    p2 = rng.rand(2, 256, 3).astype(np.float32)
    p1 = np.concatenate([p2, rng.rand(2, 768, 3).astype(np.float32)], 1)
    d2 = np.sort(((p1[:, :, None].astype(np.float64) - p2[:, None]) ** 2).sum(-1), -1)
    assert (d2[..., 3] - d2[..., 2] > 1e-5 * d2[..., 2]).all()
    f2 = rng.randn(2, 256, 32).astype(np.float32)
    g = rng.randn(2, 1024, 32).astype(np.float32)
    _, got = _interp_grad(p1, p2, f2, g)
    _, vjp = jax.vjp(lambda f: three_interpolation_fused(
        jnp.asarray(p1), jnp.asarray(p2), f, True), jnp.asarray(f2))
    np.testing.assert_allclose(got, np.asarray(vjp(jnp.asarray(g))[0]),
                               rtol=1e-5, atol=1e-5)


def test_interpolation_kernel_branch_carries_the_gradient(monkeypatch):
    """The branch that CUDA tensors take returns an output with a
    ``grad_fn`` whose backward runs the backward wrapper, handing it the
    order in which the forward took the fine points (their layout's).
    Emulated on the CPU: the dispatch is told the tensors are not on the
    CPU, the forward kernel is replaced by the plain forward and the
    backward kernel by its twin."""
    calls = []

    def fake_forward(p1, p2, f2, keep, cloud, query_cloud):
        assert keep
        calls.append("forward")
        # the listed kernel's order: the fine points along their own curve
        order = query_cloud.packed.view(torch.int32)[..., 3]
        return (*port_interp._forward_plain(p1, p2, f2), order)

    def fake_backward(grad, idx, w, n2, order):
        calls.append("backward")
        assert torch.equal(order.long(), query_cloud.perm)
        return port_interp.three_interpolation_backward_plain(grad, idx, w, n2)

    monkeypatch.setattr(port_interp, "_on_cpu", lambda *t: False)
    monkeypatch.setattr(port_interp, "_forward_kernel", fake_forward)
    monkeypatch.setattr(port_interp, "three_interpolation_backward", fake_backward)
    rng = np.random.RandomState(22)
    p1, p2 = _grid_pair(rng, 300, 80)
    p1t, p2t = _t(p1), _t(p2)
    cloud, query_cloud = spatial.sort_stages([p1t, p2t])[::-1]
    f2 = rng.randn(2, 80, 8).astype(np.float32)
    g = rng.randn(2, 300, 8).astype(np.float32)
    f2t = _t(f2).requires_grad_()
    ops.three_interpolation(p1t, p2t, f2t, cloud, query_cloud).backward(_t(g))
    got = f2t.grad.numpy()
    assert calls == ["forward", "backward"]
    _, vjp = jax.vjp(lambda f: jinterp.three_interpolation(
        jnp.asarray(p1), jnp.asarray(p2), f), jnp.asarray(f2))
    np.testing.assert_allclose(got, np.asarray(vjp(jnp.asarray(g))[0]),
                               rtol=1e-5, atol=1e-5)


# ---- contrast reductions and ambiguity ----------------------------------------

@pytest.mark.parametrize("n,root,need_s", [(300, False, True), (1024, True, False)])
def test_contrast_reductions_match_pallas_kernel(n, root, need_s):
    """Forward and VJP against the TPU kernels (interpret mode) with the
    threshold from the exact kNN (24 with self, +1e-5 cushion).  Counts
    and column 8 identical; sums within 1e-5·(1+max|ref|); df within
    1e-4·(1+max|df|).  No pair lies within 1e-6 relative of a threshold,
    where the two d² roundings could disagree."""
    _contrast_vs_pallas(n, root, need_s, layout=False)


def test_contrast_reductions_over_a_layout_match_pallas_kernel():
    """The same, with the cloud's sorted layout handed in (``cloud=``), as
    the loss hands it to the kernels: the same tolerances."""
    _contrast_vs_pallas(300, True, True, layout=True)


def _contrast_vs_pallas(n, root, need_s, layout):
    rng = np.random.RandomState(n + 20)
    p = _cloud(rng, 2, n)
    f = rng.randn(2, n, 32).astype(np.float32)
    f /= np.linalg.norm(f, axis=-1, keepdims=True)
    lab = rng.randint(0, 4, (2, n)).astype(np.float32)
    kth = (ops.knn(_t(p), _t(p), 24)[1][..., -1] * (1.0 + 1e-5)).numpy()
    d2 = ((p[:, :, None].astype(np.float64) - p[:, None]) ** 2).sum(-1)
    assert (np.abs(d2 - kth[..., None]) < 1e-6 * kth[..., None]).sum() == 0
    g = rng.randn(2, n, 9).astype(np.float32)
    tinv = 1 / 0.3

    ft = _t(f).requires_grad_()
    pt = _t(p)
    out = ops.contrast_reductions(pt, ft, _t(lab), _t(kth), tinv, root,
                                  need_s, True,
                                  cloud=spatial.sort_support(pt) if layout else None)
    out.backward(_t(g))
    jout, vjp = jax.vjp(lambda ff: jax_contrast_reductions(
        jnp.asarray(p), ff, jnp.asarray(lab), jnp.asarray(kth), tinv, root,
        True, None, need_s, True), jnp.asarray(f))
    jout = np.asarray(jout)
    got = out.detach().numpy()
    assert (jout[..., 4] + jout[..., 5] == 23).all()   # the kNN's 23 others
    np.testing.assert_array_equal(got[..., 4:6], jout[..., 4:6])
    np.testing.assert_array_equal(got[..., 8], jout[..., 8])
    for col in (0, 1, 2, 3, 6, 7):
        err = np.abs(got[..., col] - jout[..., col]).max()
        assert err <= 1e-5 * (1 + np.abs(jout[..., col]).max()), (col, err)
    jdf = np.asarray(vjp(jnp.asarray(g))[0])
    err = np.abs(ft.grad.numpy() - jdf).max()
    assert err <= 1e-4 * (1 + np.abs(jdf).max()), err


def test_contrast_twin_parts_sum_to_the_vjp():
    """The rows and support twins each hold one half of the VJP."""
    rng = np.random.RandomState(23)
    p = _cloud(rng, 2, 200)
    f = rng.randn(2, 200, 8).astype(np.float32)
    lab = rng.randint(0, 3, (2, 200)).astype(np.float32)
    kth = (ops.knn(_t(p), _t(p), 8)[1][..., -1] * (1.0 + 1e-5)).numpy()
    g = rng.randn(2, 200, 9).astype(np.float32)
    args = (_t(p), _t(f), _t(lab), _t(kth))
    ft = _t(f).requires_grad_()
    ops.contrast_reductions(args[0], ft, *args[2:], 2.0).backward(_t(g))
    g4 = _t(np.ascontiguousarray(g[..., :4]))
    rows = ops.contrast_grad_rows(*args, g4, 2.0)
    sup = ops.contrast_grad_support(*args, g4, 2.0)
    np.testing.assert_allclose((rows + sup).numpy(), ft.grad.numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(
        ops.contrast_forward(*args, 2.0).numpy(),
        ops.contrast_reductions_plain(*args, 2.0).detach().numpy())


@pytest.mark.parametrize("method1,k_cap", [(False, None), (False, 23.0), (True, 23.0)])
def test_ambiguity_from_stats_matches_jax(method1, k_cap):
    rng = np.random.RandomState(24)
    n_pos = rng.randint(0, 26, (2, 500)).astype(np.float32)
    n_neg = (23 - np.minimum(n_pos, 23)).astype(np.float32)
    d_pos = (rng.rand(2, 500) * n_pos).astype(np.float32)
    d_neg = (rng.rand(2, 500) * n_neg).astype(np.float32)
    got = ops.ambiguity_from_stats(*map(_t, (n_pos, n_neg, d_pos, d_neg)), 0.04,
                                   method1=method1, k_cap=k_cap)
    want = jamb.ambiguity_from_stats(*map(jnp.asarray, (n_pos, n_neg, d_pos, d_neg)),
                                     0.04, method1=method1, k_cap=k_cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("cctype", ["Method1", "Method2", "Method3"])
def test_ambiguity_function_matches_jax(cctype):
    rng = np.random.RandomState(25)
    posmask = rng.rand(2, 300, 23) < 0.7
    posmask[0, :50] = True                    # interior points
    dd = rng.rand(2, 300, 23).astype(np.float32)
    got = ops.ambiguity_function(_t(posmask), _t(dd), cctype, 0.04)
    want = jamb.ambiguity_function(jnp.asarray(posmask), jnp.asarray(dd), cctype, 0.04)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def test_wrappers_raise_on_non_cpu_non_cuda_tensors():
    """Only a CPU tensor takes the plain path; any other device launches a
    kernel or raises (never falls back)."""
    meta = torch.empty(1, 64, 3, device="meta")
    with pytest.raises(ValueError):
        ops.furthest_point_sample(meta, 8)
    with pytest.raises(ValueError):
        ops.ball_query(meta, meta, 0.1, 4)
    with pytest.raises(ValueError):
        ops.three_interpolation(meta, meta, torch.empty(1, 64, 8, device="meta"))
    meta_f = torch.empty(1, 64, 8, device="meta")
    meta_1 = torch.empty(1, 64, device="meta")
    with pytest.raises(ValueError):
        ops.contrast_forward(meta, meta_f, meta_1, meta_1)
    with pytest.raises(ValueError):
        ops.contrast_grad_rows(meta, meta_f, meta_1, meta_1,
                               torch.empty(1, 64, 4, device="meta"))
    with pytest.raises(ValueError):
        ops.three_interpolation_backward(meta_f, torch.empty(
            1, 64, 3, dtype=torch.int32, device="meta"), meta, 16)


def test_knn_and_refine_wrappers_raise_rather_than_fall_back():
    """``knn`` and ``dual_masks_cross`` take the plain path for CPU tensors
    only: a tensor on another device, contiguous or not, raises."""
    meta = torch.empty(1, 64, 3, device="meta")
    strided = torch.empty(1, 3, 64, device="meta").transpose(1, 2)
    meta_f = torch.empty(1, 64, 8, device="meta")
    meta_a = torch.empty(1, 64, device="meta")
    assert not strided.is_contiguous()
    for sup in (meta, strided):
        with pytest.raises(ValueError):
            ops.knn(sup, meta, 4)
        with pytest.raises(ValueError):
            ops.knn(meta, sup, 4)
        with pytest.raises(ValueError):
            ops.dual_masks_cross(sup, meta_f, meta_a, 4, "MIN")
        with pytest.raises(ValueError):
            ops.dual_masks_cross(sup, meta_f.requires_grad_(), meta_a, 4,
                                 "MIN_ALL0")
    with pytest.raises(ValueError):
        ops.refine_cross_backward(meta_f, torch.empty(
            1, 64, 1, dtype=torch.int32, device="meta"), 1.0)
    with pytest.raises(ValueError):       # a CPU query against a meta support
        ops.knn(meta, torch.zeros(1, 4, 3), 4)
    assert ops.knn.launches == 0 and ops.refine_cross.launches == 0


# ---- the whole-room kernels: dispatch, twins, spatial order -----------------

import importlib                                                 # noqa: E402

import amcontrast3d_tpu.ops.knn_pallas as KP                     # noqa: E402
from hypothesis import given, settings                           # noqa: E402
from hypothesis import strategies as st                          # noqa: E402


# the modules, not the functions of the same names that ``ops`` exports
port_fps = importlib.import_module("amcontrast3d_tpu_torch.ops.fps")
port_knn = importlib.import_module("amcontrast3d_tpu_torch.ops.knn")
port_refine = importlib.import_module("amcontrast3d_tpu_torch.ops.refine")


@pytest.mark.parametrize("n,npoint", [(203, 60), (1000, 1000), (1, 1)])
def test_fps_b1_twin_matches_pallas_b1_kernel(n, npoint):
    """One cloud: the port's B == 1 wrapper (its twin on the CPU) picks
    exactly what the TPU's B == 1 kernel picks in interpret mode."""
    xyz = _cloud(np.random.RandomState(n), 1, n)
    got = ops.furthest_point_sample_b1(_t(xyz), npoint).numpy()
    want = np.asarray(furthest_point_sample_pallas(jnp.asarray(xyz), npoint,
                                                   interpret=True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, ops.furthest_point_sample_plain(_t(xyz), npoint).numpy())


def test_ball_query_twin_against_big_pallas_kernel(monkeypatch):
    """The large-cloud TPU ball query returns a k-subset of an overfull
    ball; held against the port's twin as the JAX package's own test holds
    it against its oracle: every returned point in the ball, the same set
    where the ball holds at most k points, empty balls all 0."""
    monkeypatch.setattr(KP, "_BIG_N", 4096)   # force the large-cloud kernel
    rng = np.random.RandomState(0)
    sup = (rng.rand(1, 9000, 3) * 4).astype(np.float32)
    q = (rng.rand(1, 700, 3) * 4).astype(np.float32)
    q[0, :5] += 50.0                          # empty balls
    r, k = 0.25, 16
    pidx = np.asarray(KP.ball_query_pallas(jnp.asarray(sup), jnp.asarray(q), r,
                                           k, interpret=True))[0]
    got = ops.ball_query(_t(sup), _t(q), r, k).numpy()[0]
    inside = (port_knn.pairwise_d2(_t(q), _t(sup))[0]
              < port_knn._radius2(r)).numpy()
    hits = want = 0
    for i in range(700):
        members = set(np.where(inside[i])[0].tolist())
        assert set(got[i].tolist()) <= (members or {0})
        assert got[i].tolist() == (sorted(members) + [min(members or {0})] * k)[:k]
        if not members:
            assert pidx[i].tolist() == [0] * k
            continue
        assert set(pidx[i].tolist()) <= members
        hits += len(set(pidx[i].tolist()))
        want += min(len(members), k)
    assert hits / want >= 0.99


def test_knn_twin_against_big_pallas_kernel(monkeypatch):
    """The large-cloud TPU kNN (support streamed in chunks, best two per
    bin) against the port's exact twin: ascending, self first, recall."""
    monkeypatch.setattr(KP, "_BIG_N", 4096)
    rng = np.random.RandomState(1)
    sup = rng.rand(1, 9000, 3).astype(np.float32)
    q = np.concatenate([sup[:, :100], rng.rand(1, 100, 3).astype(np.float32)], 1)
    idx, d2 = ops.knn(_t(sup), _t(q), 8)
    pidx, pd2 = KP.knn_pallas(jnp.asarray(sup), jnp.asarray(q), 8, interpret=True)
    pidx, pd2 = np.asarray(pidx), np.asarray(pd2)
    assert np.all(np.diff(pd2, axis=-1) >= -1e-6)
    np.testing.assert_array_equal(pidx[0, :100, 0], np.arange(100))
    np.testing.assert_array_equal(idx.numpy()[0, :100, 0], np.arange(100))
    recall = np.mean([len(set(a) & set(o)) / 8
                      for a, o in zip(pidx[0], idx.numpy()[0])])
    assert recall > 0.95


def test_b1_and_large_n_route_to_the_new_wrappers(monkeypatch):
    """B == 1 goes to the whole-room FPS, and the ball query and the kNN
    take their one chunk-pruned kernel at every N and k (the JAX package's
    large-cloud kernels' place too); off the CPU each launches its kernel
    or raises, and never runs a twin."""
    calls = []
    monkeypatch.setattr(port_fps, "furthest_point_sample_b1",
                        lambda *a, **k: calls.append("furthest_point_sample_b1"))
    monkeypatch.setattr(port_knn, "_check_cuda", lambda *a: None)
    monkeypatch.setattr(port_knn.spatial, "sort_support", lambda s: type(
        "C", (), {"packed": s, "boxes": s})())
    monkeypatch.setattr(port_knn.spatial, "query_order",
                        lambda query, cloud: (query, query))
    monkeypatch.setattr(port_knn, "launch", lambda name, *a: calls.append(name))
    monkeypatch.setattr(port_knn.torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0})())
    for name in ("ball_query_plain", "knn_plain"):
        monkeypatch.setattr(port_knn, name,
                            lambda *a, _n=name, **k: calls.append(_n))
    one = torch.empty(1, 40001, 3, device="meta")
    small = torch.empty(1, 100, 3, device="meta")
    port_fps.furthest_point_sample(one, 8)
    port_knn.ball_query(one, small, 0.1, 4)
    port_knn.ball_query(small, one, 0.1, 4)
    port_knn.ball_query(one, small, 0.1, 129)      # k beyond the warp's slots
    assert calls == ["furthest_point_sample_b1"] + ["amc3d_ball_query"] * 4
    monkeypatch.undo()
    before = (ops.furthest_point_sample_b1.launches, ops.knn.launches,
              ops.ball_query.launches)
    with pytest.raises(ValueError):
        ops.furthest_point_sample(one, 8)
    for sup, q in ((one, small), (small, one)):
        with pytest.raises(ValueError, match="CUDA"):
            ops.knn(sup, q, 4)
        with pytest.raises(ValueError, match="CUDA"):
            ops.ball_query(sup, q, 0.1, 4)
    # B > 1 above the batched kernel's shared memory: a kernel or an error
    two = torch.empty(2, 60000, 3, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops.furthest_point_sample(two, 8)
    assert before == (ops.furthest_point_sample_b1.launches,
                      ops.knn.launches, ops.ball_query.launches)
    # on the CPU the wrappers are their twins
    rng = np.random.RandomState(2)
    sup, q = _t(_cloud(rng, 1, 300)), _t(_cloud(rng, 1, 50))
    assert torch.equal(ops.ball_query(sup, q, 0.5, 8),
                       ops.ball_query_plain(sup, q, 0.5, 8))
    assert torch.equal(ops.knn(sup, q, 5)[0], ops.knn_plain(sup, q, 5)[0])


# clusters of S blocks an H100 holds at once (read on the card,
# tools/profile_fps.py), and a card without 16-block clusters
_H100 = {1: 132, 2: 66, 4: 30, 8: 15, 16: 7}
_NO_16 = {**_H100, 16: 0}


@pytest.mark.parametrize("n,capacity,want", [
    (57344, _H100, [("fps", 16)]), (57345, _H100, [("fps", 16)]),
    (163840, _H100, [("fps", 16)]), (163841, _H100, ["grid"] * 3),
    (64000, _NO_16, [("fps", 8)]), (81921, _NO_16, ["grid"] * 3),
    (24000, _H100, [("fps", 16)]), (375, _H100, [("fps", 1)])])
def test_batched_fps_above_the_limit_routes_to_the_cluster_kernel(
        monkeypatch, n, capacity, want):
    """B > 1: every cloud up to 16 × 512 × 20 points goes to the cluster
    kernel of ``csrc/fps.cu`` in one launch, above 57344 points too (where
    it went to a whole-room cluster kernel before), at the cluster size
    of ``fps_cluster_size``; above, or where the card holds no cluster
    large enough, the grid kernel cloud by cloud."""
    calls = []
    monkeypatch.setattr(port_fps, "_check_cuda", lambda xyz: None)
    monkeypatch.setattr(port_fps, "_cluster_capacity", lambda index: capacity)
    monkeypatch.setattr(
        port_fps, "launch",
        lambda name, *a: calls.append((name.replace("amc3d_", ""), a[-2])))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: type("S", (), {"cuda_stream": 0}))
    monkeypatch.setattr(
        port_fps, "_fps_b1_grid",
        lambda xyz, npoint: calls.append("grid") or torch.zeros(
            1, npoint, dtype=torch.int32, device="meta"))
    before = port_fps.furthest_point_sample.launches
    out = port_fps.furthest_point_sample(
        torch.empty(3, n, 3, device="meta"), 16)
    assert calls == want and out.shape == (3, 16)
    assert port_fps.furthest_point_sample.launches == \
        before + (want[0] != "grid")


@pytest.mark.parametrize("b,n,capacity,want", [
    # the gates between cluster sizes, each ±1, on a card that holds them
    (4, 1, _H100, 1), (4, 5119, _H100, 1), (4, 5120, _H100, 4),
    (4, 7167, _H100, 4), (4, 7168, _H100, 8), (4, 18431, _H100, 8),
    (4, 18432, _H100, 16),
    # the most points S blocks keep (S × 512 × 20), ±1, where the batch
    # pushes S down to what the cloud needs
    (132, 10240, _H100, 1), (132, 10241, _H100, 2), (66, 20480, _H100, 2),
    (66, 20481, _H100, 4), (30, 40960, _H100, 4), (30, 40961, _H100, 8),
    (15, 81920, _H100, 8), (15, 81921, _H100, 16), (4, 163840, _H100, 16),
    (4, 163841, _H100, None),
    # B clusters that do not fit at once: S halves, down to what N needs
    (7, 24000, _H100, 16), (8, 24000, _H100, 8), (15, 24000, _H100, 8),
    (16, 24000, _H100, 4), (8, 81921, _H100, 16), (2, 100000, _NO_16, None),
    (2, 64000, _NO_16, 8), (4, 6000, {1: 132, 2: 66, 4: 0, 8: 0, 16: 0}, 2),
    (2, 30000, {1: 132, 2: 66, 4: 0, 8: 0, 16: 0}, None),
    # one whole-room cloud (B = 1): the gates alone, and the stages of a
    # room's subcloud forward
    (1, 608, _H100, 1), (1, 2432, _H100, 1), (1, 5120, _H100, 4),
    (1, 9728, _H100, 8), (1, 18432, _H100, 16), (1, 38912, _H100, 16),
    (1, 163840, _H100, 16), (1, 163841, _H100, None),
    (1, 40000, _NO_16, 8), (1, 90000, _NO_16, None)])
def test_fps_cluster_size_at_every_boundary(b, n, capacity, want):
    assert port_fps.fps_cluster_size(b, n, capacity) == want


def test_refine_backward_wrapper_refuses_what_the_kernel_cannot_take(
        monkeypatch):
    """Off the CPU the CrossMask VJP launches its kernel for (B, N, C) and
    (B, N, S) with B·N ≥ 1, C ≥ 1, 1 ≤ S ≤ 127, and raises for anything
    else before it launches."""
    calls = []
    monkeypatch.setattr(port_refine, "_check_cuda_tensors",
                        lambda grad, sel: None)
    monkeypatch.setattr(port_refine, "launch",
                        lambda name, *a: calls.append((name, a[3:7])))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: type("S", (), {"cuda_stream": 0}))

    def meta(*shape, dtype=torch.float32):
        return torch.empty(*shape, dtype=dtype, device="meta")

    for c, s in ((64, 1), (13, 11), (1, 127)):
        df = port_refine.refine_cross_backward(
            meta(2, 5, c), meta(2, 5, s, dtype=torch.int32), 0.5)
        assert df.shape == (2, 5, c)
    assert calls == [("amc3d_refine_cross_backward", (2, 5, c, s))
                     for c, s in ((64, 1), (13, 11), (1, 127))]
    for g, sel in (((2, 5, 64), (2, 5, 0)), ((2, 5, 64), (2, 5, 128)),
                   ((2, 5, 0), (2, 5, 1)), ((0, 5, 8), (0, 5, 1)),
                   ((2, 5, 8), (2, 4, 1)), ((2, 5, 8), (2, 5)),
                   ((10, 8), (10, 1))):
        with pytest.raises(ValueError):
            port_refine.refine_cross_backward(
                meta(*g), meta(*sel, dtype=torch.int32), 1.0)
    assert len(calls) == 3
    monkeypatch.undo()
    with pytest.raises(ValueError, match="CUDA"):  # a device it cannot launch on
        port_refine.refine_cross_backward(
            meta(2, 5, 8), meta(2, 5, 1, dtype=torch.int32), 1.0)


def test_interp_backward_twin_sums_in_query_order():
    """The twin of both backward kernels against a loop over the triples
    in ascending (query, slot) order in float64; a coarse row no query
    selects stays 0."""
    rng = np.random.RandomState(31)
    b, n1, n2, c = 2, 211, 37, 5
    idx = rng.randint(0, n2 - 1, (b, n1, 3)).astype(np.int32)   # never n2 - 1
    w = rng.rand(b, n1, 3).astype(np.float32)
    g = rng.randn(b, n1, c).astype(np.float32)
    want = np.zeros((b, n2, c))
    for bi in range(b):
        for q in range(n1):
            for k in range(3):
                want[bi, idx[bi, q, k]] += np.float64(w[bi, q, k]) * g[bi, q]
    for fn in (ops.three_interpolation_backward_plain,
               ops.three_interpolation_backward_big,
               ops.three_interpolation_backward):
        got = fn(_t(g), _t(idx), _t(w), n2).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        assert not got[:, n2 - 1].any()


def test_plain_twins_tile_whole_rooms():
    """The twins cut their query tiles so that a (tile x N) block stays
    within 2^28 elements: unchanged at the training crop, smaller for a
    whole room, and the result does not depend on the tile."""
    assert port_knn._tile_rows(2048, 4, 24000) == 2048
    assert port_knn._tile_rows(1024, 4, 24000) == 1024
    assert port_knn._tile_rows(2048, 1, 155648) == 1724
    assert port_knn._tile_rows(2048, 1, 2 ** 29) == 1
    rng = np.random.RandomState(3)
    sup, q = _t(_cloud(rng, 2, 400, True)), _t(_cloud(rng, 2, 90))
    want_i, want_d = ops.knn_plain(sup, q, 7)
    want_b = ops.ball_query_plain(sup, q, 0.3, 9)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_knn, "_TILE_ELEMENTS", 2 * 400 * 13)
        got_i, got_d = ops.knn_plain(sup, q, 7)
        assert torch.equal(got_i, want_i) and torch.equal(got_d, want_d)
        assert torch.equal(ops.ball_query_plain(sup, q, 0.3, 9), want_b)


@pytest.mark.parametrize("n,clustered", [(1, False), (64, False), (65, True),
                                         (1000, True), (4099, False)])
def test_spatial_sort_is_a_permutation_with_containing_boxes(n, clustered):
    p = _t(_cloud(np.random.RandomState(n), 2, n, clustered))
    cloud = spatial.sort_support(p)
    perm = cloud.packed.view(torch.int32)[..., 3].long()
    assert torch.equal(perm.sort(1).values, torch.arange(n).expand(2, n))
    assert torch.equal(cloud.packed[..., :3],
                       torch.gather(p, 1, perm[..., None].expand(2, n, 3)))
    assert torch.equal(cloud.codes, spatial.morton_key(
        cloud.packed[..., :3], cloud.lo, cloud.scale))
    assert (cloud.codes.diff(dim=1) >= 0).all()
    # stable: points of one cell keep their index order
    assert (perm.diff(dim=1)[cloud.codes.diff(dim=1) == 0] > 0).all()
    nc = -(-n // spatial.CHUNK)
    assert cloud.boxes.shape == (2, nc, 6)
    for c in range(nc):
        pts = cloud.packed[:, c * spatial.CHUNK:(c + 1) * spatial.CHUNK, :3]
        assert torch.equal(cloud.boxes[:, c, :3], pts.amin(1))
        assert torch.equal(cloud.boxes[:, c, 3:], pts.amax(1))
    q = _t(_cloud(np.random.RandomState(n + 1), 2, 37)) * 1.5 - 1.0
    order, home = spatial.query_order(q, cloud)
    assert order.dtype == home.dtype == torch.int32
    assert torch.equal(order.long().sort(1).values, torch.arange(37).expand(2, 37))
    assert home.min() >= 0 and home.max() < nc


_coord = st.floats(-64, 64, width=32, allow_nan=False)


@settings(max_examples=200, deadline=None)
@given(st.lists(st.tuples(_coord, _coord, _coord), min_size=1, max_size=40),
       st.tuples(_coord, _coord, _coord))
def test_box_lower_bound_never_exceeds_a_true_distance(points, query):
    """In float32, as computed: the bound of a chunk's box is at or below
    the d² of every point of the chunk, so a kernel that skips a chunk
    whose bound fails ``< r²`` (or ``<= k-th d²``) loses no point."""
    pts = torch.tensor(points, dtype=torch.float32)[None]
    q = torch.tensor(query, dtype=torch.float32)[None, None]
    boxes = spatial.chunk_boxes(pts, chunk=8)
    lb = spatial.bbox_lb(q[:, :, None, :], boxes[:, None])[0, 0]    # (nc,)
    d2 = port_knn.pairwise_d2(q, pts)[0, 0]
    for c in range(boxes.shape[1]):
        assert lb[c] <= d2[c * 8:(c + 1) * 8].min()
