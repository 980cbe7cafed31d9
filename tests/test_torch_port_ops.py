"""The PyTorch port's point ops against the JAX package on the CPU.

Inputs are made with numpy from a seed and fed to both frameworks.  The
port's ops take their plain PyTorch path here (CPU tensors);
``test_torch_port_cuda.py`` holds each CUDA kernel against that plain
path on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amcontrast3d_tpu.ops import group as jgroup
from amcontrast3d_tpu.ops import interpolate as jinterp
from amcontrast3d_tpu.ops.fps import _furthest_point_sample_lax
from amcontrast3d_tpu.ops.fps_pallas import furthest_point_sample_pallas
from amcontrast3d_tpu.ops.interpolate_pallas import three_interpolation_fused
from amcontrast3d_tpu.ops.knn import _ball_query_jnp, _knn_jnp
from amcontrast3d_tpu.ops.knn_pallas import BIN, _perm, ball_query_pallas
from amcontrast3d_tpu_torch import ops


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


def test_ball_query_against_pallas_kernel():
    """The TPU kernel returns a k-subset of the ball through a fixed
    permutation; the port returns the first k in index order.  Where the
    ball holds ≤ k points both return the whole ball, unless more than two
    of them share one 128-point bin of the permuted support: the TPU kernel
    keeps the best two per bin, and then returns a subset."""
    rng = np.random.RandomState(7)
    sup = _cloud(rng, 2, 1024)
    q = np.concatenate([sup[:, :128], _cloud(rng, 2, 128)], 1)
    r, k = 0.5, 8
    got = ops.ball_query(_t(sup), _t(q), r, k).numpy()
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
