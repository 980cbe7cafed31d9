"""The port's approx configuration against the JAX package's on the CPU:
the threshold selection of the contrast (``contrast_reductions_selfk``),
the stage-label vote (``label_vote``) and the approx branches of
``contrast_head`` and ``ambiguity_head`` (small models in this configuration:
``test_torch_port_approx_model.py``).

JAX runs as its own tests run it (``tests/test_contrast_pallas.py``):
``set_fused_contrast('on')`` and ``set_knn_backend('approx')``, the Pallas
kernels in interpret mode; the port takes ``set_knn_backend('approx')``;
each switch is restored in a ``finally``.  Inputs come from numpy seeds.

The threshold is each point's k-th smallest *distinct* d² times
float32(1 + 1e-6).  On a dyadic grid every d² is exact, so both sides
select the same value and column 8 is identical.  Off the grid JAX's CPU
compiler contracts the Pallas kernel's d² into fused multiply-adds,
``fma(dz, dz, fma(dx, dx, dy·dy))``, where the port (and the Pallas kernel
on the TPU, and the CUDA kernel) rounds ``(dx·dx + dy·dy) + dz·dz`` op by
op: there each side's column 8 is held to the k-th distinct value of its
own d², exactly, and the counts must still be identical.  Tolerances
otherwise as ``test_contrast_reductions_match_pallas_kernel``: sums within
1e-5·(1+max|ref|), the VJP within 1e-4·(1+max|df|).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amcontrast3d_tpu.loss import contrast as jcontrast
from amcontrast3d_tpu.ops import aggregate_pallas as jagg
from amcontrast3d_tpu.ops.knn import set_knn_backend as jax_knn_backend
from amcontrast3d_tpu.ops.contrast_pallas import contrast_reductions_selfk as jax_selfk
from amcontrast3d_tpu.ops.contrast_pallas import label_vote as jax_vote
from amcontrast3d_tpu_torch import ops
from amcontrast3d_tpu_torch.loss import contrast as pcontrast
from amcontrast3d_tpu_torch.ops import aggregate as pagg
from amcontrast3d_tpu_torch.ops.knn import set_knn_backend, use_approx

SLACK = np.float32(1.0 + 1e-6)
ARGS = dict(nsample=12, ccbeta=0.04, cctype="Method2", temperature=0.3,
            supervisedCL="Method1", db="-m", margin="adaptive", mu=-1, nu=0.5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


class _approx:
    """Both packages in the approx configuration (and, with ``fused``, the
    fused aggregation on), restored on exit."""

    def __init__(self, fused: bool = False):
        self.fused = fused

    def __enter__(self):
        jcontrast.set_fused_contrast("on")
        jax_knn_backend("approx")
        set_knn_backend("approx")
        if self.fused:
            jagg.set_agg_fused("on")
            pagg.set_agg_fused("on")

    def __exit__(self, *exc):
        jcontrast.set_fused_contrast("auto")
        jax_knn_backend("auto")
        set_knn_backend("auto")
        jagg.set_agg_fused("off")
        pagg.set_agg_fused("off")


def _kth_distinct(d2, k):
    """(B, M, N) → (B, M): the k-th distinct value of each row × slack."""
    kth = [[(np.unique(r)[k - 1:k].tolist() or [3e38])[0] for r in b] for b in d2]
    return np.array(kth, np.float32) * SLACK


def _d2_direct(q, s):
    d = q[:, :, None].astype(np.float32) - s[:, None].astype(np.float32)
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]


def _d2_fma(q, s):
    """JAX's CPU rounding of the Pallas kernel's d²."""
    d = (q[:, :, None] - s[:, None]).astype(np.float32)
    fma = lambda a, b, c: np.float32(a.astype(np.float64) * b + c)
    return fma(d[..., 2], d[..., 2],
               fma(d[..., 0], d[..., 0], (d[..., 1] * d[..., 1]).astype(np.float32)))


def _cloud(rng, n, grid: bool):
    if grid:
        return (rng.randint(0, 8, (2, n, 3)) / 8).astype(np.float32)
    return rng.rand(2, n, 3).astype(np.float32)


# ---- contrast_reductions_selfk -------------------------------------------------

@pytest.mark.parametrize("n,grid", [(700, True), (700, False), (3000, True),
                                    (3000, False)])
def test_selfk_matches_pallas_kernel(n, grid):
    """Forward and VJP against ``contrast_reductions_selfk`` in interpret
    mode, k = 12, at one support chunk (700, two clouds) and several (3000,
    one cloud, which the JAX entry also kd-sorts).  Counts identical; column 8 identical on the
    1/8 grid (many distance ties) and, on continuous points, each side's
    exactly the k-th distinct value of its own d² rounding."""
    rng = np.random.RandomState(n + grid)
    b = 2 if n < 2048 else 1
    p = _cloud(rng, n, grid)[:b]
    f = rng.randn(b, n, 16).astype(np.float32)
    f /= np.linalg.norm(f, axis=-1, keepdims=True)
    lab = rng.randint(0, 4, (b, n)).astype(np.float32)
    g = rng.randn(b, n, 9).astype(np.float32)
    tinv = 1 / 0.3

    ft = _t(f).requires_grad_()
    out = ops.contrast_reductions_selfk(_t(p), ft, _t(lab), 12, tinv, False,
                                        True, True)
    out.backward(_t(g))
    jout, vjp = jax.vjp(lambda ff: jax_selfk(
        jnp.asarray(p), ff, jnp.asarray(lab), 12, tinv, False, True, None,
        True, True), jnp.asarray(f))
    jout, got = np.asarray(jout), out.detach().numpy()
    np.testing.assert_array_equal(got[..., 4:6], jout[..., 4:6])
    if grid:
        np.testing.assert_array_equal(got[..., 8], jout[..., 8])
        assert (got[..., 4] + got[..., 5] > 11).mean() > 0.5   # ties widen sets
    else:
        np.testing.assert_array_equal(got[..., 8], _kth_distinct(_d2_direct(p, p), 12))
        np.testing.assert_array_equal(jout[..., 8], _kth_distinct(_d2_fma(p, p), 12))
    for col in (0, 1, 2, 3, 6, 7):
        err = np.abs(got[..., col] - jout[..., col]).max()
        assert err <= 1e-5 * (1 + np.abs(jout[..., col]).max()), (col, err)
    jdf = np.asarray(vjp(jnp.asarray(g))[0])
    err = np.abs(ft.grad.numpy() - jdf).max()
    assert err <= 1e-4 * (1 + np.abs(jdf).max()), err


@pytest.mark.parametrize("n,k", [(5, 12), (40, 300)])
def test_selection_with_fewer_distinct_values_than_k(n, k):
    """Fewer than k distinct d²: the threshold is 3e38·(1+1e-6) and every
    other point of the cloud is a member; k above one pass of 128."""
    rng = np.random.RandomState(n)
    p = _cloud(rng, n, True)
    thr = ops.contrast_select(_t(p), k).numpy()
    np.testing.assert_array_equal(thr, np.float32(3e38) * SLACK)
    red = ops.contrast_reductions_selfk(_t(p), _t(np.ones((2, n, 4), np.float32)),
                                        _t(np.zeros((2, n), np.float32)), k)
    np.testing.assert_array_equal(red[..., 4].numpy(), n - 1)


@pytest.mark.parametrize("k", [1, 24, 129, 256])
def test_selection_is_the_kth_distinct_distance(k):
    """The twin at any k (a 1/64 grid: ties, and more than 256 distinct
    values a row), against numpy's ``unique``."""
    rng = np.random.RandomState(k)
    p = (rng.randint(0, 256, (2, 600, 3)) / 64).astype(np.float32)
    thr = ops.contrast_select(_t(p), k).numpy()
    np.testing.assert_array_equal(thr, _kth_distinct(_d2_direct(p, p), k))


# ---- label_vote ------------------------------------------------------------------

@pytest.mark.parametrize("n,k", [(600, 4), (600, 16), (600, 64), (2500, 16)])
def test_label_vote_matches_pallas_kernel(n, k):
    """``label_vote`` against the JAX vote kernel in interpret mode on a
    1/32 grid (ties in distance), 5 classes: identical labels.  Ties in the
    count occur and go to the lowest class on both sides."""
    rng = np.random.RandomState(n + k)
    p0 = (rng.randint(0, 32, (2, n, 3)) / 32).astype(np.float32)
    y0 = rng.randint(0, 5, (2, n)).astype(np.int32)
    pq = p0[:, ::4][:, :n // 4] + np.float32(1 / 64)
    got = ops.label_vote(_t(p0), _t(y0), _t(pq), k, 5).numpy()
    want = np.asarray(jax_vote(jnp.asarray(p0), jnp.asarray(y0), jnp.asarray(pq),
                               k, 5, interpret=True))
    np.testing.assert_array_equal(got, want)
    # the members' class counts have tied maxima on some rows
    thr = _kth_distinct(_d2_direct(pq, p0), k)
    member = _d2_direct(pq, p0) <= thr[..., None]
    counts = np.einsum("bmn,bnc->bmc", member.astype(np.int64), np.eye(5)[y0])
    top = np.sort(counts, -1)
    assert (top[..., -1] == top[..., -2]).any()
    np.testing.assert_array_equal(got, counts.argmax(-1))


# ---- the heads ---------------------------------------------------------------------

def _stages(rng, b=2, n0=512, c=16, with_f=True):
    """A 1/16 grid cloud and three subsampled stages of it, each with
    random features."""
    p0 = (rng.randint(0, 16, (b, n0, 3)) / 16).astype(np.float32)
    ups = []
    for i in range(3):
        idxs = np.arange(0, n0, 4 ** i)[: n0 // (4 ** i)]
        f = rng.randn(b, len(idxs), c).astype(np.float32) if with_f else None
        ups.append((p0[:, idxs], f))
    return p0, ups


def test_contrast_head_approx_matches_jax():
    """``contrast_head`` with the selection and the vote: the loss within
    1e-4 relative and its gradients within 5e-4·(1+max); the stage labels
    and the neighbour counts identical; the ambiguity within 1e-5."""
    rng = np.random.RandomState(5)
    p0, ups = _stages(rng)
    y0 = rng.randint(0, 5, (2, 512)).astype(np.int64)
    args = dict(ARGS, stages_num=3)
    fts = [_t(f).requires_grad_() for _, f in ups]
    with _approx():
        loss, ai = pcontrast.contrast_head([(_t(p), f) for (p, _), f in zip(ups, fts)],
                                           _t(y0), 5, None, args)
        loss.backward()

        def jloss(fs):
            return jcontrast.contrast_head(
                [(jnp.asarray(p), f) for (p, _), f in zip(ups, fs)],
                jnp.asarray(y0), 5, None, args)
        (jl, jai), jgrads = jax.value_and_grad(jloss, has_aux=True)(
            [jnp.asarray(f) for _, f in ups])
        for i in (1, 2):
            kr = 4 ** i
            got = ops.label_vote(_t(p0), _t(y0.astype(np.int32)), _t(ups[i][0]),
                                 kr, 5).numpy()
            want = np.asarray(jax_vote(jnp.asarray(p0), jnp.asarray(y0),
                                       jnp.asarray(ups[i][0]), kr, 5,
                                       interpret=True))
            np.testing.assert_array_equal(got, want)
            zero = np.zeros(ups[i][0].shape[:2] + (1,), np.float32)
            lab = got.astype(np.float32)
            np.testing.assert_array_equal(
                ops.contrast_reductions_selfk(_t(ups[i][0]), _t(zero), _t(lab),
                                              12)[..., 4:6].numpy(),
                np.asarray(jax_selfk(jnp.asarray(ups[i][0]), jnp.asarray(zero),
                                     jnp.asarray(lab), 12, 1.0, False, True,
                                     None, False, True))[..., 4:6])
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-4)
    for f, g in zip(fts, jgrads):
        g = np.asarray(g)
        assert np.abs(f.grad.numpy() - g).max() <= 5e-4 * (1 + np.abs(g).max())
    for a, b in zip(ai, jai):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)


@pytest.mark.parametrize("cctype", ["Method1", "Method2", "Method3"])
def test_ambiguity_head_approx_matches_jax(cctype):
    """``ambiguity_head`` with the selection's reductions over a zero
    1-wide feature and the voted labels: within 1e-5 at every stage."""
    rng = np.random.RandomState(6)
    p0, ups = _stages(rng, with_f=False)
    y0 = rng.randint(0, 5, (2, 512)).astype(np.int64)
    args = dict(ARGS, stages_num=3, cctype=cctype)
    with _approx():
        got = pcontrast.ambiguity_head([(_t(p), None) for p, _ in ups], _t(y0), 5,
                                       None, args)
        want = jcontrast.ambiguity_head([(jnp.asarray(p), None) for p, _ in ups],
                                        jnp.asarray(y0), 5, None, args)
    for a, b in zip(got, want):
        assert 0 < np.asarray(b).mean() < 1
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)


def test_switches_default_and_reject_unknown_names():
    """With both switches at their defaults the exact kNN and the gather
    tail run (the accepted paths); unknown names raise."""
    assert not use_approx() and not pagg.agg_fused_enabled()
    for mode in ("exact", "auto"):
        set_knn_backend(mode)
        assert not use_approx()
    pagg.set_agg_fused("auto")
    assert not pagg.agg_fused_enabled()
    pagg.set_agg_fused("off")
    with pytest.raises(ValueError):
        set_knn_backend("fast")
    with pytest.raises(ValueError):
        pagg.set_agg_fused("yes")
    assert not use_approx() and not pagg.agg_fused_enabled()


def test_default_configuration_takes_the_exact_knn(monkeypatch):
    """At the defaults the loss asks ``knn`` for its thresholds and
    ``subscene_labels`` for the stage labels, never the selection."""
    calls = []
    monkeypatch.setattr(pcontrast, "contrast_reductions_selfk",
                        lambda *a, **k: calls.append("selfk"))
    monkeypatch.setattr(pcontrast, "label_vote",
                        lambda *a, **k: calls.append("vote"))
    knn = pcontrast.knn
    monkeypatch.setattr(pcontrast, "knn",
                        lambda *a: calls.append("knn") or knn(*a))
    rng = np.random.RandomState(7)
    _, ups = _stages(rng)
    loss, _ = pcontrast.contrast_head([(_t(p), _t(f)) for p, f in ups],
                                      _t(rng.randint(0, 5, (2, 512))), 5, None,
                                      dict(ARGS, stages_num=3))
    assert np.isfinite(loss.item()) and calls == ["knn"] * 3
