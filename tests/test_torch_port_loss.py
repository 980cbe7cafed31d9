"""The port's loss against the JAX package on the CPU: AEF labels, the
adaptive-margin contrast and ``CrossEntropyAce``.

The port computes the contrast in the reduction form of JAX's fused exact
branch (threshold neighbourhoods ``d² ≤ kth``); it is held here against
JAX's gather path (``fused`` off, K = nsample − 1 neighbour slots), which
is what the JAX package runs on the CPU.  The two agree wherever each
point's 24th-nearest d² (self included) is clear of the 25th by more
than the threshold's 1e-5 cushion, and every stage has N ≥ nsample (with
k > N the gather path pads slots with index 0).  The clouds below are
drawn so: uniform in [0, 4)³, with every point whose neighbourhood
boundary is within 2e-5 relative redrawn, also at the ``kr`` boundary of
the stage label propagation.  Tolerances: losses 1e-5 relative,
ambiguity 1e-5, gradients 1e-4·(1+max|g|).
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amcontrast3d_tpu.loss import aef as jaef
from amcontrast3d_tpu.loss import build as jbuild
from amcontrast3d_tpu.loss import contrast as jcontrast
from amcontrast3d_tpu_torch import loss as port_loss
from amcontrast3d_tpu_torch import ops
from amcontrast3d_tpu_torch.utils.config import EasyConfig

NCLS = 13
_CFG = EasyConfig()
_CFG.load(str(Path(__file__).resolve().parent.parent / "cfgs" / "s3dis"
              / "AMContrast3D-AA.yaml"), recursive=True)
AMB = dict(_CFG.ambiguity_args)          # nsample 24, T 0.3, Method2, …
JAX_AMB = {**AMB, "fused": False}        # JAX's gather path
NSAMPLE = AMB["nsample"]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _gap_ok(q, s, k):
    """(B, M) mask: the k-th and (k+1)-th nearest d² of each query among
    ``s`` differ by more than 2e-5 relative (float64)."""
    d2 = np.sort(((q[:, :, None].astype(np.float64) - s[:, None]) ** 2).sum(-1), -1)
    if d2.shape[-1] <= k:
        return np.ones(q.shape[:2], bool)
    return d2[..., k] > d2[..., k - 1] * (1 + 2e-5)


def _fps_chain(p0, n_stages):
    """Stage positions by the port's FPS (stride 4, as the model) and each
    stage point's index in p0."""
    stages, origs = [p0], [np.broadcast_to(np.arange(p0.shape[1]), p0.shape[:2])]
    for _ in range(1, n_stages):
        prev = _t(stages[-1])
        idx = ops.furthest_point_sample(prev, prev.shape[1] // 4)
        stages.append(ops.gather_points(prev, idx).numpy())
        origs.append(np.take_along_axis(origs[-1], idx.long().numpy(), 1))
    return stages, origs


def _clean_stages(rng, b, n, n_stages):
    p0 = (rng.rand(b, n, 3) * 4).astype(np.float32)
    for _ in range(50):
        stages, origs = _fps_chain(p0, n_stages)
        bad = np.zeros((b, n), bool)
        for s, (ps, orig) in enumerate(zip(stages, origs)):
            ok = _gap_ok(ps, ps, NSAMPLE)
            if s:
                ok &= _gap_ok(ps, p0, 4 ** s)
            for bi in range(b):
                bad[bi, orig[bi][~ok[bi]]] = True
        if not bad.any():
            return stages
        p0[bad] = (rng.rand(int(bad.sum()), 3) * 4).astype(np.float32)
    raise AssertionError("no clean cloud")


def _voronoi_labels(rng, p, ncls):
    """Label of the nearest of ``ncls`` random centres: rooms of regions
    with interior and boundary points."""
    centres = rng.rand(p.shape[0], ncls, 3) * 4
    d2 = ((p[:, :, None] - centres[:, None]) ** 2).sum(-1)
    return d2.argmin(-1).astype(np.int64)


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rtol * (1 + np.abs(want).max()), err


@pytest.mark.parametrize("over", [
    {},                                                            # the AA cfg
    {"margin": "learned", "db": "+m", "cctype": "Method3", "dist": "dist_dot"},
    {"margin": "constant", "db": "none", "cctype": "Method1"},
], ids=["aa_cfg", "learned_plus_m_method3_dot", "constant_none_method1"])
def test_point_contrast_margin_matches_jax_gather_path(over):
    rng = np.random.RandomState(1)
    (p,) = _clean_stages(rng, 2, 512, 1)
    y = _voronoi_labels(rng, p, 4)
    labels = np.eye(4, dtype=np.float32)[y]
    over = dict(over)
    dist = over.pop("dist", "dist_cos")
    # dist_dot: scaled so that exp(s/T) stays finite in float32
    f = (rng.randn(2, 512, 16) * (0.25 if dist == "dist_dot" else 1)
         ).astype(np.float32)
    args = {**AMB, **over}

    ft = _t(f).requires_grad_()
    loss, a = port_loss.point_contrast_margin(_t(p), ft, _t(labels), args, dist)
    loss.backward()

    def jloss(ff):
        return jcontrast.point_contrast_margin(
            jnp.asarray(p), ff, jnp.asarray(labels), {**args, "fused": False},
            dist)
    (jl, ja), jgrad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(f))
    ja = np.asarray(ja)
    assert 0.05 < ((ja > 0) & (ja <= 1)).mean() < 0.95   # boundary and interior
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(a.numpy(), ja, rtol=1e-5, atol=1e-5)
    _close(ft.grad.numpy(), jgrad, 1e-4)


def test_contrast_head_and_criterion_match_jax():
    """CrossEntropyAce over the 4 decoder stages of the small AA model
    (N 2048/512/128/32, widths 16/32/64/128): the value, its gradients in
    the logits and every stage's features, and each stage's ambiguity."""
    rng = np.random.RandomState(2)
    stages = _clean_stages(rng, 2, 2048, 4)
    y = _voronoi_labels(rng, stages[0], NCLS)
    feats = [rng.randn(2, ps.shape[1], 16 * 2 ** s).astype(np.float32)
             for s, ps in enumerate(stages)]
    logits = rng.randn(2, 2048, NCLS).astype(np.float32)

    lt = _t(logits).requires_grad_()
    ft = [_t(f).requires_grad_() for f in feats]
    up = list(zip(map(_t, stages), ft))
    loss = port_loss.build_criterion_from_cfg(_CFG.criterion_args_Ace)(
        lt, _t(y), up, NCLS, None, AMB)
    loss.backward()
    _, a_list = port_loss.contrast_head(up, _t(y), NCLS, None, AMB)

    def jloss(lg, fs, ps, yy):
        jup = list(zip(ps, fs))
        loss = jbuild.CrossEntropyAce()(lg, yy, jup, NCLS, None, JAX_AMB)
        return loss, jcontrast.contrast_head(jup, yy, NCLS, None, JAX_AMB)[1]
    (jl, ja_list), (jg_logits, jg_feats) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(
        jnp.asarray(logits), [jnp.asarray(f) for f in feats],
        [jnp.asarray(ps) for ps in stages], jnp.asarray(y))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    _close(lt.grad.numpy(), jg_logits, 1e-4)
    for got, want in zip(ft, jg_feats):
        _close(got.grad.numpy(), want, 1e-4)
    for got, want in zip(a_list, ja_list):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


def test_cross_entropy_matches_jax():
    rng = np.random.RandomState(3)
    logits = rng.randn(2, 300, NCLS).astype(np.float32)
    y = rng.randint(0, NCLS, (2, 300))
    y[0, :20] = 255
    w = rng.rand(NCLS).astype(np.float32)
    for kw in ({"ignore_index": 255, "label_smoothing": 0.2},
               {"ignore_index": 255, "weight": w}):
        got = port_loss.cross_entropy(_t(logits), _t(y), **kw)
        want = jbuild.cross_entropy(jnp.asarray(logits), jnp.asarray(y), **kw)
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    y = np.where(y == 255, 0, y)
    got = port_loss.CrossEntropy(label_smoothing=0.2)(_t(logits), _t(y))
    want = jbuild.CrossEntropy(label_smoothing=0.2)(jnp.asarray(logits),
                                                   jnp.asarray(y))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(port_loss.cross_entropy(_t(logits), _t(y)).item(),
                               float(jbuild.cross_entropy(jnp.asarray(logits),
                                                          jnp.asarray(y))),
                               rtol=1e-6)


def test_aef_labels_and_neighbourhood_match_jax():
    """On a 1/64 grid (exact d² in both kNN forms; ties to the lowest index
    in both)."""
    rng = np.random.RandomState(4)
    p0 = (rng.randint(0, 256, (2, 1024, 3)) / 64).astype(np.float32)
    p1 = p0[:, :256].copy()
    y = rng.randint(0, NCLS, (2, 1024))
    y[1, :10] = 7
    for ignore in (None, 7):
        labels0 = port_loss.one_hot_labels(_t(y), NCLS, ignore)
        jlabels0 = jaef.one_hot_labels(jnp.asarray(y), NCLS, ignore)
        np.testing.assert_array_equal(labels0.numpy(), np.asarray(jlabels0))
    got = port_loss.subscene_labels(labels0, _t(p0), _t(p1), 2)
    want = jaef.subscene_labels(jlabels0, jnp.asarray(p0), jnp.asarray(p1), 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert port_loss.subscene_labels(labels0, _t(p0), _t(p0), 0) is labels0
    idx, pm, dd = port_loss.stage_neighborhood(_t(p1), got, NSAMPLE)
    jidx, jpm, jdd = jaef.stage_neighborhood(jnp.asarray(p1), want, NSAMPLE)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jpm))
    np.testing.assert_array_equal(dd.numpy(), np.asarray(jdd))


@pytest.mark.parametrize("kw", [
    {"contrast_func": "contrast_softnn"},
    {"dist_func": "dist_l2"},
    {"args": {"supervisedCL": "Method2"}},
    {"args": {"margin": "other"}},
], ids=["softnn", "dist_l2", "method2", "margin"])
def test_unported_contrast_variants_raise(kw):
    p = _t(np.random.RandomState(5).rand(1, 64, 3).astype(np.float32))
    f = torch.randn(1, 64, 8)
    labels = torch.zeros(1, 64, dtype=torch.long)
    with pytest.raises(NotImplementedError):
        port_loss.point_contrast_margin(
            p, f, labels, {**AMB, **kw.get("args", {})},
            kw.get("dist_func", "dist_cos"),
            kw.get("contrast_func", "contrast_softnn_margin"))


def test_remat_is_not_ported():
    p = _t(np.random.RandomState(6).rand(1, 64, 3).astype(np.float32))
    with pytest.raises(NotImplementedError):
        port_loss.contrast_head([(p, torch.randn(1, 64, 8))],
                                torch.zeros(1, 64, dtype=torch.long), NCLS,
                                None, {**AMB, "remat": True})
