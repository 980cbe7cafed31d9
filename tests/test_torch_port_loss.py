"""The port's loss against the JAX package on the CPU: AEF labels, the
adaptive-margin contrast and ``CrossEntropyAce``.

The port computes the contrast of JAX's fused variants in the reduction
form of JAX's fused exact branch (threshold neighbourhoods ``d² ≤ kth``);
it is held here against JAX's gather path (``fused`` off, K = nsample − 1
neighbour slots), which is what the JAX package runs on the CPU.  The
other variants take the gather form in both packages.  The two agree wherever each
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
    """The variants outside the reduction form take the gather form (held
    to JAX's below) and give a finite loss; a margin that neither package
    knows raises ValueError in both, as JAX's ``contrast_softnn_margin``
    does."""
    p = _t(np.random.RandomState(5).rand(1, 64, 3).astype(np.float32))
    f = torch.randn(1, 64, 8)
    labels = torch.nn.functional.one_hot(
        torch.arange(64) % 3, 3).float()[None]
    args = {**AMB, **kw.get("args", {})}
    call = lambda: port_loss.point_contrast_margin(
        p, f, labels, args, kw.get("dist_func", "dist_cos"),
        kw.get("contrast_func", "contrast_softnn_margin"))
    if args["margin"] == "other":
        with pytest.raises(ValueError, match="margin"):
            call()
        with pytest.raises(ValueError, match="margin"):
            jcontrast.point_contrast_margin(
                jnp.asarray(p.numpy()), jnp.asarray(f.numpy()),
                jnp.asarray(labels.numpy()), {**args, "fused": False})
        return
    loss, a = call()
    assert torch.isfinite(loss) and a.shape == (1, 64)


@pytest.mark.parametrize("dist,func,over", [
    ("dist_l2", "contrast_softnn_margin", {}),
    ("dist_kl", "contrast_softnn_margin", {"margin": "learned"}),
    ("dist_l2", "contrast_softnn_temperature", {}),
    ("dist_l2", "contrast_softnn", {}),
    ("dist_cos", "contrast_softnn_margin", {"supervisedCL": "Method2"}),
    ("dist_dot", "contrast_softnn_margin",
     {"supervisedCL": "Method2", "margin": "learned", "db": "+m",
      "remat": True}),
], ids=["l2", "kl_learned", "softnn_temperature", "softnn", "method2_cos",
        "method2_dot_learned_plus_m_remat"])
def test_gather_form_matches_jax(dist, func, over):
    """The gather form of every variant outside the reduction form: the
    loss to 1e-5 relative, the ambiguity to 1e-5 and the gradient in the
    features to 1e-4·(1+max|g|), against JAX's ``point_contrast_margin``
    on the same K-slot neighbourhoods (256 points, nsample 24, 3 labels);
    with ``remat`` the port checkpoints the loss and keeps the kNN."""
    rng = np.random.RandomState(6)
    (p,) = _clean_stages(rng, 2, 256, 1)
    labels = np.eye(3, dtype=np.float32)[_voronoi_labels(rng, p, 3)]
    f = (rng.randn(2, 256, 8) * (0.25 if dist == "dist_dot" else 1)
         ).astype(np.float32)
    args = {**AMB, **over}
    ft = _t(f).requires_grad_()
    loss, a = port_loss.point_contrast_margin(_t(p), ft, _t(labels), args,
                                              dist, func)
    loss.backward()
    # positions and labels are arguments: closed into the jit as constants,
    # XLA folds the kNN over them for minutes
    (jl, ja), jgrad = jax.jit(jax.value_and_grad(
        lambda ff, pp, ll: jcontrast.point_contrast_margin(
            pp, ff, ll, args, dist, func),
        has_aux=True))(jnp.asarray(f), jnp.asarray(p), jnp.asarray(labels))
    assert 0.05 < ((np.asarray(ja) > 0) & (np.asarray(ja) <= 1)).mean() < 0.95
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=1e-5, atol=1e-5)
    _close(ft.grad.numpy(), jgrad, 1e-4)


def test_contrast_head_takes_the_gather_form_for_method2(monkeypatch):
    """``supervisedCL: Method2`` through ``contrast_head`` (2 stages, 256
    and 64 points) takes the gather form, as JAX's head routes it: the
    head's loss and gradients are the sum of its stages' gather-form losses
    over the propagated labels (each held to JAX in
    :func:`test_gather_form_matches_jax`, the labels in
    :func:`test_aef_labels_and_neighbourhood_match_jax`; JAX's compiler
    takes minutes over its own head here), and no contrast kernel's twin
    runs."""
    rng = np.random.RandomState(7)
    stages = _clean_stages(rng, 2, 256, 2)
    y = _voronoi_labels(rng, stages[0], 4)
    feats = [rng.randn(2, ps.shape[1], 8).astype(np.float32) for ps in stages]
    args = {**AMB, "supervisedCL": "Method2", "stages_num": 2}
    ft = [_t(f).requires_grad_() for f in feats]
    calls = []
    with monkeypatch.context() as patch:
        patch.setattr(port_loss.contrast, "contrast_reductions",
                      lambda *a, **k: calls.append(a))
        loss, a_list = port_loss.contrast_head(
            list(zip(map(_t, stages), ft)), _t(y), 4, None, args)
    assert not calls
    loss.backward()
    labels0 = port_loss.one_hot_labels(_t(y), 4, None)
    fs = [_t(f).requires_grad_() for f in feats]
    want = 0.0
    for i, (ps, f) in enumerate(zip(stages, fs)):
        labels = labels0 if i == 0 else port_loss.subscene_labels(
            labels0, _t(stages[0]), _t(ps), i)
        stage_loss, a = port_loss.contrast.point_contrast_margin(
            _t(ps), f, labels, args)
        np.testing.assert_array_equal(a.numpy(), a_list[i].numpy())
        want = want + stage_loss
    want.backward()
    np.testing.assert_allclose(loss.item(), want.item(), rtol=1e-6)
    for got, w in zip(ft, fs):
        _close(got.grad.numpy(), w.grad.numpy(), 1e-6)


def test_cross_entropy_ace_pre_matches_jax():
    """``CrossEntropyAcePre`` over 3 stages (N 1024/256/64): its four terms
    (seg, ce, contrast, reg) to 1e-5 relative, and the gradients of
    seg + reg in the logits, the stage features and the predicted
    ambiguity (the MAE's target carries none) to 1e-4·(1+max|g|)."""
    rng = np.random.RandomState(5)
    amb = {**AMB, "stages_num": 3, "w3": 0.01}
    stages = _clean_stages(rng, 2, 1024, 3)
    y = _voronoi_labels(rng, stages[0], NCLS)
    feats = [rng.randn(2, ps.shape[1], 16 * 2 ** s).astype(np.float32)
             for s, ps in enumerate(stages)]
    preds = [rng.rand(2, ps.shape[1]).astype(np.float32) for ps in stages]
    logits = rng.randn(2, 1024, NCLS).astype(np.float32)

    lt = _t(logits).requires_grad_()
    ft = [_t(f).requires_grad_() for f in feats]
    pt = [_t(a).requires_grad_() for a in preds]
    terms = port_loss.build_criterion_from_cfg({"NAME": "CrossEntropyAcePre"})(
        lt, _t(y), list(zip(map(_t, stages), ft)), pt, NCLS, None, amb)
    (terms[0] + terms[3]).backward()

    def jloss(lg, fs, pa, ps, yy):   # positions and labels as arguments:
        jup = list(zip(ps, fs))      # XLA would fold the kNN of constants
        out = jbuild.CrossEntropyAcePre()(lg, yy, jup, pa, NCLS, None,
                                          {**amb, "fused": False})
        return out[0] + out[3], out
    (_, jterms), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(logits), [jnp.asarray(f) for f in feats],
        [jnp.asarray(a) for a in preds], [jnp.asarray(ps) for ps in stages],
        jnp.asarray(y))
    for got, want in zip(terms, jterms):
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    assert terms[3].item() > 0
    _close(lt.grad.numpy(), jgrads[0], 1e-4)
    for got, want in zip(ft + pt, list(jgrads[1]) + list(jgrads[2])):
        _close(got.grad.numpy(), want, 1e-4)


@pytest.mark.parametrize("cctype,ignore", [("Method2", None), ("Method3", 7)])
def test_ambiguity_head_matches_jax(cctype, ignore):
    """``ambiguity_head`` and ``stage_ambiguity`` on a 1/64 grid (exact d²
    in both kNN forms): the ground-truth ambiguity of 3 stages to 1e-6,
    without gradient."""
    rng = np.random.RandomState(6)
    p0 = (rng.randint(0, 256, (2, 1024, 3)) / 64).astype(np.float32)
    stages = [p0, p0[:, :256].copy(), p0[:, :64].copy()]
    y = _voronoi_labels(rng, p0, NCLS)
    args = {**AMB, "stages_num": 3, "cctype": cctype}
    up = [(_t(ps), torch.zeros(2, ps.shape[1], 1)) for ps in stages]
    got = port_loss.ambiguity_head(up, _t(y), NCLS, ignore, args)
    jup = [(jnp.asarray(ps), jnp.zeros((2, ps.shape[1], 1))) for ps in stages]
    want = jcontrast.ambiguity_head(jup, jnp.asarray(y), NCLS, ignore, args)
    assert len(got) == 3
    for g, w in zip(got, want):
        assert not g.requires_grad and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
    assert 0.05 < ((got[0] > 0) & (got[0] < 1)).float().mean() < 0.95
    labels1 = port_loss.subscene_labels(
        port_loss.one_hot_labels(_t(y), NCLS, ignore), _t(p0), _t(stages[1]), 1)
    a, posmask, idx = port_loss.stage_ambiguity(_t(stages[1]), labels1, NSAMPLE,
                                                cctype, 0.04)
    assert torch.equal(a, got[1]) and posmask.shape == idx.shape == (2, 256, 23)
