"""The port's AMContrast3D++ (MM) modules against the JAX package on the CPU:
the masked refinement, every APM class, the refining decoder and
``BaseSeg_M_AMContrast3D``.

Inputs come from numpy seeds; weights are initialised in flax, their
BatchNorm statistics randomised, and moved with ``from_jax_variables``
(``strict=True``: every leaf has its counterpart).  Positions lie on a 1/64
grid in [0, 4)³, where every d² is exact in float32 in the JAX plain kNN's
matmul form and in the port's direct form, and d² ties go to the lowest
index in both, so neighbour sets, argmin choices and masks agree exactly
and only the rounding of the dense layers remains.  JAX runs its exact
branch here (the CPU backend); the TPU kernel is held against the port in
``test_torch_port_ops.py``.  Tolerances: the functional refinement 1e-6;
modules 1e-5·(1+max); the model's logits 1e-4·(1+max|logit|).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amcontrast3d_tpu.models import BaseSeg_M_AMContrast3D as JaxMM
from amcontrast3d_tpu.models import apm as japm
from amcontrast3d_tpu.models import pointnext as jpn
from amcontrast3d_tpu.models import refine as jrefine
from amcontrast3d_tpu_torch.engine import make_eval_step
from amcontrast3d_tpu_torch.models import BaseSeg_M_AMContrast3D, PointNextDecoder
from amcontrast3d_tpu_torch.models import apm, build_model_from_cfg, refine
from amcontrast3d_tpu_torch.utils.convert import from_jax_variables

B, N, NCLS = 2, 512, 13
ENCODER = dict(
    NAME="PointNextEncoder_M_AMContrast3D", blocks=[1, 2, 3, 2, 2],
    strides=[1, 4, 4, 4, 4], sa_layers=1, sa_use_res=False, width=16,
    in_channels=4, expansion=4, radius=0.1, nsample=32,
    aggr_args={"feature_type": "dp_fj", "reduction": "max"},
    group_args={"NAME": "ballquery", "normalize_dp": True},
    conv_args={"order": "conv-norm-act"}, act_args={"act": "relu"},
    norm_args={"norm": "bn"})
CLS = dict(NAME="SegHead", num_classes=NCLS, in_channels=None,
           norm_args={"norm": "bn"})
APM = dict(NAME="APM_pf_ConCate", feature_dim=[16, 32, 64, 128],
           linear_mapping=False, cross_attention=False, feat_concate=False,
           channel=[8, 4, 2], dropout=[0, 0, 0], nsample_k=12, threshold=0.5,
           threshold_max=1.0, gamma=1, fusion="MIN", att_dim=3)
AEF = dict(nsample=24, ccbeta=0.04, cctype="Method2", stages_num=4,
           source="APM")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _grid_cloud(rng, b, n):
    return (rng.randint(0, 256, (b, n, 3)) / 64).astype(np.float32)


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * (1 + np.abs(want).max()), err


def _randomize(variables, rng):
    """Random BatchNorm statistics, scales and shifts, so that eval-mode
    BatchNorm is not the identity; Dense biases random too."""
    def walk(tree, fn):
        return {k: walk(v, fn) if isinstance(v, dict) else fn(k, np.asarray(v))
                for k, v in tree.items()}

    def param(k, v):
        if k == "scale":
            return rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        if k == "bias":
            return (0.1 * rng.randn(*v.shape)).astype(np.float32)
        return v

    def stat(k, v):
        if k == "mean":
            return (0.1 * rng.randn(*v.shape)).astype(np.float32)
        return rng.uniform(0.5, 1.5, v.shape).astype(np.float32)

    tree = lambda t: jax.tree_util.tree_map(np.asarray, dict(t))
    return {"params": walk(tree(variables["params"]), param),
            "batch_stats": walk(tree(variables.get("batch_stats", {})), stat)}


def _load(module, variables):
    module.load_state_dict(from_jax_variables(variables), strict=True)
    return module


# ---- the functional refinement ------------------------------------------------

@pytest.mark.parametrize("fusion,gamma,n", [("MIN", 1.0, 300), ("MIN", 0.5, 300),
                                            ("MIN_ALL0", 0.5, 300),
                                            ("MIN", 1.0, 7)])
def test_dual_masks_matches_jax(fusion, gamma, n):
    """``dual_masks`` with an ambiguity full of exact zeros and repeated
    values (argmin ties go to the first slot in both) and, at n = 7 < k,
    with padded slots: feature to 1e-6, the refine rate to 1e-5 and the
    gradient in f to 1e-6."""
    rng = np.random.RandomState(n)
    p = _grid_cloud(rng, B, n)
    f = rng.randn(B, n, 12).astype(np.float32)
    g = rng.randn(B, n, 12).astype(np.float32)
    a = np.where(rng.rand(B, n) < 0.4, 0.0,
                 np.round(rng.rand(B, n) * 4) / 4).astype(np.float32)
    ft = _t(f).requires_grad_()
    got, rate = refine.dual_masks(_t(p), ft, _t(a), 12, fusion, 0.5, 1.0, gamma)
    got.backward(_t(g))

    def jfn(f_):
        return jrefine.dual_masks(jnp.asarray(p), f_, jnp.asarray(a), 12, fusion,
                                  0.5, 1.0, gamma)
    (want, jrate), vjp = jax.vjp(jfn, jnp.asarray(f))
    assert 5 < float(jrate) < 95
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(rate.item(), float(jrate), rtol=1e-5)
    jgrad = vjp((jnp.asarray(g), jnp.zeros(())))[0]
    np.testing.assert_allclose(ft.grad.numpy(), np.asarray(jgrad), rtol=1e-6,
                               atol=1e-6)


def test_refine_maps_and_consistency_match_jax():
    rng = np.random.RandomState(1)
    f = rng.randn(B, 50, 6).astype(np.float32)
    m = rng.rand(B, 50, 6).astype(np.float32)
    a = rng.rand(B, 50).astype(np.float32)
    for name, second in (("map_sum", m), ("map_multiply", m), ("multiply", a)):
        got = getattr(refine, name)(_t(f), _t(second))
        want = getattr(jrefine, name)(jnp.asarray(f), jnp.asarray(second))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    got = refine.consistency_regularization(_t(f[0]), _t(m[0]))
    want = jrefine.consistency_regularization(jnp.asarray(f[0]), jnp.asarray(m[0]))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    with pytest.raises(ValueError):
        refine.dual_masks(_t(_grid_cloud(rng, B, 50)), _t(f), _t(a), 4, "MEAN",
                          0.5, 1.0, 1.0)


# ---- the APM classes ------------------------------------------------------------

_DIMS = [16, 32]
_APMS = {
    "APM_pf_ConCate": dict(feature_dim=_DIMS, linear_mapping=True,
                           channel=[8, 4, 2], dropout=[0, 0, 0]),
    "APM_pf_ConCate_plain": dict(feature_dim=_DIMS, linear_mapping=False,
                                 channel=[8, 4, 2], dropout=[0, 0, 0]),
    "APM_p": dict(channel=[8, 4], dropout=[0, 0]),
    "APM_p_Group": dict(k=6, channel=[8, 4, 2], dropout=[0, 0, 0]),
    "APM_pf_CrossAtt": dict(feature_dim=_DIMS, linear_mapping=True,
                            channel=[8, 4], dropout=[0, 0]),
    "APM_p_Graph": dict(nsample_k=6),
    "APM_pp_SelfAtt": dict(att_dim=8, channel=[8, 4], dropout=[0, 0]),
}


def _all_stages(module, p, fs, training):
    return [module(p, f, stage=s, training=training) for s, f in enumerate(fs)]


@pytest.mark.parametrize("name", sorted(_APMS))
def test_apm_matches_jax(name):
    """Every APM class in eval mode at two stages (widths 16 and 32), with
    flax's weights: a (and the lifted map) to 1e-5·(1+max)."""
    rng = np.random.RandomState(len(name))
    cls_name = name.replace("_plain", "")
    kwargs = _APMS[name]
    p = _grid_cloud(rng, B, 200)
    fs = [rng.randn(B, 200, d).astype(np.float32) for d in _DIMS]
    jmod = getattr(japm, cls_name)(**kwargs)
    jp, jfs = jnp.asarray(p), [jnp.asarray(f) for f in fs]
    variables = _randomize(jmod.init({"params": jax.random.PRNGKey(0)}, jp, jfs,
                                     False, method=_all_stages), rng)
    want = jmod.apply(variables, jp, jfs, False, method=_all_stages)
    module = _load(getattr(apm, cls_name)(**kwargs), variables).eval()
    assert module is not None and cls_name in str(type(module))
    with torch.inference_mode():
        got = [module(_t(p), _t(f), stage=s) for s, f in enumerate(fs)]
    for g, w in zip(got, want):
        if isinstance(w, tuple):
            assert isinstance(g, tuple) and g[1].shape == w[1].shape
            _close(g[1], w[1], 1e-5)
            g, w = g[0], w[0]
        assert g.shape == (B, 200, 1)
        _close(g, w, 1e-5)


def test_apm_train_mode_matches_jax():
    """``APM_pf_ConCate`` in training mode without dropout: the batch
    statistics normalise, and the running statistics move as flax's
    (momentum 0.9 there is 0.1 here): 1e-5·(1+max)."""
    rng = np.random.RandomState(11)
    kwargs = _APMS["APM_pf_ConCate"]
    p = _grid_cloud(rng, B, 200)
    fs = [rng.randn(B, 200, d).astype(np.float32) for d in _DIMS]
    jmod = japm.APM_pf_ConCate(**kwargs)
    jp, jfs = jnp.asarray(p), [jnp.asarray(f) for f in fs]
    variables = _randomize(jmod.init({"params": jax.random.PRNGKey(1)}, jp, jfs,
                                     False, method=_all_stages), rng)
    want, mut = jmod.apply(variables, jp, jfs, True, method=_all_stages,
                           mutable=["batch_stats"])
    module = _load(apm.APM_pf_ConCate(**kwargs), variables).train()
    got = [module(_t(p), _t(f), stage=s) for s, f in enumerate(fs)]
    for (ga, gm), (wa, wm) in zip(got, want):
        _close(ga.detach(), wa, 1e-5)
        _close(gm.detach(), wm, 1e-5)
    after = from_jax_variables({"batch_stats": jax.tree_util.tree_map(
        np.asarray, dict(mut["batch_stats"]))})
    state = module.state_dict()
    for key, w in after.items():
        if not key.endswith("num_batches_tracked"):
            _close(state[key], w, 1e-5)


def test_apm_dropout_draws_from_its_generator():
    """With dropout on, the tower needs a generator in training mode; one
    seed gives one output, another seed another; eval mode ignores it."""
    rng = np.random.RandomState(12)
    module = apm.APM_p(channel=[8, 4], dropout=[0.5, 0])
    p = _t(_grid_cloud(rng, B, 64))
    with pytest.raises(ValueError):
        module.train()(p)
    run = lambda seed: module(p, generator=torch.Generator().manual_seed(seed))
    assert torch.equal(run(3), run(3)) and not torch.equal(run(3), run(4))
    module.eval()
    assert torch.equal(module(p), module(p))


# ---- the refining decoder -------------------------------------------------------

_NS = [600, 150, 40, 12, 4]
_ECL = [8, 16, 32, 64, 128]


def _decoder_inputs(rng):
    p = [_grid_cloud(rng, B, n) for n in _NS]
    f = [rng.randn(B, n, c).astype(np.float32) for n, c in zip(_NS, _ECL)]
    a = [np.where(rng.rand(B, n) < 0.3, 0.0, rng.rand(B, n)).astype(np.float32)
         for n in _NS[:4]]
    a_map = [rng.rand(B, n, c).astype(np.float32)
             for n, c in zip(_NS[:4], _ECL[:4])]
    return p, f, a, a_map


@pytest.mark.parametrize("kw", [
    dict(gamma=1.0, fusion="MIN"), dict(gamma=0.5, fusion="MIN"),
    dict(gamma=0.5, fusion="MIN_ALL0"), dict(refine_mapping=True),
    dict(refine_mapping=True, refine_attention=True), dict(refine=False),
], ids=["min_g1", "min_g05", "all0_g05", "map_sum", "attention", "no_refine"])
def test_refining_decoder_matches_jax(kw):
    """The decoder with refinement on four stages (600/150/40/12 points,
    k = 8, threshold 0.5 over an ambiguity that masks about a third of the
    points): the output, the pre-refinement 'up' features and the refine
    rate; 1e-5·(1+max)."""
    rng = np.random.RandomState(21)
    p, f, a, a_map = _decoder_inputs(rng)
    kwargs = {**dict(encoder_channel_list=_ECL, decoder_stages=4, refine=True,
                     nsample_k=8, threshold=0.5, threshold_max=1.0), **kw}
    jdec = jpn.PointNextDecoder(**kwargs)
    jargs = ([jnp.asarray(t) for t in p], [jnp.asarray(t) for t in f],
             [jnp.asarray(t) for t in a], [jnp.asarray(t) for t in a_map])
    variables = _randomize(jdec.init({"params": jax.random.PRNGKey(2)}, *jargs,
                                     training=False), rng)
    jout, jup, jrate = jdec.apply(variables, *jargs, training=False)
    dec = _load(PointNextDecoder(**kwargs), variables).eval()
    with torch.inference_mode():
        out, up, rate = dec([_t(t) for t in p], [_t(t) for t in f],
                            [_t(t) for t in a], [_t(t) for t in a_map])
    _close(out, jout, 1e-5)
    for got, want in zip(up, jup):
        _close(got, want, 1e-5)
    np.testing.assert_allclose(rate.item(), float(jrate), rtol=1e-5, atol=1e-6)
    refined = kw.get("refine", True) and not kw.get("refine_mapping", False)
    assert (20 < rate.item() < 50) if refined else rate.item() == 0
    # without an ambiguity list nothing is refined
    with torch.inference_mode():
        plain = dec([_t(t) for t in p], [_t(t) for t in f])
    assert plain[2].item() == 0


# ---- the MM model ---------------------------------------------------------------

def _mm_models(source, thr):
    aef = {**AEF, "source": source}
    args = dict(encoder_args=ENCODER, decoder_args={}, cls_args=CLS,
                AEF_args=aef, APM_args={**APM, "threshold": thr})
    return JaxMM(**args), BaseSeg_M_AMContrast3D(**args)


@pytest.mark.parametrize("source", ["APM", "AEF"])
def test_mm_eval_matches_jax(source):
    """``BaseSeg_M_AMContrast3D`` in eval mode (stages of 512/128/32/8
    points, the last below k = 12), refinement driven by the predicted
    ambiguity (APM, SelfMask threshold at its median) or by the ground
    truth from the labels (AEF, through ``ambiguity_head``, threshold 0.5):
    stage positions identical, the predicted ambiguity to 1e-5, the refine
    rate to 1e-5 (the threshold sits in a gap of the ambiguity values, so
    no point flips by rounding), logits and stage features to 1e-4·(1+max)."""
    rng = np.random.RandomState(31 if source == "APM" else 32)
    pos = _grid_cloud(rng, B, N)
    x = rng.rand(B, N, 4).astype(np.float32)
    y = rng.randint(0, 4, (B, N)).astype(np.int64)
    jpos, jx = jnp.asarray(pos), jnp.asarray(x)
    jmodel, model = _mm_models(source, 0.5)
    variables = _randomize(jax.jit(lambda p_, x_: jmodel.init(
        {"params": jax.random.PRNGKey(0)}, p_, x_, training=False))(jpos, jx), rng)
    _load(model, variables).eval()
    kwargs, jkwargs = {}, {}
    if source == "AEF":
        kwargs, jkwargs = {"target": _t(y)}, {"target": jnp.asarray(y)}
    else:   # near the median predicted ambiguity, so that about half is refined
        with torch.inference_mode():
            a = model(_t(pos), _t(x))[1]["ambiguity"]
        a = torch.cat([t.reshape(-1) for t in a]).sort().values
        mid = len(a) // 2 + int((a[len(a) // 2:].diff() > 1e-4).nonzero()[0])
        thr = 0.5 * (a[mid] + a[mid + 1]).item()   # clear of every value
        jmodel, model = _mm_models(source, thr)
        _load(model, variables).eval()
    jlogits, jstages, jrate = jmodel.apply(variables, jpos, jx, training=False,
                                           **jkwargs)
    assert 5 < float(jrate) < 95
    with torch.inference_mode():
        logits, stages, rate = model(_t(pos), _t(x), **kwargs)
    for got, want in zip(stages["p"], jstages["p"]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for got, want in zip(stages["ambiguity"], jstages["ambiguity"]):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_allclose(rate.item(), float(jrate), rtol=1e-5)
    _close(logits, jlogits, 1e-4)
    for key in ("f_down", "f_up"):
        for got, want in zip(stages[key], jstages[key]):
            _close(got, want, 1e-4)
    if source == "APM":     # the eval step takes the first of the 3-tuple
        out = make_eval_step(model, NCLS)({"pos": _t(pos), "x": _t(x), "y": _t(y)})
        assert torch.equal(out["logits"], logits) and out["cm"].sum() == B * N


def test_mm_builds_from_config_and_refines_by_given_ambiguity():
    """The registry builds the model from a cfg dict (aliases included);
    an ``aef_ambiguity`` list passed in replaces the predicted one."""
    cfg = dict(NAME="BaseSeg_M_AMContrast3D", encoder_args=ENCODER,
               decoder_args={"NAME": "PointNextDecoder_M_AMContrast3D"},
               cls_args=CLS, AEF_args=AEF, APM_args=APM)
    model = build_model_from_cfg(cfg).eval()
    assert isinstance(model, BaseSeg_M_AMContrast3D)
    assert model.decoder.refine and model.decoder.nsample_k == 12
    rng = np.random.RandomState(33)
    pos, x = _t(_grid_cloud(rng, B, 512)), _t(rng.rand(B, 512, 4).astype(np.float32))
    ones = [torch.ones(B, n) for n in (512, 128, 32, 8)]
    with torch.inference_mode():
        assert model(pos, x, aef_ambiguity=ones)[2].item() == 100
        assert model(pos, x, aef_ambiguity=[0 * a for a in ones])[2].item() == 0
    with pytest.raises(KeyError):
        build_model_from_cfg({**cfg, "APM_args": {**APM, "NAME": "APM_missing"}})
