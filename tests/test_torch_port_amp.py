"""The port at bfloat16 (``use_amp``) against the JAX package built with
``dtype=jnp.bfloat16``, on the CPU.

The same seeded numpy inputs and weights (``utils/convert.py::
from_jax_variables``) go through the JAX modules and the port's, both at
bfloat16: a ConvBlock (with and without a norm), a LocalAggregation and a
SetAbstraction on the gather tail and on the fused tail (the JAX tail in
interpret mode, as ``tests/test_aggregate_pallas.py`` runs it, in train and
eval mode), an InvResMLP, the SegHead, an APM tower, and the whole AA and
MM eval forwards (width 16, three stages of 1024 / 256 / 64 points, ball
radii 0.4 and 0.8: about 8 neighbours a ball).  Every
output's dtype equals JAX's: the Linears compute in bfloat16, the
BatchNorms return float32, so the features between blocks are float32 and
the stem's output, the logits and the APM's lifted map bfloat16.

Tolerances: a module's outputs within 1e-2·(1+max|out|), a bfloat16 ulp
(2⁻⁸ relative) being what two roundings of the same float32 value can
differ by; the models' logits within 3e-2·(1+max|logit|), the JAX
package's own envelope of its fused tail against its gather tail at
bfloat16 (``tests/test_aggregate_pallas.py::
test_local_aggregation_fused_bf16``).  Each test's docstring gives the
error measured against it.  ``test_the_casts_sit_where_jax_puts_them``
holds that the port's bfloat16 logits are closer to JAX's bfloat16 logits
than JAX's float32 logits are, by at least 2×: a cast missing or added
would move the port toward float32 or away from both.

The JAX models are built and run once a module (``jax_models``); positions
lie on a 1/64 grid in [0, 4)³, so FPS, the ball query and the
interpolation's neighbours agree exactly between the two.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amcontrast3d_tpu.models import BaseSeg_AMContrast3D as JaxAA
from amcontrast3d_tpu.models import BaseSeg_M_AMContrast3D as JaxMM
from amcontrast3d_tpu.models import apm as japm
from amcontrast3d_tpu.models import pointnext as jpn
from amcontrast3d_tpu.models.layers import ConvBlock as JaxConvBlock
from amcontrast3d_tpu.ops import aggregate_pallas as jagg
from amcontrast3d_tpu.ops import ball_query as jax_ball_query
from amcontrast3d_tpu_torch.models import (BaseSeg_AMContrast3D,
                                           BaseSeg_M_AMContrast3D, ConvBlock,
                                           InvResMLP, LocalAggregation,
                                           SegHead, SetAbstraction)
from amcontrast3d_tpu_torch.models.apm import APM_pf_ConCate
from amcontrast3d_tpu_torch.ops import aggregate as pagg
from amcontrast3d_tpu_torch.utils.convert import from_jax_variables

BF16 = torch.bfloat16
B, N, NCLS = 2, 1024, 13
COMMON = dict(norm_args={"norm": "bn"}, act_args={"act": "relu"},
              conv_args={"order": "conv-norm-act"})
GROUP = {"NAME": "ballquery", "radius": 0.3, "nsample": 16,
         "normalize_dp": True}
ENCODER = dict(
    NAME="PointNextEncoder_AMContrast3D", blocks=[1, 2, 2],
    strides=[1, 4, 4], sa_layers=1, sa_use_res=False, width=16,
    in_channels=4, expansion=4, radius=0.4, nsample=16,
    aggr_args={"feature_type": "dp_fj", "reduction": "max"},
    group_args={"NAME": "ballquery", "normalize_dp": True}, **COMMON)
DECODER = {"decoder_stages": 2}
CLS = dict(NAME="SegHead", num_classes=NCLS, in_channels=None,
           norm_args={"norm": "bn"})
MM_ARGS = dict(
    encoder_args={**ENCODER, "NAME": "PointNextEncoder_M_AMContrast3D"},
    decoder_args=DECODER, cls_args=CLS,
    AEF_args={"nsample": 16, "cctype": "Method2", "ccbeta": 0.04},
    APM_args={"NAME": "APM_pf_ConCate", "feature_dim": [16, 32],
              "channel": [8, 4], "dropout": [0, 0], "linear_mapping": False,
              "nsample_k": 12, "fusion": "MIN", "threshold": 0.5,
              "threshold_max": 1.0, "gamma": 0.5})


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _grid(rng, shape, cells=64, spread=1.0):
    return (rng.randint(0, int(cells * spread), shape) / cells).astype(np.float32)


def _np(x):
    """A JAX or torch array as float32 numpy (bfloat16 widens exactly)."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


def _dtype_name(x) -> str:
    return str(x.dtype).rsplit(".", 1)[-1]


def _match(got, want, tol):
    """Same dtype as JAX's; values within tol·(1+max|want|).  Returns the
    error over its bound."""
    assert _dtype_name(got) == _dtype_name(want), (got.dtype, want.dtype)
    g, w = _np(got), _np(want)
    assert g.shape == w.shape
    err = np.abs(g - w).max()
    bound = tol * (1 + np.abs(w).max())
    assert err <= bound, (err, bound)
    return err / bound


def _random_bn(variables, rng):
    """Random BatchNorm scales of both signs (so the fused tail takes minima
    on some channels), shifts and running statistics."""
    def walk(tree, fn):
        return {k: walk(v, fn) if isinstance(v, dict) else fn(k, np.asarray(v))
                for k, v in tree.items()}

    def param(k, v):
        if k == "scale":
            mag = rng.uniform(0.5, 1.5, v.shape)
            return np.where(rng.rand(*v.shape) < 0.4, -mag, mag).astype(np.float32)
        if k == "bias":
            return (0.1 * rng.randn(*v.shape)).astype(np.float32)
        return v

    def stat(k, v):
        if k == "mean":
            return (0.1 * rng.randn(*v.shape)).astype(np.float32)
        return rng.uniform(0.5, 1.5, v.shape).astype(np.float32)

    tree = lambda t: jax.tree_util.tree_map(np.asarray, dict(t))
    out = {"params": walk(tree(variables["params"]), param)}
    if "batch_stats" in variables:
        out["batch_stats"] = walk(tree(variables["batch_stats"]), stat)
    return out


def _load(module, variables):
    module.load_state_dict(from_jax_variables(variables), strict=True)
    return module


def _both(jm, pm, args, rng, train: bool, fused: bool = False):
    """(JAX outputs, port outputs) of one module on ``args`` (numpy), the
    port's weights from JAX's; ``fused`` switches both packages' fused
    tail on for the call."""
    jargs = [jnp.asarray(a) for a in args]
    variables = _random_bn(jm.init({"params": jax.random.PRNGKey(0)}, *jargs,
                                   training=False), rng)
    _load(pm, variables).train(train)
    try:
        jagg.set_agg_fused("on" if fused else "off")
        pagg.set_agg_fused("on" if fused else "off")
        if train:
            jout, _ = jm.apply(variables, *jargs, training=True,
                               mutable=["batch_stats"])
        else:
            jout = jm.apply(variables, *jargs, training=False)
        with torch.no_grad():
            pout = pm(*[_t(a) for a in args])
    finally:
        jagg.set_agg_fused("off")
        pagg.set_agg_fused("off")
    return jout, pout


# ---- single modules ---------------------------------------------------------

@pytest.mark.parametrize("norm", [False, True])
def test_convblock_bf16_matches_jax(norm):
    """A Dense at bfloat16 returns bfloat16 (no norm, the stem and the
    logits) and a BatchNorm float32; within 1e-2·(1+max) (measured 3.3e-5
    of the bound with the norm, identical without)."""
    rng = np.random.RandomState(3)
    x = rng.randn(2, 50, 7, 12).astype(np.float32)
    kw = dict(norm_args={"norm": "bn"}, act_args={"act": "relu"}) if norm else {}
    jout, pout = _both(JaxConvBlock(24, dtype=jnp.bfloat16, **kw),
                       ConvBlock(12, 24, dtype=BF16, **kw), [x], rng, train=True)
    assert _dtype_name(pout) == ("float32" if norm else "bfloat16")
    _match(pout, jout, 1e-2)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("train", [True, False])
def test_local_aggregation_bf16_matches_jax(fused, train):
    """The separable aggregation at bfloat16 (``w_f(f)`` and ``w_dp(p)``
    bfloat16; the gather tail's grouped tensor, or the fused tail's ``u``
    through the kernels' bfloat16 path, then a float32 BatchNorm): a
    float32 output within 1e-2·(1+max) of JAX's, in train and eval mode
    (measured 5e-6 to 9.4e-5 of the bound)."""
    rng = np.random.RandomState(11)
    p = _grid(rng, (2, 260, 3))
    f = rng.randn(2, 260, 16).astype(np.float32)
    jout, pout = _both(
        jpn.LocalAggregation(channels=[16, 24], group_args=GROUP,
                             dtype=jnp.bfloat16, **COMMON),
        LocalAggregation([16, 24], group_args=GROUP, dtype=BF16, **COMMON),
        [p, f], rng, train, fused)
    _match(pout, jout, 1e-2)


@pytest.mark.parametrize("fused", [False, True])
def test_set_abstraction_bf16_matches_jax(fused):
    """A set abstraction at bfloat16 (FPS, the ball query of the queries in
    the support, the separable tail) in train mode: positions identical,
    float32 features within 1e-2·(1+max) of JAX's (measured 1.5e-5 and
    7.6e-5 of the bound)."""
    rng = np.random.RandomState(12)
    p = _grid(rng, (2, 260, 3))
    f = rng.randn(2, 260, 16).astype(np.float32)
    (jp, jf), (pp, pf) = _both(
        jpn.SetAbstraction(in_channels=16, out_channels=32, stride=4,
                           group_args=GROUP, dtype=jnp.bfloat16, **COMMON),
        SetAbstraction(16, 32, stride=4, group_args=GROUP, dtype=BF16,
                       **COMMON),
        [p, f], rng, True, fused)
    np.testing.assert_array_equal(pp.numpy(), np.asarray(jp))
    _match(pf, jf, 1e-2)


def test_invresmlp_bf16_matches_jax():
    """An InvResMLP block at bfloat16 (aggregation, two ConvBlocks, the
    residual in float32) in train mode: float32 features within
    1e-2·(1+max) (measured 0.45 of the bound: the aggregation's float32
    output, 1e-6 from JAX's, rounds to another bfloat16 value at the next
    Dense for 0.4 % of its elements, one ulp that the BatchNorms carry
    on)."""
    rng = np.random.RandomState(13)
    p = _grid(rng, (2, 260, 3))
    f = rng.randn(2, 260, 16).astype(np.float32)
    aggr = {"feature_type": "dp_fj", "reduction": "max"}
    (_, jf), (_, pf) = _both(
        jpn.InvResMLP(in_channels=16, aggr_args=aggr, group_args=GROUP,
                      expansion=4, dtype=jnp.bfloat16, **COMMON),
        InvResMLP(16, aggr_args=aggr, group_args=GROUP, expansion=4,
                  dtype=BF16, **COMMON),
        [p, f], rng, True)
    _match(pf, jf, 1e-2)


def test_seghead_bf16_matches_jax():
    """The head's last Dense has no norm: the logits come out bfloat16, as
    JAX's; within 1e-2·(1+max) in eval mode (measured: identical)."""
    rng = np.random.RandomState(14)
    f = rng.randn(2, 300, 16).astype(np.float32)
    jout, pout = _both(
        jpn.SegHead(num_classes=NCLS, in_channels=16, norm_args={"norm": "bn"},
                    dtype=jnp.bfloat16),
        SegHead(NCLS, 16, norm_args={"norm": "bn"}, dtype=BF16),
        [f], rng, False)
    assert pout.dtype == BF16
    _match(pout, jout, 1e-2)


def test_apm_tower_bf16_matches_jax():
    """An APM stage at bfloat16: the tower's Dense layers bfloat16, its
    BatchNorms float32, so ``a`` is float32; the lifted map (a Dense and a
    sigmoid, no norm) bfloat16.  Train mode; within 1e-2·(1+max)
    (measured 1e-5 of the bound for ``a``, 0.21 for the map: an ulp of its
    bfloat16 rounding)."""
    rng = np.random.RandomState(15)
    p = _grid(rng, (2, 300, 3))
    f = rng.randn(2, 300, 16).astype(np.float32)
    kw = dict(feature_dim=[16], channel=[8, 4], dropout=[0, 0])

    class Stage0(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.apm = APM_pf_ConCate(linear_mapping=True, dtype=BF16, **kw)

        def forward(self, p, f):
            return self.apm(p, f, 0)

    jm = japm.APM_pf_ConCate(linear_mapping=True, dtype=jnp.bfloat16, **kw)
    jargs = [jnp.asarray(p), jnp.asarray(f)]
    variables = _random_bn(jm.init({"params": jax.random.PRNGKey(0)}, *jargs,
                                   0, training=False), rng)
    (ja, jmap), _ = jm.apply(variables, *jargs, 0, training=True,
                             mutable=["batch_stats"])
    pm = Stage0()
    pm.apm.load_state_dict(from_jax_variables(variables), strict=True)
    with torch.no_grad():
        pa, pmap = pm.train()(_t(p), _t(f))
    assert pa.dtype == torch.float32 and pmap.dtype == BF16
    _match(pa, ja, 1e-2)
    _match(pmap, jmap, 1e-2)


def test_grouped_slot_reduce_bf16_matches_pallas():
    """``grouped_slot_reduce`` on a bfloat16 ``u`` (the fused tail under
    ``use_amp``) against the Pallas entry in interpret mode: ext, su and sq
    float32 on both sides, ext within 1e-6 (both the float32 of a
    bfloat16 value), the moments within 1e-5; du bfloat16 on both sides,
    within one bfloat16 rounding (1e-2·(1+max)) of JAX's, which sums in
    float32 and casts once (measured 0.03 of the bound); dqp in qp's dtype,
    within 1e-4·(1+max) (5.8e-4 of the bound)."""
    rng = np.random.RandomState(16)
    sup = _grid(rng, (2, 300, 3))
    q = np.ascontiguousarray(sup[:, rng.permutation(300)[:90]])
    idx = np.asarray(jax_ball_query(jnp.asarray(sup), jnp.asarray(q), 0.2, 8))
    u = rng.randn(2, 300, 12).astype(np.float32)
    sgn = np.where(rng.rand(12) < 0.5, -1.0, 1.0).astype(np.float32)
    qp = rng.randn(2, 90, 12).astype(np.float32)
    gs = [rng.randn(2, 90, 12).astype(np.float32) for _ in range(3)]
    ju = jnp.asarray(u).astype(jnp.bfloat16)
    ut = _t(u).to(BF16).requires_grad_()
    qt = _t(qp).requires_grad_()
    got = pagg.grouped_slot_reduce(ut, _t(idx), _t(sgn), qp=qt)
    sum((o * _t(g)).sum() for o, g in zip(got, gs)).backward()

    def jfn(u_, qp_):
        return jagg.grouped_slot_reduce(
            jnp.asarray(sup), jnp.asarray(q), u_, jnp.asarray(idx),
            jnp.asarray(sgn), radius=0.2, qp=qp_, interpret=True)
    want = jfn(ju, jnp.asarray(qp))
    for a, b, tol in zip(got, want, (1e-6, 1e-5, 1e-5)):
        assert a.dtype == torch.float32 and b.dtype == jnp.float32
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=tol, atol=tol)
    du, dqp = jax.grad(lambda u_, qp_: sum(
        jnp.sum(o * g) for o, g in zip(jfn(u_, qp_), gs)), argnums=(0, 1))(
        ju, jnp.asarray(qp))
    assert ut.grad.dtype == BF16 and du.dtype == jnp.bfloat16
    _match(ut.grad, du, 1e-2)
    _match(qt.grad, dqp, 1e-4)


# ---- the models -------------------------------------------------------------

def _jax_model(kind, dtype):
    if kind == "aa":
        return JaxAA(encoder_args=ENCODER, decoder_args=DECODER, cls_args=CLS,
                     dtype=dtype)
    return JaxMM(**MM_ARGS, dtype=dtype)


def _port_model(kind, variables):
    if kind == "aa":
        model = BaseSeg_AMContrast3D(encoder_args=ENCODER, decoder_args=DECODER,
                                     cls_args=CLS, dtype=BF16)
    else:
        model = BaseSeg_M_AMContrast3D(**MM_ARGS, dtype=BF16)
    return _load(model, variables).eval()


@pytest.fixture(scope="module")
def jax_models():
    """Per (kind, fused): the batch, the variables (random BatchNorm
    statistics) and JAX's eval logits at bfloat16 and at float32."""
    rng = np.random.RandomState(0)
    pos = _grid(rng, (B, N, 3), spread=4.0)
    x = rng.rand(B, N, 4).astype(np.float32)
    out = {}
    for kind in ("aa", "mm"):
        jargs = (jnp.asarray(pos), jnp.asarray(x))
        # the initial variables in one jitted program (eager JAX compiles
        # op by op); the forwards stay eager, where each bfloat16 op rounds
        # its result as the casts test reads them
        variables = _random_bn(jax.jit(lambda p, f: _jax_model(
            kind, jnp.float32).init({"params": jax.random.PRNGKey(1)}, p, f,
                                    training=False))(*jargs), rng)
        for fused in (False, True):
            try:
                jagg.set_agg_fused("on" if fused else "off")
                logits = {name: _jax_model(kind, dt).apply(
                              variables, *jargs, training=False)[0]
                          for name, dt in (("bf16", jnp.bfloat16),
                                           ("f32", jnp.float32))}
            finally:
                jagg.set_agg_fused("off")
            out[kind, fused] = (pos, x, variables, logits)
    return out


def _port_logits(jax_models, kind, fused):
    pos, x, variables, _ = jax_models[kind, fused]
    model = _port_model(kind, variables)
    try:
        pagg.set_agg_fused("on" if fused else "off")
        with torch.inference_mode():
            return model(_t(pos), _t(x))[0]
    finally:
        pagg.set_agg_fused("off")


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("kind", ["aa", "mm"])
def test_eval_logits_bf16_match_jax(jax_models, kind, fused):
    """The whole eval forward at bfloat16, on the gather tail and on the
    fused tail: bfloat16 logits, as JAX's, within 3e-2·(1+max|logit|)
    (measured 0.073 / 0.048 of the bound for AA on the gather / fused
    tail, 0.074 / 0.025 for MM)."""
    got = _port_logits(jax_models, kind, fused)
    assert got.dtype == BF16 and got.shape == (B, N, NCLS)
    _match(got, jax_models[kind, fused][3]["bf16"], 3e-2)


@pytest.mark.parametrize("kind", ["aa", "mm"])
def test_the_casts_sit_where_jax_puts_them(jax_models, kind):
    """The port's bfloat16 logits are at least 2× closer to JAX's bfloat16
    logits than JAX's float32 logits are to them (root mean square over the
    batch; measured 4.9× for AA, 12.5× for MM): the rounding of the port
    follows JAX's cast points, not float32's.  A flax Dense rounds its product before adding the bias, and
    a Python scalar meets a bfloat16 tensor in bfloat16: without either, the
    port sat as far from JAX's bfloat16 logits as JAX's float32 ones do."""
    want = _np(jax_models[kind, False][3]["bf16"])
    rms = lambda a: float(np.sqrt(np.mean((a - want) ** 2)))
    port = rms(_np(_port_logits(jax_models, kind, False)))
    f32 = rms(_np(jax_models[kind, False][3]["f32"]))
    assert 2 * port <= f32, (port, f32)
