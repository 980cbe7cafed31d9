"""The PyTorch port's AA model and eval step against the JAX package.

A small ``BaseSeg_AMContrast3D`` (width 16, blocks (1, 2, 3, 2, 2), B=2,
N=1024) is built in JAX once per module, its batch statistics replaced by
random positive values, and transplanted into the port with
``from_jax_variables``.  Stage 2 has three blocks, so both the per-block
and the shared per-stage ball query run; the last stage has 4 points, so
k=32 > N is reached.  Eval logits must agree within 1e-4·(1+max|logit|)
and the stage positions exactly.

Positions lie on a 1/64 grid in [0, 4)³: every d² is then exact in
float32 in both frameworks (the JAX plain kNN uses the matmul form
``|q|² + |s|² − 2q·s``, the port the direct form), so neighbour sets
agree and only the float rounding of the dense layers remains.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amcontrast3d_tpu.models import BaseSeg_AMContrast3D as JaxAA
from amcontrast3d_tpu.models import pointnext as jpn
from amcontrast3d_tpu.models.layers import ConvBlock as JaxConvBlock
from amcontrast3d_tpu.utils.metrics import confusion_matrix_update as jax_cm
from amcontrast3d_tpu_torch.engine import make_eval_step, make_predict_step
from amcontrast3d_tpu_torch.models import pointnext as port_pointnext
from amcontrast3d_tpu_torch.models import (BaseSeg_AMContrast3D, ConvBlock,
                                           FeaturePropagation, LocalAggregation,
                                           SegHead, SetAbstraction,
                                           build_model_from_cfg, init_weights_)
from amcontrast3d_tpu_torch.models.layers import Dropout
from amcontrast3d_tpu_torch.utils.config import EasyConfig
from amcontrast3d_tpu_torch.utils.convert import from_jax_variables
from amcontrast3d_tpu_torch.utils.metrics import (ConfusionMatrix,
                                                  confusion_matrix_update)

B, N, NCLS = 2, 1024, 13
ENCODER = dict(
    NAME="PointNextEncoder_AMContrast3D", blocks=[1, 2, 3, 2, 2],
    strides=[1, 4, 4, 4, 4], sa_layers=1, sa_use_res=False, width=16,
    in_channels=4, expansion=4, radius=0.1, nsample=32,
    aggr_args={"feature_type": "dp_fj", "reduction": "max"},
    group_args={"NAME": "ballquery", "normalize_dp": True},
    conv_args={"order": "conv-norm-act"}, act_args={"act": "relu"},
    norm_args={"norm": "bn"})
CLS = dict(NAME="SegHead", num_classes=NCLS, in_channels=None,
           norm_args={"norm": "bn"})


def _grid_cloud(rng, b, n):
    return (rng.randint(0, 256, (b, n, 3)) / 64).astype(np.float32)


def _randomize_stats(variables, rng):
    """Replace every BatchNorm statistic with a random positive value (and
    the BN scale/shift with random values), so eval BN is not the identity."""
    def walk(tree, fn):
        return {k: walk(v, fn) if isinstance(v, dict) else fn(k, v)
                for k, v in tree.items()}

    def stat(_, v):
        return rng.uniform(0.5, 1.5, np.shape(v)).astype(np.float32)

    def param(k, v):
        v = np.asarray(v)
        if k == "scale":
            return rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        if k == "bias":
            return (0.1 * rng.randn(*v.shape)).astype(np.float32)
        return v

    params = jax.tree_util.tree_map(np.asarray, dict(variables["params"]))
    stats = jax.tree_util.tree_map(np.asarray, dict(variables.get("batch_stats", {})))
    return {"params": walk(params, param), "batch_stats": walk(stats, stat)}


def _load(module, variables):
    module.load_state_dict(from_jax_variables(variables), strict=True)
    return module.eval()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * (1 + np.abs(want).max()), err


@pytest.fixture(scope="module")
def small_aa():
    """(variables, batch, JAX logits, JAX stages) of the small AA model."""
    rng = np.random.RandomState(0)
    pos = _grid_cloud(rng, B, N)
    x = rng.rand(B, N, 4).astype(np.float32)
    y = rng.randint(0, NCLS, (B, N)).astype(np.int64)
    model = JaxAA(encoder_args=ENCODER, decoder_args={}, cls_args=CLS)
    variables = model.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(pos),
                           jnp.asarray(x), training=False)
    variables = _randomize_stats(variables, rng)
    logits, stages = model.apply(variables, jnp.asarray(pos), jnp.asarray(x),
                                 training=False)
    return variables, {"pos": pos, "x": x, "y": y}, np.asarray(logits), \
        jax.tree_util.tree_map(np.asarray, stages)


def test_aa_eval_logits_match_jax(small_aa):
    variables, batch, jlogits, jstages = small_aa
    model = _load(BaseSeg_AMContrast3D(encoder_args=ENCODER, decoder_args={},
                                       cls_args=CLS), variables)
    with torch.inference_mode():
        logits, stages = model(_t(batch["pos"]), _t(batch["x"]))
    assert logits.shape == (B, N, NCLS)
    for got, want in zip(stages["p"], jstages["p"]):
        np.testing.assert_array_equal(got.numpy(), want)
    assert [p.shape[1] for p in stages["p"]] == [1024, 256, 64, 16]
    _close(logits, jlogits, 1e-4)
    for key in ("f_down", "f_up"):
        for got, want in zip(stages[key], jstages[key]):
            _close(got, want, 1e-4)


def test_eval_step_matches_jax_confusion_matrix(small_aa):
    variables, batch, jlogits, _ = small_aa
    model = _load(BaseSeg_AMContrast3D(encoder_args=ENCODER, decoder_args={},
                                       cls_args=CLS), variables)
    out = make_eval_step(model, NCLS)({k: _t(v) for k, v in batch.items()})
    assert int(out["cm"].sum()) == B * N
    want = np.asarray(jax_cm(jnp.asarray(np.argmax(jlogits, -1)),
                             jnp.asarray(batch["y"]), NCLS))
    cm = confusion_matrix_update(_t(np.argmax(jlogits, -1)), _t(batch["y"]), NCLS)
    np.testing.assert_array_equal(cm.numpy(), want)
    # ignore_index goes to the cut-off virtual class, as in JAX
    np.testing.assert_array_equal(
        confusion_matrix_update(_t(np.argmax(jlogits, -1)), _t(batch["y"]), NCLS, 3).numpy(),
        np.asarray(jax_cm(jnp.asarray(np.argmax(jlogits, -1)),
                          jnp.asarray(batch["y"]), NCLS, 3)))
    acc = ConfusionMatrix(NCLS)
    acc.update_matrix(out["cm"])
    miou, macc, oa, _, _ = acc.all_metrics()
    assert 0 <= miou <= 100 and 0 <= oa <= 100
    logits = make_predict_step(model)({"pos": _t(batch["pos"]), "x": _t(batch["x"])})
    np.testing.assert_array_equal(logits.numpy(), out["logits"].numpy())


def test_build_from_config_runs():
    cfg = EasyConfig()
    cfg.load(str(Path(__file__).resolve().parent.parent / "cfgs" / "s3dis"
                 / "AMContrast3D-AA.yaml"), recursive=True)
    cfg.update(["model.encoder_args.width=16",
                "model.encoder_args.blocks=[1,2,3,2,2]"])
    model = build_model_from_cfg(cfg.model)
    assert isinstance(model, BaseSeg_AMContrast3D)
    init_weights_(model, torch.Generator().manual_seed(0))
    rng = np.random.RandomState(1)
    batch = {"pos": _t(_grid_cloud(rng, 2, 512)),
             "x": _t(rng.rand(2, 512, 4).astype(np.float32)),
             "y": _t(rng.randint(0, 13, (2, 512)))}
    out = make_eval_step(model, cfg.num_classes)(batch)
    assert out["logits"].shape == (2, 512, 13)
    assert torch.isfinite(out["logits"]).all()
    assert int(out["cm"].sum()) == 2 * 512


# the JAX modules' fields that the port's constructors lack and its table
# of unported keys leaves out: the APMs' refinement settings, which the model
# around them reads from APM_args in both packages, and fields that no JAX
# APM reads (feat_concate; att_dim, feature_dim, channel and dropout of the
# classes that take them without using them)
_READ_AROUND_THE_APM = {"linear_mapping", "cross_attention", "nsample_k",
                        "threshold", "threshold_max", "gamma", "fusion",
                        "feat_concate", "att_dim", "feature_dim", "channel",
                        "dropout"}


def test_every_jax_model_field_is_taken_or_raises_by_name():
    """For every model both registries hold: a field of the JAX module that
    the port's constructor lacks is in the port's own table of unported keys
    (``models/build.py``), with the JAX default as its value, so a cfg that
    sets it off the default raises instead of training without it."""
    import dataclasses
    import inspect

    from amcontrast3d_tpu.models.build import MODELS as JAX_MODELS
    from amcontrast3d_tpu_torch.models import build as port_build

    port = port_build.MODELS._module_dict
    jax_models = JAX_MODELS._module_dict
    assert {"PointNextEncoder", "APM_pf_ConCate", "PointNet2Encoder"} <= set(port)
    for name, cls in port.items():
        fields = {f.name: f.default for f in dataclasses.fields(jax_models[name])
                  if f.name not in ("parent", "name")}
        params = inspect.signature(cls.__init__).parameters
        table = {**port_build._JAX_FIELDS,
                 **port_build.UNPORTED_KEYS.get(cls.__name__, {})}
        for key, default in fields.items():
            if key in params:
                continue
            if name.startswith("APM_") and key in _READ_AROUND_THE_APM:
                continue
            assert key in table, (name, key)
            assert table[key] == default, (name, key, default)


# ---- single modules --------------------------------------------------------

def _jax_module(module, *args):
    variables = module.init({"params": jax.random.PRNGKey(1)},
                            *map(jnp.asarray, args), training=False)
    variables = _randomize_stats(variables, np.random.RandomState(2))
    out = module.apply(variables, *map(jnp.asarray, args), training=False)
    return variables, out


def test_convblock_matches_jax():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 50, 7, 12).astype(np.float32)
    for norm, act in ((None, None), ({"norm": "bn"}, {"act": "relu"})):
        variables, want = _jax_module(JaxConvBlock(24, norm_args=norm, act_args=act), x)
        got = _load(ConvBlock(12, 24, norm_args=norm, act_args=act), variables)(_t(x))
        _close(got.detach(), want, 1e-5)


@pytest.mark.parametrize("gather_budget", [None, 64 * 1024])
def test_local_aggregation_matches_jax(gather_budget, monkeypatch):
    """With a small gather budget the eval tail runs in query chunks."""
    if gather_budget is not None:
        monkeypatch.setattr(port_pointnext, "_EVAL_GATHER_BUDGET", gather_budget)
    rng = np.random.RandomState(4)
    p, f = _grid_cloud(rng, 2, 300), rng.randn(2, 300, 16).astype(np.float32)
    ga = {"NAME": "ballquery", "radius": 0.4, "nsample": 16, "normalize_dp": True}
    kw = dict(norm_args={"norm": "bn"}, act_args={"act": "relu"}, group_args=ga)
    variables, want = _jax_module(jpn.LocalAggregation([16, 16], **kw), p, f)
    got = _load(LocalAggregation([16, 16], **kw), variables)(_t(p), _t(f))
    _close(got.detach(), want, 1e-5)


@pytest.mark.parametrize("kw", [
    dict(channels=[16, 16, 16]),                     # two grouped convs
    dict(channels=[16, 16], feature_type="dp_fj_df"),
    dict(channels=[16, 16], norm_args=None),
], ids=["two_layers", "dp_fj_df", "no_norm"])
def test_local_aggregation_refuses_unported_forms(kw):
    kw = {"norm_args": {"norm": "bn"}, **kw}
    with pytest.raises(NotImplementedError):
        LocalAggregation(act_args={"act": "relu"},
                         group_args={"NAME": "ballquery", "radius": 0.4,
                                     "nsample": 16}, **kw)


@pytest.mark.parametrize("layers,use_res", [(1, False), (2, True)])
def test_set_abstraction_matches_jax(layers, use_res):
    """layers=1 takes the separable path, layers=2 the generic grouped MLP
    (with the residual branch)."""
    rng = np.random.RandomState(5)
    p, f = _grid_cloud(rng, 2, 400), rng.randn(2, 400, 8).astype(np.float32)
    kw = dict(in_channels=8, out_channels=32, layers=layers, stride=4,
              group_args={"NAME": "ballquery", "radius": 0.6, "nsample": 16,
                          "normalize_dp": True},
              norm_args={"norm": "bn"}, act_args={"act": "relu"},
              use_res=use_res)
    variables, (jp, jf) = _jax_module(jpn.SetAbstraction(**kw), p, f)
    new_p, got = _load(SetAbstraction(**kw), variables)(_t(p), _t(f))
    np.testing.assert_array_equal(new_p.numpy(), np.asarray(jp))
    _close(got.detach(), jf, 1e-5)


def test_set_abstraction_head_matches_jax():
    rng = np.random.RandomState(6)
    p, f = _grid_cloud(rng, 2, 100), rng.randn(2, 100, 4).astype(np.float32)
    kw = dict(in_channels=4, out_channels=16, stride=1, is_head=True)
    variables, (_, jf) = _jax_module(jpn.SetAbstraction(**kw), p, f)
    _, got = _load(SetAbstraction(**kw), variables)(_t(p), _t(f))
    _close(got.detach(), jf, 1e-6)


def test_feature_propagation_matches_jax():
    rng = np.random.RandomState(7)
    p2 = _grid_cloud(rng, 2, 64)
    p1 = np.concatenate([p2, _grid_cloud(rng, 2, 192)], 1)
    f1, f2 = rng.randn(2, 256, 8).astype(np.float32), rng.randn(2, 64, 16).astype(np.float32)
    kw = dict(norm_args={"norm": "bn"}, act_args={"act": "relu"})
    jfp = jpn.FeaturePropagation([24, 8, 8], **kw)
    variables = jfp.init({"params": jax.random.PRNGKey(1)},
                         [jnp.asarray(p1), jnp.asarray(f1)],
                         [jnp.asarray(p2), jnp.asarray(f2)], training=False)
    variables = _randomize_stats(variables, rng)
    want = jfp.apply(variables, [jnp.asarray(p1), jnp.asarray(f1)],
                     [jnp.asarray(p2), jnp.asarray(f2)], training=False)
    got = _load(FeaturePropagation([24, 8, 8], **kw), variables)(
        [_t(p1), _t(f1)], [_t(p2), _t(f2)])
    _close(got.detach(), want, 1e-5)


@pytest.mark.parametrize("shape", [(2, 50, 7, 12), (3, 40, 12)])
def test_convblock_train_mode_matches_jax(shape):
    """Training-mode BatchNorm: the output normalised with the batch
    statistics, and the running statistics moved toward the batch mean and
    the biased batch variance (momentum 0.1), as flax with
    ``mutable=["batch_stats"]``; to 1e-5."""
    rng = np.random.RandomState(8)
    x = (2 * rng.randn(*shape) + 0.5).astype(np.float32)
    kw = dict(norm_args={"norm": "bn"}, act_args={"act": "relu"})
    module = JaxConvBlock(24, **kw)
    variables = _randomize_stats(module.init({"params": jax.random.PRNGKey(3)},
                                             jnp.asarray(x), training=False), rng)
    want, mut = module.apply(variables, jnp.asarray(x), training=True,
                             mutable=["batch_stats"])
    port = _load(ConvBlock(12, 24, **kw), variables).train()
    got = port(_t(x))
    _close(got.detach(), want, 1e-5)
    stats = mut["batch_stats"]["BatchNorm_0"]
    bn = port.BatchNorm_0
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(stats["mean"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(stats["var"]),
                               rtol=1e-5, atol=1e-6)


def test_seghead_dropout_is_reproducible_from_its_generator():
    """Training-mode dropout draws from the generator it is given: the
    same seed gives the same output, another seed another; without a
    generator it raises; eval mode is the identity."""
    head = SegHead(NCLS, 16, dropout=0.5)
    init_weights_(head, torch.Generator().manual_seed(0))
    f = torch.randn(2, 100, 16, generator=torch.Generator().manual_seed(1))
    head.train()
    a = head(f, torch.Generator().manual_seed(5))
    b = head(f, torch.Generator().manual_seed(5))
    c = head(f, torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="generator"):
        head(f)
    head.eval()
    assert torch.equal(head(f), head(f, torch.Generator().manual_seed(5)))
    drop = Dropout(0.5).train()
    y = drop(torch.ones(20000), torch.Generator().manual_seed(7))
    assert set(y.unique().tolist()) == {0.0, 2.0}
    assert abs(y.mean().item() - 1.0) < 0.05
