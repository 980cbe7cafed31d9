"""The segmentation path's options against the JAX package on the CPU, one
module at a time: every ConvBlock order with every norm, MLPBlocks, the
generic LocalAggregation over every feature type and pool, the separable
branch under ``norm: ln`` (a BatchNorm in both packages), ResBlock inside a
small PointNeXt encoder, the random sampler's set abstraction and the
global FeaturePropagation.

Each case initialises the flax module, draws every norm's scale, shift and
statistics at random, loads the variables into the port with
``from_jax_variables`` (strictly: every tensor must be there), and runs
both in training mode: the output to 1e-5·(1 + max|out|), and the
gradients of ``Σ out·w`` (w a seeded draw) with respect to every parameter
and to the float inputs to 1e-4·(1 + max|grad|).  The norms' arithmetic
differs only in the variance's form (flax's ``E[x²] − E[x]²``, torch's two
passes): measured at most a few 1e-6.  Positions lie on a 1/64 grid, so
that both ball queries take the same neighbours.
"""
import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amcontrast3d_tpu.models import layers as jlayers
from amcontrast3d_tpu.models import pointnext as jpn
from amcontrast3d_tpu_torch.models import layers, pointnext
from amcontrast3d_tpu_torch.utils.convert import from_jax_variables

ORDERS = ["conv-norm-act", "norm-act-conv", "conv-act-norm"]
NORMS = ["bn", "ln", "gn", None]
FEATURES = ["dp_fj", "dp_fj_df", "pi_dp_fj_df", "dp_df"]
POOLS = ["max", "avg", "sum"]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _grid_cloud(rng, b, n):
    return (rng.randint(0, 128, (b, n, 3)) / 64).astype(np.float32)


def _randomize_norms(variables, rng):
    """Every norm's scale and shift and every BatchNorm statistic drawn at
    random (the variances positive), Dense leaves kept."""
    def walk(tree, in_norm=False):
        out = {}
        for key, value in tree.items():
            norm = in_norm or key.startswith(("BatchNorm", "LayerNorm",
                                              "GroupNorm"))
            if isinstance(value, dict):
                out[key] = walk(value, norm)
            elif norm and key in ("scale", "var"):
                out[key] = (0.5 + rng.rand(*value.shape)).astype(np.float32)
            elif norm and key in ("bias", "mean"):
                out[key] = (0.2 * rng.randn(*value.shape)).astype(np.float32)
            else:
                out[key] = np.asarray(value)
        return out
    return {k: walk(v) for k, v in variables.items()}


def _held_to_jax(jmod, port, args, select=lambda out: out, float_args=(1,),
                 rngs=None, tol=1e-5, grad_tol=1e-4):
    """``jmod`` and ``port`` (its twin) in training mode on ``args``: the
    selected output and the gradients of Σ out·w.  Returns the variables."""
    rng = np.random.RandomState(11)
    jargs = [jnp.asarray(a) for a in args]
    variables = jmod.init({"params": jax.random.PRNGKey(1)}, *jargs,
                          training=False)
    variables = _randomize_norms(jax.tree_util.tree_map(np.asarray, variables),
                                 rng)
    port.load_state_dict(from_jax_variables(variables), strict=True)
    port.train()

    def jforward(params, *xs):
        out, _ = jmod.apply({**variables, "params": params}, *xs,
                            training=True, mutable=["batch_stats"],
                            rngs=rngs or {})
        return select(out)

    shape = jax.eval_shape(jforward, variables["params"], *jargs).shape
    w = rng.randn(*shape).astype(np.float32)
    argnums = (0,) + tuple(1 + i for i in float_args)

    @jax.jit
    def out_and_grads(*a):
        loss = lambda *b: (lambda out: (jnp.sum(out * w), out))(jforward(*b))
        return jax.grad(loss, argnums, has_aux=True)(*a)

    jgrads, want = out_and_grads(variables["params"], *jargs)
    want = np.asarray(want)
    targs = [_t(a).requires_grad_(i in float_args) for i, a in enumerate(args)]
    got = select(port(*targs))
    assert got.shape == want.shape
    err = np.abs(got.detach().numpy() - want).max()
    assert err <= tol * (1 + np.abs(want).max()), err
    (got * _t(w)).sum().backward()
    params = dict(port.named_parameters())
    for name, g in from_jax_variables({"params": jgrads[0]}).items():
        g = g.numpy()
        err = np.abs(params[name].grad.numpy() - g).max()
        assert err <= grad_tol * (1 + np.abs(g).max()), (name, err)
    for i, g in zip(float_args, jgrads[1:]):
        g = np.asarray(g)
        err = np.abs(targs[i].grad.numpy() - g).max()
        assert err <= grad_tol * (1 + np.abs(g).max()), (i, err)
    return variables


class JaxSide(nn.Module):
    """flax modules side by side on the same inputs (each made by one of
    ``makers``, under flax's names: ConvBlock_0, ConvBlock_1, …), their
    outputs flattened a cloud and joined: one JAX program for many cases."""
    makers: tuple

    @nn.compact
    def __call__(self, *xs, training: bool = False):
        outs = [make()(*xs, training=training) for make in self.makers]
        return jnp.concatenate([o.reshape(o.shape[0], -1) for o in outs], 1)


class PortSide(torch.nn.Module):
    """The port's twin of :class:`JaxSide`."""

    def __init__(self, modules):
        super().__init__()
        names = {}
        for m in modules:
            kind = type(m).__name__
            self.add_module(f"{kind}_{names.get(kind, 0)}", m)
            names[kind] = names.get(kind, 0) + 1

    def forward(self, *xs):
        outs = [m(*xs) for m in self.children()]
        return torch.cat([o.reshape(o.shape[0], -1) for o in outs], 1)


@pytest.mark.parametrize("norm", NORMS)
def test_convblock_order_and_norm_match_jax(norm):
    """A grouped (B, M, K, C) tensor through a ConvBlock of 16 → 64
    channels in each order: the GroupNorm normalises each group over M, K
    and its channels (flax's every non-batch axis), the ``norm-act-conv``
    norm the 16 input channels; the output is contiguous (the GroupNorm's
    came out permuted and the interpolation kernel refused it on the
    card)."""
    x = np.random.RandomState(3).randn(2, 20, 6, 16).astype(np.float32)
    kws = [dict(norm_args=None if norm is None else {"norm": norm},
                act_args={"act": "relu"}, order=order) for order in ORDERS]
    variables = _held_to_jax(
        JaxSide(tuple(lambda kw=kw: jlayers.ConvBlock(64, **kw) for kw in kws)),
        PortSide([layers.ConvBlock(16, 64, **kw) for kw in kws]), [x],
        float_args=(0,))
    flax_norm = {"bn": "BatchNorm_0", "ln": "LayerNorm_0",
                 "gn": "GroupNorm_0", None: None}[norm]
    for i in range(len(ORDERS)):
        assert set(variables["params"][f"ConvBlock_{i}"]) == \
            {"Dense_0", flax_norm} - {None}
    # channels-last and laid out so: the next layer's kernels (the
    # interpolation, the gathers) take contiguous tensors only
    for kw in kws:
        assert layers.ConvBlock(16, 64, **kw)(torch.from_numpy(x)).is_contiguous()


def test_group_norm_refuses_what_flax_refuses():
    """min(32, C) groups must divide C: 48 channels raise in both."""
    x = jnp.zeros((1, 4, 48))
    with pytest.raises(ValueError):
        jlayers.ConvBlock(48, norm_args={"norm": "gn"}).init(
            {"params": jax.random.PRNGKey(0)}, x)
    with pytest.raises(ValueError, match="divide"):
        layers.ConvBlock(8, 48, norm_args={"norm": "gn"})


def test_mlp_blocks_match_jax():
    """Three ConvBlocks (12 → 32 → 32 → 16) with ``norm: ln`` and the
    last activation off, in each order."""
    x = np.random.RandomState(4).randn(2, 30, 12).astype(np.float32)
    kws = [dict(norm_args={"norm": "ln"}, act_args={"act": "gelu"},
                order=order, last_act=False) for order in ORDERS]
    _held_to_jax(
        JaxSide(tuple(lambda kw=kw: jlayers.MLPBlocks([32, 32, 16], **kw)
                      for kw in kws)),
        PortSide([layers.MLPBlocks(12, [32, 32, 16], **kw) for kw in kws]),
        [x], float_args=(0,))


def test_generic_local_aggregation_matches_jax():
    """Two grouped convs (so the generic branch in both packages) over
    every feature type of ``CHANNEL_MAP`` and every pool."""
    rng = np.random.RandomState(5)
    p, f = _grid_cloud(rng, 2, 160), rng.randn(2, 160, 8).astype(np.float32)
    kws = [dict(norm_args={"norm": "bn"}, act_args={"act": "relu"},
                group_args={"NAME": "ballquery", "radius": 0.3, "nsample": 8,
                            "normalize_dp": True},
                feature_type=feature_type, reduction=pool)
           for feature_type in FEATURES for pool in POOLS]
    ports = [pointnext.LocalAggregation([8, 16, 16], **kw) for kw in kws]
    assert not any(m.separable or m.takes_fused() for m in ports)
    _held_to_jax(
        JaxSide(tuple(lambda kw=kw: jpn.LocalAggregation([8, 16, 16], **kw)
                      for kw in kws)), PortSide(ports), [p, f])


def test_single_layer_forms_take_the_jax_branch():
    """A single ``dp_fj`` conv takes the separable branch exactly where the
    JAX package's ``use_separable`` does: another order or no norm gives
    the generic branch, a kNN grouping the separable one."""
    rng = np.random.RandomState(6)
    p, f = _grid_cloud(rng, 2, 128), rng.randn(2, 128, 8).astype(np.float32)
    forms = [dict(conv_args={"order": "norm-act-conv"}), dict(norm_args=None),
             dict(group_args={"NAME": "knn", "nsample": 8}, reduction="avg")]
    kws = [{"norm_args": {"norm": "bn"}, "act_args": {"act": "relu"},
            "group_args": {"NAME": "ballquery", "radius": 0.3, "nsample": 8},
            **form} for form in forms]
    ports = [pointnext.LocalAggregation([8, 8], **kw) for kw in kws]
    variables = _held_to_jax(
        JaxSide(tuple(lambda kw=kw: jpn.LocalAggregation([8, 8], **kw)
                      for kw in kws)), PortSide(ports), [p, f])
    assert [m.separable for m in ports] == [False, False, True]
    for i, m in enumerate(ports):
        assert m.separable == ("w_f" in variables["params"][
            f"LocalAggregation_{i}"])


def test_separable_branch_under_ln_is_held_to_the_jax_batchnorm():
    """``norm: ln`` on a single ``dp_fj`` conv: the JAX package's
    ``use_separable`` accepts any norm and its separable tail normalises
    with a BatchNorm (``models/pointnext.py:272-282``); the port follows
    it, BatchNorm_0 and all (upstream OpenPoints would take a LayerNorm)."""
    rng = np.random.RandomState(7)
    p, f = _grid_cloud(rng, 2, 128), rng.randn(2, 128, 8).astype(np.float32)
    kw = dict(norm_args={"norm": "ln"}, act_args={"act": "relu"},
              group_args={"NAME": "ballquery", "radius": 0.3, "nsample": 8})
    port = pointnext.LocalAggregation([8, 16], **kw)
    variables = _held_to_jax(jpn.LocalAggregation([8, 16], **kw), port,
                             [p, f])
    assert port.separable and "BatchNorm_0" in variables["batch_stats"]


ENCODER = dict(in_channels=4, width=4, blocks=[1, 2], strides=[1, 4],
               nsample=8, radius=0.25, expansion=2,
               group_args={"NAME": "ballquery", "normalize_dp": True})


class JaxEncoderLoop(nn.Module):
    """The JAX ``PointNextEncoder``'s loop (``models/pointnext.py:650-718``)
    over its own SetAbstraction and block modules, under the encoder's
    names, without the stage's shared grouping.  The JAX encoder itself
    cannot run ``block: ResBlock``: it hands every block ``cached_idx``,
    which ``ResBlock.__call__`` does not take (a TypeError)."""
    kw: dict

    @nn.compact
    def __call__(self, p, f, training: bool = False):
        enc = jpn.PointNextEncoder(**self.kw)
        norm = self.kw.get("norm_args") or {"norm": "bn"}
        act = {"act": "relu"}
        aggr = self.kw.get("aggr_args") or {"feature_type": "dp_fj",
                                            "reduction": "max"}
        blocks, strides = enc.blocks, enc.strides
        radii = jpn.to_full_list(enc.radius, blocks, strides, 2)
        nsamples = jpn.to_full_list(enc.nsample, blocks, strides, 1)
        block_cls = jpn._BLOCKS[enc.block]
        p_list, f_list, in_ch = [p], [f], enc.in_channels
        for i, ch in enumerate(enc.channel_list):
            ga = {**dict(enc.group_args), "radius": radii[i][0],
                  "nsample": nsamples[i][0]}
            p, f = jpn.SetAbstraction(
                in_channels=in_ch, out_channels=ch, stride=strides[i],
                group_args=ga, norm_args=norm, act_args=act,
                conv_args=enc.conv_args, is_head=i == 0,
                feature_type=aggr["feature_type"], name=f"enc{i}_sa")(
                    p, f, training)
            in_ch = ch
            for j in range(1, blocks[i]):
                gaj = {**dict(enc.group_args), "radius": radii[i][j],
                       "nsample": nsamples[i][j]}
                p, f = block_cls(
                    in_channels=ch, aggr_args=aggr, norm_args=norm,
                    act_args=act, group_args=gaj, conv_args=enc.conv_args,
                    expansion=enc.expansion, name=f"enc{i}_block{j}")(
                        p, f, training)
            p_list.append(p)
            f_list.append(f)
        return p_list, f_list


def _stage_features(out):
    feats = [x.reshape(2, -1) for x in out[1][1:]]
    if isinstance(feats[0], torch.Tensor):
        return torch.cat(feats, 1)
    return jnp.concatenate(feats, 1)


@pytest.mark.parametrize("kw", [
    dict(block="ResBlock", aggr_args={"feature_type": "dp_fj_df",
                                      "reduction": "max"},
         norm_args={"norm": "ln"}),
    dict(norm_args={"norm": "gn"}, conv_args={"order": "norm-act-conv"}),
], ids=["resblock_dp_fj_df_ln", "invres_gn_norm_act_conv"])
def test_encoder_with_the_options_matches_jax(kw):
    """A small PointNeXt encoder (stages of 1 and 2 blocks, 192 points,
    widths 4 and 8) with ResBlock or the generic InvResMLP: every stage's
    features, the gradients of every parameter and of the input
    features.  The InvResMLP case runs the JAX encoder itself; the
    ResBlock ones its loop (:class:`JaxEncoderLoop`)."""
    rng = np.random.RandomState(8)
    p, f = _grid_cloud(rng, 2, 192), rng.randn(2, 192, 4).astype(np.float32)
    args = {**ENCODER, **kw}
    jmod = (JaxEncoderLoop(args) if kw.get("block") == "ResBlock"
            else jpn.PointNextEncoder(**args))
    _held_to_jax(jmod, pointnext.PointNextEncoder(**args), [p, f],
                 select=_stage_features)


def test_random_sampler_set_abstraction_matches_jax(monkeypatch):
    """``sampler: random``: both packages' ``random_sample`` return the same
    seeded indices (patched in this test only), so the set abstractions
    must agree; the port draws from the generator it is handed, on the
    cloud's device, with replacement in [0, N)."""
    rng = np.random.RandomState(9)
    p, f = _grid_cloud(rng, 2, 200), rng.randn(2, 200, 8).astype(np.float32)
    picks = rng.randint(0, 200, (2, 50)).astype(np.int32)
    monkeypatch.setattr(jpn, "random_sample",
                        lambda xyz, n, key: jnp.asarray(picks[:, :n]))
    monkeypatch.setattr(pointnext, "random_sample",
                        lambda xyz, n, gen: _t(picks[:, :n]))
    kw = dict(in_channels=8, out_channels=16, stride=4, sampler="random",
              group_args={"NAME": "ballquery", "radius": 0.3, "nsample": 8},
              norm_args={"norm": "bn"}, act_args={"act": "relu"})
    port = pointnext.SetAbstraction(**kw)
    gen = torch.Generator().manual_seed(0)
    forward = port.forward
    port.forward = lambda p, f: forward(p, f, port.sample(p, gen))
    _held_to_jax(jpn.SetAbstraction(**kw), port, [p, f],
                 select=lambda out: out[1],
                 rngs={"sampling": jax.random.PRNGKey(0)})
    monkeypatch.undo()
    idx, q = port.sample(_t(p), torch.Generator().manual_seed(3))
    assert idx.shape == (2, 50) and idx.dtype == torch.int32
    assert 0 <= int(idx.min()) and int(idx.max()) < 200
    assert torch.equal(q, _t(p)[torch.arange(2)[:, None], idx.long()])
    with pytest.raises(ValueError, match="generator"):
        port.sample(_t(p))


def test_global_feature_propagation_matches_jax():
    """``upsample=False``: the mean over the points through ``Dense_0`` and
    a ReLU, broadcast and concatenated, then the ConvBlocks of mlp[2:]."""
    rng = np.random.RandomState(10)
    p, f = _grid_cloud(rng, 2, 64), rng.randn(2, 64, 16).astype(np.float32)
    kw = dict(norm_args={"norm": "bn"}, act_args={"act": "relu"})
    jfp = jpn.FeaturePropagation([16, 8, 12, 12], upsample=False, **kw)
    port = pointnext.FeaturePropagation([16, 8, 12, 12], upsample=False, **kw)

    class JaxGlobal:
        def init(self, rngs, p, f, training):
            return jfp.init(rngs, [p, f], training=training)

        def apply(self, variables, p, f, **kw):
            return jfp.apply(variables, [p, f], **kw)

    class PortGlobal(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.fp = port

        def forward(self, p, f):
            return self.fp([p, f])

        def load_state_dict(self, state, strict=True):
            return self.fp.load_state_dict(state, strict=strict)

        def named_parameters(self, *a, **k):
            return self.fp.named_parameters(*a, **k)

    _held_to_jax(JaxGlobal(), PortGlobal(), [p, f])


def test_a_base_model_with_the_options_loads_strictly_and_moments_go_to_adamw_only():
    """``from_jax_variables`` maps a whole JAX ``BaseSeg`` built with the
    new options (the generic aggregation's ``MLPBlocks_0`` over
    ``dp_fj_df``, ``norm: ln`` in the blocks and the set abstractions,
    ``norm: gn`` in the decoder and the head) leaf
    by leaf into the port's, ``strict=True`` (ResBlock's names load so in
    :func:`test_encoder_with_the_options_matches_jax`).
    ``load_jax_train_state`` writes the JAX trainer's Adam moments only into
    a ``torch.optim.AdamW`` and raises naming any other optimizer."""
    from amcontrast3d_tpu.models import build_model_from_cfg as jax_model
    from amcontrast3d_tpu_torch.models import build_model_from_cfg
    from amcontrast3d_tpu_torch.optim import build_optimizer_from_cfg
    from amcontrast3d_tpu_torch.utils.convert import load_jax_train_state

    cfg = {"NAME": "BaseSeg",
           "encoder_args": {**ENCODER, "norm_args": {"norm": "ln"},
                            "aggr_args": {"feature_type": "dp_fj_df",
                                          "reduction": "max"}},
           "decoder_args": {"NAME": "PointNextDecoder", "decoder_stages": 1,
                            "norm_args": {"norm": "gn"}},
           "cls_args": {"NAME": "SegHead", "num_classes": 5,
                        "norm_args": {"norm": "gn"}}}
    rng = np.random.RandomState(12)
    p, f = _grid_cloud(rng, 1, 64), rng.randn(1, 64, 4).astype(np.float32)
    # the tree's structure and shapes (traced, not run), drawn at random
    shapes = jax.eval_shape(jax_model(cfg).init,
                            {"params": jax.random.PRNGKey(0)},
                            jnp.asarray(p), jnp.asarray(f))
    variables = jax.tree_util.tree_map(
        lambda a: rng.rand(*a.shape).astype(np.float32), shapes)
    block = variables["params"]["encoder"]["enc1_block1"]
    assert "MLPBlocks_0" in block["LocalAggregation_0"]
    assert "LayerNorm_0" in variables["params"]["encoder"]["enc1_sa"][
        "ConvBlock_0"]
    model = build_model_from_cfg(cfg)
    state = from_jax_variables(variables)
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state, strict=True)
    zeros = jax.tree_util.tree_map(np.zeros_like, variables["params"])
    adamw = build_optimizer_from_cfg({"NAME": "adamw"}, model)
    load_jax_train_state(model, adamw, variables, zeros, zeros, count=3)
    assert all(st["step"] == 3 for st in adamw.state.values())
    with pytest.raises(NotImplementedError, match="Chain"):
        load_jax_train_state(model, build_optimizer_from_cfg({"NAME": "sgd"},
                                                             model),
                             variables, zeros, zeros, count=3)
