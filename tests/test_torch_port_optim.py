"""The port's optimizers against the optax chain of the JAX package's
``build_tx`` on the CPU.

Each case runs the same updates on the same parameter tree: leaves under
PointNeXt's names (a 160 × 128 Linear among them, whose dims reach
adafactor's factoring at 128) and one under a ViT block's name, which the
layer decay scales.  The gradients are seeded
numpy draws, mapped into both trees leaf by leaf
(``utils.convert.from_jax_variables``).  JAX takes ``build_tx(cfg,
schedule, clip, plateau=True, param_labels=...)`` with one frozen
parameter; the port takes ``build_optimizer_from_cfg`` with that parameter
frozen (``optim.freeze_parameters_``) and ``engine.train.apply_gradients``
(the clip, the schedule's rate, the plateau factor).  The factor is 0.5
from the third update on, so that an update scaled inside the chain
instead of after it shows.

Tolerance: every parameter after every update within 1e-6·(1 + max|θ|)
of optax's.  The two sides round apart only where their float32
expressions do (a bias correction's power, a square root, a cube root,
XLA's fused ``g + wd·θ``): measured at most 1.1e-6 (rmsprop), most cases
below 1e-7.  An adam-family update divides by ``|g| + eps``, so where the
coupled decay cancels the clipped gradient to within its rounding
(``|c·g + wd·θ|`` near 1e-8) a last-digit difference moves that element
by up to lr (jitted and eager JAX differ there as much); the gradients
are drawn with every such element at least 1e-4 from cancelling.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from amcontrast3d_tpu.engine.train import build_tx
from amcontrast3d_tpu.optim.extras import vit_layer_id as jax_vit_layer_id
from amcontrast3d_tpu.scheduler.plateau_lr import set_plateau_scale
from amcontrast3d_tpu_torch.engine.train import apply_gradients
from amcontrast3d_tpu_torch.optim import (build_optimizer_from_cfg,
                                          freeze_parameters_)
from amcontrast3d_tpu_torch.optim.extras import vit_layer_id
from amcontrast3d_tpu_torch.utils.convert import from_jax_variables

LR, CLIP, FROZEN = 0.01, 1.0, r"encoder/enc1_block1/ConvBlock_0"
NAMES = ["adam", "adamw", "sgd", "radam", "adabelief", "adafactor", "lamb",
         "lars", "nadam", "novograd", "rmsprop", "lion", "adamp", "sgdp",
         "madgrad", "madgradw"]
# the JAX factory's other names of the same rules
ALIASES = {"momentum": "sgd", "nadamw": "nadam", "nvnovograd": "novograd",
           "rmsprop_tf": "rmsprop"}


SHAPES = {
    "encoder.enc0_sa.ConvBlock_0.Dense_0.weight": (8, 4),
    "encoder.enc1_sa.w_f.weight": (16, 8),
    "encoder.enc1_sa.BatchNorm_0.weight": (16,),
    "encoder.enc1_sa.BatchNorm_0.bias": (16,),
    "encoder.enc1_block1.ConvBlock_0.Dense_0.weight": (32, 16),
    "encoder.blocks2.mlp.Dense_0.weight": (16, 16),
    "head.ConvBlock_0.Dense_0.weight": (128, 160),
    "head.ConvBlock_0.Dense_0.bias": (128,),
}


def _port_tree():
    model = torch.nn.Module()
    rng = torch.Generator().manual_seed(0)
    for name, shape in SHAPES.items():
        *mods, leaf = name.split(".")
        node = model
        for m in mods:
            if not hasattr(node, m):
                node.add_module(m, torch.nn.Module())
            node = getattr(node, m)
        node.register_parameter(leaf, torch.nn.Parameter(
            torch.randn(shape, generator=rng) * 0.3))
    return model


def _flax_tree(named):
    """The flax tree of the port's parameters: a 2-D weight is the
    transposed kernel, a 1-D weight a norm's scale."""
    tree = {}
    for name, t in named:
        *mods, leaf = name.split(".")
        a = t.detach().numpy().copy()
        if leaf == "weight":
            leaf, a = ("kernel", a.T.copy()) if a.ndim == 2 else ("scale", a)
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = a
    return tree


def _gradients(rng, params, jparams, cfg):
    """A seeded gradient tree, its decayed elements away from cancelling
    (see the module's docstring)."""
    wd = float(cfg.get("weight_decay", 0.0))
    flat, tree = jax.tree_util.tree_flatten(params)
    theta = jax.tree_util.tree_leaves(jparams)
    grads = [rng.randn(*a.shape) * 0.5 for a in flat]
    for _ in range(20):
        c = min(1.0, CLIP / np.sqrt(sum((g ** 2).sum() for g in grads)))
        bad = [(np.abs(c * g + wd * np.asarray(t)) < 1e-4) & (g.ndim > 1)
               for g, t in zip(grads, theta)]
        if not any(b.any() for b in bad) or not wd:
            return jax.tree_util.tree_unflatten(
                tree, [g.astype(np.float32) for g in grads])
        for g, b in zip(grads, bad):
            g[b] = rng.randn(int(b.sum())) * 0.5
    raise AssertionError("no gradient draw away from cancelling")


def _run(cfg, steps=3, seed=1):
    model = _port_tree()
    named = list(model.named_parameters())
    params = _flax_tree(named)
    assert set(from_jax_variables({"params": params})) == {n for n, _ in named}
    labels = lambda tree: jax.tree_util.tree_map_with_path(
        lambda path, _: "frozen" if "/".join(
            str(k.key) for k in path).startswith(FROZEN) else "trainable", tree)
    schedule = lambda count: LR * 0.7 ** count
    tx = build_tx(cfg, schedule, CLIP, plateau=True, param_labels=labels)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jparams)
    update = jax.jit(tx.update)
    frozen = freeze_parameters_(model, FROZEN)
    assert frozen
    optimizer = build_optimizer_from_cfg(cfg, model, lr=LR)
    trained = [p for _, p in named if p.requires_grad]
    rng = np.random.RandomState(seed)
    worst = 0.0
    for s in range(steps):
        scale = 1.0 if s < 2 else 0.5
        grads = _gradients(rng, params, jparams, cfg)
        state = set_plateau_scale(state, scale)
        updates, state = update(jax.tree_util.tree_map(jnp.asarray, grads),
                                state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        mapped = from_jax_variables({"params": grads})
        for name, p in named:
            p.grad = mapped[name].clone() if p.requires_grad else None
        apply_gradients(optimizer, trained, schedule(s), scale, CLIP)
        want = from_jax_variables({"params": jax.tree_util.tree_map(
            np.asarray, jparams)})
        for name, p in named:
            w = want[name].numpy()
            err = np.abs(p.detach().numpy() - w).max()
            assert err <= 1e-6 * (1 + np.abs(w).max()), (cfg, s, name, err)
            worst = max(worst, err)
    return model, worst


@pytest.mark.parametrize("name", NAMES)
def test_optimizer_matches_the_optax_chain(name):
    """Three updates with a schedule, weight decay 0.05, the clip, the
    plateau factor and a frozen parameter; adafactor factors the 160 × 128
    Linear in the flax kernel's layout."""
    model, _ = _run({"NAME": name, "weight_decay": 0.05})
    frozen = dict(model.named_parameters())[
        "encoder.enc1_block1.ConvBlock_0.Dense_0.weight"]
    assert not frozen.requires_grad


@pytest.mark.parametrize("cfg,steps", [
    ({"NAME": "lookahead_adam", "lookahead_k": 2}, 5),
    ({"NAME": "lookahead_sgdp", "lookahead_k": 2, "weight_decay": 0.05}, 5),
    ({"NAME": "adamw", "layer_decay": 0.75, "num_layers": 3,
      "weight_decay": 0.05}, 3),
    ({"NAME": "lookahead_lion", "layer_decay": 0.5, "lookahead_k": 3}, 4),
    ({"NAME": "radam", "betas": [0.9, 0.9]}, 8),
], ids=["lookahead_adam", "lookahead_sgdp", "layer_decay_adamw",
        "lookahead_layer_decay", "radam_rectified"])
def test_wrappers_match_the_optax_chain(cfg, steps):
    """``lookahead_<name>`` through two syncs (the first takes the slow
    weights from the fast ones), ``layer_decay`` inside and outside a
    lookahead on the PointNeXt tree, and radam past its rectification
    threshold (b2 = 0.9 crosses ρ ≥ 5 at the sixth update)."""
    _run(cfg, steps=steps)


@pytest.mark.parametrize("alias", sorted(ALIASES))
def test_aliases_take_their_rule(alias):
    """Each alias of the JAX factory's table (it maps ``momentum`` to
    ``sgd``, ``nadamw`` to ``nadam``, ``nvnovograd`` to ``novograd``,
    ``rmsprop_tf`` to ``rmsprop``, with coupled decay) makes the same
    three updates, bit for bit, as the name it stands for, which
    :func:`test_optimizer_matches_the_optax_chain` holds to optax."""
    trees = []
    for name in (alias, ALIASES[alias]):
        model = _port_tree()
        opt = build_optimizer_from_cfg({"NAME": name, "weight_decay": 0.05},
                                       model, lr=LR)
        rng = np.random.RandomState(3)
        params = list(model.parameters())
        for s in range(3):
            for p in params:
                p.grad = torch.from_numpy(
                    rng.randn(*p.shape).astype(np.float32))
            apply_gradients(opt, params, LR * 0.7 ** s, 1.0, CLIP)
        trees.append([p.detach().clone() for p in params])
    assert all(torch.equal(a, b) for a, b in zip(*trees))


def test_layer_decay_takes_1_as_no_decay_and_adahessian_raises():
    """``layer_decay`` is taken only for 0 < layer_decay < 1, as in JAX: at
    1.0 the adamw stays ``torch.optim.AdamW``.  ``adahessian`` builds (its
    rule is held to JAX's in ``test_torch_port_adahessian.py``) and raises
    on a step without the Hutchinson diagonal, as JAX's update does; an
    unknown name raises ValueError, as in JAX."""
    model = _port_tree()
    opt = build_optimizer_from_cfg({"NAME": "adamw", "layer_decay": 1.0},
                                   model)
    assert isinstance(opt, torch.optim.AdamW)
    opt = build_optimizer_from_cfg({"NAME": "adahessian"}, model)
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    with pytest.raises(ValueError, match="Hutchinson"):
        opt.step()
    with pytest.raises(ValueError, match="not supported"):
        build_optimizer_from_cfg({"NAME": "sawtooth"}, model)


@pytest.mark.parametrize("path", [
    "encoder.enc1_block1.LocalAggregation_0.w_f.kernel", "head.kernel",
    "encoder.block3.attn.qkv.kernel", "encoder.cls_token",
    "encoder.pos_embed.0.kernel", "blocks11.mlp.kernel",
    "encoder.rel_pos_bias.table", "block.norm.scale"])
def test_vit_layer_id_is_the_jax_rule(path):
    for layers in (4, 14):
        assert vit_layer_id(path, layers) == jax_vit_layer_id(path, layers)
