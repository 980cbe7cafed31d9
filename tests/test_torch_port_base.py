"""The vanilla PointNeXt baseline (``--kind base``, ``BaseSeg`` of
``cfgs/s3dis/pointnext-xl.yaml``) against the JAX package on the CPU
(``examples/segmentation/main_torch.py`` end to end is in
``test_torch_port_traincli.py``, beside the other CLI runs).

The cfg is cut to width 8 and three stages (blocks [1, 2, 2], strides
[1, 4, 4], two decoder stages) with the SegHead's dropout off; the rest is
the cfg's own: the separable ``dp_fj`` aggregation with a ball query of
r = 0.1 (here 0.4, for the sparser cloud), BatchNorm, ``CrossEntropy``
with label smoothing 0.2, AdamW at lr 0.01 with weight decay 1e-4, the
cosine schedule and the clip at 10.  B = 2, N = 512 on a 1/64 grid, so
that both packages' FPS and ball query agree exactly.

Tolerances, those of ``test_torch_port_train.py``: the loss 1e-5
relative, the logits 1e-4·(1 + max|logit|), the step-1 gradients 5e-2
relative L2 a tensor (with a 1e-5·√n floor for the biases ahead of a
BatchNorm, whose exact gradient is 0) and 2e-2 over all (max-pool
near-ties route a few gradients to another neighbour: measured 0.4 %),
each of three ``make_train_step`` steps replayed from JAX's state: its
loss 1e-5 relative, the batch statistics 1e-4·(1 + max), the parameters
within 3·lr.
"""
import copy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amcontrast3d_tpu.engine import train as jtrain
from amcontrast3d_tpu.loss import build_criterion_from_cfg as jax_criterion
from amcontrast3d_tpu.models import build_model_from_cfg as jax_model
from amcontrast3d_tpu.scheduler import as_step_schedule as jax_step_schedule
from amcontrast3d_tpu.scheduler import build_scheduler_from_cfg as jax_scheduler
from amcontrast3d_tpu_torch.engine import make_train_step
from amcontrast3d_tpu_torch.loss import build_criterion_from_cfg
from amcontrast3d_tpu_torch.models import build_model_from_cfg
from amcontrast3d_tpu_torch.optim import build_optimizer_from_cfg
from amcontrast3d_tpu_torch.scheduler import (as_step_schedule,
                                              build_scheduler_from_cfg)
from amcontrast3d_tpu_torch.utils.config import EasyConfig
from amcontrast3d_tpu_torch.utils.convert import from_jax_variables

ROOT = Path(__file__).resolve().parent.parent
B, N, NCLS, STEPS, STEPS_PER_EPOCH = 2, 512, 13, 3, 2
CFG = EasyConfig()
CFG.load(str(ROOT / "cfgs" / "s3dis" / "pointnext-xl.yaml"), recursive=True)


def _model_cfg():
    model = copy.deepcopy(dict(CFG.model))
    model["encoder_args"] = {**model["encoder_args"], "width": 8,
                             "blocks": [1, 2, 2], "strides": [1, 4, 4],
                             "radius": 0.4}
    model["decoder_args"] = {**model["decoder_args"], "decoder_stages": 2}
    model["cls_args"] = {**model["cls_args"], "dropout": 0}
    return model


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def reference():
    """JAX: the batch, the variables, the step-1 logits, loss and
    gradients, and the losses of three ``make_train_step`` steps."""
    rng = np.random.RandomState(0)
    batch = {"pos": (rng.randint(0, 128, (B, N, 3)) / 64).astype(np.float32),
             "x": rng.rand(B, N, 4).astype(np.float32)}
    centres = rng.rand(B, NCLS, 3) * 2
    batch["y"] = ((batch["pos"][:, :, None] - centres[:, None]) ** 2
                  ).sum(-1).argmin(-1).astype(np.int64)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    model = jax_model(_model_cfg())
    criterion = jax_criterion(CFG.criterion_args)
    variables = _initial_variables(model, jbatch, rng)
    rng_key = jax.random.PRNGKey(1)
    lr_fn, _ = jax_scheduler(dict(CFG))
    tx = jtrain.build_tx(CFG.optimizer, jax_step_schedule(lr_fn, STEPS_PER_EPOCH),
                         CFG.grad_norm_clip)
    train_step = jtrain.make_train_step(model, criterion, tx, "base", NCLS)

    @jax.jit
    def step(state):
        """JAX's step, beside the loss, logits and gradients of the state
        it starts from (one program: XLA shares the forward)."""
        def loss_fn(params):
            loss, (_, logits, _) = jtrain._forward_loss(
                model, criterion, "base", NCLS, None, {}, params,
                state.batch_stats, jbatch, rng_key)
            return loss, logits
        (loss, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params)
        return train_step(state, jbatch, rng_key), loss, logits, grads

    state = jtrain.TrainState(step=jnp.zeros((), jnp.int32),
                              params=variables["params"],
                              batch_stats=variables["batch_stats"],
                              opt_state=tx.init(variables["params"]))
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    losses, states = [], []
    for i in range(STEPS):
        adam = state.opt_state[1][0]               # ScaleByAdamState
        states.append({"params": tree(state.params),
                       "batch_stats": tree(state.batch_stats),
                       "mu": tree(adam.mu), "nu": tree(adam.nu),
                       "count": int(adam.count)})
        (state, metrics), loss, logits, grads = step(state)
        if i == 0:
            first = {"loss": float(loss), "logits": np.asarray(logits),
                     "grads": tree(grads)}
        losses.append(float(metrics["loss"]))
    states.append({"params": tree(state.params),
                   "batch_stats": tree(state.batch_stats)})
    return {"batch": batch, "variables": tree(variables), **first,
            "losses": losses, "states": states}


def _initial_variables(model, jbatch, rng):
    """The model's variables at flax's initial values but for the Dense
    kernels, drawn from N(0, 1/fan_in) by ``rng`` (the tree from
    ``jax.eval_shape``: traced, not run)."""
    shapes = jax.eval_shape(lambda p, x: model.init(
        {"params": jax.random.PRNGKey(0)}, p, x, training=False),
        jbatch["pos"], jbatch["x"])

    def value(path, a):
        leaf = path[-1].key
        if leaf == "kernel":
            return (rng.randn(*a.shape) / np.sqrt(a.shape[0])).astype(np.float32)
        fill = 1.0 if leaf in ("scale", "var") else 0.0
        return np.full(a.shape, fill, np.float32)
    return jax.tree_util.tree_map_with_path(value, shapes)


def _port_model(variables):
    model = build_model_from_cfg(_model_cfg())
    model.load_state_dict(from_jax_variables(variables), strict=True)
    return model


def test_base_step1_loss_logits_and_gradients_match_jax(reference):
    batch = {k: _t(v) for k, v in reference["batch"].items()}
    model = _port_model(reference["variables"]).train()
    logits = model(batch["pos"], batch["x"])
    loss = build_criterion_from_cfg(CFG.criterion_args)(logits, batch["y"])
    loss.backward()
    np.testing.assert_allclose(loss.item(), reference["loss"], rtol=1e-5)
    want = reference["logits"]
    assert np.abs(logits.detach().numpy() - want).max() <= \
        1e-4 * (1 + np.abs(want).max())
    grads = from_jax_variables({"params": reference["grads"]})
    params = dict(model.named_parameters())
    assert set(grads) == set(params)
    num = den = 0.0
    for name, g in grads.items():
        g = g.numpy().astype(np.float64)
        diff = np.linalg.norm(params[name].grad.numpy() - g)
        assert diff <= 5e-2 * np.linalg.norm(g) + 1e-5 * np.sqrt(g.size), name
        num, den = num + diff ** 2, den + np.sum(g ** 2)
    assert np.sqrt(num / den) <= 2e-2


def test_base_train_steps_match_jax(reference):
    """Each of three steps of the port's ``make_train_step`` (kind
    ``base``, the cfg's AdamW, schedule and clip) from JAX's state before
    it (parameters, batch statistics, Adam moments and count; replayed,
    since Adam moves a parameter by about lr·sign(g), so one free-running
    step's last digits move the next by up to lr): the loss, the batch
    statistics after it to 1e-4·(1+max), the parameters within 3·lr."""
    batch = {k: _t(v) for k, v in reference["batch"].items()}
    model = _port_model(reference["variables"])
    optimizer = build_optimizer_from_cfg(CFG.optimizer, model, lr=CFG.lr)
    lr_fn, _ = build_scheduler_from_cfg(dict(CFG))
    step = make_train_step(model, build_criterion_from_cfg(CFG.criterion_args),
                           optimizer, as_step_schedule(lr_fn, STEPS_PER_EPOCH),
                           "base", NCLS, None, {}, CFG.grad_norm_clip)
    states = reference["states"]
    params = dict(model.named_parameters())
    for i in range(STEPS):
        model.load_state_dict(from_jax_variables(states[i]), strict=True)
        first = from_jax_variables({"params": states[i]["mu"]})
        second = from_jax_variables({"params": states[i]["nu"]})
        for name, p in params.items():
            optimizer.state[p] = {
                "step": torch.tensor(float(states[i]["count"])),
                "exp_avg": first[name].clone(),
                "exp_avg_sq": second[name].clone()}
        step.state["step"] = i
        np.testing.assert_allclose(step(batch)["loss"].item(),
                                   reference["losses"][i], rtol=1e-5)
        got = model.state_dict()
        for name, w in from_jax_variables(states[i + 1]).items():
            w, g = w.numpy(), got[name].numpy()
            if name.endswith(("running_mean", "running_var")):
                assert np.abs(g - w).max() <= 1e-4 * (1 + np.abs(w).max())
            elif not name.endswith("num_batches_tracked"):
                assert np.abs(g - w).max() <= 3 * CFG.lr, name
