"""The port's AA and MM train steps against the JAX package on the CPU.

The small AA model (width 16, blocks (1, 2, 3, 2, 2), no dropout, B=2,
N=2048; contrast stages of 2048/512/128/32 points) is built in JAX once
per module and transplanted into the port with ``from_jax_variables``.
Both take the S3DIS AA recipe of ``cfgs/s3dis/AMContrast3D-AA.yaml``:
``CrossEntropyAce``, AdamW (lr 0.01, wd 1e-4), cosine schedule stepped per
epoch (2 steps per epoch here, so step 2 moves to epoch 2), clip 10.

Positions lie on a 1/256 grid in [0, 4)³: every d² is exact in float32
in both kNN forms, so FPS, ball query, interpolation and the label
propagation agree exactly.  The port's contrast uses threshold
neighbourhoods ``d² ≤ kth`` and JAX's CPU path K = 23 neighbour slots;
they agree where no point's 25th-nearest d² (self included) falls inside
the threshold, so points whose stage neighbourhood has such a tie are
redrawn (as are duplicates).  Labels: a Voronoi partition into 13
regions.

The MM step (``BaseSeg_M_AMContrast3D`` with ``APM_pf_ConCate`` towers of
8/4/2 channels, ``CrossEntropyAcePre``, the recipe of
``cfgs/s3dis/AMContrast3D-MM.yaml``) runs on the same batch with the
SelfMask threshold at 0.5, where the train-mode BatchNorm ahead of the last
sigmoid centres the predicted ambiguity, so about half of the points are
refined (at the cfg's 0.9 none would be).

Tolerances (each test says what it measured): step-1 gradients 2e-2
relative L2 over all parameters and 5e-2 per tensor, since max-pool
near-ties route a few gradients differently; losses 1e-5 relative;
batch statistics 1e-4·(1+max); parameters after each step within 3·lr,
with most elements far closer.  The last is loose on purpose: Adam moves
a parameter by about lr·sign(g) wherever |g| ≫ eps, so a gradient of
1e-9 that differs in its last digits between the frameworks moves the
parameter by up to lr.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amcontrast3d_tpu.engine import train as jtrain
from amcontrast3d_tpu.loss import build_criterion_from_cfg as jax_criterion
from amcontrast3d_tpu.models import BaseSeg_AMContrast3D as JaxAA
from amcontrast3d_tpu.models import BaseSeg_M_AMContrast3D as JaxMM
from amcontrast3d_tpu.scheduler import as_step_schedule as jax_step_schedule
from amcontrast3d_tpu.scheduler import build_scheduler_from_cfg as jax_scheduler
from amcontrast3d_tpu_torch import ops
from amcontrast3d_tpu_torch.engine import make_train_step
from amcontrast3d_tpu_torch.loss import build_criterion_from_cfg
from amcontrast3d_tpu_torch.models import (BaseSeg_AMContrast3D,
                                           BaseSeg_M_AMContrast3D, init_weights_)
from amcontrast3d_tpu_torch.optim import (build_optimizer_from_cfg,
                                          clip_by_global_norm_)
from amcontrast3d_tpu_torch.scheduler import (as_step_schedule,
                                              build_scheduler_from_cfg)
from amcontrast3d_tpu_torch.utils.config import EasyConfig
from amcontrast3d_tpu_torch.utils.convert import from_jax_variables
from torch_threads import default_threads  # noqa: F401

# tolerances read with torch's default thread count (tests/torch_threads.py)
pytestmark = pytest.mark.usefixtures("default_threads")

B, N, NCLS, STEPS, STEPS_PER_EPOCH = 2, 2048, 13, 3, 2
CFG = EasyConfig()
CFG.load(str(Path(__file__).resolve().parent.parent / "cfgs" / "s3dis"
             / "AMContrast3D-AA.yaml"), recursive=True)
AMB = dict(CFG.ambiguity_args)
NSAMPLE = AMB["nsample"]
ENCODER = dict(
    NAME="PointNextEncoder_AMContrast3D", blocks=[1, 2, 3, 2, 2],
    strides=[1, 4, 4, 4, 4], sa_layers=1, sa_use_res=False, width=16,
    in_channels=4, expansion=4, radius=0.1, nsample=32,
    aggr_args={"feature_type": "dp_fj", "reduction": "max"},
    group_args={"NAME": "ballquery", "normalize_dp": True},
    conv_args={"order": "conv-norm-act"}, act_args={"act": "relu"},
    norm_args={"norm": "bn"})
CLS = dict(NAME="SegHead", num_classes=NCLS, in_channels=None,
           norm_args={"norm": "bn"}, dropout=0)
MM_CFG = EasyConfig()
MM_CFG.load(str(Path(__file__).resolve().parent.parent / "cfgs" / "s3dis"
                / "AMContrast3D-MM.yaml"), recursive=True)
MM_AMB = dict(MM_CFG.ambiguity_args)
MM_STEPS = 2
MM_ARGS = dict(
    encoder_args={**ENCODER, "NAME": "PointNextEncoder_M_AMContrast3D"},
    decoder_args={}, cls_args=CLS, AEF_args=MM_AMB,
    APM_args={**dict(MM_CFG.model.APM_args), "feature_dim": [16, 32, 64, 128],
              "channel": [8, 4, 2], "dropout": [0, 0, 0], "threshold": 0.5})
MM_TERMS = ("loss", "loss_seg", "loss_ce", "loss_contrast", "loss_reg",
            "refine_rate")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _stage_clouds(pos):
    """Positions of the 4 contrast stages (the model's FPS, stride 4) and
    each stage point's index into ``pos``."""
    stages, origs = [pos], [np.broadcast_to(np.arange(pos.shape[1]), pos.shape[:2])]
    for _ in range(3):
        prev = _t(stages[-1])
        idx = ops.furthest_point_sample(prev, prev.shape[1] // 4)
        stages.append(ops.gather_points(prev, idx).numpy())
        origs.append(np.take_along_axis(origs[-1], idx.long().numpy(), 1))
    return stages, origs


def _tie_free_grid_cloud(rng):
    pos = (rng.randint(0, 1024, (B, N, 3)) / 256).astype(np.float32)
    for _ in range(50):
        bad = np.zeros((B, N), bool)
        for ps, orig in zip(*_stage_clouds(pos)):
            d2 = np.sort(((ps[:, :, None].astype(np.float64) - ps[:, None]) ** 2)
                         .sum(-1), -1).astype(np.float32)
            kth = d2[..., NSAMPLE - 1] * np.float32(1.0 + 1e-5)
            ok = (d2[..., 1] > 0) & (d2[..., NSAMPLE] > kth)
            for b in range(B):
                bad[b, orig[b][~ok[b]]] = True
        if not bad.any():
            return pos
        pos[bad] = rng.randint(0, 1024, (int(bad.sum()), 3)) / 256
    raise AssertionError("no tie-free cloud")


def _batch(rng):
    pos = _tie_free_grid_cloud(rng)
    centres = rng.rand(B, NCLS, 3) * 4
    y = ((pos[:, :, None] - centres[:, None]) ** 2).sum(-1).argmin(-1)
    return {"pos": pos, "x": rng.rand(B, N, 4).astype(np.float32),
            "y": y.astype(np.int64)}


def _jax_tx():
    lr_fn, _ = jax_scheduler(dict(CFG))
    return jtrain.build_tx(CFG.optimizer, jax_step_schedule(lr_fn, STEPS_PER_EPOCH),
                           CFG.grad_norm_clip)


@pytest.fixture(scope="module")
def shared_batch():
    return _batch(np.random.RandomState(0))


def _jax_reference(model, criterion, kind, amb, batch, steps, with_grads):
    """JAX: initial variables, step-1 gradients, and the metrics, params and
    batch statistics of ``steps`` ``make_train_step`` steps."""
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jax.jit(lambda p, x: model.init(
        {"params": jax.random.PRNGKey(0)}, p, x, training=False))(
        jbatch["pos"], jbatch["x"])
    rng = jax.random.PRNGKey(1)

    def loss_fn(params, batch_stats, b, key):
        return jtrain._forward_loss(model, criterion, kind, NCLS, None, amb,
                                    params, batch_stats, b, key)[0]
    grads = None
    if with_grads:
        grads = jax.jit(jax.grad(loss_fn))(variables["params"],
                                           variables["batch_stats"], jbatch, rng)
    tx = _jax_tx()
    state = jtrain.TrainState(step=jnp.zeros((), jnp.int32),
                              params=variables["params"],
                              batch_stats=variables["batch_stats"],
                              opt_state=tx.init(variables["params"]))
    step = jax.jit(jtrain.make_train_step(model, criterion, tx, kind, NCLS,
                                          None, amb))
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    states, losses, cms, metrics_list = [], [], [], []
    for _ in range(steps):
        adam = state.opt_state[1][0]               # ScaleByAdamState
        states.append({"params": tree(state.params),
                       "batch_stats": tree(state.batch_stats),
                       "mu": tree(adam.mu), "nu": tree(adam.nu),
                       "count": int(adam.count)})
        state, metrics = step(state, jbatch, rng)
        losses.append(float(metrics["loss"]))
        cms.append(np.asarray(metrics["cm"]))
        metrics_list.append({k: float(v) for k, v in metrics.items()
                             if k != "cm"})
    states.append({"params": tree(state.params),
                   "batch_stats": tree(state.batch_stats)})
    return {"batch": batch, "variables": tree(variables), "grads": tree(grads),
            "losses": losses, "cms": cms, "states": states,
            "metrics": metrics_list}


@pytest.fixture(scope="module")
def reference(shared_batch):
    return _jax_reference(
        JaxAA(encoder_args=ENCODER, decoder_args={}, cls_args=CLS),
        jax_criterion(CFG.criterion_args_Ace), "aa", AMB, shared_batch, STEPS,
        with_grads=True)


@pytest.fixture(scope="module")
def reference_mm(shared_batch):
    return _jax_reference(JaxMM(**MM_ARGS),
                          jax_criterion(MM_CFG.criterion_args_AcePre), "mm",
                          MM_AMB, shared_batch, MM_STEPS, with_grads=True)


def _port_model(variables):
    model = BaseSeg_AMContrast3D(encoder_args=ENCODER, decoder_args={},
                                 cls_args=CLS)
    model.load_state_dict(from_jax_variables(variables), strict=True)
    return model


def _close(got, want, tol, name):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, name
    err = np.abs(got - want).max()
    assert err <= tol * (1 + np.abs(want).max()), (name, err)


def _gradients_close(model, jax_grads, floor=1e-5):
    """The model's ``.grad`` against JAX's gradient tree: 5e-2 relative L2 per
    tensor (plus a ``floor``·√n floor) and 2e-2 over all parameters.  Returns
    {name: (‖JAX gradient‖, ‖difference‖)}."""
    want = from_jax_variables({"params": jax_grads})
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    num = den = 0.0
    norms, off = {}, {}
    for name, g in want.items():
        g = g.numpy().astype(np.float64)
        diff = np.linalg.norm(got[name].grad.numpy() - g)
        if diff > 5e-2 * np.linalg.norm(g) + floor * np.sqrt(g.size):
            off[name] = (diff, np.linalg.norm(g), g.size)
        num, den = num + diff ** 2, den + np.sum(g ** 2)
        norms[name] = (np.linalg.norm(g), diff)
    assert not off, off
    assert np.sqrt(num / den) <= 2e-2, np.sqrt(num / den)
    return norms


def test_step1_gradients_match_jax(reference):
    """Gradients of the first step, per parameter tensor in relative L2
    (and over all parameters): the two forwards differ by float rounding
    (~1e-5 relative at the deepest stage), and wherever a max-pooled
    channel's two best neighbours are closer than that, the gradient goes
    to the other neighbour; measured 0.4 % over all parameters and at most
    1.7 % for a tensor (0.4-1.1 % and 2.4 % on another batch).  A bias
    followed by BatchNorm has an exact gradient of zero and holds only
    rounding noise (up to 7e-6 an element); the 1e-5·√n floor covers
    it."""
    batch = {k: _t(v) for k, v in reference["batch"].items()}
    model = _port_model(reference["variables"]).train()
    logits, stages = model(batch["pos"], batch["x"])
    up = list(zip(stages["p"], stages["f_up"]))
    loss = build_criterion_from_cfg(CFG.criterion_args_Ace)(
        logits, batch["y"], up, NCLS, None, AMB)
    loss.backward()
    np.testing.assert_allclose(loss.item(), reference["losses"][0], rtol=1e-5)
    _gradients_close(model, reference["grads"])


def test_mm_step1_gradients_match_jax(reference_mm):
    """The ``mm`` loss (seg + reg) at the SelfMask threshold 0.5: its
    step-1 gradients against ``jax.grad`` at the tolerances of the AA test,
    APM towers included, so a term that reaches the APM, the refined decoder
    or the regression with a wrong scale fails here (the replay below would
    not see it at step 1, where Adam moves a parameter by lr·sign(g)).
    The noise floor is 2e-5 an element here: every tensor but one meets
    the AA test's 1e-5, and that one is the first layer's bias ahead of a
    BatchNorm, whose exact gradient is zero and whose rounding noise
    measured 1.2e-5 an element.  Only the regression term reaches the APM
    (the masks and the argmin pass no gradient), at w3 = 0.01, so its
    gradients (norms 5e-8 to 8e-4) lie under that floor: they are held
    on their own, each tensor but the biases ahead of a BatchNorm within
    2e-3 relative L2 and with no floor (measured at most 3.2e-4)."""
    batch = {k: _t(v) for k, v in reference_mm["batch"].items()}
    model = BaseSeg_M_AMContrast3D(**MM_ARGS)
    model.load_state_dict(from_jax_variables(reference_mm["variables"]),
                          strict=True)
    model.train()
    logits, stages, rate = model(batch["pos"], batch["x"])
    up = list(zip(stages["p"], stages["f_up"]))
    seg, _, _, reg = build_criterion_from_cfg(MM_CFG.criterion_args_AcePre)(
        logits, batch["y"], up, stages["ambiguity"], NCLS, None, MM_AMB)
    loss = seg + reg
    loss.backward()
    assert 20 < rate.item() < 80
    np.testing.assert_allclose(loss.item(), reference_mm["losses"][0], rtol=1e-5)
    norms = _gradients_close(model, reference_mm["grads"], floor=2e-5)
    apm = {n: v for n, v in norms.items() if n.startswith("APM.")}
    assert {n.split(".")[1] for n in apm} == {f"layer_{s}" for s in range(4)}
    for name, (norm, diff) in apm.items():
        if not (name.endswith(".bias") and ".Dense_" in name):
            assert norm > 0 and diff <= 2e-3 * norm, (name, diff, norm)


def _load_state(model, optimizer, state):
    """JAX's params, batch statistics and Adam moments into the port."""
    model.load_state_dict(from_jax_variables(state), strict=True)
    params = dict(model.named_parameters())
    for key in ("mu", "nu"):
        moments = from_jax_variables({"params": state[key]})
        for name, p in params.items():
            st = optimizer.state[p]
            st["step"] = torch.tensor(float(state["count"]))
            st["exp_avg" if key == "mu" else "exp_avg_sq"] = moments[name].clone()


def _replay(step, model, optimizer, reference, steps, terms):
    """Each step from JAX's state before it; see
    ``test_train_steps_match_jax`` for the bounds."""
    batch = {k: _t(v) for k, v in reference["batch"].items()}
    states = reference["states"]
    for i in range(steps):
        _load_state(model, optimizer, states[i])
        step.state["step"] = i
        out = step(batch)
        for key in terms:
            np.testing.assert_allclose(out[key].item(),
                                       reference["metrics"][i][key], rtol=1e-5,
                                       err_msg=f"{key} step {i}")
        cm = out["cm"].numpy()
        assert cm.sum() == B * N
        assert np.abs(cm - reference["cms"][i]).sum() <= 2 * B * N * 1e-3
        want = from_jax_variables(states[i + 1])
        got = model.state_dict()
        assert set(got) == set(want)
        diffs = []
        for name, w in want.items():
            if name.endswith("num_batches_tracked"):
                continue
            if name.endswith(("running_mean", "running_var")):
                _close(got[name], w, 1e-4, name)
            else:
                diffs.append(np.abs(got[name].numpy() - w.numpy()).ravel())
        diffs = np.concatenate(diffs)
        within = {t: (diffs <= t).mean() for t in (1e-5, 1e-4, 1e-3)}
        assert within[1e-5] >= (0.99 if i == 0 else 0.4), (i, within)
        assert within[1e-4] >= 0.9 and within[1e-3] >= 0.99, (i, within)
        assert diffs.max() <= 3 * CFG.lr, (i, diffs.max())


def test_train_steps_match_jax(reference):
    """Each of 3 ``make_train_step`` steps from JAX's state before it
    (params, batch statistics, Adam moments, step count): the loss to
    1e-5, the train confusion matrix up to argmax near-ties, the batch
    statistics after it to 1e-4·(1+max), and the parameters after it,
    every element within 3·lr: Adam turns a gradient whose sign differs by
    rounding (about 0.2 % of the elements at step 1) into an update of
    order lr the other way, and from step 2 on the new gradient's
    max-pool flips (see above) move m̂/√v̂ by ~1e-3 relative.  Measured
    fractions within 1e-5 / 1e-4 / 1e-3: 99.8 / 99.9 / 99.9 % (step 1),
    47 / 92 / 99.8 % (step 2), 98.4 / 99.9 / 99.998 % (step 3); the
    bounds are 99 % within 1e-5 at step 1 (40 % later), 90 % within
    1e-4 and 99 % within 1e-3."""
    model = _port_model(reference["variables"])
    optimizer = build_optimizer_from_cfg(CFG.optimizer, model, lr=CFG.lr)
    lr_fn, _ = build_scheduler_from_cfg(dict(CFG))
    step = make_train_step(model, build_criterion_from_cfg(CFG.criterion_args_Ace),
                           optimizer, as_step_schedule(lr_fn, STEPS_PER_EPOCH),
                           "aa", NCLS, None, AMB, CFG.grad_norm_clip)
    _replay(step, model, optimizer, reference, STEPS, ("loss",))
    assert step.state["step"] == STEPS


def test_mm_train_steps_match_jax(reference_mm):
    """The ``mm`` step (loss = seg + reg) replayed from JAX's state for 2
    steps, with the bounds of ``test_train_steps_match_jax``; the loss, its
    four terms and the refine rate to 1e-5, and the refinement really runs
    (rate between 20 and 80 %).  The APM's parameters are part of the
    state: ``from_jax_variables`` loads them with ``strict=True`` and the
    state after the step covers the same keys."""
    model = BaseSeg_M_AMContrast3D(**MM_ARGS)
    model.load_state_dict(from_jax_variables(reference_mm["variables"]),
                          strict=True)
    assert any(name.startswith("APM.layer_3.") for name in model.state_dict())
    optimizer = build_optimizer_from_cfg(MM_CFG.optimizer, model, lr=MM_CFG.lr)
    lr_fn, _ = build_scheduler_from_cfg(dict(MM_CFG))
    step = make_train_step(
        model, build_criterion_from_cfg(MM_CFG.criterion_args_AcePre), optimizer,
        as_step_schedule(lr_fn, STEPS_PER_EPOCH), "mm", NCLS, None, MM_AMB,
        MM_CFG.grad_norm_clip)
    _replay(step, model, optimizer, reference_mm, MM_STEPS, MM_TERMS)
    for metrics in reference_mm["metrics"]:
        assert 20 < metrics["refine_rate"] < 80
        np.testing.assert_allclose(metrics["loss"], metrics["loss_seg"]
                                   + metrics["loss_reg"], rtol=1e-6)
    assert step.state["step"] == MM_STEPS


@pytest.mark.parametrize("kind", ["aa", "mm"])
def test_a_step_sorts_its_stage_clouds_once(kind, reference, reference_mm):
    """One ``make_train_step`` step from JAX's state, as the replay takes it
    (the loss, its terms and the state after it within the replay's bounds
    of JAX), with every sort of stage clouds counted: the forward sorts its
    five stage clouds once (``ops.spatial.sort_stages``, ahead of the
    encoder's ball queries and the decoder's CrossMask), and the loss sorts
    none: each stage's contrast takes one of the forward's layouts, made for
    that stage's positions.  An eval forward sorts once too."""
    from unittest import mock

    from amcontrast3d_tpu_torch.loss import contrast as pcontrast
    from amcontrast3d_tpu_torch.ops import spatial

    ref = reference if kind == "aa" else reference_mm
    cfg, amb = (CFG, AMB) if kind == "aa" else (MM_CFG, MM_AMB)
    if kind == "aa":
        model = _port_model(ref["variables"])
        criterion = build_criterion_from_cfg(CFG.criterion_args_Ace)
    else:
        model = BaseSeg_M_AMContrast3D(**MM_ARGS)
        model.load_state_dict(from_jax_variables(ref["variables"]), strict=True)
        criterion = build_criterion_from_cfg(MM_CFG.criterion_args_AcePre)
    optimizer = build_optimizer_from_cfg(cfg.optimizer, model, lr=cfg.lr)
    lr_fn, _ = build_scheduler_from_cfg(dict(cfg))
    step = make_train_step(model, criterion, optimizer,
                           as_step_schedule(lr_fn, STEPS_PER_EPOCH), kind, NCLS,
                           None, amb, cfg.grad_norm_clip)
    sorted_by_forward, loss_sorts, given = [], [], []
    sort_stages, margin = spatial.sort_stages, pcontrast.point_contrast_margin

    def forward_sort(stages):
        sorted_by_forward.append(sort_stages(stages))
        return sorted_by_forward[-1]

    def recording_margin(p, *args, cloud=None, **kwargs):
        given.append((p, cloud))
        return margin(p, *args, cloud=cloud, **kwargs)

    with mock.patch.object(spatial, "sort_stages", forward_sort), \
            mock.patch.object(pcontrast, "sort_stages",
                              lambda *a: loss_sorts.append(a)), \
            mock.patch.object(pcontrast, "point_contrast_margin",
                              recording_margin):
        _replay(step, model, optimizer, ref, 1,
                ("loss",) if kind == "aa" else MM_TERMS)
        assert len(sorted_by_forward) == 1 and not loss_sorts
        assert [len(c) for c in sorted_by_forward] == [5]
        layouts = {id(c) for c in sorted_by_forward[0]}
        assert len(given) == 4
        for p, cloud in given:
            assert id(cloud) in layouts
            spatial.check_layout(cloud, p)
        model.eval()
        with torch.no_grad():
            batch = {k: _t(v) for k, v in ref["batch"].items()}
            model(batch["pos"], batch["x"])
        assert len(sorted_by_forward) == 2 and not loss_sorts


def test_mm_train_step_with_ground_truth_ambiguity():
    """``source: AEF``: the step hands the labels to the model, whose
    refinement then follows the ground-truth ambiguity; the rate differs
    from the APM-driven one and every term stays finite."""
    rng = np.random.RandomState(5)
    batch = {"pos": _t((rng.randint(0, 1024, (2, 512, 3)) / 256).astype(np.float32)),
             "x": _t(rng.rand(2, 512, 4).astype(np.float32)),
             "y": _t(rng.randint(0, 3, (2, 512)))}
    rates = {}
    for source in ("APM", "AEF"):
        amb = {**MM_AMB, "source": source}
        model = BaseSeg_M_AMContrast3D(**{**MM_ARGS, "AEF_args": amb})
        init_weights_(model, torch.Generator().manual_seed(0))
        optimizer = build_optimizer_from_cfg(MM_CFG.optimizer, model, lr=MM_CFG.lr)
        step = make_train_step(
            model, build_criterion_from_cfg(MM_CFG.criterion_args_AcePre),
            optimizer, MM_CFG.lr, "mm", NCLS, None, amb, MM_CFG.grad_norm_clip)
        out = step(batch)
        assert all(np.isfinite(out[k].item()) for k in MM_TERMS)
        rates[source] = out["refine_rate"].item()
    assert 0 < rates["AEF"] < 100 and rates["AEF"] != rates["APM"]


def test_free_running_losses_follow_jax(reference):
    """3 steps from the same start without resynchronising: the losses
    drift apart by the chaotic growth of the step-1 differences above
    (measured 1.5e-6, 6.5e-4 and 7.5e-3 relative)."""
    batch = {k: _t(v) for k, v in reference["batch"].items()}
    model = _port_model(reference["variables"])
    optimizer = build_optimizer_from_cfg(CFG.optimizer, model, lr=CFG.lr)
    lr_fn, _ = build_scheduler_from_cfg(dict(CFG))
    step = make_train_step(model, build_criterion_from_cfg(CFG.criterion_args_Ace),
                           optimizer, as_step_schedule(lr_fn, STEPS_PER_EPOCH),
                           "aa", NCLS, None, AMB, CFG.grad_norm_clip)
    losses = [step(batch)["loss"].item() for _ in range(STEPS)]
    np.testing.assert_allclose(losses[0], reference["losses"][0], rtol=1e-5)
    np.testing.assert_allclose(losses, reference["losses"], rtol=2e-2)
    assert losses[-1] < losses[0]


def test_optimizer_chain_matches_optax():
    """AdamW with the ndim>1 decay mask, the global-norm clip and the
    per-epoch cosine schedule, over 5 steps of fixed gradients (some
    above the clip norm, some below), against optax's ``build_tx`` chain:
    parameters to 1e-6."""
    rng = np.random.RandomState(9)
    init = {"w": rng.randn(6, 5).astype(np.float32),
            "b": rng.randn(5).astype(np.float32)}
    grads = [{k: (rng.randn(*v.shape) * s).astype(np.float32)
              for k, v in init.items()} for s in (10, 0.5, 3, 0.01, 8)]
    lr_fn, _ = jax_scheduler(dict(CFG))
    tx = _jax_tx()
    params = {k: jnp.asarray(v) for k, v in init.items()}
    opt_state = tx.init(params)

    class Tiny(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(_t(init["w"]).clone())
            self.b = torch.nn.Parameter(_t(init["b"]).clone())

    tiny = Tiny()
    optimizer = build_optimizer_from_cfg(CFG.optimizer, tiny, lr=CFG.lr)
    assert [len(g["params"]) for g in optimizer.param_groups] == [1, 1]
    schedule = as_step_schedule(build_scheduler_from_cfg(dict(CFG))[0],
                                STEPS_PER_EPOCH)
    for s, g in enumerate(grads):
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                       opt_state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
        tiny.w.grad, tiny.b.grad = _t(g["w"]).clone(), _t(g["b"]).clone()
        clip_by_global_norm_(list(tiny.parameters()), CFG.grad_norm_clip)
        for group in optimizer.param_groups:
            group["lr"] = schedule(s)
        optimizer.step()
        for k in init:
            np.testing.assert_allclose(getattr(tiny, k).detach().numpy(),
                                       np.asarray(params[k]), rtol=1e-6,
                                       atol=1e-6, err_msg=f"{k} step {s}")


def test_schedule_matches_jax():
    cfg = dict(CFG)
    for over in ({}, {"warmup_epochs": 5}):
        c = {**cfg, **over}
        got, epochs = build_scheduler_from_cfg(c)
        want, jepochs = jax_scheduler(c)
        assert epochs == jepochs == 150
        for e in range(0, 160):
            # JAX evaluates in float32: terms of size lr round to ~1e-9
            np.testing.assert_allclose(got(e), float(want(e)), rtol=1e-6,
                                       atol=1e-9)
    sched = as_step_schedule(lambda e: float(e), 4)
    assert [sched(s) for s in (0, 3, 4, 9)] == [1.0, 1.0, 2.0, 3.0]
    # the other schedules are ported (tests/test_torch_port_traincli.py);
    # a name neither package knows raises in both
    for build in (build_scheduler_from_cfg, jax_scheduler):
        with pytest.raises(ValueError, match="not supported"):
            build({**cfg, "sched": "sawtooth"})
    # every optimizer of the JAX table is ported
    # (tests/test_torch_port_optim.py), adahessian too
    # (tests/test_torch_port_adahessian.py): its rule refuses a step without
    # the Hutchinson diagonal
    linear = torch.nn.Linear(2, 2)
    optimizer = build_optimizer_from_cfg({"NAME": "adahessian"}, linear)
    linear.weight.grad = torch.ones(2, 2)
    with pytest.raises(ValueError, match="Hutchinson"):
        optimizer.step()
    optimizer.step(hess=[torch.ones(2, 2), torch.ones(2)])
    assert torch.isfinite(linear.weight).all()


class _SeedNet(torch.nn.Module):
    """Keeps the dropout generator's seed of every forward."""

    def __init__(self):
        super().__init__()
        self.lin = torch.nn.Linear(4, NCLS)
        self.seeds = []

    def forward(self, pos, x, generator=None):
        self.seeds.append(generator.initial_seed())
        return self.lin(x)


def test_dropout_seeds_of_two_seeds_share_no_step():
    """Step s reseeds the dropout generator with ``fold_in(seed, s)``
    (↔ ``jax.random.fold_in(PRNGKey(seed), s)``): a rerun takes the same
    seeds, and the runs of seeds 43 and 143 (the delta gate's seeds 42 and
    142, plus one) share none over 200 steps, where ``seed + s`` gave them
    100 in common, step s + 100 of one being step s of the other."""
    from amcontrast3d_tpu_torch.utils.random import fold_in
    rng = np.random.RandomState(3)
    batch = {"pos": _t(rng.rand(2, 16, 3).astype(np.float32)),
             "x": _t(rng.rand(2, 16, 4).astype(np.float32)),
             "y": _t(rng.randint(0, NCLS, (2, 16)))}

    def run(seed, steps=200):
        model = _SeedNet()
        step = make_train_step(
            model, lambda logits, y: torch.nn.functional.cross_entropy(
                logits.reshape(-1, NCLS), y.reshape(-1)),
            torch.optim.SGD(model.parameters(), lr=0.01), 0.01, "base", NCLS,
            generator=torch.Generator().manual_seed(seed))
        for _ in range(steps):
            step(batch)
        return model.seeds

    first = run(43)
    assert first == [fold_in(43, s) for s in range(200)]
    assert run(43, 3) == first[:3]
    assert not set(first) & set(run(143))
    assert len(set(first)) == 200
    assert all(0 <= x < 2 ** 63 for x in first)
    assert len(set(range(43, 243)) & set(range(143, 343))) == 100


def test_dropout_masks_follow_the_seed_and_the_step():
    """With dropout on, two runs from one seed take identical steps, and
    a run from another seed does not."""
    rng = np.random.RandomState(3)
    batch = {"pos": _t((rng.randint(0, 1024, (2, 512, 3)) / 256).astype(np.float32)),
             "x": _t(rng.rand(2, 512, 4).astype(np.float32)),
             "y": _t(rng.randint(0, NCLS, (2, 512)))}

    def run(seed):
        model = BaseSeg_AMContrast3D(encoder_args=ENCODER, decoder_args={},
                                     cls_args={**CLS, "dropout": 0.5})
        init_weights_(model, torch.Generator().manual_seed(0))
        optimizer = build_optimizer_from_cfg(CFG.optimizer, model, lr=CFG.lr)
        step = make_train_step(
            model, build_criterion_from_cfg(CFG.criterion_args_Ace), optimizer,
            CFG.lr, "aa", NCLS, None, AMB, CFG.grad_norm_clip,
            torch.Generator().manual_seed(seed))
        return [step(batch)["loss"].item() for _ in range(2)]

    first = run(11)
    assert run(11) == first
    assert run(12) != first
    with pytest.raises(NotImplementedError):
        make_train_step(torch.nn.Linear(2, 2), None,
                        torch.optim.SGD(torch.nn.Linear(2, 2).parameters(), 0.1),
                        0.1, "sharded", NCLS)
