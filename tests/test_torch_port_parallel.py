"""The port's data parallelism against the JAX package's sharded steps, on
the CPU.

The port runs one process a rank: two gloo ranks are spawned once for the
module (``parallel.launch``, a ``file://`` rendezvous in a temporary
directory) and run every case in turn, each on its rows of the same global
batch; the JAX side runs ``make_sharded_*_step`` on a mesh of 2 of the 8
host devices that ``tests/conftest.py`` makes.  This module imports JAX
only inside the functions that use it, since the ranks import it too.

Inputs are made from numpy seeds.  The models are small: the AA and MM
models of ``tests/test_torch_port_train.py`` with one block a stage (width
16), B = 2 clouds of 2048 points (one a rank) on a 1/256 grid in [0, 4)³,
tie-free for the contrast stages as there, dropout off.  JAX's variables
cross with ``from_jax_variables``.

Tolerances (as the port's one-device tests hold the same functions): the
synced BatchNorm's output and input gradient 1e-5·(1+max), its running
statistics 1e-6·(1+max); the synced GroupStatsBN's output 1e-5·(1+max),
its running statistics 1e-5·(1+max) and its input gradients 1e-4·(1+max)
(the JAX kernel splits γ into two bfloat16 pieces); the train steps, each
replayed from JAX's state before it: loss and aux terms 1e-5 relative,
batch statistics 1e-4·(1+max), the confusion matrix up to argmax
near-ties, parameters within the bounds of
``test_torch_port_train.py::test_train_steps_match_jax`` (Adam turns a
gradient whose sign rounding flips into an update of order lr); eval
logits 1e-4·(1+max|logit|).  Two ranks on a batch of one cloud tiled twice
against one process on the cloud: loss 1e-5 relative, gradients and batch
statistics 1e-5·(1+max): the synced statistics combine the ranks' means
and variances, one process's are torch's own; with remat, bit for bit the
step without.
"""
import os
import pickle

import numpy as np
import pytest
import torch
from torch import nn

from amcontrast3d_tpu_torch import ops, parallel
from amcontrast3d_tpu_torch.engine import make_eval_step, make_predict_step, make_train_step
from amcontrast3d_tpu_torch.loss import build_criterion_from_cfg
from amcontrast3d_tpu_torch.models import (BaseSeg_AMContrast3D,
                                           BaseSeg_M_AMContrast3D)
from amcontrast3d_tpu_torch.models.layers import Dropout, batch_norm
from amcontrast3d_tpu_torch.models.pointnext import group_stats_bn
from amcontrast3d_tpu_torch.optim import build_optimizer_from_cfg
from amcontrast3d_tpu_torch.scheduler import (as_step_schedule,
                                              build_scheduler_from_cfg)
from amcontrast3d_tpu_torch.utils import dist_utils
from amcontrast3d_tpu_torch.utils.config import EasyConfig
from amcontrast3d_tpu_torch.utils.convert import (from_jax_variables,
                                                  load_jax_train_state)
from torch_threads import default_threads  # noqa: F401

# tolerances read with torch's default thread count (tests/torch_threads.py)
pytestmark = pytest.mark.usefixtures("default_threads")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, B, N, NCLS, STEPS, STEPS_PER_EPOCH = 2, 2, 2048, 13, 2, 2


def _cfg(name):
    cfg = EasyConfig()
    cfg.load(os.path.join(REPO, "cfgs", "s3dis", name), recursive=True)
    return cfg


CFG, MM_CFG = _cfg("AMContrast3D-AA.yaml"), _cfg("AMContrast3D-MM.yaml")
AMB, MM_AMB = dict(CFG.ambiguity_args), dict(MM_CFG.ambiguity_args)
NSAMPLE = AMB["nsample"]
ENCODER = dict(
    NAME="PointNextEncoder_AMContrast3D", blocks=[1, 1, 1, 1, 1],
    strides=[1, 4, 4, 4, 4], sa_layers=1, sa_use_res=False, width=16,
    in_channels=4, expansion=4, radius=0.1, nsample=32,
    aggr_args={"feature_type": "dp_fj", "reduction": "max"},
    group_args={"NAME": "ballquery", "normalize_dp": True},
    conv_args={"order": "conv-norm-act"}, act_args={"act": "relu"},
    norm_args={"norm": "bn"})
CLS = dict(NAME="SegHead", num_classes=NCLS, in_channels=None,
           norm_args={"norm": "bn"}, dropout=0)
AA_ARGS = dict(encoder_args=ENCODER, decoder_args={}, cls_args=CLS)
MM_ARGS = dict(
    encoder_args={**ENCODER, "NAME": "PointNextEncoder_M_AMContrast3D"},
    decoder_args={}, cls_args=CLS, AEF_args=MM_AMB,
    APM_args={**dict(MM_CFG.model.APM_args), "feature_dim": [16, 32, 64, 128],
              "channel": [8, 4, 2], "dropout": [0, 0, 0], "threshold": 0.5})
KINDS = {"aa": (AA_ARGS, CFG, AMB, ("loss",)),
         "mm": (MM_ARGS, MM_CFG, MM_AMB,
                ("loss", "loss_seg", "loss_ce", "loss_contrast", "loss_reg",
                 "refine_rate"))}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, tol, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    err = np.abs(got - want).max()
    assert err <= tol * (1 + np.abs(want).max()), (name, err)


# ---- inputs ----------------------------------------------------------------

def _stage_clouds(pos):
    """The contrast stages' positions (the model's FPS, stride 4) and each
    stage point's index into ``pos``."""
    stages = [pos]
    origs = [np.broadcast_to(np.arange(pos.shape[1]), pos.shape[:2])]
    for _ in range(3):
        prev = _t(stages[-1])
        idx = ops.furthest_point_sample(prev, prev.shape[1] // 4)
        stages.append(ops.gather_points(prev, idx).numpy())
        origs.append(np.take_along_axis(origs[-1], idx.long().numpy(), 1))
    return stages, origs


def _batch(rng, b=B):
    """Grid clouds whose contrast neighbourhoods have no tie at the
    NSAMPLE-th neighbour (see ``tests/test_torch_port_train.py``), and
    Voronoi labels."""
    pos = (rng.randint(0, 1024, (b, N, 3)) / 256).astype(np.float32)
    for _ in range(50):
        bad = np.zeros((b, N), bool)
        for ps, orig in zip(*_stage_clouds(pos)):
            d2 = np.sort(((ps[:, :, None].astype(np.float64) - ps[:, None]) ** 2)
                         .sum(-1), -1).astype(np.float32)
            kth = d2[..., NSAMPLE - 1] * np.float32(1.0 + 1e-5)
            ok = (d2[..., 1] > 0) & (d2[..., NSAMPLE] > kth)
            for i in range(b):
                bad[i, orig[i][~ok[i]]] = True
        if not bad.any():
            break
        pos[bad] = rng.randint(0, 1024, (int(bad.sum()), 3)) / 256
    else:
        raise AssertionError("no tie-free cloud")
    centres = rng.rand(b, NCLS, 3) * 4
    y = ((pos[:, :, None] - centres[:, None]) ** 2).sum(-1).argmin(-1)
    return {"pos": pos, "x": rng.rand(b, N, 4).astype(np.float32),
            "y": y.astype(np.int64)}


def _port_model(kind, variables, remat=False):
    cls = BaseSeg_AMContrast3D if kind == "aa" else BaseSeg_M_AMContrast3D
    args = dict(KINDS[kind][0])
    args["encoder_args"] = {**args["encoder_args"], "remat": remat}
    model = cls(**args)
    model.load_state_dict(from_jax_variables(variables), strict=True)
    return model


def _port_step(kind, model, distributed, generator=None, remat=False):
    _, cfg, amb, _ = KINDS[kind]
    amb = {**amb, "remat": remat}
    crit = cfg.criterion_args_Ace if kind == "aa" else cfg.criterion_args_AcePre
    optimizer = build_optimizer_from_cfg(cfg.optimizer, model, lr=cfg.lr)
    lr_fn, _ = build_scheduler_from_cfg(dict(cfg))
    step = make_train_step(model, build_criterion_from_cfg(crit), optimizer,
                           as_step_schedule(lr_fn, STEPS_PER_EPOCH), kind,
                           NCLS, None, amb, cfg.grad_norm_clip, generator,
                           distributed=distributed)
    return step, optimizer


def _capture_gradients(optimizer):
    """The gradients AdamW sees at each step (after the all_reduce and the
    clip), kept in the returned list."""
    seen = []
    optimizer.register_step_pre_hook(lambda opt, *_: seen.append(
        [p.grad.clone() for g in opt.param_groups for p in g["params"]]))
    return seen


# ---- what each rank runs ---------------------------------------------------

def _bn_case(rank, case):
    bn = batch_norm(case["x"].shape[-1])
    bn.load_state_dict(case["state"])
    parallel.sync_batchnorm_(bn)
    x = _t(parallel.shard_batch({"x": case["x"]})["x"]).requires_grad_()
    w = _t(parallel.shard_batch({"w": case["w"]})["w"])
    y = bn.train()(x)
    (y * w).sum().backward()
    parallel.all_reduce_gradients_(bn.parameters())
    return {"y": y.detach().numpy(), "dx": x.grad.numpy(),
            "dscale": bn.weight.grad.numpy(), "dbias": bn.bias.grad.numpy(),
            "mean": bn.running_mean.numpy(), "var": bn.running_var.numpy()}


def _gsbn_case(rank, case):
    bn = group_stats_bn(case["u"].shape[-1])
    bn.load_state_dict(case["state"])
    parallel.sync_batchnorm_(bn)
    local = parallel.shard_batch({k: case[k] for k in ("u", "qp", "idx", "w")})
    u = _t(local["u"]).requires_grad_()
    qp = _t(local["qp"]).requires_grad_()
    y = bn.train().pool(u, qp, _t(local["idx"]), torch.relu)
    (y * _t(local["w"])).sum().backward()
    return {"y": y.detach().numpy(), "du": u.grad.numpy(),
            "dqp": qp.grad.numpy(), "mean": bn.running_mean.numpy(),
            "var": bn.running_var.numpy()}


def _replay_case(kind, rank, ref):
    """Each step from JAX's state before it, on this rank's rows."""
    model = _port_model(kind, ref["states"][0])
    parallel.sync_batchnorm_(model)
    step, optimizer = _port_step(kind, model, distributed=True)
    batch = {k: _t(v) for k, v in parallel.shard_batch(ref["batch"]).items()}
    calls = [0]
    for m in model.modules():
        if isinstance(m, nn.BatchNorm1d):
            m.register_forward_pre_hook(lambda *_: calls.__setitem__(0, calls[0] + 1))
    out = []
    for i in range(STEPS):
        st = ref["states"][i]
        load_jax_train_state(model, optimizer, st, st["mu"], st["nu"],
                             st["count"])
        step.state["step"] = i
        parallel.reset_counts()
        calls[0] = 0
        metrics = step(batch)
        out.append({"metrics": {k: v.numpy() for k, v in metrics.items()},
                    "state": {k: v.numpy().copy()
                              for k, v in model.state_dict().items()},
                    "collectives": dict(parallel.COUNTS),
                    "batchnorm_calls": calls[0]})
    return out


def _eval_case(rank, ref):
    model = _port_model("aa", ref["states"][-1])
    parallel.sync_batchnorm_(model)
    batch = {k: _t(v) for k, v in parallel.shard_batch(ref["batch"]).items()}
    out = make_eval_step(model, NCLS, None, distributed=True)(batch)
    logits = make_predict_step(model)(batch)
    return {"logits": out["logits"].numpy(), "cm": out["cm"].numpy(),
            "predict": logits.numpy()}


def _tiled_case(rank, ref):
    """One step on the global batch of one cloud tiled twice, without and
    with both remats (the encoder's and the loss's)."""
    tiled = {k: np.concatenate([v[:1]] * WORLD) for k, v in ref["batch"].items()}
    out = {}
    for remat in (False, True):
        model = _port_model("aa", ref["states"][0], remat)
        parallel.sync_batchnorm_(model)
        step, optimizer = _port_step("aa", model, distributed=True, remat=remat)
        seen = _capture_gradients(optimizer)
        parallel.reset_counts()
        metrics = step({k: _t(v) for k, v in parallel.shard_batch(tiled).items()})
        out[remat] = {
            "loss": metrics["loss"].item(), "cm": metrics["cm"].numpy(),
            "grads": [g.numpy() for g in seen[0]],
            "state": {k: v.numpy().copy() for k, v in model.state_dict().items()},
            "collectives": dict(parallel.COUNTS)}
    return out


class _DropNet(nn.Module):
    """A Linear and a dropout whose masks it keeps (kind ``base``)."""

    def __init__(self):
        super().__init__()
        self.lin = nn.Linear(4, NCLS)
        self.drop = Dropout(0.5)
        self.masks = []

    def forward(self, pos, x, generator=None):
        h = self.drop(self.lin(x), generator)
        self.masks.append((h == 0).numpy().copy())
        return h


def _dropout_masks(distributed, runs=2):
    """The masks of two steps, drawn twice from a fresh step each time."""
    rng = np.random.RandomState(3)
    batch = {"pos": _t(rng.rand(2, 64, 3).astype(np.float32)),
             "x": _t(rng.rand(2, 64, 4).astype(np.float32)),
             "y": _t(rng.randint(0, NCLS, (2, 64)))}
    out = []
    for _ in range(runs):
        torch.manual_seed(0)
        model = _DropNet()
        optimizer = torch.optim.AdamW(model.parameters(), lr=0.01)
        step = make_train_step(
            model, lambda logits, y: nn.functional.cross_entropy(
                logits.reshape(-1, NCLS), y.reshape(-1)),
            optimizer, 0.01, "base", NCLS,
            generator=torch.Generator().manual_seed(11),
            distributed=distributed)
        for _ in range(2):
            step(batch)
        out.append(model.masks)
    return out


def _rank_cases(rank, device, inputs, out_dir):
    torch.set_num_threads(2)      # beside the other test workers' threads
    with open(inputs, "rb") as f:
        ref = pickle.load(f)
    res = {"bn": _bn_case(rank, ref["bn"]), "gsbn": _gsbn_case(rank, ref["gsbn"]),
           "eval": _eval_case(rank, ref["aa"]),
           "tiled": _tiled_case(rank, ref["aa"]),
           "dropout": _dropout_masks(distributed=True),
           "dist_utils": (dist_utils.get_dist_info(),
                          dist_utils.reduce_tensor(torch.tensor([rank + 1.0])),
                          dist_utils.gather_tensor(torch.tensor([rank])))}
    for kind in KINDS:
        res[kind] = _replay_case(kind, rank, ref[kind])
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


# ---- the JAX side ----------------------------------------------------------

def _np_tree(t):
    import jax
    return jax.tree_util.tree_map(np.asarray, t)


def _jax_bn(rng):
    """flax ``BatchNorm(axis_name='dp')`` under ``shard_map`` on a mesh of
    2: output, input gradient, pmean'd parameter gradients, and the running
    statistics after the step."""
    import jax
    import jax.numpy as jnp
    from flax import linen as fnn
    from jax.sharding import PartitionSpec as P
    from amcontrast3d_tpu.engine.train import _get_shard_map
    from amcontrast3d_tpu.parallel import get_mesh

    c = 8
    x = (rng.randn(4, 96, c) * 2 + 0.5).astype(np.float32)
    w = rng.randn(4, 96, c).astype(np.float32)
    params = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
              "bias": (0.1 * rng.randn(c)).astype(np.float32)}
    stats = {"mean": (0.1 * rng.randn(c)).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                       axis_name="dp", dtype=jnp.float32)

    def local(params, stats, x, w):
        def f(params, x):
            y, upd = bn.apply({"params": params, "batch_stats": stats}, x,
                              mutable=["batch_stats"])
            return jnp.sum(y * w), (y, upd["batch_stats"])
        (_, (y, upd)), (gp, gx) = jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True)(params, x)
        return y, gx, jax.lax.pmean(gp, "dp"), upd

    fn = jax.jit(_get_shard_map()(
        local, mesh=get_mesh(WORLD), in_specs=(P(), P(), P("dp"), P("dp")),
        out_specs=(P("dp"), P("dp"), P(), P()), check_vma=False))
    y, gx, gp, upd = _np_tree(fn(params, stats, x, w))
    state = from_jax_variables({"params": {"BatchNorm_0": params},
                                "batch_stats": {"BatchNorm_0": stats}})
    return ({"x": x, "w": w,
             "state": {k.split(".", 1)[1]: v for k, v in state.items()}},
            {"y": y, "dx": gx, "dscale": gp["scale"], "dbias": gp["bias"],
             "mean": upd["mean"], "var": upd["var"]})


def _jax_gsbn(rng):
    """The JAX fused tail's ``GroupStatsBN(axis_name='dp')`` (the Pallas
    kernels in interpret mode, as the JAX package runs them on the CPU)
    under ``shard_map`` on a mesh of 2."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from amcontrast3d_tpu.engine.train import _get_shard_map
    from amcontrast3d_tpu.models.pointnext import GroupStatsBN
    from amcontrast3d_tpu.parallel import get_mesh

    n, m, k, c, radius = 300, 90, 8, 12, 0.2
    sup = (rng.randint(0, 64, (4, n, 3)) / 64).astype(np.float32)
    q = np.ascontiguousarray(sup[:, rng.permutation(n)[:m]])
    idx = ops.ball_query(_t(sup), _t(q), radius, k).numpy()
    u = rng.randn(4, n, c).astype(np.float32)
    qp = (0.3 * rng.randn(4, m, c)).astype(np.float32)
    w = rng.randn(4, m, c).astype(np.float32)
    params = {"scale": np.where(rng.rand(c) < 0.5, -1.0, 1.0).astype(np.float32)
              * rng.uniform(0.5, 1.5, c).astype(np.float32),
              "bias": (0.1 * rng.randn(c)).astype(np.float32)}
    stats = {"mean": (0.1 * rng.randn(c)).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}
    gs = GroupStatsBN(use_running_average=False, axis_name="dp")

    def local(sup, q, u, qp, idx, w):
        def f(u, qp):
            y, upd = gs.apply({"params": params, "batch_stats": stats}, sup,
                              q, u, qp, idx, radius, jax.nn.relu,
                              mutable=["batch_stats"])
            return jnp.sum(y * w), (y, upd["batch_stats"])
        (_, (y, upd)), (du, dqp) = jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True)(u, qp)
        return y, du, dqp, upd

    d = P("dp")
    fn = jax.jit(_get_shard_map()(
        local, mesh=get_mesh(WORLD), in_specs=(d, d, d, d, d, d),
        out_specs=(d, d, d, P()), check_vma=False))
    y, du, dqp, upd = _np_tree(fn(sup, q, u, qp, idx, w))
    state = from_jax_variables({"params": {"BatchNorm_0": params},
                                "batch_stats": {"BatchNorm_0": stats}})
    return ({"u": u, "qp": qp, "idx": idx, "w": w,
             "state": {k.split(".", 1)[1]: v for k, v in state.items()}},
            {"y": y, "du": du, "dqp": dqp, "mean": upd["mean"],
             "var": upd["var"]})


def _jax_sharded(kind, batch):
    """``make_sharded_train_step`` on a mesh of 2 for STEPS steps (the
    state before each and after the last), then the sharded eval and
    predict steps on the last state (AA)."""
    import jax
    import jax.numpy as jnp
    from amcontrast3d_tpu.engine import train as jtrain
    from amcontrast3d_tpu.loss import build_criterion_from_cfg as jax_criterion
    from amcontrast3d_tpu.models import BaseSeg_AMContrast3D as JaxAA
    from amcontrast3d_tpu.models import BaseSeg_M_AMContrast3D as JaxMM
    from amcontrast3d_tpu.parallel import get_mesh, replicate, shard_batch
    from amcontrast3d_tpu.scheduler import as_step_schedule as jax_schedule
    from amcontrast3d_tpu.scheduler import build_scheduler_from_cfg as jax_sched

    args, cfg, amb, _ = KINDS[kind]
    model = (JaxAA if kind == "aa" else JaxMM)(**args, bn_axis_name="dp")
    crit = jax_criterion(cfg.criterion_args_Ace if kind == "aa"
                         else cfg.criterion_args_AcePre)
    lr_fn, _ = jax_sched(dict(cfg))
    tx = jtrain.build_tx(cfg.optimizer, jax_schedule(lr_fn, STEPS_PER_EPOCH),
                         cfg.grad_norm_clip)
    local = {k: jnp.asarray(v[:1]) for k, v in batch.items()}
    variables = jax.jit(lambda p, x: model.init(
        {"params": jax.random.PRNGKey(0)}, p, x, training=False))(
        local["pos"], local["x"])
    mesh = get_mesh(WORLD)
    state = replicate(jtrain.TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"])), mesh)
    sbatch = shard_batch({k: jnp.asarray(v) for k, v in batch.items()}, mesh)
    step = jtrain.make_sharded_train_step(jtrain.make_train_step(
        model, crit, tx, kind, NCLS, None, amb, axis_name="dp"), mesh)
    rng = replicate(jax.random.PRNGKey(1), mesh)
    states, metrics = [], []
    for _ in range(STEPS):
        adam = state.opt_state[1][0]
        states.append({"params": _np_tree(state.params),
                       "batch_stats": _np_tree(state.batch_stats),
                       "mu": _np_tree(adam.mu), "nu": _np_tree(adam.nu),
                       "count": int(adam.count)})
        state, m = step(state, sbatch, rng)
        metrics.append(_np_tree(m))
    states.append({"params": _np_tree(state.params),
                   "batch_stats": _np_tree(state.batch_stats)})
    out = {"batch": batch, "states": states, "metrics": metrics}
    if kind == "aa":
        ev = jtrain.make_sharded_eval_step(jtrain.make_eval_step(
            model, kind, NCLS, axis_name="dp"), mesh)
        pr = jtrain.make_sharded_predict_step(jtrain.make_predict_step(model),
                                              mesh)
        out["eval"] = _np_tree(ev(state, sbatch))
        out["predict"] = np.asarray(pr(state, {k: sbatch[k]
                                               for k in ("pos", "x")}))
    return out


# ---- the module's run --------------------------------------------------------

@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """JAX's references, then the two ranks (spawned once) on every case,
    then the one-process runs of the port the ranks are held against."""
    tmp = tmp_path_factory.mktemp("parallel")
    rng = np.random.RandomState(0)
    batch = _batch(rng)
    bn_in, bn_ref = _jax_bn(rng)
    gs_in, gs_ref = _jax_gsbn(rng)
    ref = {"bn": bn_in, "gsbn": gs_in}
    for kind in KINDS:
        ref[kind] = _jax_sharded(kind, batch)
    inputs = str(tmp / "inputs.pkl")
    with open(inputs, "wb") as f:
        pickle.dump({k: ({kk: vv for kk, vv in v.items()
                          if kk not in ("eval", "predict", "metrics")}
                         if k in KINDS else v) for k, v in ref.items()}, f)
    parallel.launch(_rank_cases, WORLD, (inputs, str(tmp)), device_type="cpu",
                    timeout=600)
    ranks = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    # one process on one copy of the tiled cloud
    model = _port_model("aa", ref["aa"]["states"][0])
    step, optimizer = _port_step("aa", model, distributed=False)
    seen = _capture_gradients(optimizer)
    one = {k: _t(v[:1]) for k, v in batch.items()}
    metrics = step(one)
    single = {"loss": metrics["loss"].item(), "cm": metrics["cm"].numpy(),
              "grads": [g.numpy() for g in seen[0]],
              "state": {k: v.numpy() for k, v in model.state_dict().items()}}
    return {"ref": ref, "bn": bn_ref, "gsbn": gs_ref, "ranks": ranks,
            "single": single}


def _joined(ranks, *keys):
    """The ranks' rows of one output, concatenated in rank order."""
    out = []
    for r in ranks:
        for k in keys:
            r = r[k]
        out.append(r)
    return np.concatenate(out)


def test_synced_batchnorm_matches_flax_under_axis_name(run):
    """``ChannelsLastBatchNorm`` with ``sync_batchnorm_`` on two ranks
    against flax ``BatchNorm(axis_name='dp')`` under ``shard_map``: the
    output and the input gradient of Σ y·w (each rank's share of the
    statistics' cotangent reaches every rank, as the VJP of JAX's ``pmean``
    does), the parameter gradients averaged over the ranks, and the running
    statistics, moved from the global batch's mean and biased variance
    (flax's E[x²] − E[x]², the port's the ranks' variances and the spread
    of their means: equal but for rounding on these inputs)."""
    ranks, want = run["ranks"], run["bn"]
    _close(_joined(ranks, "bn", "y"), want["y"], 1e-5, "y")
    _close(_joined(ranks, "bn", "dx"), want["dx"], 1e-5, "dx")
    for r in ranks:
        _close(r["bn"]["dscale"], want["dscale"], 1e-5, "dscale")
        _close(r["bn"]["dbias"], want["dbias"], 1e-5, "dbias")
        _close(r["bn"]["mean"], want["mean"], 1e-6, "mean")
        _close(r["bn"]["var"], want["var"], 1e-6, "var")


def test_synced_group_stats_bn_matches_jax_under_axis_name(run):
    """The fused tail's ``GroupStatsBN.pool`` (the plain twins of kernels 20
    and 21 on the CPU) on two ranks against JAX's ``GroupStatsBN`` with
    ``axis_name='dp'`` (its Pallas kernels in interpret mode): the pooled
    output, the gradients of u and qp through the kernels' moments (every
    rank's share of g_sum and g_sq), the running statistics."""
    ranks, want = run["ranks"], run["gsbn"]
    _close(_joined(ranks, "gsbn", "y"), want["y"], 1e-5, "y")
    _close(_joined(ranks, "gsbn", "du"), want["du"], 1e-4, "du")
    _close(_joined(ranks, "gsbn", "dqp"), want["dqp"], 1e-4, "dqp")
    for r in ranks:
        _close(r["gsbn"]["mean"], want["mean"], 1e-5, "mean")
        _close(r["gsbn"]["var"], want["var"], 1e-5, "var")


@pytest.mark.parametrize("kind", list(KINDS))
def test_two_rank_train_steps_match_jax_sharded_step(run, kind):
    """The port's sharded train step on two ranks, each step replayed from
    the state of JAX's ``make_sharded_train_step`` on a mesh of 2 before it:
    the loss and the aux terms (averaged over the ranks) and the confusion
    matrix (summed) are the same on both ranks and JAX's, the batch
    statistics and the parameters after the step JAX's within the bounds
    of the one-device replay.  Each step's collectives: a train-mode
    BatchNorm call gathers the ranks' moments forward and all-reduces their
    cotangents backward; one all_reduce of the gradients and two of the
    metrics."""
    ref, ranks = run["ref"][kind], run["ranks"]
    terms = KINDS[kind][3]
    lr = KINDS[kind][1].lr
    for i in range(STEPS):
        got = [r[kind][i] for r in ranks]
        want = ref["metrics"][i]
        for key in terms:
            for g in got:
                np.testing.assert_allclose(g["metrics"][key], want[key],
                                           rtol=1e-5, err_msg=f"{key} {i}")
        for g in got:
            cm = g["metrics"]["cm"]
            assert cm.sum() == B * N
            assert np.abs(cm - want["cm"]).sum() <= 2 * B * N * 1e-3
        np.testing.assert_array_equal(got[0]["metrics"]["cm"],
                                      got[1]["metrics"]["cm"])
        target = from_jax_variables(ref["states"][i + 1])
        diffs = []
        for name, w in target.items():
            if name.endswith("num_batches_tracked"):
                continue
            for g in got:
                if name.endswith(("running_mean", "running_var")):
                    _close(g["state"][name], w, 1e-4, name)
                else:
                    diffs.append(np.abs(g["state"][name] - w.numpy()).ravel())
        np.testing.assert_array_equal(
            np.concatenate([v.ravel() for v in got[0]["state"].values()]),
            np.concatenate([v.ravel() for v in got[1]["state"].values()]))
        diffs = np.concatenate(diffs)
        within = {t: (diffs <= t).mean() for t in (1e-5, 1e-4, 1e-3)}
        assert within[1e-5] >= (0.99 if i == 0 else 0.4), (i, within)
        assert within[1e-4] >= 0.9 and within[1e-3] >= 0.99, (i, within)
        assert diffs.max() <= 3 * lr, (i, diffs.max())
        counts, calls = got[0]["collectives"], got[0]["batchnorm_calls"]
        assert calls > 10 and counts["broadcast"] == 0
        assert counts["all_gather"] == calls
        assert counts["all_reduce"] == calls + 3


def test_two_rank_eval_and_predict_match_jax_sharded_steps(run):
    """``make_eval_step(distributed=True)`` and the predict step on each
    rank's rows against ``make_sharded_eval_step`` and
    ``make_sharded_predict_step``: the logits of the local rows, and the
    confusion matrix summed over the ranks (the same on both)."""
    ref, ranks = run["ref"]["aa"], run["ranks"]
    want = ref["eval"]
    _close(_joined(ranks, "eval", "logits"), want["logits"], 1e-4, "logits")
    _close(_joined(ranks, "eval", "predict"), ref["predict"], 1e-4, "predict")
    for r in ranks:
        cm = r["eval"]["cm"]
        assert cm.sum() == B * N
        assert np.abs(cm - want["cm"]).sum() <= 2 * B * N * 1e-3
    np.testing.assert_array_equal(ranks[0]["eval"]["cm"], ranks[1]["eval"]["cm"])


def test_two_ranks_on_a_tiled_batch_equal_one_process(run):
    """Two ranks on one cloud tiled twice (each rank's row the same cloud)
    against one process on that cloud: equal shards make the mean over the
    ranks the one-process mean, so the loss, the gradients AdamW sees, the
    batch statistics and the parameters after the step agree; the
    confusion matrix is twice the one-process one."""
    single = run["single"]
    for r in run["ranks"]:
        got = r["tiled"][False]
        np.testing.assert_allclose(got["loss"], single["loss"], rtol=1e-5)
        np.testing.assert_array_equal(got["cm"], 2 * single["cm"])
        assert len(got["grads"]) == len(single["grads"])
        for g, w in zip(got["grads"], single["grads"]):
            _close(g, w, 1e-5, "grad")
        for name, w in single["state"].items():
            if name.endswith(("running_mean", "running_var")):
                _close(got["state"][name], w, 1e-5, name)


def test_remat_recomputes_the_synced_statistics_without_moving_them(run):
    """The same two-rank step with the encoder's and the loss's remat: the
    recompute runs each synced BatchNorm's forward gather again (the ranks
    recompute in the same order, so the collectives meet) and gives
    the first pass's statistics, so the loss, the gradients and the
    parameters after the step are bit for bit those without remat, and the
    running statistics moved once."""
    for r in run["ranks"]:
        plain, remat = r["tiled"][False], r["tiled"][True]
        assert remat["loss"] == plain["loss"]
        for g, w in zip(remat["grads"], plain["grads"]):
            np.testing.assert_array_equal(g, w)
        for name, w in plain["state"].items():
            np.testing.assert_array_equal(remat["state"][name], w, err_msg=name)
            if name.endswith("num_batches_tracked"):
                assert int(w) == 1
        # the recompute gathers the moments again, the backward is one pass
        counts, once = remat["collectives"], plain["collectives"]
        assert counts["all_gather"] > once["all_gather"]
        assert counts["all_reduce"] == once["all_reduce"]


def test_each_rank_draws_its_own_dropout_masks(run):
    """The dropout generator is seeded from (seed, step, rank): the two
    ranks' masks differ, a rerun draws the same ones, and rank 0's are the
    one-process step's."""
    masks = [r["dropout"] for r in run["ranks"]]
    for m in masks:
        for a, b in zip(m[0], m[1]):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(masks[0][0], masks[1][0]):
        assert (a != b).mean() > 0.2
    for a, b in zip(masks[0][0], _dropout_masks(distributed=False, runs=1)[0]):
        np.testing.assert_array_equal(a, b)


def test_dist_utils_reduce_and_gather_over_the_ranks(run):
    """``utils/dist_utils.py``: each rank's (rank, world size, distributed),
    the mean over the ranks and the gather in rank order; outside a process
    group a process is rank 0 of 1 and both are the identity."""
    for rank, r in enumerate(run["ranks"]):
        info, reduced, gathered = r["dist_utils"]
        assert info == (rank, WORLD, True)
        assert reduced.tolist() == [1.5]
        assert gathered.tolist() == [[0], [1]]
    t = torch.tensor([3.0])
    assert dist_utils.get_dist_info() == (0, 1, False)
    assert dist_utils.reduce_tensor(t) is t and dist_utils.gather_tensor(t) is t


def test_a_batch_the_ranks_cannot_split_raises_naming_batch_size():
    """``shard_batch`` and the loader refuse a batch size that is not a
    multiple of the world size, as JAX's ``device_put`` does."""
    from amcontrast3d_tpu_torch.data.build import NumpyLoader
    batch = {"pos": np.zeros((3, 8, 3), np.float32)}
    with pytest.raises(ValueError, match="batch_size"):
        parallel.shard_batch(batch, rank=0, world_size=2)
    with pytest.raises(ValueError, match="batch_size"):
        NumpyLoader(list(range(6)), 3, rank=1, world_size=2)
    rows = parallel.shard_batch({"pos": np.arange(8)}, rank=1, world_size=4)
    np.testing.assert_array_equal(rows["pos"], [2, 3])


SCENE = ["--cfg", os.path.join(REPO, "cfgs", "synthetic", "AMContrast3D-AA.yaml"),
         "--device", "cpu", "mode=test", "dataset.common.num_rooms=1",
         "dataset.common.n_points=2500", "dataset.common.voxel_size=0.1",
         "dataset.test.voxel_max=None", "eval_bucket=256",
         "ambiguity_args.miou_B_I=True", "ambiguity_args.nsample=8", "seed=3",
         "save_pred=True"]


def test_two_rank_whole_scene_test_votes_as_one_rank(tmp_path, monkeypatch):
    """``main_cli mode=test`` with ``world_size=2`` on the CPU (two gloo
    ranks spawned by the CLI): each bucket's subclouds are scored r, r+2, …
    by rank r and gathered to rank 0, which votes; the voted labels are
    identical to one rank's, and so are the metrics."""
    import functools

    from amcontrast3d_tpu_torch.engine import cli

    monkeypatch.setattr(parallel, "launch",
                        functools.partial(parallel.launch, timeout=600))

    runs = {}
    for world in (1, 2):
        res = cli.main_cli("aa", SCENE + [f"world_size={world}",
                                          f"root_dir={tmp_path / str(world)}"])
        runs[world] = (res, np.loadtxt(os.path.join(
            res["run_dir"], "predictions", "cloud_0.txt"), dtype=np.int64))
    (one, pred1), (two, pred2) = runs[1], runs[2]
    buckets = one["clouds"][0]["buckets"]
    # a bucket of several subclouds, so the ranks share it
    assert max(buckets.count(b) for b in set(buckets)) >= 2
    assert pred1.shape == (one["clouds"][0]["points"],)
    np.testing.assert_array_equal(pred2, pred1)
    np.testing.assert_array_equal(two["cm"].value, one["cm"].value)
    assert two["boundary"] == one["boundary"] and two["inner"] == one["inner"]
