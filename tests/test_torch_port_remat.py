"""Remat (``encoder_args.remat``, ``ambiguity_args.remat``) and the
bfloat16 train step, on the CPU.

Remat checkpoints each set abstraction and block of the encoder and each
stage's margin loss (``torch.utils.checkpoint``, not reentrant).  A train
step with either or both switches on gives the loss, every gradient, every
parameter after AdamW and every BatchNorm statistic of the step without
them, bit for bit, from one state (small AA and MM models, width 16, two
clouds of three stages of 512 / 128 / 32 points, on the gather tail and the
fused tail, float32 and bfloat16); counters show that the recompute runs no FPS, ball
query, sort, kNN, threshold selection or contrast forward, and that every
BatchNorm moved its statistics once.

The plain twins of the fused aggregation's kernels (20 and 21) at
bfloat16 are held against their float32 twins on bfloat16-representable
inputs: the same float32 arithmetic, so ext, the tie count and the
moments are identical and du is the rounding of the float32 twin's.

``test_bf16_train_step_matches_jax``: one AA step's loss and gradients at
bfloat16 against the JAX package's ``jax.grad`` of its loss built with
``dtype=jnp.bfloat16``, with and without remat.  The ball radii (0.4, then
0.8) give a ball about 8 neighbours in these clouds of 1024 and 256 points
in [0, 4)³.
"""
import copy
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amcontrast3d_tpu.engine import train as jtrain
from amcontrast3d_tpu.loss import build_criterion_from_cfg as jax_criterion
from amcontrast3d_tpu.models import BaseSeg_AMContrast3D as JaxAA
from amcontrast3d_tpu_torch import ops
from amcontrast3d_tpu_torch.engine import make_train_step
from amcontrast3d_tpu_torch.loss import build_criterion_from_cfg
from amcontrast3d_tpu_torch.loss import contrast as pcontrast
from amcontrast3d_tpu_torch.models import (BaseSeg_AMContrast3D,
                                           BaseSeg_M_AMContrast3D, init_weights_)
from amcontrast3d_tpu_torch.models import pointnext as ppn
from amcontrast3d_tpu_torch.ops import aggregate as pagg
from amcontrast3d_tpu_torch.ops import contrast as pops_contrast
from amcontrast3d_tpu_torch.ops import spatial
from amcontrast3d_tpu_torch.ops.knn import set_knn_backend
from amcontrast3d_tpu_torch.optim import build_optimizer_from_cfg
from amcontrast3d_tpu_torch.utils.config import EasyConfig
from amcontrast3d_tpu_torch.utils.convert import from_jax_variables

B, N, NCLS = 2, 1024, 13
CFGS = Path(__file__).resolve().parent.parent / "cfgs" / "s3dis"
AA_CFG, MM_CFG = EasyConfig(), EasyConfig()
AA_CFG.load(str(CFGS / "AMContrast3D-AA.yaml"), recursive=True)
MM_CFG.load(str(CFGS / "AMContrast3D-MM.yaml"), recursive=True)
# two decoder stages: the contrast and the ground-truth ambiguity over both
AMB = {**dict(AA_CFG.ambiguity_args), "stages_num": 2}
MM_AMB = {**dict(MM_CFG.ambiguity_args), "stages_num": 2}
NSAMPLE = AMB["nsample"]
ENCODER = dict(
    NAME="PointNextEncoder_AMContrast3D", blocks=[1, 2, 2],
    strides=[1, 4, 4], sa_layers=1, sa_use_res=False, width=16,
    in_channels=4, expansion=4, radius=0.4, nsample=16,
    aggr_args={"feature_type": "dp_fj", "reduction": "max"},
    group_args={"NAME": "ballquery", "normalize_dp": True},
    conv_args={"order": "conv-norm-act"}, act_args={"act": "relu"},
    norm_args={"norm": "bn"})
DECODER = {"decoder_stages": 2}
CLS = dict(NAME="SegHead", num_classes=NCLS, in_channels=None,
           norm_args={"norm": "bn"}, dropout=0)
MM_ARGS = dict(
    encoder_args={**ENCODER, "NAME": "PointNextEncoder_M_AMContrast3D"},
    decoder_args=DECODER, cls_args=CLS, AEF_args=MM_AMB,
    APM_args={**dict(MM_CFG.model.APM_args), "feature_dim": [16, 32],
              "channel": [8, 4], "dropout": [0, 0], "threshold": 0.5})


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _stage_clouds(pos):
    """The positions of the two contrast stages (stride 4) and each stage
    point's index into ``pos``."""
    stages, origs = [pos], [np.broadcast_to(np.arange(pos.shape[1]), pos.shape[:2])]
    prev = _t(pos)
    idx = ops.furthest_point_sample(prev, prev.shape[1] // 4)
    stages.append(ops.gather_points(prev, idx).numpy())
    origs.append(np.take_along_axis(origs[0], idx.long().numpy(), 1))
    return stages, origs


def _batch(rng, n=N):
    """B clouds of ``n`` positions on a 1/256 grid in [0, 4)³, redrawn where
    a stage point's k-th and (k+1)-th neighbour tie (the port's threshold
    neighbourhoods and JAX's K slots agree only without such ties); Voronoi
    labels."""
    pos = (rng.randint(0, 1024, (B, n, 3)) / 256).astype(np.float32)
    for _ in range(50):
        bad = np.zeros((B, n), bool)
        for ps, orig in zip(*_stage_clouds(pos)):
            d2 = np.sort(((ps[:, :, None].astype(np.float64) - ps[:, None]) ** 2)
                         .sum(-1), -1).astype(np.float32)
            kth = d2[..., NSAMPLE - 1] * np.float32(1.0 + 1e-5)
            ok = (d2[..., 1] > 0) & (d2[..., NSAMPLE] > kth)
            for b in range(B):
                bad[b, orig[b][~ok[b]]] = True
        if not bad.any():
            break
        pos[bad] = rng.randint(0, 1024, (int(bad.sum()), 3)) / 256
    else:
        raise AssertionError("no tie-free cloud")
    centres = rng.rand(B, NCLS, 3) * 4
    y = ((pos[:, :, None] - centres[:, None]) ** 2).sum(-1).argmin(-1)
    return {"pos": pos, "x": rng.rand(B, n, 4).astype(np.float32),
            "y": y.astype(np.int64)}


@pytest.fixture(scope="module")
def batch():
    return _batch(np.random.RandomState(0))


@pytest.fixture(scope="module")
def small_batch():
    """Two clouds of 512 points, tie-free as ``batch``."""
    return _batch(np.random.RandomState(1), 512)


def _model(kind, dtype, remat: bool):
    encoder = {**ENCODER, "remat": remat}
    if kind == "aa":
        return BaseSeg_AMContrast3D(encoder_args=encoder, decoder_args=DECODER,
                                    cls_args=CLS, dtype=dtype)
    args = dict(MM_ARGS, encoder_args={**MM_ARGS["encoder_args"],
                                       "remat": remat})
    return BaseSeg_M_AMContrast3D(**args, dtype=dtype)


COUNTED = ((ppn, "furthest_point_sample"), (ppn, "ball_query"),
           (spatial, "sort_stages"), (pcontrast, "sort_stages"),
           (pcontrast, "knn"), (pops_contrast, "contrast_select"),
           (pops_contrast, "contrast_forward_plain"),
           (ppn, "grouped_slot_reduce"))


def _counted_step(kind, dtype, remat, enc_remat, batch):
    """One ``make_train_step`` step (AdamW, clip) of a freshly seeded model
    with ``remat`` for the loss and ``enc_remat`` for the encoder; returns
    (loss, gradients, parameters and buffers after the step, calls of each
    counted function, the model)."""
    cfg, amb = (AA_CFG, AMB) if kind == "aa" else (MM_CFG, MM_AMB)
    model = _model(kind, dtype, enc_remat)
    init_weights_(model, torch.Generator().manual_seed(3))
    criterion = build_criterion_from_cfg(
        cfg.criterion_args_Ace if kind == "aa" else cfg.criterion_args_AcePre)
    optimizer = build_optimizer_from_cfg(cfg.optimizer, model, lr=cfg.lr)
    step = make_train_step(model, criterion, optimizer, 0.01, kind, NCLS, None,
                           {**amb, "remat": remat}, cfg.grad_norm_clip)
    calls = {}

    def counting(name, fn):
        def wrapper(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **k)
        return wrapper

    patches = [mock.patch.object(mod, name, counting(
        f"{mod.__name__.rsplit('.', 1)[-1]}.{name}", getattr(mod, name)))
        for mod, name in COUNTED]
    for patch in patches:
        patch.start()
    try:
        out = step({k: _t(v) for k, v in batch.items()})
    finally:
        for patch in patches:
            patch.stop()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return out["loss"], grads, copy.deepcopy(model.state_dict()), calls, model


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("kind", ["aa", "mm"])
def test_remat_step_is_identical(small_batch, kind, fused, dtype):
    """With ``encoder_args.remat`` and ``ambiguity_args.remat`` (each alone
    and both), a train step from one state gives the same loss, gradients,
    parameters after AdamW and BatchNorm statistics as the step without, bit
    for bit; its recompute runs no FPS, ball query, sort, kNN, selection or
    contrast forward (the same calls as without remat) and only the
    encoder's aggregations again (``grouped_slot_reduce`` on the fused
    tail: once more a set abstraction or block); every BatchNorm moved its
    running statistics once (``num_batches_tracked`` 1).  The steps take
    two clouds of 512 points (B = 2: the BatchNorm statistics and the
    contrast's stages span both clouds)."""
    try:
        pagg.set_agg_fused("on" if fused else "off")
        runs = {flags: _counted_step(kind, dtype, *flags, small_batch)
                for flags in ((False, False), (True, False), (False, True),
                              (True, True))}
    finally:
        pagg.set_agg_fused("off")
    loss, grads, state, calls, model = runs[False, False]
    assert torch.isfinite(loss)
    aggregations = sum(1 for n, _ in model.named_modules()
                       if n.startswith("encoder.enc") and n.count(".") == 1
                       and not n.endswith("enc0_sa"))
    for (remat, enc_remat), (l2, g2, s2, c2, _) in runs.items():
        assert torch.equal(l2, loss), (remat, enc_remat)
        for name, g in grads.items():
            assert torch.equal(g2[name], g), (name, remat, enc_remat)
        for name, v in state.items():
            assert torch.equal(s2[name], v), (name, remat, enc_remat)
        want = dict(calls)
        if enc_remat and fused:
            want["pointnext.grouped_slot_reduce"] += aggregations
        assert c2 == want, (remat, enc_remat, c2, want)
    assert calls["pointnext.furthest_point_sample"] == 2
    assert calls.get("pointnext.grouped_slot_reduce", 0) == (
        aggregations if fused else 0)
    tracked = [v for n, v in runs[True, True][2].items()
               if n.endswith("num_batches_tracked")]
    assert tracked and all(int(v) == 1 for v in tracked)


@pytest.mark.parametrize("backend", ["exact", "approx"])
def test_ambiguity_remat_keeps_the_kernels_outputs(backend):
    """``contrast_head`` with ``ambiguity_args.remat``: the same loss and
    feature gradients bit for bit, the threshold (kNN or selection) and the
    contrast forward called as often as without remat (once a stage), the
    two halves of the VJP once a stage."""
    rng = np.random.RandomState(4)
    p0 = (rng.randint(0, 512, (2, 512, 3)) / 128).astype(np.float32)
    ups = [(_t(p0), rng.randn(2, 512, 8).astype(np.float32)),
           (_t(np.ascontiguousarray(p0[:, ::4])),
            rng.randn(2, 128, 8).astype(np.float32))]
    target = _t(rng.randint(0, 5, (2, 512)))
    args = dict(nsample=8, ccbeta=0.04, cctype="Method2", stages_num=2,
                temperature=0.3, mu=1.0, nu=0.1, margin="adaptive")
    res = []
    try:
        set_knn_backend("approx" if backend == "approx" else "auto")
        for remat in (False, True):
            feats = [_t(f).requires_grad_() for _, f in ups]
            calls = {}
            real = {n: getattr(pops_contrast, n) for n in
                    ("contrast_select", "contrast_forward_plain", "_grad_plain")}
            real_knn = pcontrast.knn

            def count(name, fn):
                def wrapper(*a, **k):
                    calls[name] = calls.get(name, 0) + 1
                    return fn(*a, **k)
                return wrapper
            with mock.patch.object(pcontrast, "knn", count("knn", real_knn)), \
                    mock.patch.multiple(pops_contrast, **{
                        n: count(n, f) for n, f in real.items()}):
                loss, _ = pcontrast.contrast_head(
                    [(p, f) for (p, _), f in zip(ups, feats)], target, 5, None,
                    dict(args, remat=remat))
                loss.backward()
            res.append((loss.detach(), [f.grad for f in feats], calls))
    finally:
        set_knn_backend("auto")
    (l0, g0, c0), (l1, g1, c1) = res
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert c0 == c1
    assert c0["contrast_forward_plain"] == 2 and c0["_grad_plain"] == 2
    assert c0.get("contrast_select", 0) == (2 if backend == "approx" else 0)


@pytest.mark.parametrize("stats,with_qp", [(True, True), (True, False),
                                           (False, False)])
def test_bf16_twins_hold_the_float32_twins(stats, with_qp):
    """The plain twins of kernels 20 and 21 on a bfloat16 ``u`` against the
    float32 twins on the same values: ext, the tie count, su and sq
    identical (the same float32 arithmetic after an exact widening); du
    bfloat16, the float32 twin's du rounded, and its float32 accumulator
    that du itself."""
    rng = np.random.RandomState(9)
    n, m, c, k = 400, 100, 12, 16
    u = _t(rng.randn(2, n, c).astype(np.float32)).bfloat16()
    idx = _t(rng.randint(0, n, (2, m, k)).astype(np.int32))
    idx[:, :, k // 2:] = idx[:, :, :1]                      # repeated slots
    sgn = _t(np.where(rng.rand(c) < 0.5, -1.0, 1.0).astype(np.float32))
    qp = _t(rng.randn(2, m, c).astype(np.float32)) if with_qp else None
    got = ops.aggregate_forward(u, idx, sgn, qp, stats, keep_ties=True)
    want = ops.aggregate_forward_plain(u.float(), idx, sgn, qp, stats,
                                       keep_ties=True)
    for a, b in zip(got, want):
        assert (a is None and b is None) or torch.equal(a, b)
    assert got[0].dtype == torch.float32
    gs = [_t(rng.randn(2, m, c).astype(np.float32))
          for _ in range(3 if stats else 1)]
    acc = torch.empty(u.shape, dtype=torch.float32)
    du = ops.aggregate_backward(u, idx, qp, got[0], got[3], *gs,
                                accumulator=acc)
    du32 = ops.aggregate_backward_plain(u.float(), idx, qp, want[0], want[3],
                                        *gs)
    assert du.dtype == torch.bfloat16
    assert torch.equal(acc, du32) and torch.equal(du, du32.bfloat16())


# ---- the bfloat16 train step against JAX ------------------------------------

@pytest.fixture(scope="module")
def jax_steps(batch):
    """JAX's AA model: the initial variables, and per compute type (bfloat16
    and float32) the loss and the gradients of one step (``jax.grad`` of
    the train step's loss)."""
    criterion = jax_criterion(AA_CFG.criterion_args_Ace)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    variables, out = None, {}
    for name, dtype in (("bf16", jnp.bfloat16), ("f32", jnp.float32)):
        model = JaxAA(encoder_args=ENCODER, decoder_args=DECODER, cls_args=CLS,
                      dtype=dtype)
        if variables is None:
            variables = jax.jit(lambda p, x: model.init(
                {"params": jax.random.PRNGKey(0)}, p, x, training=False))(
                jbatch["pos"], jbatch["x"])

        def loss_fn(params, batch_stats, b, key, model=model):
            return jtrain._forward_loss(model, criterion, "aa", NCLS, None, AMB,
                                        params, batch_stats, b, key)[0]
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
            variables["params"], variables["batch_stats"], jbatch,
            jax.random.PRNGKey(1))
        out[name] = (float(loss), {k: v.numpy().astype(np.float64) for k, v in
                                   from_jax_variables({"params": tree(grads)}).items()})
    return tree(variables), out


@pytest.mark.parametrize("remat", [False, True])
def test_bf16_train_step_matches_jax(batch, jax_steps, remat):
    """One AA step at bfloat16 (both remats off, then both on) against
    JAX's at bfloat16 from the same weights.  The loss within
    1e-2·(1+|loss|) (measured 1.7e-3 relative).  At bfloat16 this small
    model's gradients are dominated by rounding, which flips max-pool
    winners: JAX's own bfloat16 gradient lies 27 % (relative L2 over all
    parameters) from its float32 one, the port's float32 gradient 3e-5
    from JAX's.  So the port's bfloat16 gradient is held to JAX's own
    spread: each tensor within 2× the distance between JAX's bfloat16 and
    float32 gradients of that tensor (plus 1e-4·√n, for the biases ahead of
    a BatchNorm, whose exact gradient is 0; measured at most 1.54×), and
    within 1.5× over all parameters (measured 1.05×)."""
    variables, ref = jax_steps
    jloss, jgrads = ref["bf16"]
    spread = ref["f32"][1]
    model = _model("aa", torch.bfloat16, remat)
    model.load_state_dict(from_jax_variables(variables), strict=True)
    model.train()
    b = {k: _t(v) for k, v in batch.items()}
    logits, stages = model(b["pos"], b["x"])
    assert logits.dtype == torch.bfloat16
    loss = build_criterion_from_cfg(AA_CFG.criterion_args_Ace)(
        logits, b["y"], list(zip(stages["p"], stages["f_up"])), NCLS, None,
        {**AMB, "remat": remat}, clouds=stages["clouds"])
    assert loss.dtype == torch.float32
    loss.backward()
    assert abs(loss.item() - jloss) <= 1e-2 * (1 + abs(jloss)), (loss.item(), jloss)
    got = dict(model.named_parameters())
    assert set(got) == set(jgrads)
    num = den = own = 0.0
    off = {}
    for name, g in jgrads.items():
        diff = np.linalg.norm(got[name].grad.numpy() - g)
        apart = np.linalg.norm(spread[name] - g)
        if diff > 2 * apart + 1e-4 * np.sqrt(g.size):
            off[name] = (diff, apart)
        num, den, own = num + diff ** 2, den + np.sum(g ** 2), own + apart ** 2
    assert not off, off
    assert np.sqrt(num) <= 1.5 * np.sqrt(own), (np.sqrt(num / den),
                                                np.sqrt(own / den))
