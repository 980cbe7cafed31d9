"""Small AA and MM models in the approx configuration with the fused
aggregation on, in the port and in the JAX package, on the CPU: the weights
carried across by ``from_jax_variables``, then the eval logits, the
train-mode loss and the running statistics.

JAX runs its approx configuration as its own tests run it
(``set_fused_contrast('on')``, ``set_knn_backend('approx')``,
``set_agg_fused('on')``, the Pallas kernels in interpret mode), the port
with ``set_knn_backend('approx')`` and ``set_agg_fused('on')``, all
restored on exit.  Positions lie on a 1/256 grid, where every d² is exact
in both packages.  The MM refinement keeps the port's exact CrossMask in
this configuration, where the TPU's selects the points within the 12th
distinct d²: the two agree where no point has a tie among its 13 smallest
d², so the cloud is drawn without one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amcontrast3d_tpu.loss import build_criterion_from_cfg as jax_criterion
from amcontrast3d_tpu.models import BaseSeg_AMContrast3D as JaxAA
from amcontrast3d_tpu.models import BaseSeg_M_AMContrast3D as JaxMM
from amcontrast3d_tpu_torch import ops
from amcontrast3d_tpu_torch.loss import build_criterion_from_cfg
from amcontrast3d_tpu_torch.models import BaseSeg_AMContrast3D, BaseSeg_M_AMContrast3D
from test_torch_port_approx import ARGS, _approx, _d2_direct, _t

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
           norm_args={"norm": "bn"}, dropout=0)
AMB = dict(ARGS, stages_num=4, w1=0.1, w2=0.9, w3=0.01, stages="up",
           source="APM")
APM = dict(NAME="APM_pf_ConCate", feature_dim=[16, 32, 64, 128],
           linear_mapping=False, cross_attention=False, feat_concate=False,
           channel=[8, 4, 2], dropout=[0, 0, 0], nsample_k=12, threshold=0.5,
           threshold_max=1.0, gamma=1, fusion="MIN", att_dim=3)
CRITERIA = {"aa": dict(NAME="CrossEntropyAce", label_smoothing=0.2),
            "mm": dict(NAME="CrossEntropyAcePre", label_smoothing=0.2)}


def _stage_clouds(pos):
    """The model's four stage clouds (FPS, stride 4) and each stage point's
    index into ``pos``."""
    stages, origs = [pos], [np.broadcast_to(np.arange(pos.shape[1]), pos.shape[:2])]
    for _ in range(3):
        prev = _t(stages[-1])
        idx = ops.furthest_point_sample(prev, prev.shape[1] // 4)
        stages.append(ops.gather_points(prev, idx).numpy())
        origs.append(np.take_along_axis(origs[-1], idx.long().numpy(), 1))
    return stages, origs


def _refine_tie_free_cloud(rng):
    """A 1/256 grid cloud in [0, 4)³ whose stages have no tie among any
    point's 13 smallest d²: the MM refinement's 12 neighbours are then the
    same set in the port's exact kernel and in the TPU's threshold
    selection (a tie before the 12th widens the latter)."""
    pos = (rng.randint(0, 1024, (B, N, 3)) / 256).astype(np.float32)
    for _ in range(60):
        bad = np.zeros((B, N), bool)
        for ps, orig in zip(*_stage_clouds(pos)):
            d2 = np.sort(_d2_direct(ps, ps), -1)[..., :13]
            tie = (np.diff(d2, axis=-1) == 0).any(-1)
            for b in range(B):
                bad[b, orig[b][tie[b]]] = True
        if not bad.any():
            return pos
        pos[bad] = rng.randint(0, 1024, (int(bad.sum()), 3)) / 256
    raise AssertionError("no tie-free cloud")


@pytest.fixture(scope="module")
def model_batch():
    rng = np.random.RandomState(8)
    pos = _refine_tie_free_cloud(rng)
    centres = rng.rand(B, NCLS, 3) * 4
    y = ((pos[:, :, None] - centres[:, None]) ** 2).sum(-1).argmin(-1)
    return {"pos": pos, "x": rng.rand(B, N, 4).astype(np.float32),
            "y": y.astype(np.int64)}


@pytest.mark.parametrize("kind", ["aa", "mm"])
def test_small_model_approx_fused_matches_jax(kind, model_batch):
    """A small AA and MM model (width 16, blocks (1, 2, 3, 2, 2); MM with
    the SelfMask at 0.5, so about half of the points are refined), the
    weights carried across by ``from_jax_variables``, the approx
    configuration and the fused aggregation on in both packages: the eval
    logits within 1e-4·(1+max|logit|), the train-mode loss within 1e-4
    relative, the running statistics within 1e-4·(1+max)."""
    from amcontrast3d_tpu.engine import train as jtrain
    from amcontrast3d_tpu_torch.utils.convert import from_jax_variables

    batch = model_batch
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    if kind == "aa":
        jmodel = JaxAA(encoder_args=ENCODER, decoder_args={}, cls_args=CLS)
        model = BaseSeg_AMContrast3D(encoder_args=ENCODER, decoder_args={},
                                     cls_args=CLS)
    else:
        enc = {**ENCODER, "NAME": "PointNextEncoder_M_AMContrast3D"}
        jmodel = JaxMM(encoder_args=enc, decoder_args={}, cls_args=CLS,
                       AEF_args=AMB, APM_args=APM)
        model = BaseSeg_M_AMContrast3D(encoder_args=enc, decoder_args={},
                                       cls_args=CLS, AEF_args=AMB, APM_args=APM)
    with _approx(fused=True):
        variables = jax.jit(lambda p, x: jmodel.init(
            {"params": jax.random.PRNGKey(0)}, p, x, training=False))(
            jb["pos"], jb["x"])
        model.load_state_dict(from_jax_variables(variables), strict=True)
        jeval = jax.jit(lambda v, p, x: jmodel.apply(v, p, x, training=False)[0])(
            variables, jb["pos"], jb["x"])
        jloss, (jstats, _, jaux) = jax.jit(
            lambda v, b: jtrain._forward_loss(
                jmodel, jax_criterion(CRITERIA[kind]), kind, NCLS, None, AMB,
                v["params"], v["batch_stats"], b, jax.random.PRNGKey(1)))(
            variables, jb)
        model.eval()
        with torch.no_grad():
            logits = model(_t(batch["pos"]), _t(batch["x"]))[0]
        model.train()
        out = model(_t(batch["pos"]), _t(batch["x"]))
        up = list(zip(out[1]["p"], out[1]["f_up"]))
        criterion = build_criterion_from_cfg(CRITERIA[kind])
        if kind == "aa":
            loss = criterion(out[0], _t(batch["y"]), up, NCLS, None, AMB)
        else:
            seg, _, _, reg = criterion(out[0], _t(batch["y"]), up,
                                       out[1]["ambiguity"], NCLS, None, AMB)
            loss = seg + reg
            assert 20 < out[2].item() < 80
            np.testing.assert_allclose(out[2].item(), float(jaux["refine_rate"]),
                                       rtol=1e-6)
    want = np.asarray(jeval)
    err = np.abs(logits.numpy() - want).max()
    assert err <= 1e-4 * (1 + np.abs(want).max()), err
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    stats = from_jax_variables({"batch_stats": jax.tree_util.tree_map(
        np.asarray, jstats)})
    got = model.state_dict()
    for name, w in stats.items():
        if name.endswith(("running_mean", "running_var")):
            err = np.abs(got[name].numpy() - w.numpy()).max()
            assert err <= 1e-4 * (1 + np.abs(w.numpy()).max()), (name, err)
