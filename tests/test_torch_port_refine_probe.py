"""Refinement-sensitivity probe of the port: the DualMasks path's effect on
the end metric, with the method of ``tests/test_refine_probe.py``.

Parity tests hold the refinement's numerics to the JAX package; this probe
holds its effect.  A small MM model is trained on the hard synthetic rooms
through the port's ``main_cli`` on the CPU (8 epochs, 3 rooms of 3000
points, 512-point crops, B = 2).  At eval the decoder features of exactly
the high-ambiguity points (the refinement's own self-mask, with the
ground-truth AEF ambiguity) are corrupted, and DualMasks must recover more
than 1 val mIoU and 1 val OA over the same model with the refinement off
(γ = 0), with the refine rate in 1-60 %.  A refinement that is inert (a
wrong mask, a wrong neighbour, a wrong blend) loses the recovery and fails
here.
"""
import glob

import numpy as np
import pytest
import torch
import yaml
import torch_threads  # noqa: F401  (one thread in an xdist worker)

from amcontrast3d_tpu_torch.data import build_dataloader_from_cfg
from amcontrast3d_tpu_torch.engine.cli import main_cli
from amcontrast3d_tpu_torch.engine.runner import _prep_batch
from amcontrast3d_tpu_torch.models import build_model_from_cfg
from amcontrast3d_tpu_torch.models import pointnext as ppn
from amcontrast3d_tpu_torch.utils import ConfusionMatrix, EasyConfig
from amcontrast3d_tpu_torch.utils.ckpt import load_checkpoint

NCLS = 13


@pytest.fixture
def mm_cfg(tmp_path):
    """``tests/test_refine_probe.py``'s configuration, as it is."""
    cfg = {
        "dataset": {
            "common": {"NAME": "Synthetic", "num_rooms": 3, "n_points": 3000,
                       "voxel_size": 0.04, "hard": True},
            "train": {"split": "train", "voxel_max": 512, "loop": 6},
            "val": {"split": "val", "voxel_max": 512},
            "test": {"split": "val", "voxel_max": 512},
        },
        "feature_keys": "x,heights",
        "num_classes": NCLS,
        "batch_size": 2,
        "val_batch_size": 2,
        "eval_bucket": 512,
        "epochs": 8,
        "val_freq": 2,
        "seed": 0,
        "criterion_args_AcePre": {"NAME": "CrossEntropyAcePre"},
        "sched": "cosine", "lr": 0.01, "min_lr": 1.0e-5,
        "optimizer": {"NAME": "adamw", "weight_decay": 1.0e-4},
        "grad_norm_clip": 10,
        "root_dir": str(tmp_path / "log"),
        "log_dir": "probe",
        "datatransforms": {
            "train": ["PointCloudXYZAlign", "ChromaticNormalize"],
            "val": ["PointCloudXYZAlign", "ChromaticNormalize"],
            "kwargs": {"gravity_dim": 2},
        },
        "ambiguity_args": {"action": False, "vis": False, "nsample": 8,
                           "ccbeta": 0.04, "cctype": "Method2",
                           "temperature": 0.3, "supervisedCL": "Method1",
                           "db": "-m", "margin": "adaptive", "mu": -1,
                           "nu": 0.5, "miou_B_I": False, "w1": 0.1,
                           "w2": 0.9, "w3": 0.01, "stages": "up",
                           "stages_num": 2, "source": "APM",
                           "source_mode": "Train"},
        "model": {
            "NAME": "BaseSeg_M_AMContrast3D",
            "encoder_args": {
                "NAME": "PointNextEncoder_M_AMContrast3D",
                "blocks": [1, 1, 1], "strides": [1, 4, 4], "sa_layers": 1,
                "sa_use_res": False, "width": 16, "in_channels": 4,
                "expansion": 4, "radius": 0.1, "nsample": 8,
                "aggr_args": {"feature_type": "dp_fj", "reduction": "max"},
                "group_args": {"NAME": "ballquery", "normalize_dp": True},
                "conv_args": {"order": "conv-norm-act"},
                "act_args": {"act": "relu"}, "norm_args": {"norm": "bn"},
            },
            "decoder_args": {"NAME": "PointNextDecoder_M_AMContrast3D",
                             "decoder_stages": 2},
            "cls_args": {"NAME": "SegHead", "num_classes": NCLS,
                         "in_channels": None, "norm_args": {"norm": "bn"}},
            "APM_args": {"NAME": "APM_pf_ConCate",
                         "feature_dim": [16, 32],
                         "linear_mapping": False, "cross_attention": False,
                         "feat_concate": False,
                         "channel": [32, 16, 8, 4, 2],
                         "dropout": [0, 0, 0, 0, 0],
                         "nsample_k": 8, "threshold": 0.6,
                         "threshold_max": 1.0, "gamma": 1, "fusion": "MIN",
                         "att_dim": 3},
        },
        "distributed": False,
    }
    cfg["model"]["AEF_args"] = dict(cfg["ambiguity_args"])
    path = tmp_path / "mm_probe.yaml"
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path)


def _eval_variant(model, batches, corrupt: bool, refine_on: bool):
    """(val mIoU, val OA, mean refine rate) with the decoder's
    ``dual_masks`` wrapped: the self-masked (high-ambiguity) features first
    corrupted or not, then either the real refinement or the features
    passed through (γ = 0)."""
    real = ppn.dual_masks

    def wrapper(p, f, a, nsample_k, fusion, thr, thr_max, gamma, cloud=None):
        mask = (a >= thr) & (a <= thr_max)
        if corrupt:
            # a sign flip: far out of distribution after the ReLU towers,
            # where rolled rows would stay spatially smooth
            f = torch.where(mask[..., None], -f, f)
        if refine_on:
            return real(p, f, a, nsample_k, fusion, thr, thr_max, gamma, cloud)
        return f, mask.float().mean() * 100.0

    ppn.dual_masks = wrapper
    try:
        cm = ConfusionMatrix(NCLS)
        rates = []
        with torch.no_grad():
            for b in batches:
                logits, _, rate = model(torch.from_numpy(b["pos"]),
                                        torch.from_numpy(b["x"]),
                                        target=torch.from_numpy(b["y"]))
                cm.update(logits.argmax(-1).numpy().ravel(), b["y"].ravel())
                rates.append(float(rate))
    finally:
        ppn.dual_masks = real
    miou, _, oa, _, _ = cm.all_metrics()
    return float(miou), float(oa), float(np.mean(rates))


def test_dualmasks_recovers_corrupted_boundary_features(mm_cfg, tmp_path):
    results = main_cli("mm", argv=["--device", "cpu", "--cfg", mm_cfg])
    assert np.isfinite(results["best_val"])
    best = glob.glob(str(tmp_path / "log" / "probe" / "*" / "checkpoint" /
                         "*best*.ckpt"))[0]

    cfg = EasyConfig()
    cfg.load(mm_cfg, recursive=True)
    # the probe model: the ground-truth (AEF) ambiguity drives the
    # refinement, so "the high-ambiguity points" is a label-derived set
    mcfg = dict(cfg.model)
    mcfg["AEF_args"] = {**dict(mcfg["AEF_args"]), "source": "AEF"}
    model = build_model_from_cfg(mcfg)
    load_checkpoint(model, best)
    model.eval()

    loader = build_dataloader_from_cfg(cfg.val_batch_size, cfg.dataset, None,
                                       cfg.datatransforms, split="val", seed=0)
    try:
        batches = [_prep_batch(b, cfg) for b in loader]
    finally:
        loader.close()
    assert batches and all(b["pos"].shape[1] == 512 for b in batches)

    clean_miou, clean_oa, rate = _eval_variant(model, batches, corrupt=False,
                                               refine_on=True)
    corr_ref_miou, corr_ref_oa, _ = _eval_variant(model, batches, corrupt=True,
                                                  refine_on=True)
    corr_off_miou, corr_off_oa, _ = _eval_variant(model, batches, corrupt=True,
                                                  refine_on=False)
    print(f"probe: clean {clean_miou:.2f}/{clean_oa:.2f}  "
          f"corrupt+refine {corr_ref_miou:.2f}/{corr_ref_oa:.2f}  "
          f"corrupt+off {corr_off_miou:.2f}/{corr_off_oa:.2f}  "
          f"refine_rate {rate:.1f}%")

    # the self-mask hits a real, non-degenerate share of the points
    assert 1.0 < rate < 60.0, f"refine rate {rate:.1f}% out of sane band"
    # the corruption hurts the unrefined model (else the probe is vacuous)
    assert corr_off_oa < clean_oa - 1.0, (corr_off_oa, clean_oa)
    # and DualMasks recovers a measurable share of the damage
    assert corr_ref_miou > corr_off_miou + 1.0, (corr_ref_miou, corr_off_miou)
    assert corr_ref_oa > corr_off_oa + 1.0, (corr_ref_oa, corr_off_oa)
