"""The port's train CLI on two data-parallel gloo ranks on the CPU.

``main_cli --device cpu world_size=2`` spawns the ranks.  The train set is
one Synthetic room taken whole (no crop, no shuffle, no random transform)
twice a batch, so each rank's row of a batch is the same cloud: the mean
over the ranks is then the one-process mean (as the JAX package's
``test_sharded_multiepoch_equals_single_device`` tiles its batches), and
the two-rank run can be held against one process.  Tolerance: the first
loss of a resumed run 1e-5 relative (the ranks' BatchNorms normalise by
the inference kernel with the gathered statistics, one process's by the
training kernel).  No JAX here.
"""
import functools
import glob
import json
import os
import shutil

import numpy as np
import pytest
import torch
import yaml

from amcontrast3d_tpu_torch import parallel
from amcontrast3d_tpu_torch.engine import cli


def _tiny_cfg(tmp_path):
    """The traincli tests' tiny configuration with a train set of one whole
    room twice: one step an epoch of B = 2."""
    cfg = {
        "dataset": {
            "common": {"NAME": "Synthetic", "num_rooms": 1, "n_points": 1200,
                       "voxel_size": 0.04},
            "train": {"split": "train", "voxel_max": 100000, "variable": True,
                      "shuffle": False, "loop": 2},
            "val": {"split": "val", "voxel_max": 256},
        },
        "feature_keys": "x,heights", "num_classes": 13, "batch_size": 2,
        "val_batch_size": 1, "eval_bucket": 256, "epochs": 2, "val_freq": 1,
        "seed": 2, "sched": "cosine", "lr": 0.01, "min_lr": 1.0e-5,
        "optimizer": {"NAME": "adamw", "weight_decay": 1.0e-4},
        "grad_norm_clip": 10, "root_dir": str(tmp_path / "log"),
        "log_dir": "synthetic",
        "datatransforms": {
            "train": ["PointCloudXYZAlign", "ChromaticNormalize"],
            "val": ["PointCloudXYZAlign", "ChromaticNormalize"],
            "kwargs": {"gravity_dim": 2}},
        "ambiguity_args": {"action": False, "vis": False, "nsample": 8,
                           "ccbeta": 0.04, "cctype": "Method2",
                           "temperature": 0.3, "supervisedCL": "Method1",
                           "db": "-m", "margin": "adaptive", "mu": -1,
                           "nu": 0.5, "miou_B_I": False, "w1": 0.1, "w2": 0.9,
                           "w3": 0.01, "stages": "up", "stages_num": 2,
                           "source": "APM", "source_mode": "Train"},
        "criterion_args_Ace": {"NAME": "CrossEntropyAce",
                               "label_smoothing": 0.2},
        "model": {
            "NAME": "BaseSeg_AMContrast3D",
            "encoder_args": {
                "NAME": "PointNextEncoder_AMContrast3D",
                "blocks": [1, 1, 1], "strides": [1, 4, 4], "sa_layers": 1,
                "sa_use_res": False, "width": 8, "in_channels": 4,
                "expansion": 4, "radius": 0.3, "nsample": 8,
                "aggr_args": {"feature_type": "dp_fj", "reduction": "max"},
                "group_args": {"NAME": "ballquery", "normalize_dp": True},
                "conv_args": {"order": "conv-norm-act"},
                "act_args": {"act": "relu"}, "norm_args": {"norm": "bn"}},
            "decoder_args": {"NAME": "PointNextDecoder_AMContrast3D",
                             "decoder_stages": 2},
            "cls_args": {"NAME": "SegHead", "num_classes": 13,
                         "in_channels": None, "norm_args": {"norm": "bn"},
                         "dropout": 0}},
    }
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def test_two_rank_train_cli_writes_from_rank_0_and_resumes_as_one_rank(
        tmp_path, monkeypatch):
    """Two epochs on two ranks: only rank 0 writes ``latest`` and ``best``,
    the scalars (one row a tag and epoch) and the log file, and both epochs'
    losses are one process's.  ``mode=resume`` on two ranks then carries
    on from ``latest``: its first loss is that of a one-rank resume of the
    same checkpoint."""
    monkeypatch.setattr(parallel, "launch",
                        functools.partial(parallel.launch, timeout=600))
    argv = ["--cfg", _tiny_cfg(tmp_path), "--device", "cpu"]
    two = cli.main_cli("aa", argv + ["world_size=2"])
    run_dir = two["run_dir"]
    ckpts = sorted(os.path.basename(p)
                   for p in glob.glob(os.path.join(run_dir, "checkpoint", "*")))
    assert len(ckpts) == 2 and ckpts[0].endswith("_ckpt_best.ckpt") \
        and ckpts[1].endswith("_ckpt_latest.ckpt")
    assert not glob.glob(os.path.join(run_dir, "*rank*"))
    rows = [json.loads(line)
            for line in open(os.path.join(run_dir, "scalars.jsonl"))]
    assert sorted(r["step"] for r in rows if r["tag"] == "train_loss") == [1, 2]
    latest = os.path.join(run_dir, "checkpoint", ckpts[1])
    blob = torch.load(latest, weights_only=False)
    assert blob["epoch"] == 2 and blob["step"] == 2

    one = cli.main_cli("aa", argv + ["world_size=1"])
    np.testing.assert_allclose([t["loss"] for t in two["timing"]],
                               [t["loss"] for t in one["timing"]], rtol=1e-5)

    # the one-rank resume reads a copy in a run directory of its own
    single = tmp_path / "single" / "checkpoint"
    single.mkdir(parents=True)
    shutil.copy(latest, single / ckpts[1])
    resumed = {}
    for world, path in ((2, latest), (1, str(single / ckpts[1]))):
        res = cli.main_cli("aa", argv + [f"world_size={world}", "mode=resume",
                                         "epochs=3", f"pretrained_path={path}"])
        (record,) = res["timing"]
        assert record["epoch"] == 3 and record["steps"] == 1
        resumed[world] = record["loss"]
    np.testing.assert_allclose(resumed[2], resumed[1], rtol=1e-5)
    assert torch.load(latest, weights_only=False)["step"] == 3


def test_runner_refuses_ranks_it_is_not_one_of(tmp_path):
    """A cfg asking for two CPU ranks in a process outside a process group
    raises naming ``distributed``; ``distributed=False`` runs it on one."""
    from amcontrast3d_tpu_torch.engine.runner import Runner
    from amcontrast3d_tpu_torch.utils import EasyConfig

    cfg = EasyConfig()
    cfg.load(_tiny_cfg(tmp_path), recursive=True)
    cfg.world_size = 2
    with pytest.raises(RuntimeError, match="distributed"):
        Runner(cfg, kind="aa", device="cpu")
    cfg.distributed = False
    runner = Runner(cfg, kind="aa", device="cpu")
    assert not runner.distributed and runner.rank == 0
