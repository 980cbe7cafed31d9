"""The port's train CLI against the JAX package on the CPU.

Host modules (train transforms, the loader, the datasets, the schedules,
the plateau scheduler, the freeze labels) are numpy or plain Python in both
packages: the same inputs, made from a seed with numpy, and the same
``np.random.seed`` give equal arrays.  The interpolation VJP's plain twin is
held against the gradient of the JAX package's query-chunked Pallas kernel
in interpret mode.  The trainer as a whole: ``Runner.train`` of both packages
on the tiny configuration of ``tests/test_cli.py`` from carried-over
weights, and the port's ``main_cli`` train → resume → test on the CPU.

Tolerances: host modules exact (the subsampler's barycentres 1e-6: float64
sums in another order); schedules 1e-6 relative (JAX evaluates them in
float32, where terms of the size of lr round to 1e-9); the interpolation
VJP 1e-5; train losses 1e-5 relative at step 1 and 1e-3 free-running.
"""
import copy
import glob
import json
import multiprocessing
import os
import runpy
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import amcontrast3d_tpu.data as jdata
import amcontrast3d_tpu.transforms as jtransforms
from amcontrast3d_tpu.engine.runner import Runner as JaxRunner
from amcontrast3d_tpu.scheduler import as_step_schedule as jax_step_schedule
from amcontrast3d_tpu.scheduler import build_scheduler_from_cfg as jax_scheduler
from amcontrast3d_tpu.scheduler.plateau_lr import PlateauScheduler as JaxPlateau
from amcontrast3d_tpu.utils import EasyConfig as JaxConfig
import amcontrast3d_tpu_torch.data as pdata
import amcontrast3d_tpu_torch.transforms as ptransforms
from amcontrast3d_tpu_torch import ops
from amcontrast3d_tpu_torch.engine import cli as pcli
from amcontrast3d_tpu_torch.engine import runner as prunner
from amcontrast3d_tpu_torch.optim import freeze_parameters_, freeze_pattern
from amcontrast3d_tpu_torch.scheduler import (PlateauScheduler,
                                              as_step_schedule,
                                              build_scheduler_from_cfg)
from amcontrast3d_tpu_torch.utils import EasyConfig
from amcontrast3d_tpu_torch.utils.convert import (checkpoint_from_jax,
                                                  from_jax_variables)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(path, cls=EasyConfig):
    cfg = cls()
    cfg.load(os.path.join(REPO, "cfgs", path), recursive=True)
    return cfg


def _sample(rng, n=400):
    return {"pos": (rng.rand(n, 3) * [4, 3, 2.5]).astype(np.float32),
            "x": (rng.rand(n, 3) * 255).astype(np.float32),
            "y": rng.randint(0, 13, n).astype(np.int64)}


def _equal_dicts(got, want):
    assert set(got) == set(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


# every kwarg the two recipes hand to their transforms, and a mirror / drop
# probability that takes both branches over the seeds below
KWARGS = {**dict(_cfg("s3dis/default.yaml").datatransforms.kwargs),
          **dict(_cfg("scannet/default.yaml").datatransforms.kwargs),
          "scale": [0.8, 1.2], "angle": [0.2, 0.1, 1], "shift": [0.2, 0.2, 0.1],
          "mirror": [0.5, 0.5, -1], "feature_drop": 0.5, "color_drop": 0.5,
          "p": 0.5, "dropout_application_ratio": 0.5}
PER_SAMPLE = sorted(set(jtransforms.DataTransforms.module_dict) - {"Cutmix"})


def test_port_registers_every_transform_of_the_jax_package():
    assert set(ptransforms.DataTransforms.module_dict) == \
        set(jtransforms.DataTransforms.module_dict)
    assert len(PER_SAMPLE) == 29
    assert not hasattr(ptransforms, "NOT_PORTED")


@pytest.mark.parametrize("name", PER_SAMPLE)
def test_transform_matches_jax(name):
    """One class a case: equal arrays under one ``np.random.seed``, over
    seeds that take both sides of every random branch."""
    kwargs = dict(KWARGS)
    if name == "RandomRotateZ":
        kwargs["angle"] = 1.0
    if name in ("RandomScale", "RandomScaleAndJitter", "RandomScaleAndTranslate"):
        kwargs["mirror"] = [0.5, -1, -1]
    theirs = jtransforms.DataTransforms.build(name, **kwargs)
    ours = ptransforms.DataTransforms.build(name, **kwargs)
    moved = False
    for seed in range(6):
        data = _sample(np.random.RandomState(seed))
        np.random.seed(seed)
        want = theirs(copy.deepcopy(data))
        np.random.seed(seed)
        got = ours(copy.deepcopy(data))
        _equal_dicts(got, want)
        moved |= any(got[k].shape != data[k].shape
                     or got[k].dtype != data[k].dtype
                     or not np.array_equal(got[k], data[k]) for k in data) \
            or set(got) != set(data)
    assert moved or name in ("PointsToTensor", "PointCloudToTensor"), name


def test_cutmix_matches_jax():
    rng = np.random.RandomState(2)
    batch = {"pos": rng.rand(4, 50, 3).astype(np.float32),
             "x": rng.rand(4, 50, 3).astype(np.float32)}
    target = rng.randint(0, 13, (4, 50))
    outs = []
    for mod in (jtransforms, ptransforms):
        np.random.seed(5)
        cut = mod.DataTransforms.build("Cutmix", num_classes=13)
        data, mixed = cut(copy.deepcopy(batch), target.copy())
        outs.append((data, mixed))
    _equal_dicts(outs[1][0], outs[0][0])
    np.testing.assert_array_equal(outs[1][1], outs[0][1])
    np.testing.assert_array_equal(
        ptransforms.mixup_target(target, 13, 0.3, 0.1),
        jtransforms.mixup_target(target, 13, 0.3, 0.1))


@pytest.mark.parametrize("recipe", ["s3dis", "scannet"])
@pytest.mark.parametrize("split", ["train", "val"])
def test_recipe_pipeline_matches_jax(recipe, split):
    """The recipe's whole transform list, as the loaders build it."""
    cfg = _cfg(f"{recipe}/default.yaml")
    theirs = jtransforms.build_transforms_from_cfg(split, cfg.datatransforms)
    ours = ptransforms.build_transforms_from_cfg(split, cfg.datatransforms)
    assert [type(t).__name__ for t in ours.transforms] == \
        list(cfg.datatransforms[split])
    for seed in range(4):
        data = _sample(np.random.RandomState(10 + seed), 700)
        np.random.seed(seed)
        want = theirs(copy.deepcopy(data))
        np.random.seed(seed)
        got = ours(copy.deepcopy(data))
        _equal_dicts(got, want)
        assert got["pos"].dtype == np.float32


# ---------------------------------------------------------------------------
# the loader
# ---------------------------------------------------------------------------

SYNTH = {"common": {"NAME": "Synthetic", "num_rooms": 3, "n_points": 2500,
                    "voxel_size": 0.08},
         "train": {"split": "train", "voxel_max": 200, "loop": 3},
         "val": {"split": "val", "voxel_max": 200}}
TRANSFORMS = {"train": ["ChromaticAutoContrast", "PointCloudScaling",
                        "PointCloudXYZAlign", "PointCloudJitter",
                        "ChromaticNormalize"],
              "val": ["PointCloudXYZAlign", "ChromaticNormalize"],
              "kwargs": {"gravity_dim": 2, "scale": [0.9, 1.1]}}


@pytest.mark.parametrize("split,batch", [("train", 2), ("train", 4), ("val", 2)])
def test_loader_batches_match_jax(split, batch):
    """Same index batches per epoch, equal batches from one seed, and
    ``drop_last`` for the train split only (9 samples: 4 or 2 batches)."""
    loaders = [mod.build_dataloader_from_cfg(batch, SYNTH, None, TRANSFORMS,
                                             split=split, seed=7)
               for mod in (jdata, pdata)]
    assert len(loaders[0]) == len(loaders[1]) == \
        {("train", 2): 4, ("train", 4): 2, ("val", 2): 2}[(split, batch)]
    for epoch in (1, 2):
        batches = []
        for loader in loaders:
            loader.set_epoch(epoch)
            np.random.seed(100 + epoch)
            batches.append(list(loader))
        for a, b in zip(loaders[0]._index_batches(), loaders[1]._index_batches()):
            np.testing.assert_array_equal(a, b)
        assert len(batches[0]) == len(batches[1]) == len(loaders[0])
        for want, got in zip(*batches):
            _equal_dicts(got, want)
            assert got["pos"].shape == (len(got["y"]), 200, 3)
    first = [np.concatenate(list(loaders[1]._index_batches()))]
    loaders[1].set_epoch(3)
    first.append(np.concatenate(list(loaders[1]._index_batches())))
    assert (split == "train") == (not np.array_equal(*first))


def test_loader_collates_and_reraises():
    samples = [{"pos": np.zeros((n, 3), np.float32), "y": np.arange(n)}
               for n in (3, 5)]
    for mod in (jdata, pdata):
        packed = mod.concat_collate_fn(samples)
        assert packed["pos"].shape == (8, 3)
        np.testing.assert_array_equal(packed["offset"], [3, 8])

    class Broken:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            raise KeyError(f"item {i}")

    with pytest.raises(KeyError, match="item"):
        list(pdata.NumpyLoader(Broken(), 2))


def test_loader_with_two_workers_ends_and_terminates_its_pool():
    """Forked workers (per-worker numpy seeds): fixed-shape batches, every
    sample of the epoch once, done within seconds, no child left."""
    t0 = time.time()
    loader = pdata.build_dataloader_from_cfg(
        2, SYNTH, {"num_workers": 2}, TRANSFORMS, split="train", seed=1)
    assert loader.num_workers == min(2, max(os.cpu_count() - 1, 0))
    for epoch in (1, 2):
        loader.set_epoch(epoch)
        batches = list(loader)
        assert len(batches) == 4
        assert all(b["pos"].shape == (2, 200, 3) and b["x"].shape == (2, 200, 3)
                   and np.isfinite(b["pos"]).all() for b in batches)
    pool = loader._pool
    loader.close()
    assert loader._pool is None
    if pool is not None:
        assert not [p for p in multiprocessing.active_children()
                    if p.is_alive() and "Fork" in type(p).__name__]
    assert time.time() - t0 < 60


# ---------------------------------------------------------------------------
# the datasets, on tiny files
# ---------------------------------------------------------------------------

def _write_s3dis(root, rng):
    raw = root / "raw"
    raw.mkdir(parents=True)
    for name, n in (("Area_1_office_1", 900), ("Area_2_hall_1", 700),
                    ("Area_5_office_2", 800)):
        room = np.concatenate([rng.rand(n, 3) * [3, 2, 2.5] + [10, 20, 0],
                               rng.rand(n, 3) * 255,
                               rng.randint(0, 13, (n, 1))], 1)
        np.save(raw / f"{name}.npy", room.astype(np.float64))
    return str(root)


@pytest.mark.parametrize("split,presample,voxel_max", [
    ("train", False, 300), ("train", False, 1500), ("val", True, None),
    ("val", False, None)])
def test_s3dis_dataset_matches_jax(tmp_path, split, presample, voxel_max):
    rng = np.random.RandomState(0)
    roots = [_write_s3dis(tmp_path / side, np.random.RandomState(0))
             for side in ("jax", "port")]
    cfg = _cfg("s3dis/default.yaml")
    items = []
    for mod, tmod, root in ((jdata, jtransforms, roots[0]),
                            (pdata, ptransforms, roots[1])):
        transform = tmod.build_transforms_from_cfg(
            "train" if split == "train" else "val", cfg.datatransforms)
        np.random.seed(3)
        ds = mod.build_dataset_from_cfg(
            {"NAME": "S3DIS", "data_root": root, "voxel_size": 0.1},
            {"split": split, "voxel_max": voxel_max, "presample": presample,
             "loop": 2, "variable": False}, transform=transform)
        np.random.seed(4)
        items.append([ds[i] for i in range(len(ds))])
    assert len(items[0]) == len(items[1]) == (4 if split == "train" else 2)
    for want, got in zip(*items):
        _equal_dicts(got, want)
        assert got["heights"].shape == (len(got["y"]), 1)
        if split == "train":
            assert len(got["y"]) == voxel_max
    del rng


@pytest.mark.parametrize("split,presample", [("train", False), ("val", True),
                                             ("val", False)])
def test_scannet_dataset_matches_jax(tmp_path, split, presample):
    roots = []
    for side in ("jax", "port"):
        rng = np.random.RandomState(1)
        for sp in ("train", "val"):
            (tmp_path / side / sp).mkdir(parents=True)
            for i in range(2):
                n = 600 + 100 * i
                label = rng.randint(0, 20, n).astype(np.int64)
                label[::7] = -100
                torch.save((rng.rand(n, 3).astype(np.float32) * 2,
                            rng.rand(n, 3).astype(np.float32) * 2 - 1, label),
                           tmp_path / side / sp / f"scene{i:04d}_00.pth")
        roots.append(str(tmp_path / side))
    cfg = _cfg("scannet/default.yaml")
    items = []
    for mod, tmod, root in ((jdata, jtransforms, roots[0]),
                            (pdata, ptransforms, roots[1])):
        transform = tmod.build_transforms_from_cfg(
            "train" if split == "train" else "val", cfg.datatransforms)
        np.random.seed(3)
        ds = mod.build_dataset_from_cfg(
            {"NAME": "ScanNet", "data_root": root, "voxel_size": 0.05},
            {"split": split, "voxel_max": 250 if split == "train" else None,
             "presample": presample, "loop": 3 if split == "train" else 1},
            transform=transform)
        assert ds.ignore_index == -100 and ds.num_classes == 20
        np.random.seed(4)
        items.append([ds[i] for i in range(len(ds))])
    assert len(items[0]) == len(items[1]) == (6 if split == "train" else 2)
    for want, got in zip(*items):
        _equal_dicts(got, want)
    assert any((it["y"] == -100).any() for it in items[1])


def test_grid_subsampling_matches_the_native_extension():
    """The numpy subsampler against the JAX package's C++ one: voxels in
    the same (first-seen) order, barycentres to 1e-6, labels equal."""
    from amcontrast3d_tpu.native import grid_subsampling as native
    rng = np.random.RandomState(5)
    pts = (rng.rand(3000, 3) * [3, 2, 1] - [1, 0.5, 0]).astype(np.float32)
    feat = rng.rand(3000, 3).astype(np.float32)
    lab = rng.randint(0, 5, 3000).astype(np.int32)
    want = native(pts, feat, lab, sampleDl=0.2)
    got = pdata.grid_subsampling(pts, feat, lab, sampleDl=0.2)
    assert got[0].shape == want[0].shape and len(got[0]) < 1200
    np.testing.assert_allclose(got[0], want[0], atol=1e-6)
    np.testing.assert_allclose(got[1], want[1], atol=1e-6)
    np.testing.assert_array_equal(got[2], want[2])
    only = pdata.grid_subsampling(pts, sampleDl=0.2)
    np.testing.assert_array_equal(only, got[0])
    two = pdata.grid_subsampling(pts, labels=np.stack([lab, lab % 2], 1),
                                 sampleDl=0.2)[1]
    np.testing.assert_array_equal(two, native(
        pts, labels=np.stack([lab, lab % 2], 1), sampleDl=0.2)[1])


@pytest.mark.parametrize("split", ["train", "val"])
def test_s3dis_sphere_dataset_matches_jax(tmp_path, split):
    roots = [_write_s3dis(tmp_path / side, np.random.RandomState(0))
             for side in ("jax", "port")]
    items, sets = [], []
    for mod, root in ((jdata, roots[0]), (pdata, roots[1])):
        np.random.seed(8)
        ds = mod.build_dataset_from_cfg(
            {"NAME": "S3DISSphere", "data_root": root, "voxel_size": 0.15},
            {"split": split, "in_radius": 0.8, "num_points": 120,
             "num_steps": 5})
        if split == "train":
            # the train potentials come from an unseeded generator: hand both
            # packages the same ones
            prng = np.random.RandomState(9)
            ds.potentials = [prng.rand(len(c[0])) * 1e-3 for c in ds.clouds]
            ds.argmins = [int(np.argmin(p)) for p in ds.potentials]
        np.random.seed(9)
        items.append([ds[i] for i in range(len(ds))])
        sets.append(ds)
    for (wp, wc, wl), (gp, gc, gl) in zip(sets[0].clouds, sets[1].clouds):
        np.testing.assert_allclose(gp, wp, atol=1e-6)
        np.testing.assert_allclose(gc, wc, atol=1e-4)
        np.testing.assert_array_equal(gl, wl)
    assert len(items[1]) == 5
    for want, got in zip(*items):
        assert set(got) == set(want)
        np.testing.assert_array_equal(got["point_idx"], want["point_idx"])
        np.testing.assert_array_equal(got["y"], want["y"])
        np.testing.assert_allclose(got["pos"], want["pos"], atol=1e-5)
        np.testing.assert_allclose(got["x"], want["x"], atol=1e-2)
    if split == "val":
        for a, b in zip(sets[0].projections, sets[1].projections):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# schedules, plateau, freezing
# ---------------------------------------------------------------------------

SCHEDULES = {
    "cosine": {"sched": "cosine", "min_lr": 1e-5},
    "cosine_warmup": {"sched": "cosine", "warmup_epochs": 4, "warmup_lr": 1e-6},
    "multistep": {"sched": "multistep", "decay_epochs": [70, 90],
                  "decay_rate": 0.1, "min_lr": None},
    "multistep_warmup": {"sched": "multisteplr", "milestones": [5, 9, 30],
                         "decay_rate": 0.5, "warmup_epochs": 3},
    "step": {"sched": "step", "decay_epochs": 7, "decay_rate": 0.7},
    "poly": {"sched": "poly", "power": 0.9, "min_lr": 1e-6},
    "tanh": {"sched": "tanh", "lb": -6.0, "ub": 4.0, "warmup_epochs": 2},
    "plateau": {"sched": "plateau", "warmup_epochs": 3, "patience_epochs": 2},
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_every_schedule_matches_jax(name):
    """Over epochs 0 … epochs + 5 and through the per-step form: JAX
    computes in float32, 1e-6 relative."""
    cfg = {"epochs": 100, "lr": 0.01, **SCHEDULES[name]}
    got, epochs = build_scheduler_from_cfg(cfg)
    want, jepochs = jax_scheduler(cfg)
    assert epochs == jepochs == 100
    for e in range(0, 106):
        assert isinstance(got(e), float)
        # terms of size lr round to ~1e-9 in float32
        np.testing.assert_allclose(got(e), float(want(e)), rtol=1e-6, atol=1e-9)
    ours, theirs = as_step_schedule(got, 7, 3), jax_step_schedule(want, 7, 3)
    for s in (0, 6, 7, 300, 699):
        np.testing.assert_allclose(ours(s), float(theirs(s)), rtol=1e-6,
                                   atol=1e-9)
    assert (name == "plateau") == hasattr(got, "plateau")
    with pytest.raises(ValueError, match="not supported"):
        build_scheduler_from_cfg({**cfg, "sched": "sawtooth"})


@pytest.mark.parametrize("mode", ["max", "min"])
def test_plateau_scheduler_matches_jax(mode):
    kw = dict(base_lr=0.01, mode=mode, decay_rate=0.5, patience_t=2,
              threshold=1e-3, cooldown_t=1, lr_min=1e-3)
    ours, theirs = PlateauScheduler(**kw), JaxPlateau(**kw)
    rng = np.random.RandomState(0)
    metrics = np.concatenate([np.linspace(10, 30, 6), 30 + rng.rand(14),
                              np.full(10, 29.0)])
    if mode == "min":
        metrics = 100 - metrics
    scales = []
    for i, m in enumerate(metrics):
        scales.append(ours.step(float(m)))
        assert scales[-1] == theirs.step(float(m)) == ours.scale
        assert ours.state_dict() == theirs.state_dict()
        if i == 12:
            resumed = PlateauScheduler(**kw)
            resumed.load_state_dict(ours.state_dict())
    assert min(scales) == pytest.approx(0.1) and scales[0] == 1.0
    for m in metrics[13:]:
        last = resumed.step(float(m))
    assert last == scales[-1]


def test_plateau_scale_multiplies_the_step_rate():
    """The factor lands on every group's rate from the next step on, as
    JAX's ``scale_by_plateau`` rescales the whole update."""
    from amcontrast3d_tpu_torch.engine import make_train_step

    class Head(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.lin = torch.nn.Linear(3, 2)

        def forward(self, pos, x, generator=None):
            return self.lin(x)

    model = Head()
    opt = torch.optim.AdamW([{"params": [model.lin.weight]},
                             {"params": [model.lin.bias]}], lr=1.0)
    step = make_train_step(
        model, lambda logits, y: torch.nn.functional.cross_entropy(
            logits.flatten(0, 1), y.flatten()), opt, lambda s: 0.01, "base", 2)
    assert step.state == {"step": 0, "lr_scale": 1.0}
    batch = {"pos": torch.zeros(1, 4, 3), "x": torch.randn(1, 4, 3),
             "y": torch.tensor([[0, 1, 1, 0]])}
    step(batch)
    assert [g["lr"] for g in opt.param_groups] == [0.01, 0.01]
    step.state["lr_scale"] = 0.25
    step(batch)
    assert [g["lr"] for g in opt.param_groups] == [0.0025, 0.0025]
    assert step.state["step"] == 2


def test_plateau_schedule_through_the_trainer(tmp_path):
    """``sched: plateau`` in ``Runner.train``: a validation score that does
    not improve halves the rate of the following epochs, the checkpoint
    keeps the scheduler's state, and a resumed run starts from its scale."""
    path = _tiny_cfg(tmp_path)
    opts = ["sched=plateau", "patience_epochs=0", "decay_rate=0.5", "seed=2",
            "threshold=10.0", "lr=0.002", "min_lr=0.0001"]
    cfg = _load(EasyConfig, path, opts + ["epochs=3"])
    pcli.generate_exp_directory(cfg, exp_name=["plateau"])
    runner = RecordingRunner(cfg, kind="aa", device="cpu")
    results = runner.train()
    # mode max with a threshold no score can clear: every epoch after the
    # first is a bad one
    assert [t["lr"] for t in results["timing"]] == [0.002, 0.002, 0.001]
    assert runner.rates == [0.002] * 6 + [0.001] * 3
    latest = glob.glob(os.path.join(cfg.ckpt_dir, "*latest.ckpt"))[0]
    blob = torch.load(latest, weights_only=False)
    assert blob["plateau"] == runner.plateau.state_dict()
    assert blob["plateau"]["lr"] == pytest.approx(0.0005)
    cfg2 = _load(EasyConfig, path, opts + ["epochs=4", "mode=resume",
                                           f"pretrained_path={latest}"])
    cfg2.run_dir, cfg2.ckpt_dir = str(tmp_path / "again"), None
    resumed = RecordingRunner(cfg2, kind="aa", device="cpu")
    resumed.train()
    assert resumed.rates == pytest.approx([0.0005] * 3)


class TinyModel(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.encoder = torch.nn.ModuleDict({
            "enc0_sa": torch.nn.Linear(2, 2),
            "enc1_block1": torch.nn.Linear(2, 2)})
        self.head = torch.nn.Linear(2, 2)


@pytest.mark.parametrize("cfg,frozen", [
    ({"mode": "train"}, []),
    ({"mode": "finetune_freeze_blocks"},
     ["encoder.enc1_block1.weight", "encoder.enc1_block1.bias"]),
    ({"mode": "finetune", "freeze_re": "encoder"},
     ["encoder.enc0_sa.weight", "encoder.enc0_sa.bias",
      "encoder.enc1_block1.weight", "encoder.enc1_block1.bias"]),
    ({"mode": "finetune_freeze_blocks", "freeze_re": "head/bias"},
     ["head.bias"]),
])
def test_freeze_labels_match_jax(cfg, frozen):
    """The same regular expression over the same paths as
    ``Runner._freeze_labels``; a frozen parameter leaves the optimizer."""
    from amcontrast3d_tpu_torch.optim import build_optimizer_from_cfg
    model = TinyModel()
    assert freeze_parameters_(model, freeze_pattern(cfg)) == frozen
    runner = JaxRunner.__new__(JaxRunner)
    runner.cfg = JaxConfig(cfg)
    labels = runner._freeze_labels()
    params = {"encoder": {"enc0_sa": {"kernel": 0, "bias": 0},
                          "enc1_block1": {"kernel": 0, "bias": 0}},
              "head": {"kernel": 0, "bias": 0}}
    want = [] if labels is None else [
        ".".join(k).replace("kernel", "weight")
        for k, v in __import__("flax").traverse_util.flatten_dict(
            labels(params)).items() if v == "frozen"]
    assert sorted(frozen) == sorted(want)
    opt = build_optimizer_from_cfg({"NAME": "adamw", "weight_decay": 0.1}, model)
    owned = {id(p) for g in opt.param_groups for p in g["params"]}
    for name, p in model.named_parameters():
        assert (id(p) in owned) == (name not in frozen)
        assert p.requires_grad == (name not in frozen)


# ---------------------------------------------------------------------------
# the interpolation VJP for large query sets
# ---------------------------------------------------------------------------

def _clear_of_third_neighbour_ties(rng, n1, n2):
    """Positions whose 3rd and 4th nearest coarse d² differ by 1e-3
    relative: the TPU kernel's cushion admits no 4th neighbour there."""
    p2 = (rng.rand(1, n2, 3) * 3).astype(np.float32)
    keep = np.zeros((0, 3), np.float32)
    while len(keep) < n1:
        cand = (rng.rand(2 * n1, 3) * 3).astype(np.float32)
        d2 = np.sort(((cand[:, None].astype(np.float64) - p2[0][None]) ** 2
                      ).sum(-1), -1)
        keep = np.concatenate([keep, cand[d2[:, 3] > d2[:, 2] * (1 + 1e-3)]])
    return keep[None, :n1], p2


def test_interp_backward_twin_matches_the_chunked_pallas_kernel(monkeypatch):
    """The plain twin of both backward kernels against the gradient of
    ``three_interpolation_fused`` through its query-chunked kernel
    (interpret mode, the budget and the query block patched here as
    ``tests/test_interpolate_pallas.py`` does): 1e-5."""
    import amcontrast3d_tpu.ops.interpolate_pallas as IP
    rng = np.random.RandomState(11)
    p1, p2 = _clear_of_third_neighbour_ties(rng, 1100, 700)
    f2 = rng.randn(1, 700, 12).astype(np.float32)
    g = rng.randn(1, 1100, 12).astype(np.float32)
    monkeypatch.setattr(IP, "_QBUF_VMEM_BUDGET", 1)  # force the chunked kernel
    monkeypatch.setattr(IP, "_QB", 512)              # several query blocks

    def loss(f_, p1_, p2_, g_):
        return jnp.sum(IP.three_interpolation_fused(p1_, p2_, f_, True) * g_)

    want = np.asarray(jax.grad(loss)(jnp.asarray(f2), jnp.asarray(p1),
                                     jnp.asarray(p2), jnp.asarray(g)))
    idx, w = ops.three_interpolation_weights(torch.from_numpy(p1),
                                             torch.from_numpy(p2))
    for fn in (ops.three_interpolation_backward_plain,
               ops.three_interpolation_backward_big,    # CPU tensors: the twin
               ops.three_interpolation_backward):
        got = fn(torch.from_numpy(g), idx, w, 700).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # and through autograd, as the decoder reaches it
    f = torch.from_numpy(f2).requires_grad_()
    out = ops.three_interpolation(torch.from_numpy(p1), torch.from_numpy(p2), f)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(f.grad.numpy(), want, rtol=1e-5, atol=1e-5)
    never = np.setdiff1d(np.arange(700), idx.numpy().ravel())
    assert len(never) and not f.grad.numpy()[0, never].any()


def test_interp_backward_refuses_what_is_neither_cpu_nor_cuda():
    g = torch.empty(1, 8, 4, device="meta")
    idx = torch.empty(1, 8, 3, dtype=torch.int32, device="meta")
    w = torch.empty(1, 8, 3, device="meta")
    for fn in (ops.three_interpolation_backward,
               ops.three_interpolation_backward_big,
               ops.three_interpolation_backward_small):
        with pytest.raises(ValueError, match="CUDA"):
            fn(g, idx, w, 5)
    assert ops.three_interpolation_backward_big.launches == 0


def test_batched_fps_above_the_shared_memory_limit_needs_no_gpu_on_cpu():
    """On the CPU the wrapper takes the twin whatever the size; the batched
    kernel has no shared-memory gate any more: its clusters take up to
    16 × 512 × 20 points a cloud."""
    assert not hasattr(ops.fps, "MAX_KERNEL_N")
    assert ops.fps.CLUSTER_POINTS == 163840
    xyz = torch.from_numpy(np.random.RandomState(0).rand(2, 300, 3)
                           .astype(np.float32))
    assert torch.equal(ops.furthest_point_sample(xyz, 20),
                       ops.furthest_point_sample_plain(xyz, 20))


# ---------------------------------------------------------------------------
# the trainer as a whole
# ---------------------------------------------------------------------------

def _tiny_cfg(tmp_path):
    """The configuration of ``tests/test_cli.py``, for three train steps an
    epoch and with the whole val room scored."""
    cfg = {
        "dataset": {
            "common": {"NAME": "Synthetic", "num_rooms": 2, "n_points": 3000,
                       "voxel_size": 0.04},
            "train": {"split": "train", "voxel_max": 256, "loop": 3},
            "val": {"split": "val", "voxel_max": 256},
            "test": {"split": "val", "voxel_max": 256},
        },
        "feature_keys": "x,heights", "num_classes": 13, "batch_size": 2,
        "val_batch_size": 2, "eval_bucket": 256, "epochs": 1, "val_freq": 1,
        "seed": 0, "sched": "cosine", "lr": 0.01, "min_lr": 1.0e-5,
        "optimizer": {"NAME": "adamw", "weight_decay": 1.0e-4},
        "grad_norm_clip": 10, "root_dir": str(tmp_path / "log"),
        "log_dir": "synthetic",
        "datatransforms": {
            "train": ["PointCloudScaling", "PointCloudXYZAlign",
                      "ChromaticNormalize"],
            "val": ["PointCloudXYZAlign", "ChromaticNormalize"],
            "kwargs": {"gravity_dim": 2, "scale": [0.9, 1.1]}},
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
        "distributed": False,
    }
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


class RecordingJaxRunner(JaxRunner):
    """Keeps the initial variables, every batch and every step's loss and
    optimizer state of ``Runner.train``."""

    def build_state(self, example_batch):
        state = super().build_state(example_batch)
        self.initial = _tree({"params": state.params,
                              "batch_stats": state.batch_stats})
        self.batches, self.losses, self.adam = [], [], []
        return state

    def train_step_fn(self):
        fn = super().train_step_fn()

        def step(state, batch, rng):
            self.batches.append(_tree(batch))
            state, metrics = fn(state, batch, rng)
            self.losses.append(float(metrics["loss"]))
            adam = state.opt_state[1][0]
            self.adam = [_tree(adam.mu), _tree(adam.nu), int(adam.count)]
            self.final = _tree({"params": state.params,
                                "batch_stats": state.batch_stats})
            return state, metrics
        return step


class RecordingRunner(prunner.Runner):
    def train_step_fn(self):
        fn = super().train_step_fn()
        if not hasattr(self, "losses"):
            self.batches, self.losses, self.rates = [], [], []

        def step(batch):
            self.batches.append({k: v.numpy() for k, v in batch.items()})
            out = fn(batch)
            self.losses.append(out["loss"].item())
            self.rates.append(self.optimizer.param_groups[0]["lr"])
            return out
        step.state = fn.state
        return step


def _load(cls, path, opts=()):
    cfg = cls()
    cfg.load(path, recursive=True)
    cfg.update(list(opts))
    cfg.cfg_basename = "tiny"
    return cfg


def _save_payload(tmp_path, name, payload):
    path = str(tmp_path / f"{name}.ckpt")
    torch.save(payload, path)
    return path


@pytest.fixture(scope="module")
def both_trainers(tmp_path_factory):
    """One epoch of three steps of ``Runner.train`` in both packages from
    the JAX trainer's initial weights."""
    tmp = tmp_path_factory.mktemp("trainers")
    path = _tiny_cfg(tmp)
    theirs = RecordingJaxRunner(_load(JaxConfig, path), kind="aa")
    _, jresults = theirs.train()

    # the JAX trainer draws one batch ahead of its first epoch to initialise
    # the model, and its prefetch thread runs on to the end of that pass
    # (2 batches beyond the first fit the queue): the port, which needs no
    # such batch, is handed a train loader that has made the same draws
    build = pdata.build_dataloader_from_cfg

    def aligned(*args, split="train", **kwargs):
        loader = build(*args, split=split, **kwargs)
        if split == "train":
            list(loader)
        return loader

    start = _save_payload(tmp, "start", checkpoint_from_jax(
        prunner.Runner(_load(EasyConfig, path), kind="aa", device="cpu").model,
        None, theirs.initial))
    cfg = _load(EasyConfig, path, ["mode=finetune", f"pretrained_path={start}"])
    cfg.run_dir = str(tmp / "port_run")
    ours = RecordingRunner(cfg, kind="aa", device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(prunner, "build_dataloader_from_cfg", aligned)
        results = ours.train()
    return {"jax": theirs, "jax_results": jresults, "port": ours,
            "results": results, "cfg_path": path, "tmp": tmp}


def test_runner_train_feeds_both_packages_equal_batches(both_trainers):
    theirs, ours = both_trainers["jax"], both_trainers["port"]
    assert len(theirs.batches) == len(ours.batches) == 3
    for want, got in zip(theirs.batches, ours.batches):
        for k in ("pos", "x", "y"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got["x"].shape == (2, 256, 4)


def test_runner_train_losses_and_val_miou_match_jax(both_trainers):
    """Per-step loss 1e-5 at step 1 (same weights, same batch) and 1e-3
    free-running over steps 2 and 3 (measured 7e-8, 5e-7 and 0 relative: the
    tiny model has few max-pool near-ties); the epoch's val mIoU and OA
    within 0.5 points (measured identical), the results' keys and the
    timing records."""
    theirs, ours = both_trainers["jax"], both_trainers["port"]
    np.testing.assert_allclose(ours.losses[0], theirs.losses[0], rtol=1e-5)
    np.testing.assert_allclose(ours.losses, theirs.losses, rtol=1e-3)
    res, jres = both_trainers["results"], both_trainers["jax_results"]
    assert set(jres) <= set(res) and set(res) - set(jres) == {"timing"}
    assert abs(res["val_miou"] - jres["val_miou"]) <= 0.5
    assert abs(res["val_oa"] - jres["val_oa"]) <= 0.5
    assert res["best_epoch"] == jres["best_epoch"] == 1
    (record,) = res["timing"]
    assert record["steps"] == 3 and record["cm_total"] == 3 * 2 * 256
    np.testing.assert_allclose(record["loss"], np.mean(ours.losses), rtol=1e-6)
    want_lr = float(jax_scheduler(_load(JaxConfig, both_trainers["cfg_path"]))[0](1))
    np.testing.assert_allclose(ours.rates, [want_lr] * 3, rtol=1e-6)
    rows = [json.loads(line) for line in
            open(os.path.join(ours.cfg.run_dir, "scalars.jsonl"))]
    assert {r["tag"] for r in rows} >= {"train_loss", "train_miou", "train_macc",
                                        "val_miou", "best_val", "lr"}


def test_resume_from_the_jax_trainers_state(both_trainers):
    """``checkpoint_from_jax`` carries parameters, batch statistics, the
    AdamW moments and count and the epoch: ``mode=resume`` starts at epoch 2,
    its first step at the step count and the learning rate JAX's schedule
    gives there, and the first resumed loss equals the JAX trainer's next
    step on the same batch to 1e-5."""
    theirs, tmp, path = (both_trainers["jax"], both_trainers["tmp"],
                         both_trainers["cfg_path"])
    mu, nu, count = theirs.adam
    assert count == 3
    donor = prunner.Runner(_load(EasyConfig, path), kind="aa", device="cpu")
    donor.build_state()
    ckpt = _save_payload(tmp, "carried", checkpoint_from_jax(
        donor.model, donor.optimizer, theirs.final, mu, nu, count, epoch=1,
        best_val=12.5, best_epoch=1))
    cfg = _load(EasyConfig, path, ["mode=resume", f"pretrained_path={ckpt}",
                                   "epochs=2"])
    cfg.run_dir, cfg.ckpt_dir = str(tmp / "resumed"), None
    ours = RecordingRunner(cfg, kind="aa", device="cpu")
    results = ours.train()
    assert cfg.start_epoch == 2 and len(ours.losses) == 3
    assert ours.train_step_fn().state["step"] == 6
    lr_fn, _ = jax_scheduler({**_load(JaxConfig, path), "epochs": 2})
    want_lr = float(jax_step_schedule(lr_fn, 3)(count))
    np.testing.assert_allclose(ours.rates[0], want_lr, rtol=1e-6)
    assert want_lr != float(lr_fn(1))
    assert results["best_val"] >= 12.5          # the carried best is kept
    for state in ours.optimizer.state.values():
        assert state["step"].item() == 6

    # the JAX trainer's 4th step on that batch, from its own state
    from amcontrast3d_tpu.engine import train as jtrain
    jcfg = _load(JaxConfig, path, ["epochs=2"])
    jr = JaxRunner(jcfg, kind="aa")
    jcfg.steps_per_epoch = 3
    batch = {k: jnp.asarray(v) for k, v in ours.batches[0].items()}
    state = jr.build_state(batch)
    adam = state.opt_state[1][0]._replace(
        mu=jax.tree_util.tree_map(jnp.asarray, mu),
        nu=jax.tree_util.tree_map(jnp.asarray, nu),
        count=jnp.asarray(count, jnp.int32))
    opt_state = (state.opt_state[0], (adam,) + tuple(state.opt_state[1][1:]))
    opt_state = jax.tree_util.tree_map(
        lambda x: x, opt_state)
    state = jtrain.TrainState(
        step=jnp.asarray(count, jnp.int32),
        params=jax.tree_util.tree_map(jnp.asarray, theirs.final["params"]),
        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                           theirs.final["batch_stats"]),
        opt_state=_with_counts(opt_state, count))
    _, metrics = jr.train_step_fn()(state, batch, jax.random.PRNGKey(1))
    np.testing.assert_allclose(ours.losses[0], float(metrics["loss"]), rtol=1e-5)


def _with_counts(opt_state, count):
    """Every step counter of an optax state (Adam's, the schedule's) at
    ``count``."""
    def fix(x):
        if hasattr(x, "_fields") and "count" in x._fields:
            x = x._replace(count=jnp.asarray(count, jnp.int32))
        if isinstance(x, tuple):
            vals = tuple(fix(v) for v in x)
            return type(x)(*vals) if hasattr(x, "_fields") else vals
        return x
    return fix(opt_state)


def test_cli_train_resume_and_test_on_the_cpu(tmp_path):
    """The port's ``main_cli``: two epochs write ``latest`` and ``best``,
    ``mode=resume`` runs the third in the same run directory at the rate the
    JAX schedule gives for it, ``mode=test`` reads ``best``; the finetune
    family loads weights and trains, frozen parameters stay bit-identical."""
    path = _tiny_cfg(tmp_path)
    # from this seed epoch 1 scores best, so best and latest differ
    argv = ["--cfg", path, "--device", "cpu", "seed=2"]
    res = pcli.main_cli("aa", argv + ["epochs=2"])
    assert res["best_val"] > 0 and res["best_epoch"] == 1
    assert len(res["timing"]) == 2
    ckpts = glob.glob(os.path.join(res["run_dir"], "checkpoint", "*.ckpt"))
    latest = [c for c in ckpts if "latest" in c]
    best = [c for c in ckpts if "best" in c]
    assert len(latest) == 1 and len(best) == 1
    blob = torch.load(latest[0], weights_only=False)
    assert blob["epoch"] == 2 and blob["step"] == 6 and "optimizer" in blob["state"]
    assert torch.load(best[0], weights_only=False)["epoch"] == 1

    res3 = pcli.main_cli("aa", argv + ["mode=resume", "epochs=3",
                                       f"pretrained_path={latest[0]}"])
    assert res3["run_dir"] == res["run_dir"]
    (record,) = res3["timing"]
    lr_fn, _ = jax_scheduler({**_load(JaxConfig, path), "epochs": 3})
    want = float(jax_step_schedule(lr_fn, 3)(6))
    np.testing.assert_allclose(record["lr"], want, rtol=1e-6)
    assert record["epoch"] == 3 and res3["best_val"] >= res["best_val"]
    assert torch.load(latest[0], weights_only=False)["step"] == 9
    rows = [json.loads(line) for line in
            open(os.path.join(res["run_dir"], "scalars.jsonl"))]
    assert sorted(r["step"] for r in rows if r["tag"] == "lr") == [1, 2, 3]

    out = pcli.main_cli("aa", argv + ["mode=test", f"pretrained_path={best[0]}"])
    assert np.isfinite(out["miou"]) and len(out["ious"]) == 13

    before = torch.load(latest[0], weights_only=False)["state"]["model"]
    fine = pcli.main_cli("aa", argv + ["mode=finetune_encoder",
                                       "freeze_re=encoder/enc1_sa",
                                       f"pretrained_path={latest[0]}"])
    after = torch.load(glob.glob(os.path.join(
        fine["run_dir"], "checkpoint", "*latest.ckpt"))[0],
        weights_only=False)["state"]["model"]
    frozen = [k for k in before if k.startswith("encoder.enc1_sa.")
              and k.endswith(("weight", "bias"))]
    assert len(frozen) >= 4
    for k in frozen:
        assert torch.equal(before[k], after[k]), k
    assert not torch.equal(before["encoder.enc0_sa.ConvBlock_0.Dense_0.weight"],
                           after["encoder.enc0_sa.ConvBlock_0.Dense_0.weight"])


def test_cli_profile_writes_a_trace(tmp_path):
    """``--profile`` wraps the training in a ``torch.profiler`` trace under
    the run directory."""
    res = pcli.main_cli("aa", ["--cfg", _tiny_cfg(tmp_path), "--device", "cpu",
                               "--profile", "seed=2"])
    trace = os.path.join(res["run_dir"], "profile", "trace.json")
    assert os.path.getsize(trace) > 1000 and np.isfinite(res["timing"][0]["loss"])


def test_a_non_finite_loss_stops_the_run(tmp_path):
    """The two-step lag of the metrics does not hide it."""
    path = _tiny_cfg(tmp_path)
    cfg = _load(EasyConfig, path)
    cfg.run_dir = str(tmp_path / "run")
    runner = prunner.Runner(cfg, kind="aa", device="cpu")
    with torch.no_grad():
        next(runner.model.parameters()).fill_(float("nan"))
    with pytest.raises(FloatingPointError, match="non-finite"):
        runner.train()


def test_cli_trains_and_tests_at_bf16_on_the_cpu(tmp_path):
    """``use_amp=True``, ``encoder_args.remat=True`` and
    ``ambiguity_args.remat=True`` pass through the cfg overrides: the port's
    ``main_cli`` trains one epoch with a bfloat16 model (every Linear in
    bfloat16, float32 parameters), writes its checkpoints, and
    ``mode=test`` scores the rooms from ``best`` at bfloat16."""
    argv = ["--cfg", _tiny_cfg(tmp_path), "--device", "cpu", "seed=2",
            "use_amp=True", "model.encoder_args.remat=True",
            "ambiguity_args.remat=True"]
    res = pcli.main_cli("aa", argv)
    assert np.isfinite(res["timing"][0]["loss"]) and res["best_val"] >= 0
    best = glob.glob(os.path.join(res["run_dir"], "checkpoint", "*best.ckpt"))
    assert len(best) == 1
    state = torch.load(best[0], weights_only=False)["state"]["model"]
    assert all(v.dtype in (torch.float32, torch.int64) for v in state.values())
    cfg = _load(EasyConfig, os.path.join(res["run_dir"], "cfg.yaml"))
    assert cfg.use_amp and cfg.model.encoder_args.remat \
        and cfg.ambiguity_args.remat
    out = pcli.main_cli("aa", argv + ["mode=test", f"pretrained_path={best[0]}"])
    assert np.isfinite(out["miou"]) and len(out["ious"]) == 13


@pytest.mark.parametrize("opts,error,match", [
    pytest.param(["distributed=True"], None, "distributed",
                 id="opts0-distributed"),
    pytest.param(["optimizer.layer_decay=0.75"], None, "layer_decay",
                 id="opts1-layer_decay"),
    pytest.param(["optimizer.NAME=adahessian"], None, "adahessian",
                 id="opts2-adahessian")])
def test_unported_options_raise_by_name(tmp_path, opts, error, match):
    """Options that are not ported raise by name.  ``distributed`` is
    ported (the data-parallel ranks, ``engine.cli``): it is taken, and on
    the CPU with no ``world_size`` it asks for one rank, so the runner
    builds as a single process.  ``layer_decay`` is ported: the runner
    builds the JAX factory's chain with ``num_layers`` from the model
    (12 where it names no depth).  ``adahessian`` is ported: the runner's
    step takes the Hutchinson diagonal (``needs_hessian``, as the JAX
    runner sets it from the name) and trains; with ``use_amp`` (whose
    second order is not ported) it raises by name."""
    cfg = _load(EasyConfig, _tiny_cfg(tmp_path), opts)
    cfg.run_dir = str(tmp_path / "run")
    if match == "adahessian":
        from unittest import mock

        from amcontrast3d_tpu_torch.engine import train as ptrain

        seen = []
        make = ptrain.make_train_step
        with mock.patch.object(prunner, "make_train_step",
                               lambda *a, **k: seen.append(k) or make(*a, **k)):
            res = prunner.Runner(cfg, kind="aa", device="cpu").train()
        assert seen and all(k["needs_hessian"] for k in seen)
        assert np.isfinite(res["timing"][0]["loss"])
        amp = _load(EasyConfig, _tiny_cfg(tmp_path), opts + ["use_amp=True"])
        amp.run_dir = str(tmp_path / "amp")
        with pytest.raises(NotImplementedError, match="use_amp"):
            prunner.Runner(amp, kind="aa", device="cpu").train()
        return
    if match == "layer_decay":
        from amcontrast3d_tpu_torch.optim.extras import Chain

        runner = prunner.Runner(cfg, kind="aa", device="cpu")
        optimizer = runner.build_state()
        assert isinstance(optimizer, Chain)
        assert optimizer.rules and len(optimizer.rules) == len(
            list(runner.model.parameters()))
        return
    if error is None:
        runner = prunner.Runner(cfg, kind="aa", device="cpu")
        assert cfg[match] is True
        assert not runner.distributed and runner.world_size == 1
        return
    with pytest.raises(error, match=match):
        prunner.Runner(cfg, kind="aa", device="cpu").train()


def test_validate_sphere_matches_jax(tmp_path):
    """Both packages' ``validate_sphere`` over the same spheres with the
    same weights: the same metrics (argmax near-ties aside: 0.5)."""
    roots = [_write_s3dis(tmp_path / side, np.random.RandomState(0))
             for side in ("jax", "port")]
    path = _tiny_cfg(tmp_path)
    metrics = []
    jrunner = JaxRunner(_load(JaxConfig, path), kind="aa")
    loaders = []
    for mod, root in ((jdata, roots[0]), (pdata, roots[1])):
        np.random.seed(2)
        ds = mod.build_dataset_from_cfg(
            {"NAME": "S3DISSphere", "data_root": root, "voxel_size": 0.15},
            {"split": "val", "in_radius": 0.9, "num_points": 128,
             "num_steps": 4},
            transform=mod.build.build_transforms_from_cfg(
                "val", _load(EasyConfig, path).datatransforms))
        loaders.append(mod.NumpyLoader(ds, 2, prefetch=False))
    np.random.seed(3)
    first = next(iter(jdata.NumpyLoader(loaders[0].dataset, 2, prefetch=False)))
    from amcontrast3d_tpu.engine.runner import _prep_batch
    jrunner.cfg.steps_per_epoch = 1
    state = jrunner.build_state(_prep_batch(first, jrunner.cfg))
    # the potentials moved with that batch: start both from fresh datasets
    for loader, mod, root in zip(loaders, (jdata, pdata), roots):
        loader.dataset.__init__(
            data_root=root, voxel_size=0.15, split="val", in_radius=0.9,
            num_points=128, num_steps=4, transform=loader.dataset.transform)
    np.random.seed(4)
    metrics.append(jrunner.validate_sphere(state, loaders[0]))
    ours = prunner.Runner(_load(EasyConfig, path), kind="aa", device="cpu")
    ours.model.load_state_dict(from_jax_variables(_tree(
        {"params": state.params, "batch_stats": state.batch_stats})))
    np.random.seed(4)
    metrics.append(ours.validate_sphere(loaders[1]))
    for want, got in zip(metrics[0][:3], metrics[1][:3]):
        assert abs(want - got) <= 0.5
    assert len(metrics[1][3]) == 13


# ---------------------------------------------------------------------------
# examples/segmentation/main_torch.py (--kind base)
# ---------------------------------------------------------------------------

def _tiny_base_cfg(tmp_path):
    """``cfgs/s3dis/pointnext-xl.yaml``'s recipe (its model cut to width 8
    and three stages, no dropout) on two synthetic rooms, for two train
    steps an epoch, one epoch."""
    xl = EasyConfig()
    xl.load(os.path.join(REPO, "cfgs", "s3dis", "pointnext-xl.yaml"),
            recursive=True)
    model = json.loads(json.dumps(dict(xl.model)))
    model["encoder_args"].update(width=8, blocks=[1, 2, 2], strides=[1, 4, 4],
                                 radius=0.3, nsample=8)
    model["decoder_args"]["decoder_stages"] = 2
    model["cls_args"]["dropout"] = 0
    cfg = {
        "dataset": {
            "common": {"NAME": "Synthetic", "num_rooms": 2, "n_points": 3000,
                       "voxel_size": 0.04},
            "train": {"split": "train", "voxel_max": 256, "loop": 2},
            "val": {"split": "val", "voxel_max": 256},
            "test": {"split": "val", "voxel_max": 256},
        },
        "feature_keys": "x,heights", "num_classes": 13, "batch_size": 2,
        "val_batch_size": 2, "eval_bucket": 256, "epochs": 1, "val_freq": 1,
        "seed": 0, "sched": "cosine", "lr": 0.01, "min_lr": 1.0e-5,
        "optimizer": dict(xl.optimizer), "grad_norm_clip": 10,
        "criterion_args": dict(xl.criterion_args),
        "root_dir": str(tmp_path / "log"), "log_dir": "synthetic",
        "datatransforms": {
            "train": ["PointCloudScaling", "PointCloudXYZAlign",
                      "ChromaticNormalize"],
            "val": ["PointCloudXYZAlign", "ChromaticNormalize"],
            "kwargs": {"gravity_dim": 2, "scale": [0.9, 1.1]}},
        "model": model, "distributed": False,
    }
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(json.loads(json.dumps(cfg))))
    return str(path)


def _main_torch(argv, monkeypatch):
    """``main_torch.py`` run as a script; returns what its ``main_cli``
    returned."""
    out = {}
    main_cli = pcli.main_cli

    def recording(kind=None, argv=None):
        out["kind"] = kind
        out["result"] = main_cli(kind, argv)
        return out["result"]

    monkeypatch.setattr(pcli, "main_cli", recording)
    monkeypatch.setattr(sys, "argv", ["main_torch.py"] + argv)
    runpy.run_path(os.path.join(REPO, "examples", "segmentation",
                                "main_torch.py"), run_name="__main__")
    assert out["kind"] == "base"
    return out["result"]


def test_main_torch_trains_resumes_and_tests_on_the_cpu(tmp_path, monkeypatch):
    """``examples/segmentation/main_torch.py`` (``--kind base``): an epoch
    writes ``latest``, ``mode=resume`` runs the second from it with the
    optimizer's state, ``mode=test`` scores the rooms from it."""
    argv = ["--cfg", _tiny_base_cfg(tmp_path), "--device", "cpu"]
    res = _main_torch(argv, monkeypatch)
    assert len(res["timing"]) == 1 and np.isfinite(res["timing"][0]["loss"])
    (latest,) = glob.glob(str(tmp_path / "log" / "**" / "*latest.ckpt"),
                          recursive=True)
    blob = torch.load(latest, weights_only=False)
    assert blob["epoch"] == 1 and blob["step"] == 2
    assert "exp_avg" in str(blob["state"]["optimizer"]["state"])
    res2 = _main_torch(argv + ["mode=resume", "epochs=2",
                               f"pretrained_path={latest}"], monkeypatch)
    assert res2["run_dir"] == res["run_dir"] and len(res2["timing"]) == 1
    assert res2["timing"][0]["epoch"] == 2
    assert torch.load(latest, weights_only=False)["step"] == 4
    out = _main_torch(argv + ["mode=test", f"pretrained_path={latest}"],
                      monkeypatch)
    assert np.isfinite(out["miou"]) and len(out["ious"]) == 13
