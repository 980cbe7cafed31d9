"""The port's whole-scene test path against the JAX package, on the CPU.

Host modules (``data``, ``transforms``, ``engine.evaluate``,
``engine.runner``, ``engine.cli``, ``utils``) get the same inputs, made
from a seed with numpy, as their JAX counterparts.  Numpy-only functions
must return equal arrays under the same ``np.random`` seed.  The
whole-scene test runs the small synthetic AA and MM models in both
packages with the JAX weights carried over by ``from_jax_variables``:
per-subcloud logits within 1e-4·(1+max|logit|) (dense layers round
differently), voted predictions equal except where the two top voted
logits lie within that tolerance of each other, mIoU / boundary / inner
within 0.05 points.

For that run both packages' transform pipelines get one more step that
snaps the positions to a 1/128 m grid: every d² is then exact in float32
in both frameworks.  The JAX plain kNN uses the form ``|q|² + |s|² − 2q·s``
and the port the direct form; off the grid the first gives a coarse point
that is also a fine point a d² of ~1e-6 instead of 0, which moves its
interpolation weight from 1 to 0.98 and the logits by 1e-2.
"""
import os

import numpy as np
import pytest
import torch

import amcontrast3d_tpu.data.synthetic as jsyn
import amcontrast3d_tpu.engine.evaluate as jev
import amcontrast3d_tpu_torch.data.synthetic as psyn
import amcontrast3d_tpu_torch.engine.evaluate as pev
from amcontrast3d_tpu.data import data_util as jdu
from amcontrast3d_tpu.engine.runner import Runner as JaxRunner
from amcontrast3d_tpu.engine.runner import _prep_batch as jax_prep_batch
from amcontrast3d_tpu.transforms import build_transforms_from_cfg as jax_transforms
from amcontrast3d_tpu.utils import ConfusionMatrix as JaxCM
from amcontrast3d_tpu.utils import EasyConfig as JaxConfig
from amcontrast3d_tpu_torch.data import DATASETS, build_dataset_from_cfg
from amcontrast3d_tpu_torch.data import data_util as pdu
from amcontrast3d_tpu_torch.engine import cli as pcli
from amcontrast3d_tpu_torch.engine.runner import Runner, resolve_device
from amcontrast3d_tpu_torch.transforms import DataTransforms
from amcontrast3d_tpu_torch.transforms import build_transforms_from_cfg
from amcontrast3d_tpu_torch.utils import (AverageMeter, ConfusionMatrix,
                                          EasyConfig, load_checkpoint,
                                          resume_checkpoint, save_checkpoint,
                                          set_random_seed)
from amcontrast3d_tpu_torch.utils.convert import from_jax_variables
from amcontrast3d_tpu_torch.utils.vis import labels_to_colors, read_obj, write_obj

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = {kind: os.path.join(REPO, "cfgs", "synthetic", f"AMContrast3D-{kind.upper()}.yaml")
       for kind in ("aa", "mm")}
OVERRIDES = ["mode=test", "dataset.common.num_rooms=1",
             "dataset.common.n_points=2500", "dataset.common.voxel_size=0.1",
             "dataset.test.voxel_max=None", "eval_bucket=256",
             "ambiguity_args.miou_B_I=True", "ambiguity_args.action=True",
             "ambiguity_args.nsample=8", "distributed=False", "seed=3",
             "save_pred=True"]


def _both(fn_jax, fn_port, seed, *args):
    """Run both functions from the same ``np.random`` state on copies."""
    out = []
    for fn in (fn_jax, fn_port):
        np.random.seed(seed)
        out.append(fn(*[a.copy() if isinstance(a, np.ndarray) else a
                        for a in args]))
    return out


def _assert_same(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif a is None:
        assert b is None
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# data_util, transforms, Synthetic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hash_type,mode", [("fnv", 0), ("fnv", 1),
                                            ("ravel", 0), ("ravel", 1)])
def test_voxelize_matches_jax(hash_type, mode):
    coord = np.random.RandomState(1).rand(3000, 3) * 2
    _assert_same(*_both(
        lambda c: jdu.voxelize(c, 0.1, hash_type, mode),
        lambda c: pdu.voxelize(c, 0.1, hash_type, mode), 5, coord))


@pytest.mark.parametrize("split,voxel_max,variable",
                         [("train", 500, True), ("val", 500, True),
                          ("train", 5000, False), ("val", None, True)])
def test_crop_pc_matches_jax(split, voxel_max, variable):
    rng = np.random.RandomState(2)
    coord, feat = rng.rand(4000, 3) * 3, rng.rand(4000, 3) * 255
    label = rng.randint(0, 13, (4000, 1))
    _assert_same(*_both(
        lambda c, f, l: jdu.crop_pc(c, f, l, split, 0.1, voxel_max,
                                    variable=variable),
        lambda c, f, l: pdu.crop_pc(c, f, l, split, 0.1, voxel_max,
                                    variable=variable), 7, coord, feat, label))


def test_pad_cloud_bucket_size_features_and_class_weights_match_jax():
    rng = np.random.RandomState(3)
    data = {"pos": rng.rand(700, 3).astype(np.float32),
            "x": rng.rand(700, 3).astype(np.float32),
            "heights": rng.rand(700, 1).astype(np.float32),
            "y": rng.randint(0, 13, 700)}
    for target in (700, 1024):
        _assert_same(jdu.pad_cloud(data, target, np.random.RandomState(0)),
                     pdu.pad_cloud(data, target, np.random.RandomState(0)))
    _assert_same(*_both(lambda: jdu.pad_cloud(data, 900),
                        lambda: pdu.pad_cloud(data, 900), 4))
    sizes = list(range(1, 40000, 997)) + [73729, 106496, 106497, 155648,
                                          155649, 1200000]
    for multiple in (256, 8192):
        assert [jdu.bucket_size(n, multiple) for n in sizes] == \
            [pdu.bucket_size(n, multiple) for n in sizes]
    assert pdu.bucket_size(91478) == 106496 and pdu.bucket_size(130575) == 155648
    for keys in ("x,heights", "pos,x,heights", "x"):
        got = pdu.get_features_by_keys(data, keys)
        assert isinstance(got, np.ndarray)
        _assert_same(jdu.get_features_by_keys(data, keys), got)
    counts = rng.randint(1, 10 ** 6, 13)
    for normalize in (False, True):
        _assert_same(jdu.get_class_weights(counts, normalize),
                     pdu.get_class_weights(counts, normalize))


@pytest.mark.parametrize("split", ["val", "test", "vote"])
def test_val_test_transforms_match_jax(split):
    cfg = JaxConfig()
    cfg.load(os.path.join(REPO, "cfgs", "s3dis", "default.yaml"), recursive=True)
    rng = np.random.RandomState(4)
    data = {"pos": rng.rand(500, 3) * 4, "x": rng.rand(500, 3) * 255}
    fn_jax = jax_transforms(split, cfg.datatransforms)
    fn_port = build_transforms_from_cfg(split, cfg.datatransforms)
    assert len(fn_port.transforms) == len(fn_jax.transforms)
    for seed in range(6):       # ChromaticDropGPU drops on some seeds only
        _assert_same(*_both(lambda p, x: fn_jax({"pos": p, "x": x}),
                            lambda p, x: fn_port({"pos": p, "x": x}),
                            seed, data["pos"], data["x"]))


def test_unported_transform_raises_by_name():
    """Every transform of the JAX package is registered now (each is held
    against its original in ``test_torch_port_traincli.py``), so the S3DIS
    train list builds; a name nobody registered still raises by name."""
    cfg = JaxConfig()
    cfg.load(os.path.join(REPO, "cfgs", "s3dis", "default.yaml"), recursive=True)
    built = build_transforms_from_cfg("train", cfg.datatransforms)
    assert [type(t).__name__ for t in built.transforms] == \
        list(cfg.datatransforms.train)
    import amcontrast3d_tpu.transforms as jt
    assert set(DataTransforms.module_dict) == set(jt.DataTransforms.module_dict)
    with pytest.raises(KeyError, match="ChromaticWarp"):
        build_transforms_from_cfg("train", {"train": ["ChromaticWarp"]})


@pytest.mark.parametrize("hard", [False, True])
def test_synthetic_rooms_match_jax(hard):
    kw = dict(num_rooms=2, n_points=3000, voxel_size=0.1, voxel_max=400,
              split="train", seed=5, hard=hard)
    a, b = jsyn.Synthetic(**kw), psyn.Synthetic(**kw)
    _assert_same(a.rooms, b.rooms)
    assert len(a) == len(b)
    _assert_same(*_both(lambda: a[1], lambda: b[1], 9))
    built = build_dataset_from_cfg({"NAME": "Synthetic", **kw}, {"split": "val"})
    assert isinstance(built, psyn.Synthetic) and built.split == "val"
    assert "Synthetic" in DATASETS.module_dict


# ---------------------------------------------------------------------------
# generate_data_list / load_data, the four dataset branches
# ---------------------------------------------------------------------------

def _dataset_cfg(cls, name, root, **common):
    cfg = cls()
    cfg.update({"dataset": {"common": {"NAME": name, "data_root": str(root),
                                       "voxel_size": 0.2, **common},
                            "test": {"split": "val"}}})
    return cfg


def _same_load(cfg_of, test_modes=("multi_voxel", "nearest_neighbor")):
    for mode in test_modes:
        cj, cp = cfg_of(JaxConfig), cfg_of(EasyConfig)
        cj.test_mode = cp.test_mode = mode
        lj, lp = jev.generate_data_list(cj), pev.generate_data_list(cp)
        assert lj == lp and len(lp) > 0
        for item in lp:
            _assert_same(*_both(lambda: jev.load_data(item, cj),
                                lambda: pev.load_data(item, cp), 11))


def test_load_data_synthetic_matches_jax():
    _same_load(lambda cls: _dataset_cfg(cls, "Synthetic", "", num_rooms=2,
                                        n_points=2000))


def test_load_data_s3dis_style_matches_jax(tmp_path):
    rng = np.random.RandomState(6)
    raw = tmp_path / "raw"
    raw.mkdir()
    for name in ("Area_5_office_1.npy", "Area_5_hallway_2.npy", "Area_1_x.npy"):
        room = np.concatenate([rng.rand(900, 3) * 3, rng.rand(900, 3) * 255,
                               rng.randint(0, 13, (900, 1))], 1)
        np.save(raw / name, room.astype(np.float64))
    _same_load(lambda cls: _dataset_cfg(cls, "S3DIS", tmp_path, test_area=5))
    assert len(pev.generate_data_list(
        _dataset_cfg(EasyConfig, "S3DIS", tmp_path, test_area=5))) == 2


def test_load_data_scannet_style_matches_jax(tmp_path):
    rng = np.random.RandomState(7)
    (tmp_path / "val").mkdir()
    for i in range(2):
        torch.save((rng.rand(800, 3).astype(np.float32) * 3,
                    rng.rand(800, 3).astype(np.float32) * 2 - 1,
                    rng.randint(0, 20, 800)), tmp_path / "val" / f"scene{i}.pth")
    _same_load(lambda cls: _dataset_cfg(cls, "ScanNet", tmp_path))


def test_load_data_semantickitti_style_matches_jax(tmp_path):
    rng = np.random.RandomState(8)
    for seq in ("00", "08", "11"):
        for sub in ("velodyne", "labels"):
            (tmp_path / "sequences" / seq / sub).mkdir(parents=True)
        for i in range(2):
            scan = (rng.rand(600, 4) * 20).astype(np.float32)
            scan.tofile(tmp_path / "sequences" / seq / "velodyne" / f"{i:06d}.bin")
            lab = rng.choice([0, 10, 40, 48, 50, 70, 252], 600).astype(np.uint32)
            lab.tofile(tmp_path / "sequences" / seq / "labels" / f"{i:06d}.label")
    _same_load(lambda cls: _dataset_cfg(cls, "SemanticKITTI", tmp_path),
               test_modes=("multi_voxel",))


def test_unknown_dataset_raises():
    with pytest.raises(ValueError):
        pev.generate_data_list(_dataset_cfg(EasyConfig, "ModelNet", ""))


# ---------------------------------------------------------------------------
# boundary / ambiguity metrics
# ---------------------------------------------------------------------------

def _grid_points(rng, n, cells=128, extent=4.0):
    return (rng.randint(0, int(cells * extent), (n, 3)) / cells).astype(np.float32)


@pytest.mark.parametrize("ignore_index", [None, 3])
def test_posmask_ambiguity_and_metrics_match_jax(ignore_index):
    rng = np.random.RandomState(9)
    xyz = _grid_points(rng, 600)
    target = (xyz[:, 0] * 2).astype(np.int64) % 5
    pj, ij = jev.posmask_searching(xyz, target, 8, 5, ignore_index)
    pp, ip = pev.posmask_searching(xyz, target, 8, 5, ignore_index,
                                   device="cpu")
    # neighbour order may differ inside a d² tie; the sets and masks may not
    np.testing.assert_array_equal(np.sort(ij, -1), np.sort(ip, -1))
    np.testing.assert_array_equal(pj.sum(-1), pp.sum(-1))
    for cctype in ("Method1", "Method2", "Method3"):
        aj = jev.ambiguity_for_cloud(xyz, pj, ij, cctype, 0.04)
        ap = pev.ambiguity_for_cloud(xyz, pj, ij, cctype, 0.04)
        np.testing.assert_allclose(ap, aj, rtol=0, atol=1e-6)
    pred = np.where(rng.rand(600) < 0.8, target, (target + 1) % 5)
    a = jev.ambiguity_for_cloud(xyz, pj, ij, "Method2", 0.04)
    rj = jev.ambiguity_metrics(a, target, pred, 0.5, [JaxCM(5) for _ in range(5)])
    rp = pev.ambiguity_metrics(a, target, pred, 0.5,
                               [ConfusionMatrix(5) for _ in range(5)])
    assert rj == rp
    assert pev.ambiguity_summary([rp, rp]) == jev.ambiguity_summary([rj, rj])


def test_confusion_matrix_update_and_meter_match_jax():
    rng = np.random.RandomState(10)
    pred, true = rng.randint(0, 6, 500), rng.randint(0, 6, 500)
    for ignore in (None, 2):
        cj, cp = JaxCM(6, ignore), ConfusionMatrix(6, ignore)
        for sl in (slice(0, 200), slice(200, 500)):
            cj.update(pred[sl], true[sl])
            cp.update(pred[sl], true[sl])
        np.testing.assert_array_equal(cj.value, cp.value)
        assert cj.all_metrics()[:3] == cp.all_metrics()[:3]
    meter = AverageMeter()
    meter.update(2.0, 3)
    meter.update(4.0)
    assert (meter.val, meter.sum, meter.count, meter.avg) == (4.0, 10.0, 4, 2.5)


def test_set_random_seed_seeds_all_three():
    import random
    g = set_random_seed(7)
    first = (random.random(), np.random.rand(), torch.rand(1).item(),
             torch.rand(1, generator=g).item())
    g = set_random_seed(7)
    assert first == (random.random(), np.random.rand(), torch.rand(1).item(),
                     torch.rand(1, generator=g).item())


def test_vis_writers_round_trip(tmp_path):
    rng = np.random.RandomState(11)
    pts, lab = rng.rand(20, 3).astype(np.float32), rng.randint(0, 5, 20)
    import amcontrast3d_tpu.utils.vis as jvis
    np.testing.assert_array_equal(labels_to_colors(lab), jvis.labels_to_colors(lab))
    write_obj(pts, labels_to_colors(lab), str(tmp_path / "a" / "c.obj"))
    got, cols = read_obj(str(tmp_path / "a" / "c.obj"))
    np.testing.assert_allclose(got, pts, atol=1e-4)
    np.testing.assert_allclose(cols, labels_to_colors(lab), atol=1e-6)


# ---------------------------------------------------------------------------
# the whole-scene test, AA and MM, both packages
# ---------------------------------------------------------------------------

def _load_cfg(cls, kind, run_dir, extra=()):
    cfg = cls()
    cfg.load(CFG[kind], recursive=True)
    cfg.update(list(OVERRIDES) + list(extra))
    cfg.run_dir = str(run_dir)
    return cfg


def _grid_transforms(module, monkeypatch):
    """``module``'s transform pipelines end by snapping the positions to a
    1/128 m grid (see the module doc)."""
    build = module.build_transforms_from_cfg

    def snap(data):
        data["pos"] = (np.round(data["pos"] * 128) / 128).astype(np.float32)
        return data

    def snapped(split, cfg):
        pipeline = build(split, cfg)
        pipeline.transforms.append(snap)
        return pipeline

    monkeypatch.setattr(module, "build_transforms_from_cfg", snapped)


def _recording(predict, logits, to_numpy):
    def wrapped(*args):
        out = predict(*args)
        logits.append(to_numpy(out))
        return out
    return wrapped


@pytest.fixture(scope="module", params=["aa", "mm"])
def scene(request, tmp_path_factory):
    """Both packages' ``test_whole_scenes`` on one synthetic room with the
    same weights: (kind, JAX result, port result, per-subcloud logits of
    both, the port runner, the port cfg)."""
    kind = request.param
    mp = pytest.MonkeyPatch()
    _grid_transforms(jev, mp)
    _grid_transforms(pev, mp)
    try:
        cj = _load_cfg(JaxConfig, kind, tmp_path_factory.mktemp(f"jax_{kind}"))
        jrunner = JaxRunner(cj, kind=kind)
        ds = jsyn.Synthetic(**{**dict(cj.dataset.common), "split": "val",
                               "voxel_max": 256, "transform":
                               jax_transforms("val", cj.datatransforms)})
        cj.steps_per_epoch = 1
        state = jrunner.build_state(jax_prep_batch(
            {k: v[None] for k, v in ds[0].items()}, cj))
        jlogits = []
        jrunner._steps["predict"] = _recording(
            jrunner.predict_fn(), jlogits, lambda o: np.asarray(o)[0])
        rj = jev.test_whole_scenes(jrunner, state, jev.generate_data_list(cj), cj)

        cp = _load_cfg(EasyConfig, kind, tmp_path_factory.mktemp(f"port_{kind}"))
        runner = Runner(cp, kind=kind, device="cpu")
        import jax
        variables = jax.tree_util.tree_map(
            np.asarray, {"params": state.params, "batch_stats": state.batch_stats})
        runner.model.load_state_dict(from_jax_variables(variables), strict=True)
        plogits = []
        runner._predict = _recording(runner.predict_fn(), plogits,
                                     lambda o: o[0].numpy())
        rp = pev.test_whole_scenes(runner, pev.generate_data_list(cp), cp)
    finally:
        mp.undo()
    return kind, rj, rp, jlogits, plogits, runner, cp, cj


def test_whole_scene_subcloud_logits_match_jax(scene):
    kind, rj, rp, jlogits, plogits, *_ = scene
    cloud = rp["clouds"][0]
    assert cloud["finite"] and len(cloud["subclouds"]) == len(plogits) > 1
    assert len(jlogits) == len(plogits)
    assert all(b % 256 == 0 and b >= n for n, b in
               zip(cloud["subclouds"], cloud["buckets"]))
    for lj, lp in zip(jlogits, plogits):
        assert lj.shape == lp.shape
        err = np.abs(lj - lp).max()
        assert err <= 1e-4 * (1 + np.abs(lj).max()), err


def test_whole_scene_votes_and_metrics_match_jax(scene):
    kind, rj, rp, jlogits, plogits, runner, cp, cj = scene
    pred_j = np.loadtxt(os.path.join(cj.run_dir, "predictions", "cloud_0.txt"))
    pred_p = np.loadtxt(os.path.join(cp.run_dir, "predictions", "cloud_0.txt"))
    assert len(pred_p) == rp["clouds"][0]["points"] == rp["cm"].total
    # the voted logits again, from the split and the recorded logits
    np.random.seed(0)
    _, _, _, idx_points, *_ = pev.load_data(0, cp)
    votes = np.zeros((len(pred_p), cp.num_classes), np.float64)
    count = np.zeros(len(pred_p))
    for idx_part, logits in zip(idx_points, plogits):
        np.add.at(votes, idx_part, logits[:len(idx_part)])
        np.add.at(count, idx_part, 1)
    votes /= count[:, None]
    np.testing.assert_array_equal(votes.argmax(-1), pred_p)
    top2 = np.sort(votes, -1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 1e-4 * (1 + np.abs(votes).max())
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(pred_j[clear], pred_p[clear])
    for key in ("miou", "macc", "oa"):
        assert abs(rj[key] - rp[key]) <= 0.05, key
    for key in ("boundary", "inner"):
        assert np.abs(np.subtract(rj[key], rp[key])).max() <= 0.05, key
    total = sum(rp["clouds"][0]["subclouds"])
    assert rp["cm_boundary"].total + rp["cm_inner"].total == total
    np.testing.assert_allclose(rj["ambiguity"]["count_pct"],
                               rp["ambiguity"]["count_pct"], atol=0.05)
    np.testing.assert_allclose(rj["ambiguity_summary"]["miou"],
                               rp["ambiguity_summary"]["miou"], atol=0.05)


def test_validate_and_boundary_inner_run_on_the_port(scene):
    kind, *_, runner, cp, cj = scene
    ds = psyn.Synthetic(**{**dict(cp.dataset.common), "split": "val",
                           "voxel_max": 300, "transform":
                           build_transforms_from_cfg("val", cp.datatransforms)})
    np.random.seed(1)
    batches = [{k: v[None] for k, v in ds[0].items()}]
    miou, macc, oa, ious, accs = runner.validate(batches)
    assert 0 <= miou <= 100 and len(ious) == cp.num_classes
    assert runner.validate_boundary_inner(batches)[:3] == (miou, macc, oa)
    # training and the sphere protocol are ported: the sphere validation
    # wants a loader whose dataset holds the clouds, not bare batches
    assert callable(runner.train) and runner.optimizer is None
    with pytest.raises(AttributeError, match="dataset"):
        runner.validate_sphere(batches)


# ---------------------------------------------------------------------------
# checkpoints and the CLI
# ---------------------------------------------------------------------------

def _tiny_cfg(tmp_path, **extra):
    cfg = EasyConfig()
    cfg.update({"run_name": "run", "ckpt_dir": str(tmp_path), **extra})
    return cfg


def test_checkpoint_round_trip_and_encoder_only(tmp_path):
    cfg = EasyConfig()
    cfg.load(CFG["aa"], recursive=True)
    a, b = Runner(cfg, "aa", "cpu").model, Runner(cfg, "aa", "cpu").model
    for p in b.parameters():
        torch.nn.init.normal_(p)
    opt = torch.optim.AdamW(a.parameters(), lr=0.1)
    ck = _tiny_cfg(tmp_path, save_freq=2)
    path = save_checkpoint(ck, {"model": a.state_dict(),
                                "optimizer": opt.state_dict()}, 4,
                           additioanl_dict={"best_val": 51.5}, is_best=True)
    assert sorted(os.listdir(tmp_path)) == [
        "run_E4.ckpt", "run_ckpt_best.ckpt", "run_ckpt_latest.ckpt"]
    before = {k: v.clone() for k, v in b.state_dict().items()}
    epoch, extras = load_checkpoint(b, path, module="encoder")
    assert (epoch, extras["best_val"]) == (4, 51.5)
    for k, v in b.state_dict().items():
        want = a.state_dict()[k] if k.startswith("encoder.") else before[k]
        assert torch.equal(v, want), k
    ck.pretrained_path = path
    assert resume_checkpoint(ck, b, opt)["epoch"] == 4 and ck.start_epoch == 5
    for k, v in b.state_dict().items():
        assert torch.equal(v, a.state_dict()[k]), k
    with pytest.raises(FileNotFoundError):
        load_checkpoint(b, str(tmp_path / "none.ckpt"))
    torch.save({"model": {}}, tmp_path / "foreign.pth")
    with pytest.raises(ValueError, match="not a checkpoint of this package"):
        load_checkpoint(b, str(tmp_path / "foreign.pth"))


@pytest.mark.parametrize("kind", ["aa", "mm"])
def test_cli_test_mode_on_cpu(kind, tmp_path):
    argv = ["--cfg", CFG[kind], "--device", "cpu", *OVERRIDES,
            "save_pred=False", f"root_dir={tmp_path}"]
    results = pcli.main_cli(kind, argv)
    assert np.isfinite(results["miou"]) and "boundary" in results
    assert os.path.isfile(results["csv_path"])
    assert os.path.isfile(os.path.join(results["run_dir"], "cfg.yaml"))
    rows = open(results["csv_path"]).read().splitlines()
    assert rows[0].startswith("method,Area,OA,mACC,mIoU") and len(rows) == 2
    # the same run from a checkpoint of these weights gives the same numbers
    cfg = EasyConfig()
    cfg.load(CFG[kind], recursive=True)
    cfg.update(["seed=3"])
    model = Runner(cfg, kind, "cpu").model
    path = save_checkpoint(_tiny_cfg(tmp_path), {"model": model.state_dict()}, 1)
    again = pcli.main_cli(None, ["--kind", kind] + argv[:-1] + [
        f"root_dir={tmp_path}", f"pretrained_path={path}"])
    np.testing.assert_array_equal(results["cm"].value, again["cm"].value)


def test_cli_val_mode_and_training_modes(tmp_path):
    argv = ["--cfg", CFG["aa"], "--device", "cpu", f"root_dir={tmp_path}",
            "dataset.common.num_rooms=1", "dataset.common.n_points=2500",
            "dataset.common.voxel_size=0.1", "dataset.val.voxel_max=300",
            "eval_bucket=256", "seed=3"]
    out = pcli.main_cli("aa", argv + ["mode=val"])
    assert set(out) == {"miou", "macc", "oa"} and np.isfinite(out["miou"])
    # every other mode trains (one step an epoch here)
    short = argv + ["dataset.train.voxel_max=300", "dataset.train.loop=2",
                    "batch_size=2", "epochs=1"]
    latest = None
    for mode in ("train", "resume", "finetune_encoder"):
        extra = [f"pretrained_path={latest}"] if mode == "finetune_encoder" else []
        out = pcli.main_cli("aa", short + [f"mode={mode}"] + extra)
        assert np.isfinite(out["timing"][0]["loss"]) and out["timing"][0]["steps"] == 1
        latest = os.path.join(out["run_dir"], "checkpoint", os.path.basename(
            out["run_dir"]) + "_ckpt_latest.ckpt")
        assert os.path.isfile(latest)


def test_entry_points_need_a_card_unless_cpu_is_named():
    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(None)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pcli.main_cli("aa", ["--cfg", CFG["aa"], "mode=test"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pev.posmask_searching(np.zeros((9, 3), np.float32),
                                  np.zeros(9, np.int64), 4, 2)
