"""Whole-scene voting test + boundary/inner + ambiguity-stratified metrics.

↔ ``amcontrast3d_tpu/engine/evaluate.py`` (itself ↔
``examples/segmentation/main_AA.py:516-802`` ``test_boundary_inner`` and
``openpoints/AMContrast3D/metrics.py`` ``posmask_searching``,
``ambiguity_metrics``).  The host side (subcloud split, padding, voting,
metrics) is the JAX package's numpy code; the forward and the boundary kNN
run on the runner's device, one subcloud per dispatch.  Scoring several
subclouds per dispatch over a device mesh waits for the data-parallel
slice (ROADMAP.md).

Pipeline per cloud (multi_voxel mode): voxelize(mode=1) → one subcloud per
voxel rank (each picks point ``i % count`` of every voxel) → per-subcloud
forward (bucket-padded for fixed shapes) → concatenate → scatter-MEAN the
logits back onto original points → argmax → confusion matrices.

Reference quirk reproduced: the boundary mask is
``0 < Σ posmask < nsample`` (main_AA.py:631-633) where Σ posmask ≤ nsample−1,
i.e. "has at least one same-label neighbor".
"""
from __future__ import annotations

import glob
import logging
import os
import time
from typing import Dict, List

import numpy as np
import torch

from ..data.data_util import bucket_size, get_features_by_keys, pad_cloud, voxelize
from ..ops import ambiguity_function, knn
from ..transforms import build_transforms_from_cfg
from ..utils import ConfusionMatrix, get_mious
from .runner import resolve_device


def generate_data_list(cfg) -> List:
    """↔ main_AA.py:52-68."""
    name = cfg.dataset.common.NAME.lower()
    if "s3dis" in name:
        raw_root = os.path.join(cfg.dataset.common.data_root, "raw")
        data_list = sorted(os.listdir(raw_root))
        return [os.path.join(raw_root, item) for item in data_list
                if f"Area_{cfg.dataset.common.test_area}" in item]
    if "scannet" in name:
        return sorted(glob.glob(os.path.join(
            cfg.dataset.common.data_root, cfg.dataset.test.split, "*.pth")))
    if "semantickitti" in name:
        # ↔ main_AA.py:60-65: each entry is a [velodyne.bin, .label] pair
        from ..data.semantickitti import get_semantickitti_file_list
        split_no = 1 if cfg.dataset.test.split == "val" else 2
        return get_semantickitti_file_list(
            os.path.join(cfg.dataset.common.data_root, "sequences"),
            str(cfg.dataset.test.get("test_id", 0) + 11))[split_no]
    if "synthetic" in name:
        from ..data.synthetic import Synthetic
        ds = Synthetic(**{**dict(cfg.dataset.common),
                          **dict(cfg.dataset.get("test", {})),
                          "transform": None})
        return list(range(len(ds.rooms)))
    raise ValueError(f"dataset {name} not supported for whole-scene test")


def load_data(data_path, cfg):
    """↔ main_AA.py:74-116 (multi_voxel / nearest_neighbor subcloud split)."""
    name = cfg.dataset.common.NAME.lower()
    label, feat = None, None
    if "s3dis" in name:
        data = np.load(data_path)  # xyzrgbl
        coord, feat, label = data[:, :3], data[:, 3:6], data[:, 6]
        feat = np.clip(feat / 255.0, 0, 1).astype(np.float32)
    elif "scannet" in name:
        data = torch.load(data_path, weights_only=False)
        coord, feat = np.asarray(data[0]), np.asarray(data[1])
        label = np.asarray(data[2]) if cfg.dataset.test.split != "test" else None
        feat = np.clip((feat + 1) / 2.0, 0, 1).astype(np.float32)
    elif "semantickitti" in name:
        # ↔ main_AA.py:85-88: .bin scan + .label remapped via the read LUT
        from ..data.semantickitti import (load_label_kitti, load_pc_kitti,
                                          remap_lut_read)
        coord = load_pc_kitti(data_path[0])
        if cfg.dataset.test.split != "test":
            label = load_label_kitti(data_path[1], remap_lut_read)
    elif "synthetic" in name:
        from ..data.synthetic import Synthetic
        ds = Synthetic(**{**dict(cfg.dataset.common),
                          **dict(cfg.dataset.get("test", {})),
                          "transform": None})
        coord, color, label = ds.rooms[int(data_path)]
        coord, feat = coord.copy(), color.copy()
    else:
        raise ValueError(name)
    coord -= coord.min(0)

    idx_points = []
    voxel_idx, reverse_idx_part, reverse_idx_sort = None, None, None
    voxel_size = cfg.dataset.common.get("voxel_size", None)
    if voxel_size is not None:
        idx_sort, voxel_idx, count = voxelize(coord, voxel_size, mode=1)
        if cfg.get("test_mode", "multi_voxel") == "nearest_neighbor":
            idx_select = (np.cumsum(np.insert(count, 0, 0)[0:-1]) +
                          np.random.randint(0, count.max(), count.size) % count)
            idx_part = idx_sort[idx_select]
            npoints_subcloud = voxel_idx.max() + 1
            idx_shuffle = np.random.permutation(npoints_subcloud)
            idx_part = idx_part[idx_shuffle]
            reverse_idx_part = np.argsort(idx_shuffle, axis=0)
            idx_points.append(idx_part)
            reverse_idx_sort = np.argsort(idx_sort, axis=0)
        else:
            for i in range(count.max()):
                idx_select = (np.cumsum(np.insert(count, 0, 0)[0:-1]) +
                              i % count)
                idx_part = idx_sort[idx_select]
                np.random.shuffle(idx_part)
                idx_points.append(idx_part)
    else:
        idx_points.append(np.arange(len(coord)))
    return (coord, feat, label, idx_points, voxel_idx, reverse_idx_part,
            reverse_idx_sort)


# ---------------------------------------------------------------------------
# boundary / ambiguity metrics
# ---------------------------------------------------------------------------

def posmask_searching(xyz: np.ndarray, target: np.ndarray, nsample: int,
                      num_classes: int, ignore_index=None, device=None):
    """↔ AMContrast3D/metrics.py:160-184 on a flat (N, 3) cloud; the kNN
    runs through the CUDA kernels on the card, or on the plain path when
    the caller names the CPU (``device="cpu"``).

    Returns (posmask (N, nsample-1) bool, neighbor_idx (N, nsample-1)).
    """
    lab = np.asarray(target).astype(np.int64)
    if ignore_index is not None:   # ignored points form a class of their own
        lab = np.where(lab == ignore_index, num_classes, lab)
    p = torch.from_numpy(np.ascontiguousarray(xyz[None], np.float32)).to(
        resolve_device(device))
    idx, _ = knn(p, p, nsample)
    idx = idx[0, :, 1:].cpu().numpy()  # drop self-loop
    neigh_lab = lab[idx]
    posmask = lab[:, None] == neigh_lab
    return posmask, idx


def ambiguity_for_cloud(xyz: np.ndarray, posmask: np.ndarray,
                        neighbor_idx: np.ndarray, cctype: str,
                        ccbeta: float) -> np.ndarray:
    dp = xyz[neighbor_idx] - xyz[:, None, :]
    dd = np.sum(dp * dp, axis=-1)
    return ambiguity_function(torch.from_numpy(posmask),
                              torch.from_numpy(dd.astype(np.float32)),
                              cctype, ccbeta).numpy()


def ambiguity_metrics(ambiguity_soft: np.ndarray, label: np.ndarray,
                      pred: np.ndarray, nu: float, cms: List[ConfusionMatrix]):
    """Bucketed {0, low, ν, high, 1} metrics (↔ metrics.py:33-156).

    ``cms`` is the list of 5 accumulating confusion matrices."""
    mapping = np.floor(ambiguity_soft * 10 + 1)
    nu_m = nu * 10 + 1
    buckets = [mapping == 1,
               np.logical_and(1 < mapping, mapping < nu_m),
               mapping == nu_m,
               np.logical_and(nu_m < mapping, mapping < 11),
               mapping == 11]
    results = {"miou": [], "macc": [], "oa": [], "count_pct": []}
    for cm, mask in zip(cms, buckets):
        cm.update(pred[mask], label[mask])
        miou, macc, oa, _, _ = get_mious(cm.tp, cm.union, cm.count)
        results["miou"].append(round(miou, 2))
        results["macc"].append(round(macc, 2))
        results["oa"].append(round(oa, 2))
        results["count_pct"].append(round(float(mask.sum()) / len(mapping) * 100, 2))
    return results


# ---------------------------------------------------------------------------
# whole-scene voting test
# ---------------------------------------------------------------------------

def ambiguity_summary(amb_results: List[Dict]) -> Dict:
    """Aggregate per-cloud ambiguity-bucket metrics (↔ metrics.py:9-29):
    mean mIoU/mACC/OA/count% per {0, low, ν, high, 1} bucket."""
    out = {}
    for key in ("miou", "macc", "oa", "count_pct"):
        out[key] = np.round(np.mean([r[key] for r in amb_results], axis=0),
                            2).tolist()
    logging.info("miou per ambiguity: %s", out["miou"])
    logging.info("macc per ambiguity: %s", out["macc"])
    logging.info("oa per ambiguity: %s", out["oa"])
    logging.info("count%% per ambiguity: %s", out["count_pct"])
    return out


def prepare_parts(coord, feat, idx_points, cfg, pipe_transform) -> List:
    """Host prep of every voxel-rank subcloud of one cloud: shift to the
    origin, the val/test transforms, heights, bucket padding.  Returns per
    subcloud ``(idx_part, n, bucket, pos (bucket, 3), x (bucket, C))``.

    Padding draws from a local RNG so it does not perturb the global
    shuffle stream (the reference has no padding; keeping the np.random
    sequence identical makes the subcloud split byte-comparable)."""
    gravity_dim = 2
    pad_rng = np.random.RandomState(0)
    parts = []
    for idx_part in idx_points:
        coord_part = coord[idx_part].copy()
        coord_part -= coord_part.min(0)
        data = {"pos": coord_part.astype(np.float32)}
        if feat is not None:
            data["x"] = feat[idx_part].copy()
        data = pipe_transform(data)
        if "heights" in cfg.feature_keys and "heights" not in data:
            data["heights"] = coord_part[:, gravity_dim:gravity_dim + 1].astype(np.float32)
        n = len(idx_part)
        nb = bucket_size(n, cfg.get("eval_bucket", 8192))
        data = pad_cloud(data, nb, rng=pad_rng)
        parts.append((idx_part, n, nb, data["pos"],
                      np.asarray(get_features_by_keys(data, cfg.feature_keys))))
    return parts


def test_whole_scenes(runner, data_list, cfg) -> Dict:
    """↔ ``test_boundary_inner`` (main_AA.py:516-802): per-cloud voxel-rank
    subclouds → model → scatter-mean voting → global CM (+ optional
    boundary/inner and ambiguity-bucket CMs).

    Beside the metrics the result holds ``clouds``: per cloud its points,
    voxels, subcloud sizes and buckets, whether every logit was finite,
    and the host-clock seconds of its phases (``prep_s`` host preparation,
    ``forward_s`` device forward with the copies to and from the device,
    ``vote_s`` voting, ``boundary_s`` the boundary/inner and ambiguity
    neighbour searches and their metrics)."""
    # ↔ main_AA.py:522 set_random_seed(0): pins the subcloud shuffle stream
    # so test-mode predictions are reproducible (and comparable with the
    # reference run on the same rooms)
    from ..utils.random import set_random_seed
    set_random_seed(0)
    predict = runner.predict_fn()
    device = runner.device
    aargs = dict(cfg.get("ambiguity_args", {}) or {})
    miou_b_i = bool(aargs.get("miou_B_I", False))
    action = bool(aargs.get("action", False))

    trans_cfg = cfg.get("datatransforms")
    pipe_transform = build_transforms_from_cfg(
        "test" if (trans_cfg and trans_cfg.get("test")) else "val", trans_cfg)

    all_cm = ConfusionMatrix(cfg.num_classes, cfg.get("ignore_index"))
    cm_b = ConfusionMatrix(cfg.num_classes, cfg.get("ignore_index"))
    cm_i = ConfusionMatrix(cfg.num_classes, cfg.get("ignore_index"))
    amb_cms = [ConfusionMatrix(cfg.num_classes, cfg.get("ignore_index"))
               for _ in range(5)]
    amb_results = []
    clouds = []

    for cloud_idx, data_path in enumerate(data_list):
        t_start = time.perf_counter()
        (coord, feat, label, idx_points, voxel_idx, reverse_idx_part,
         reverse_idx_sort) = load_data(data_path, cfg)
        n_total = len(coord)
        vote_sum = np.zeros((n_total, cfg.num_classes), np.float32)
        vote_cnt = np.zeros((n_total,), np.float32)
        nearest_neighbor = len(idx_points) == 1 and voxel_idx is not None and \
            cfg.get("test_mode", "multi_voxel") == "nearest_neighbor"

        # phase 1 — host prep of every voxel-rank subcloud
        parts = prepare_parts(coord, feat, idx_points, cfg, pipe_transform)
        t_prep = time.perf_counter()

        # phase 2 — score, bucket by bucket, one subcloud per dispatch; the
        # logits come back to the host per subcloud
        part_logits = [None] * len(parts)
        by_nb: Dict[int, List[int]] = {}
        for j, p in enumerate(parts):
            by_nb.setdefault(p[2], []).append(j)
        for nb in sorted(by_nb):
            for j in by_nb[nb]:
                batch = runner.put_batch({"pos": parts[j][3][None],
                                          "x": parts[j][4][None]})
                part_logits[j] = predict(batch)[0, :parts[j][1]].cpu().numpy()
        t_forward = time.perf_counter()

        # phase 3 — scatter-mean voting (order-independent sums)
        sub_logits_cache = None
        for (idx_part, n, _, _, _), logits in zip(parts, part_logits):
            # a point occurs once in a subcloud (padding is cut off above),
            # so the indexed += is np.add.at, several times faster
            vote_sum[idx_part] += logits
            vote_cnt[idx_part] += 1.0
            sub_logits_cache = (idx_part, logits)

        if nearest_neighbor:
            idx_part, logits = sub_logits_cache
            full = logits[reverse_idx_part][voxel_idx][reverse_idx_sort]
            pred = full.argmax(-1)
        else:
            pred = (vote_sum / np.maximum(vote_cnt, 1.0)[:, None]).argmax(-1)
        t_vote = time.perf_counter()

        if label is not None:
            label = np.asarray(label).squeeze().astype(np.int64)
            all_cm.update(pred, label)

            if miou_b_i:
                # Reference protocol (main_AA.py:624-643): the boundary/inner
                # split is PER-SUBCLOUD — each voxel-rank part contributes
                # its own pre-voting argmax, masked by a posmask computed on
                # that part's transformed coords (so a point in several
                # ranks is counted once per rank, with that rank's
                # prediction — not the voted one).
                for (idx_part, n, _, pos_pad, _), logits in zip(parts,
                                                                part_logits):
                    label_part = label[idx_part]
                    pm_part, _ = posmask_searching(
                        np.asarray(pos_pad[:n]), label_part,
                        aargs["nsample"], cfg.num_classes,
                        cfg.get("ignore_index"), device)
                    s = pm_part.sum(-1)
                    boundary = np.logical_and(0 < s, s < aargs["nsample"])
                    pred_part = logits.argmax(-1)
                    cm_b.update(pred_part[boundary], label_part[boundary])
                    cm_i.update(pred_part[~boundary], label_part[~boundary])
            if action:
                data_test = pipe_transform({"pos": coord.copy().astype(np.float32),
                                            "x": feat.copy() if feat is not None else None})
                p_full = np.asarray(data_test["pos"])
                posmask, neighbor_idx = posmask_searching(
                    p_full, label, aargs["nsample"], cfg.num_classes,
                    cfg.get("ignore_index"), device)
                a = ambiguity_for_cloud(p_full, posmask, neighbor_idx,
                                        aargs.get("cctype", "Method2"),
                                        aargs.get("ccbeta", 0.04))
                amb_results.append(ambiguity_metrics(a, label, pred,
                                                     aargs.get("nu", 0.5),
                                                     amb_cms))
        t_boundary = time.perf_counter()
        clouds.append({
            "points": n_total,
            "voxels": int(voxel_idx.max()) + 1 if voxel_idx is not None else n_total,
            "subclouds": [p[1] for p in parts],
            "buckets": [p[2] for p in parts],
            "finite": bool(all(np.isfinite(l).all() for l in part_logits)),
            "prep_s": t_prep - t_start, "forward_s": t_forward - t_prep,
            "vote_s": t_vote - t_forward, "boundary_s": t_boundary - t_vote})
        if cfg.get("visualize"):
            # ↔ main_AA.py:713-735: export gt / pred colored clouds
            from ..utils.vis import labels_to_colors, write_obj
            vis_dir = os.path.join(cfg.get("run_dir", "."), "visualization")
            cmap = getattr(cfg, "cmap", None)
            name = f"{cfg.dataset.common.NAME.lower()}-{cloud_idx}"
            write_obj(coord, labels_to_colors(pred, cmap),
                      os.path.join(vis_dir, f"{name}-pred.obj"))
            if label is not None:
                write_obj(coord, labels_to_colors(label, cmap),
                          os.path.join(vis_dir, f"{name}-gt.obj"))
        if cfg.get("save_pred"):
            # ↔ main_AA.py:736-751: benchmark submission export
            pred_dir = os.path.join(cfg.get("run_dir", "."), "predictions")
            os.makedirs(pred_dir, exist_ok=True)
            dname = cfg.dataset.common.NAME.lower()
            if "scannet" in dname:
                # remap train ids → raw ScanNet label ids
                valid_ids = np.array([1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12,
                                      14, 16, 24, 28, 33, 34, 36, 39])
                out = valid_ids[pred]
                base = os.path.splitext(os.path.basename(str(data_path)))[0]
                np.savetxt(os.path.join(pred_dir, base + ".txt"), out,
                           fmt="%d")
            elif "semantickitti" in dname:
                from ..data.semantickitti import remap_lut_write
                out = remap_lut_write[pred + 1].astype(np.uint32)
                out.tofile(os.path.join(pred_dir, f"{cloud_idx:06d}.label"))
            else:
                np.savetxt(os.path.join(pred_dir, f"cloud_{cloud_idx}.txt"),
                           pred, fmt="%d")
        logging.info("Test cloud [%d/%d] done (%d pts)", cloud_idx + 1,
                     len(data_list), n_total)

    miou, macc, oa, ious, accs = get_mious(all_cm.tp, all_cm.union, all_cm.count)
    # per-class values as plain lists so they survive artifact serialization
    # (json / the convergence tool's snippet filter)
    out = {"miou": miou, "macc": macc, "oa": oa,
           "ious": np.asarray(ious).tolist(),
           "accs": np.asarray(accs).tolist(), "cm": all_cm, "clouds": clouds}
    if miou_b_i:
        out["cm_boundary"], out["cm_inner"] = cm_b, cm_i
        out["boundary"] = [float(v) for v in
                           get_mious(cm_b.tp, cm_b.union, cm_b.count)[:3]]
        out["inner"] = [float(v) for v in
                        get_mious(cm_i.tp, cm_i.union, cm_i.count)[:3]]
    if action and amb_results:
        out["ambiguity"] = amb_results[-1]
        out["ambiguity_summary"] = ambiguity_summary(amb_results)
    return out
