"""Host-side data utilities (numpy) — ↔ ``amcontrast3d_tpu/data/data_util.py``
(itself ↔ openpoints/dataset/data_util.py), copied: the port imports nothing
of the JAX package.

``voxelize`` (FNV-hash voxel grid, data_util.py:108-143), ``crop_pc``
(data_util.py:146-174) and ``get_features_by_keys`` (channels-last here,
data_util.py:177-189).  These run on the host CPU feeding the device, exactly
like the reference's dataloader workers.

Fixed-shape padding: :func:`pad_cloud` rounds a variable-size cloud
up to a bucket size by repeating random real points — the same trick the
reference uses for non-variable batching (``crop_pc`` padding branch,
data_util.py:160-166) — so kNN/FPS see no phantom coordinates and voting
simply counts duplicates twice.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def fnv_hash_vec(arr: np.ndarray) -> np.ndarray:
    """FNV64-1A over integer coordinate rows (data_util.py:95-105)."""
    assert arr.ndim == 2
    arr = arr.copy().astype(np.uint64)
    hashed_arr = np.uint64(14695981039346656037) * np.ones(
        arr.shape[0], dtype=np.uint64)
    for j in range(arr.shape[1]):
        hashed_arr *= np.uint64(1099511628211)
        hashed_arr = np.bitwise_xor(hashed_arr, arr[:, j])
    return hashed_arr


def ravel_hash_vec(arr: np.ndarray) -> np.ndarray:
    """Ravel (row-major) hash (data_util.py:108-125)."""
    assert arr.ndim == 2
    arr = arr.copy()
    arr -= arr.min(0)
    arr = arr.astype(np.uint64, copy=False)
    arr_max = arr.max(0).astype(np.uint64) + 1
    keys = np.zeros(arr.shape[0], dtype=np.uint64)
    for j in range(arr.shape[1] - 1):
        keys += arr[:, j]
        keys *= arr_max[j + 1]
    keys += arr[:, -1]
    return keys


def voxelize(coord: np.ndarray, voxel_size=0.05, hash_type: str = "fnv",
             mode: int = 0):
    """mode 0 (train): random point per voxel → unique idx.
    mode 1 (val/test): (idx_sort, voxel_idx, count) for voting
    (data_util.py:127-143)."""
    discrete_coord = np.floor(coord / np.array(voxel_size))
    if hash_type == "ravel":
        key = ravel_hash_vec(discrete_coord)
    else:
        key = fnv_hash_vec(discrete_coord)
    idx_sort = np.argsort(key)
    key_sort = key[idx_sort]
    _, voxel_idx, count = np.unique(key_sort, return_counts=True,
                                    return_inverse=True)
    if mode == 0:
        idx_select = (np.cumsum(np.insert(count, 0, 0)[0:-1]) +
                      np.random.randint(0, count.max(), count.size) % count)
        return idx_sort[idx_select]
    return idx_sort, voxel_idx, count


def crop_pc(coord, feat, label, split: str = "train", voxel_size: float = 0.04,
            voxel_max: Optional[int] = None, downsample: bool = True,
            variable: bool = True, shuffle: bool = True):
    """Voxel-downsample + spherical crop to voxel_max (data_util.py:146-174)."""
    if voxel_size and downsample:
        coord -= coord.min(0)
        uniq_idx = voxelize(coord, voxel_size)
        coord = coord[uniq_idx]
        feat = feat[uniq_idx] if feat is not None else None
        label = label[uniq_idx] if label is not None else None
    if voxel_max is not None:
        crop_idx = None
        N = len(label) if label is not None else len(coord)
        if N >= voxel_max:
            init_idx = np.random.randint(N) if "train" in split else N // 2
            crop_idx = np.argsort(
                np.sum(np.square(coord - coord[init_idx]), 1))[:voxel_max]
        elif not variable:
            query_inds = np.arange(N)
            padding_choice = np.random.choice(N, voxel_max - N)
            crop_idx = np.hstack([query_inds, query_inds[padding_choice]])
        crop_idx = np.arange(coord.shape[0]) if crop_idx is None else crop_idx
        if shuffle:
            crop_idx = crop_idx[np.random.permutation(len(crop_idx))]
        coord = coord[crop_idx]
        feat = feat[crop_idx] if feat is not None else None
        label = label[crop_idx] if label is not None else None
    coord -= coord.min(0)
    return (coord.astype(np.float32),
            feat.astype(np.float32) if feat is not None else None,
            label.astype(np.int64) if label is not None else None)


def pad_cloud(data: dict, target_n: int, rng: Optional[np.random.RandomState] = None):
    """Pad every per-point array in ``data`` to ``target_n`` points by
    repeating random real points; adds 'valid_n' with the true count."""
    n = len(data["pos"])
    data = dict(data)
    data["valid_n"] = np.int32(n)
    if n >= target_n:
        return data
    rng = rng or np.random
    extra = rng.choice(n, target_n - n)
    idx = np.concatenate([np.arange(n), extra])
    for k, v in list(data.items()):
        if isinstance(v, np.ndarray) and v.ndim >= 1 and len(v) == n:
            data[k] = v[idx]
    data["pad_idx"] = idx.astype(np.int64)
    return data


def bucket_size(n: int, multiple: int = 8192) -> int:
    """Round a variable room size up to a bucket: linear multiples up to
    4×multiple, then a ×1.4 geometric ladder snapped to `multiple` — ~14
    buckets cover rooms up to 1M points with ≤40% padding.  The JAX
    package bounds its number of compilations with it; the port keeps it so
    that both score the same padded subclouds."""
    if n <= 4 * multiple:
        return int(-(-n // multiple) * multiple)
    b = 4 * multiple
    while b < n:
        b = -(-int(b * 1.4) // multiple) * multiple
    return int(b)


def get_features_by_keys(data: dict, keys: str = "pos,x"):
    """Concatenate feature keys channels-LAST (B, N, ΣC) — the reference
    transposes to channels-first (data_util.py:177-189); the models here
    are channels-last so no transpose.  Numpy arrays in, numpy out."""
    arrs = [data[k] for k in keys.split(",")]
    if len(arrs) == 1:
        return arrs[0]
    return np.concatenate(arrs, axis=-1)


def get_class_weights(num_per_class, normalize: bool = False) -> np.ndarray:
    """↔ data_util.py:192-199."""
    weight = np.asarray(num_per_class) / float(np.sum(num_per_class))
    ce_label_weight = 1.0 / (weight + 0.02)
    if normalize:
        ce_label_weight = (ce_label_weight * len(ce_label_weight)) / ce_label_weight.sum()
    return ce_label_weight.astype(np.float32)


def grid_subsampling(points: np.ndarray, features: np.ndarray = None,
                     labels: np.ndarray = None, sampleDl: float = 0.1):
    """Barycenter voxel-grid subsample (↔ the JAX package's host extension
    ``native.grid_subsampling``, itself ↔ cpp/subsampling), in numpy.

    points (n, 3) float32; features (n, f) float32; labels (n,) or (n, l)
    integers.  Per occupied voxel of edge ``sampleDl`` the mean of points
    and features (summed in float64 in point order) and per label column the
    most frequent value (ties to the lowest); voxels come in the order of
    their first point.  Returns the subsampled arrays in the same shapes."""
    points = np.ascontiguousarray(points, np.float32)
    n = len(points)
    if n == 0 or sampleDl <= 0:
        raise ValueError("grid_subsampling needs points and sampleDl > 0")
    inv = 1.0 / np.float32(sampleDl).astype(np.float64)
    dl = np.float32(sampleDl).astype(np.float64)
    p64 = points.astype(np.float64)
    origin = np.floor(p64.min(0) * inv) * dl
    cell = np.floor((p64 - origin) * inv).astype(np.int64)
    nx = int(np.floor((p64[:, 0].max() - origin[0]) * inv)) + 1
    ny = int(np.floor((p64[:, 1].max() - origin[1]) * inv)) + 1
    key = cell[:, 0] + nx * cell[:, 1] + nx * ny * cell[:, 2]
    _, first, inverse = np.unique(key, return_index=True, return_inverse=True)
    rank = np.empty(len(first), np.int64)
    rank[np.argsort(first, kind="stable")] = np.arange(len(first))
    voxel = rank[inverse]                      # first-seen order
    m = len(first)
    count = np.bincount(voxel, minlength=m).astype(np.float64)

    def mean(a):
        return np.stack([np.bincount(voxel, weights=a[:, d], minlength=m)
                         / count for d in range(a.shape[1])], 1
                        ).astype(np.float32)
    result = [mean(p64)]
    if features is not None:
        result.append(mean(np.asarray(features, np.float32).astype(np.float64)))
    if labels is not None:
        lab = np.asarray(labels)
        squeeze = lab.ndim == 1
        lab = lab.reshape(n, -1).astype(np.int64)
        out = np.empty((m, lab.shape[1]), np.int32)
        for col in range(lab.shape[1]):
            values, codes = np.unique(lab[:, col], return_inverse=True)
            votes = np.zeros((m, len(values)), np.int64)
            np.add.at(votes, (voxel, codes), 1)
            out[:, col] = values[votes.argmax(1)]   # first maximum: lowest
        result.append(out[:, 0] if squeeze else out)
    return result[0] if len(result) == 1 else tuple(result)
