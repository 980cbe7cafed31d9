"""DATASETS registry and dataloader factory (↔ ``amcontrast3d_tpu/data/
build.py``, itself ↔ openpoints/dataset/build.py).

A host-side numpy loader: fixed-shape batches (train clouds are cropped or
padded to ``voxel_max`` by the dataset, ``data_util.crop_pc``) stacked and
prefetched on a background thread while the device computes, items
optionally loaded by a pool of forked worker processes.  One process
drives one device, so the batch is the global batch and no per-rank sampler
is needed.  The epoch's shuffle comes from ``seed + epoch`` and the item
order within a batch is that of the index list, so both packages see equal
batches from equal seeds.

The workers are forked from the thread that starts the iteration (never
from the prefetch thread) and touch only numpy: a process forked after the
CUDA context exists must not use it.
"""
from __future__ import annotations

import logging
import queue
import threading
from typing import Dict, Iterator

import numpy as np

from ..transforms import build_transforms_from_cfg
from ..utils.registry import Registry

DATASETS = Registry("datasets")


def concat_collate_fn(samples):
    """Offset-style packed batch (↔ dataset/build.py:13-27) — kept for the
    packed-layout API surface; the dense path uses ``stack_collate_fn``."""
    out = {}
    keys = samples[0].keys()
    for k in keys:
        out[k] = np.concatenate([s[k] for s in samples], axis=0)
    offset, count = [], 0
    for s in samples:
        count += len(s["pos"])
        offset.append(count)
    out["offset"] = np.asarray(offset, dtype=np.int32)
    return out


def stack_collate_fn(samples):
    out = {}
    for k in samples[0].keys():
        out[k] = np.stack([np.asarray(s[k]) for s in samples], axis=0)
    return out


# Fork-inherited dataset handle: set immediately before Pool() forks so the
# children inherit the dataset through copy-on-write memory instead of
# pickling it per task (a presample cache is GBs; per-item pickling would be
# slower than a single process; ↔ torch workers, dataset/build.py:44-98).
_FORK_DATASET = None


def _worker_init(seed: int):
    # decorrelate per-worker numpy RNG streams (inherited state is identical
    # across forks; ↔ torch DataLoader worker seeding)
    import os as _os
    np.random.seed((seed + _os.getpid() * 2654435761) % (2 ** 31 - 1))


def _load_item(idx):
    return _FORK_DATASET[int(idx)]


class NumpyLoader:
    """Epoch-based loader: shuffling, thread prefetch (overlaps host batch
    assembly with device compute), optional multiprocess item loading
    (↔ torch DataLoader ``num_workers``, dataset/build.py:44-98)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, collate_fn=stack_collate_fn,
                 seed: int = 0, prefetch: bool = True, num_workers: int = 0,
                 prefetch_depth: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.collate_fn = collate_fn
        self.seed = seed
        self.epoch = 0
        self.prefetch = prefetch
        self.prefetch_depth = max(int(prefetch_depth), 1)
        self.num_workers = num_workers
        self._pool = None

    def _get_pool(self):
        if self._pool is None and self.num_workers > 0:
            import multiprocessing
            global _FORK_DATASET
            _FORK_DATASET = self.dataset
            try:
                self._pool = multiprocessing.get_context("fork").Pool(
                    self.num_workers, initializer=_worker_init,
                    initargs=(self.seed,))
            finally:
                # children forked with their inherited reference; the parent
                # global is no longer needed
                _FORK_DATASET = None
        return self._pool

    def close(self):
        """Terminate the worker processes, if any were started."""
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    # reference exposes loader.sampler.set_epoch; keep the attribute shape
    @property
    def sampler(self):
        return self

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _index_batches(self):
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            rng.shuffle(idx)
        nb = len(self)
        for b in range(nb):
            sel = idx[b * self.batch_size:(b + 1) * self.batch_size]
            if len(sel) == 0:
                return
            yield sel

    def _make_batch(self, sel):
        pool = self._get_pool()
        if pool is not None:
            items = pool.map(_load_item, [int(i) for i in sel])
        else:
            items = [self.dataset[int(i)] for i in sel]
        return self.collate_fn(items)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        self._get_pool()     # fork here, not from the prefetch thread
        if not self.prefetch:
            for sel in self._index_batches():
                yield self._make_batch(sel)
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch_depth)
        stop = object()

        def worker():
            try:
                for sel in self._index_batches():
                    q.put(self._make_batch(sel))
            finally:
                q.put(stop)

        failure = []

        def guarded():
            try:
                worker()
            except Exception as e:       # re-raised where the batches go
                failure.append(e)

        t = threading.Thread(target=guarded, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is stop:
                break
            yield item
        if failure:
            raise failure[0]


def build_dataset_from_cfg(common_cfg, split_cfg=None, transform=None):
    cfg = dict(common_cfg or {})
    cfg.update(dict(split_cfg or {}))
    cfg["transform"] = transform
    return DATASETS.build(cfg)


def build_dataloader_from_cfg(batch_size: int, dataset_cfg,
                              dataloader_cfg=None, datatransforms_cfg=None,
                              split: str = "train", distributed: bool = False,
                              seed: int = 0):
    """↔ dataset/build.py:44-98 (same call shape as the reference mains)."""
    if datatransforms_cfg is not None:
        trans_split = "train" if split == "train" else "val"
        transform = build_transforms_from_cfg(trans_split, datatransforms_cfg)
    else:
        transform = None
    dataset_cfg = dict(dataset_cfg)
    dataset = build_dataset_from_cfg(dataset_cfg.get("common", {}),
                                     dataset_cfg.get(split, {}),
                                     transform=transform)
    shuffle = split == "train"
    dl_cfg = dict(dataloader_cfg or {})
    num_workers = int(dl_cfg.get("num_workers", 0) or 0)
    import os as _os
    num_workers = min(num_workers, max(_os.cpu_count() - 1, 0))
    loader = NumpyLoader(dataset, batch_size, shuffle=shuffle,
                         drop_last=split == "train", seed=seed,
                         num_workers=num_workers,
                         prefetch_depth=int(dl_cfg.get("prefetch_depth", 2)))
    logging.info("dataset %s split %s: %d samples, %d batches",
                 dataset.__class__.__name__, split, len(dataset), len(loader))
    return loader
