"""DATASETS registry and dataset factory.

↔ ``amcontrast3d_tpu/data/build.py`` as far as the whole-scene test path
needs it: the registry and ``build_dataset_from_cfg``.  The loader
(``NumpyLoader``, the collate functions, worker processes,
``build_dataloader_from_cfg``) waits for the train CLI (ROADMAP.md).
"""
from __future__ import annotations

from ..utils.registry import Registry

DATASETS = Registry("datasets")


def build_dataset_from_cfg(common_cfg, split_cfg=None, transform=None):
    cfg = dict(common_cfg or {})
    cfg.update(dict(split_cfg or {}))
    cfg["transform"] = transform
    return DATASETS.build(cfg)
