"""Data transforms (numpy, per-sample) — ↔ ``amcontrast3d_tpu/transforms``.

Ported so far: the registry, ``Compose``, ``build_transforms_from_cfg`` and
the classes of the val/test pipelines of ``cfgs/*/default.yaml``
(``PointsToTensor``, ``PointCloudXYZAlign``, ``ChromaticNormalize``, and
``ChromaticDropGPU`` of ``vote``).  They take and return numpy arrays and
draw from the process RNG (``np.random``), exactly as in the JAX package,
so the same seed gives the same sample.  The train-time augmentations wait
for the train CLI (ROADMAP.md); a config that names one gets a
``NotImplementedError`` with the name.

Factory contract (``transforms_factory.py:45-60``): a list of names plus one
shared ``kwargs`` dict composes into a single callable.
"""
from __future__ import annotations

import numpy as np

from ..utils.registry import Registry

DataTransforms = Registry("datatransforms")

# transforms of the JAX package that are not ported yet
NOT_PORTED = (
    "PointCloudToTensor", "PointCloudCenterAndNormalize", "PointCloudScaling",
    "PointCloudTranslation", "PointCloudScaleAndTranslate", "PointCloudJitter",
    "PointCloudScaleAndJitter", "PointCloudRotation", "RandomDropout",
    "RandomHorizontalFlip", "ChromaticAutoContrast", "ChromaticTranslation",
    "ChromaticJitter", "ChromaticPerDropGPU", "RandomDropFeature",
    "NumpyChromaticNormalize", "RandomRotate", "RandomRotateZ", "RandomScale",
    "RandomShift", "RandomScaleAndTranslate", "RandomFlip", "RandomJitter",
    "RandomScaleAndJitter", "HueSaturationTranslation", "Cutmix",
)


@DataTransforms.register_module()
class PointsToTensor:
    """No-op placeholder for API parity (arrays stay numpy until they go to
    the device); float64 arrays become float32."""

    def __init__(self, **kwargs):
        pass

    def __call__(self, data):
        for k, v in data.items():
            if isinstance(v, np.ndarray) and v.dtype == np.float64:
                data[k] = v.astype(np.float32)
        return data


@DataTransforms.register_module()
class PointCloudXYZAlign:
    """Center xy, shift z-min to 0 (↔ point_transformer_gpu.py:71-89)."""

    def __init__(self, gravity_dim=2, **kwargs):
        self.gravity_dim = gravity_dim

    def __call__(self, data):
        pos = data["pos"]
        pos = pos - pos.mean(axis=0, keepdims=True)
        pos[:, self.gravity_dim] -= pos[:, self.gravity_dim].min()
        data["pos"] = pos
        return data


@DataTransforms.register_module()
class ChromaticDropGPU:
    """Drop all colors with probability p (↔ point_transformer_gpu.py:374-381)."""

    def __init__(self, color_drop=0.2, **kwargs):
        self.color_drop = color_drop

    def __call__(self, data):
        if np.random.rand() < self.color_drop:
            data["x"][:, :3] = 0
        return data


@DataTransforms.register_module()
class ChromaticNormalize:
    """↔ point_transformer_gpu.py:396-409."""

    def __init__(self, color_mean=[0.5136457, 0.49523646, 0.44921124],
                 color_std=[0.18308958, 0.18415008, 0.19252081], **kwargs):
        self.color_mean = np.array(color_mean, dtype=np.float32)
        self.color_std = np.array(color_std, dtype=np.float32)

    def __call__(self, data):
        if data["x"][:, :3].max() > 1:
            data["x"][:, :3] = data["x"][:, :3] / 255.0
        data["x"][:, :3] = (data["x"][:, :3] - self.color_mean) / self.color_std
        return data


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
        return data


def build_transforms_from_cfg(split: str, datatransforms_cfg) -> Compose:
    """↔ transforms_factory.py:45-60: cfg[split] is a name list, cfg.kwargs
    the shared kwargs."""
    if datatransforms_cfg is None:
        return Compose([])
    cfg = dict(datatransforms_cfg)
    names = cfg.get(split) or []
    kwargs = dict(cfg.get("kwargs") or {})
    transforms = []
    for name in names:
        if name in NOT_PORTED:
            raise NotImplementedError(
                f"transform {name} is not ported yet (ROADMAP.md §1)")
        transforms.append(DataTransforms.build(name, **kwargs))
    return Compose(transforms)
