"""Every shipped model cfg builds in the port, and a model option that the
JAX package reads and the port does not take raises by name instead of
being dropped (``models/build.py``); ``bn_axis_name``, the JAX modules'
BatchNorm axis across devices, is taken by the builders.  No JAX: the JAX
side of the key table is held in ``test_torch_port_model.py``."""
import copy
from pathlib import Path

import pytest
import torch

from amcontrast3d_tpu_torch.models import build_model_from_cfg
from amcontrast3d_tpu_torch.utils.config import EasyConfig

CFGS = Path(__file__).resolve().parent.parent / "cfgs"
MODEL_CFGS = sorted(str(p.relative_to(CFGS)) for recipe in ("s3dis", "scannet", "synthetic")
                    for p in (CFGS / recipe).glob("*.yaml") if p.name != "default.yaml")


def _model_cfg(name):
    cfg = EasyConfig()
    cfg.load(str(CFGS / name), recursive=True)
    return copy.deepcopy(cfg.model)


def test_the_cfg_list_is_every_model_cfg():
    assert len(MODEL_CFGS) == 9
    assert "s3dis/pointnet++.yaml" in MODEL_CFGS


@pytest.mark.parametrize("name", MODEL_CFGS)
def test_every_shipped_cfg_builds_in_the_port(name):
    model = build_model_from_cfg(_model_cfg(name))
    assert sum(p.numel() for p in model.parameters()) > 0


@pytest.mark.parametrize("name", MODEL_CFGS)
def test_every_shipped_cfg_builds_with_remat_at_bf16(name):
    """``encoder_args.remat: True`` (the JAX encoder's ``nn.remat``) and the
    runner's bfloat16 compute type build every shipped cfg: a PointNeXt
    encoder takes the switch (PointNet++'s JAX encoder has no such field,
    and neither has the port's), and every Linear computes in bfloat16 with
    float32 parameters."""
    from amcontrast3d_tpu_torch.models.layers import Dense

    model = _model_cfg(name)
    model.encoder_args.remat = True
    built = build_model_from_cfg(model, dtype=torch.bfloat16)
    encoder = built.encoder
    assert getattr(encoder, "remat", True) is True
    dense = [m for m in built.modules() if isinstance(m, torch.nn.Linear)]
    assert dense and all(isinstance(m, Dense) and m.compute_dtype == torch.bfloat16
                         for m in dense)
    assert all(p.dtype == torch.float32 for p in built.parameters())


@pytest.mark.parametrize("section,key,value,default", [
    ("encoder_args", "bn_axis_name", "batch", None),
    ("cls_args", "bn_axis_name", "data", None),
    ("encoder_args", "sampler", "random", "fps")])
def test_other_unported_keys_raise_off_their_jax_default(section, key, value,
                                                         default):
    """The PointNet++ encoder's sampler: off the JAX default the build
    raises naming the key, at it the model builds.  The JAX modules' field
    of BatchNorm across devices, ``bn_axis_name``, raised so until data
    parallelism was ported; now it is taken: set to a name in a section,
    every BatchNorm that section builds syncs over the default process
    group (``synced``, no group of its own), and at the JAX default (None)
    every BatchNorm of the model stays local."""
    from amcontrast3d_tpu_torch.models.layers import ChannelsLastBatchNorm

    name = "s3dis/pointnet++.yaml" if key == "sampler" else "s3dis/AMContrast3D-AA.yaml"
    model = _model_cfg(name)
    model[section][key] = value
    if key == "bn_axis_name":
        built = build_model_from_cfg(model)
        part = built.encoder if section == "encoder_args" else built.head
        norms = [m for m in part.modules()
                 if isinstance(m, ChannelsLastBatchNorm)]
        assert norms and all(m.synced and m.process_group is None
                             for m in norms)
    else:
        with pytest.raises(NotImplementedError, match=key):
            build_model_from_cfg(model)
    model[section][key] = default
    built = build_model_from_cfg(model)
    assert not any(getattr(m, "synced", False) for m in built.modules())


@pytest.mark.parametrize("name", ["s3dis/AMContrast3D-AA.yaml",
                                  "s3dis/AMContrast3D-MM.yaml",
                                  "s3dis/pointnet++.yaml"])
def test_bn_axis_name_syncs_every_batchnorm_of_the_model(name):
    """``build_model_from_cfg(cfg, bn_axis_name='dp')``, as the JAX runner
    builds its model when ``distributed``: every BatchNorm of the model (the
    MM model's APM towers included) syncs, and none is left a
    ``torch.nn.BatchNorm`` of another kind."""
    from amcontrast3d_tpu_torch.models.layers import ChannelsLastBatchNorm

    built = build_model_from_cfg(_model_cfg(name), bn_axis_name="dp")
    norms = [m for m in built.modules()
             if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
    assert len(norms) > 10
    assert all(isinstance(m, ChannelsLastBatchNorm) and m.synced
               for m in norms)
    if "MM" in name:
        assert any(n.startswith("APM.") and isinstance(m, ChannelsLastBatchNorm)
                   for n, m in built.named_modules())
