"""Every shipped model cfg builds in the port, and a model option that the
JAX package reads and the port does not take raises by name instead of
being dropped (``models/build.py``).  No JAX: the JAX side of the key table
is held in ``test_torch_port_model.py``."""
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
    """The JAX modules' framework field of BatchNorm across devices and the
    PointNet++ encoder's sampler: off the JAX default the build raises
    naming the key, at it the model builds."""
    name = "s3dis/pointnet++.yaml" if key == "sampler" else "s3dis/AMContrast3D-AA.yaml"
    model = _model_cfg(name)
    model[section][key] = value
    with pytest.raises(NotImplementedError, match=key):
        build_model_from_cfg(model)
    model[section][key] = default
    build_model_from_cfg(model)
