"""Every shipped model cfg builds in the port, and a model option that the
JAX package reads and the port does not take raises by name instead of
being dropped (``models/build.py``).  No JAX: the JAX side of the key table
is held in ``test_torch_port_model.py``."""
import copy
from pathlib import Path

import pytest

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


@pytest.mark.parametrize("name", ["s3dis/AMContrast3D-AA.yaml",
                                  "synthetic/AMContrast3D-MM.yaml",
                                  "scannet/pointnext-xl.yaml"])
def test_encoder_remat_raises_by_name(name):
    """``encoder_args.remat: True`` (the JAX encoder's ``nn.remat``) is not
    ported: the build raises and names the key; at the JAX default (False)
    it builds."""
    model = _model_cfg(name)
    model.encoder_args.remat = True
    with pytest.raises(NotImplementedError, match="remat"):
        build_model_from_cfg(model)
    model.encoder_args.remat = False
    build_model_from_cfg(model)


@pytest.mark.parametrize("section,key,value,default", [
    ("encoder_args", "bn_axis_name", "batch", None),
    ("encoder_args", "dtype", "bfloat16", "float32"),
    ("cls_args", "bn_axis_name", "data", None),
    ("encoder_args", "sampler", "random", "fps")])
def test_other_unported_keys_raise_off_their_jax_default(section, key, value,
                                                         default):
    """The JAX modules' framework fields (BatchNorm across devices, the
    compute type) and the PointNet++ encoder's sampler: off the JAX default
    the build raises naming the key, at it the model builds."""
    name = "s3dis/pointnet++.yaml" if key == "sampler" else "s3dis/AMContrast3D-AA.yaml"
    model = _model_cfg(name)
    model[section][key] = value
    with pytest.raises(NotImplementedError, match=key):
        build_model_from_cfg(model)
    model[section][key] = default
    build_model_from_cfg(model)
