"""MODELS registry, ``make_module`` and ``build_model_from_cfg``.

↔ ``amcontrast3d_tpu/models/build.py``.  The flax modules there are
dataclasses filtered by field; an ``nn.Module`` here is filtered by the
parameters of its ``__init__`` (unknown config keys are ignored, with the
tolerance of the reference's ``**kwargs`` constructors).  A key that the
JAX module reads and the port's constructor lacks is not ignored: set to
anything but the JAX default it raises ``NotImplementedError`` by name
(:data:`UNPORTED_KEYS`), so an option that is not ported never trains
without a word.  ``bn_axis_name``, the JAX modules' BatchNorm axis across
devices, is taken by the builders here: set to a name, every BatchNorm of
the module built (:func:`make_module`, :func:`build_model_from_cfg`)
averages its statistics over the default process group
(:func:`amcontrast3d_tpu_torch.parallel.sync_batchnorm_`).
"""
from __future__ import annotations

import inspect
import math
from typing import Any, Dict

import torch
from torch import nn

from ..utils.registry import Registry

MODELS = Registry("models")


# the fields that every flax module of the JAX package reads and no
# constructor of the port takes, with their JAX defaults: BatchNorm's axis
# across devices (the runner's ``distributed``), which the builders below
# take for the whole module they build
_JAX_FIELDS = {"bn_axis_name": None}
# per port class, the other fields its JAX module reads and the port's
# constructor lacks, with their JAX defaults (``models/pointnext.py:605``,
# ``models/pointnetv2.py:82`` of the JAX package).  The JAX modules' other
# extra fields are read by no JAX module (the APMs' ``feat_concate``), or by
# the model around them, which the port's reads too (the APMs'
# ``nsample_k``, ``threshold``, ``fusion`` … from ``APM_args``).
UNPORTED_KEYS = {
    "PointNet2Encoder": {"sampler": "fps"},
}


def filter_kwargs(cls, kwargs: Dict[str, Any]) -> Dict[str, Any]:
    """The keys of ``kwargs`` that ``cls.__init__`` takes.  Raises
    ``NotImplementedError`` naming a key that the JAX module reads and the
    port's lacks, when it differs from the JAX default."""
    params = inspect.signature(cls.__init__).parameters
    unported = UNPORTED_KEYS.get(cls.__name__, {})
    for key, value in kwargs.items():
        if key not in params and key in unported and value != unported[key]:
            raise NotImplementedError(
                f"{cls.__name__}: {key}={value!r} is not ported (the JAX "
                f"package's default is {unported[key]!r})")
    return {k: v for k, v in kwargs.items() if k in params and k != "self"}


def _sync(module: nn.Module, bn_axis_name) -> nn.Module:
    if bn_axis_name is not None:
        from ..parallel import sync_batchnorm_
        sync_batchnorm_(module)
    return module


def make_module(cls, args, **extra):
    kwargs = dict(args) if args is not None else {}
    kwargs.pop("NAME", None)
    kwargs.update(extra)
    axis = kwargs.pop("bn_axis_name", None)
    return _sync(cls(**filter_kwargs(cls, kwargs)), axis)


def build_model_from_cfg(cfg, **kwargs):
    if not isinstance(cfg, str):
        kwargs = {**dict(cfg), **kwargs}
        cfg = {"NAME": kwargs.pop("NAME", None)}
    axis = kwargs.pop("bn_axis_name", None)
    return _sync(MODELS.build(cfg, **kwargs), axis)


@torch.no_grad()
def init_weights_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights, drawn in ``model.named_parameters()`` order
    from ``generator`` (a CPU generator, so a seed gives the same weights on
    every device): Linear weights ~ N(0, 1/fan_in) as flax's lecun_normal,
    biases 0, BatchNorm scale 1 and shift 0, running mean ~ N(0, 0.1²) and
    running var ~ U(0.5, 1.5), so that the eval-mode normalisation is not
    the identity."""
    for module in model.modules():
        if isinstance(module, nn.Linear):
            w = torch.randn(module.weight.shape, generator=generator)
            module.weight.copy_(w / math.sqrt(module.in_features))
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, nn.modules.batchnorm._BatchNorm):
            module.reset_parameters()
            shape = module.running_mean.shape
            module.running_mean.copy_(
                0.1 * torch.randn(shape, generator=generator))
            module.running_var.copy_(
                0.5 + torch.rand(shape, generator=generator))
    return model


@torch.no_grad()
def init_train_weights_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """The initial weights of a training run, as flax's defaults give them
    in the JAX package: Linear weights from a normal distribution of
    variance 1/fan_in truncated at two standard deviations (lecun_normal),
    biases 0, BatchNorm scale 1, shift 0, running mean 0 and variance 1.
    Drawn from ``generator`` (a CPU generator) in ``model.modules()`` order,
    so a seed gives the same weights on every device."""
    for module in model.modules():
        if isinstance(module, nn.Linear):
            # the standard deviation of a unit normal cut at +-2
            std = math.sqrt(1.0 / module.in_features) / 0.87962566103423978
            nn.init.trunc_normal_(module.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, nn.modules.batchnorm._BatchNorm):
            module.reset_parameters()
            module.reset_running_stats()
    return model
