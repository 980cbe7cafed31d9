"""MODELS registry, ``make_module`` and ``build_model_from_cfg``.

↔ ``amcontrast3d_tpu/models/build.py``.  The flax modules there are
dataclasses filtered by field; an ``nn.Module`` here is filtered by the
parameters of its ``__init__`` (unknown config keys are ignored, with the
tolerance of the reference's ``**kwargs`` constructors).
"""
from __future__ import annotations

import inspect
import math
from typing import Any, Dict

import torch
from torch import nn

from ..utils.registry import Registry

MODELS = Registry("models")


def filter_kwargs(cls, kwargs: Dict[str, Any]) -> Dict[str, Any]:
    params = inspect.signature(cls.__init__).parameters
    return {k: v for k, v in kwargs.items() if k in params and k != "self"}


def make_module(cls, args, **extra):
    kwargs = dict(args) if args is not None else {}
    kwargs.pop("NAME", None)
    kwargs.update(extra)
    return cls(**filter_kwargs(cls, kwargs))


def build_model_from_cfg(cfg, **kwargs):
    return MODELS.build(cfg, **kwargs)


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
