"""Conv block and the norm / act factories.

↔ ``amcontrast3d_tpu/models/layers.py``.  A 1×1 conv is an ``nn.Linear``
on the trailing (channel) axis of any ``(..., C)`` tensor; BatchNorm
reduces over every axis but the last, as flax's ``nn.BatchNorm`` does
there (momentum 0.9 in flax is 0.1 here, eps 1e-5).  Submodules keep the
flax names (``Dense_0``, ``BatchNorm_0``, ``ConvBlock_{i}``) so that
:func:`amcontrast3d_tpu_torch.utils.convert.from_jax_variables` maps
weights mechanically.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn


def _norm_name(norm_args) -> Optional[str]:
    if norm_args is None:
        return None
    if isinstance(norm_args, str):
        return norm_args.lower()
    name = dict(norm_args).get("norm", None)
    return name.lower() if name is not None else None


def _act_name(act_args) -> Optional[str]:
    if act_args is None:
        return None
    if isinstance(act_args, str):
        return act_args.lower()
    name = dict(act_args).get("act", None)
    return name.lower() if name is not None else None


_ACTS = {
    "relu": F.relu,
    "relu6": F.relu6,
    "leakyrelu": lambda x: F.leaky_relu(x, negative_slope=0.01),
    "elu": F.elu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),   # flax nn.gelu default
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "silu": F.silu,
    "swish": F.silu,
    "hardswish": F.hardswish,
    "softmax": lambda x: F.softmax(x, dim=-1),
}


def create_act(act_args) -> Optional[Callable]:
    name = _act_name(act_args)
    if name is None:
        return None
    if name not in _ACTS:
        raise ValueError(f"activation {name} not supported")
    return _ACTS[name]


class ChannelsLastBatchNorm(nn.BatchNorm1d):
    """BatchNorm over every axis but the last of a ``(..., C)`` tensor.

    Training mode normalises with the batch statistics (torch's two-pass
    variance; flax computes ``E[x²] − E[x]²``) and moves the running
    statistics toward the batch mean and the *biased* batch variance, as
    flax's ``nn.BatchNorm`` does; torch's own update uses the unbiased one."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x2 = x.reshape(-1, x.shape[-1])
        if not self.training:
            return super().forward(x2).view(x.shape)
        y = F.batch_norm(x2, None, None, self.weight, self.bias, True, 0.0,
                         self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x2, dim=0, correction=0)
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(mean, alpha=m)
            self.running_var.mul_(1 - m).add_(var, alpha=m)
            self.num_batches_tracked.add_(1)
        return y.view(x.shape)


def batch_norm(channels: int) -> ChannelsLastBatchNorm:
    return ChannelsLastBatchNorm(channels, eps=1e-5, momentum=0.1)


class Dropout(nn.Module):
    """Inverted dropout whose mask comes from an explicit generator (↔
    flax ``nn.Dropout``: keep with probability 1−rate, scale by
    1/(1−rate)).  The identity in eval mode; in training mode a
    ``generator`` on the tensor's device is required."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.training or self.rate == 0:
            return x
        if generator is None:
            raise ValueError("dropout in training mode needs a generator")
        keep = torch.empty_like(x).bernoulli_(1 - self.rate, generator=generator)
        return x * keep / (1 - self.rate)


class ConvBlock(nn.Module):
    """Linear (+BatchNorm) (+act) in ``conv-norm-act`` order; the bias is
    dropped when a norm follows (↔ ``create_convblock1d/2d``)."""

    def __init__(self, in_channels: int, out_channels: int, norm_args=None,
                 act_args=None, order: str = "conv-norm-act",
                 bias: bool = True):
        super().__init__()
        if order != "conv-norm-act":
            raise NotImplementedError(f"order {order} not ported")
        norm = _norm_name(norm_args)
        if norm is not None and not norm.startswith(("bn", "syncbn")):
            raise NotImplementedError(f"norm {norm} not ported")
        self.act = create_act(act_args)
        self.Dense_0 = nn.Linear(in_channels, out_channels,
                                 bias=bias and norm is None)
        self.BatchNorm_0 = batch_norm(out_channels) if norm else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Dense_0(x)
        if self.BatchNorm_0 is not None:
            x = self.BatchNorm_0(x)
        return self.act(x) if self.act is not None else x

