"""Conv block and the norm / act factories.

↔ ``amcontrast3d_tpu/models/layers.py``.  A 1×1 conv is an ``nn.Linear``
on the trailing (channel) axis of any ``(..., C)`` tensor; BatchNorm
reduces over every axis but the last, as flax's ``nn.BatchNorm`` does
there (momentum 0.9 in flax is 0.1 here, eps 1e-5).  Submodules keep the
flax names (``Dense_0``, ``BatchNorm_0``, ``ConvBlock_{i}``) so that
:func:`amcontrast3d_tpu_torch.utils.convert.from_jax_variables` maps
weights mechanically.

The compute type (``dtype``, the JAX modules' field of that name; the
runner's ``use_amp`` sets it to bfloat16) sits where flax puts it: a
:class:`Dense` keeps float32 parameters and multiplies bfloat16 casts of
its input and weight, returning bfloat16, as ``nn.Dense(dtype=bf16)``
does; the BatchNorms (flax's ``BatchNorm(dtype=float32)``) take any input
and compute and return float32.  No autocast: it would cast where the JAX
package does not.

Under the encoder's remat (:func:`recomputing`) a BatchNorm normalises as
in the forward and leaves its running statistics alone, so they move once
a step.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .. import parallel


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


_RECOMPUTE = [0]


@contextlib.contextmanager
def recomputing():
    """Marks the recompute of a checkpointed region: train-mode BatchNorms
    inside it move no running statistic (the forward moved them)."""
    _RECOMPUTE[0] += 1
    try:
        yield
    finally:
        _RECOMPUTE[0] -= 1


def moves_statistics() -> bool:
    """Whether a train-mode BatchNorm called now moves its running
    statistics: not in a remat's recompute."""
    return _RECOMPUTE[0] == 0


def rounded(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``: a Python scalar meets a tensor in the
    tensor's dtype in JAX (a weakly typed scalar).  A host number, so no
    copy to the device."""
    return torch.tensor(value, dtype=dtype).item()


def as_dtype(dtype) -> torch.dtype:
    """A compute type by any name (``"bfloat16"``, ``torch.bfloat16``,
    ``jnp.bfloat16``'s string, None = float32)."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    name = str(dtype).rsplit(".", 1)[-1].strip("'>")
    table = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    if name not in table:
        raise NotImplementedError(f"compute dtype {dtype!r} is not ported "
                                  "(float32 or bfloat16)")
    return table[name]


class Dense(nn.Linear):
    """``nn.Linear`` with flax's ``nn.Dense(dtype=...)``: float32
    parameters; the input and the weight cast to ``dtype``, their product
    rounded to ``dtype``, then the bias (cast too) added in ``dtype``.
    ``exact``: the product of the cast operands accumulated in float32 and
    rounded once, as ``precision=HIGHEST`` on bfloat16 operands computes
    it."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype=None, exact: bool = False):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = as_dtype(dtype)
        self.exact = exact

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt == torch.float32:
            return F.linear(x, self.weight, self.bias)
        w = self.weight.to(dt)
        if self.exact:
            y = F.linear(x.to(dt).float(), w.float()).to(dt)
        else:
            y = F.linear(x.to(dt), w)
        # flax adds the bias to the rounded product, in ``dtype``
        return y if self.bias is None else y + self.bias.to(dt)


class _SyncedBatchNorm(torch.autograd.Function):
    """The synced BatchNorm of a (rows, C) tensor with its VJP written out,
    so that a call is a handful of launches each way.  Each rank's mean and
    biased variance come from one ``var_mean`` pass and are gathered from
    every rank in one collective; the global mean is the mean of the ranks'
    means (each rank weighs alike, as flax's ``pmean``) and the variance
    the ranks' mean variance plus the spread of their means about it: the
    global batch's biased variance, with no E[x²] − E[x]² to cancel (at
    world size 1, the rank's own).  Then the BatchNorm kernels' inference
    forward; backward, their inference backward (x, weight, bias) and the
    statistics' cotangents summed over the ranks in one all_reduce and
    folded into the rows'."""

    @staticmethod
    def forward(ctx, x, weight, bias, module):
        group, eps = module.process_group, module.eps
        n = torch.distributed.get_world_size(group)
        var_l, mean_l = torch.var_mean(x, dim=0, correction=0)
        rows = [torch.empty(2, x.shape[1], device=x.device) for _ in range(n)]
        parallel.collective("all_gather", rows, torch.stack([mean_l, var_l]),
                            group=group)
        means, variances = torch.stack(rows).unbind(1)
        mean = means.mean(0)
        spread = means - mean
        var = variances.mean(0) + spread.square().mean(0)
        module.move_statistics(mean, var)
        invstd = torch.rsqrt(var + eps)
        rank = torch.distributed.get_rank(group)
        ctx.save_for_backward(x, weight, mean, var, invstd, mean_l,
                              spread[rank])
        ctx.group, ctx.n, ctx.eps = group, n, eps
        return F.batch_norm(x, mean, var, weight, bias, False, 0.0, eps)

    @staticmethod
    def backward(ctx, g):
        x, weight, mean, var, invstd, mean_l, spread = ctx.saved_tensors
        # the inference form reads the statistics it is handed; the CUDA
        # kernel wants the saved ones defined too
        gx, gw, gb = torch.ops.aten.native_batch_norm_backward(
            g.contiguous(), x, weight, mean, var, mean, invstd, False,
            ctx.eps, [True, True, True])
        scale = weight * invstd
        both = torch.stack([-scale * gb, -0.5 * invstd * scale * gw])
        parallel.collective("all_reduce", both, group=ctx.group)
        g_mean, g_var = both.unbind(0)
        # this rank's mean and variance: 1/n of the global mean's cotangent
        # and of the variance's, and 2/n (m_r − mean) of the variance's
        rows = x.shape[0]
        g_ml = torch.addcmul(g_mean, spread, g_var, value=2.0) / (ctx.n * rows)
        g_vl = g_var * (2.0 / (ctx.n * rows))
        # E[x] and the biased variance of the rows: dx = g_ml + g_vl (x − m)
        return (gx.addcmul_(x, g_vl).add_(torch.addcmul(g_ml, mean_l, g_vl,
                                                        value=-1.0)),
                gw, gb, None)


class ChannelsLastBatchNorm(nn.BatchNorm1d):
    """BatchNorm over every axis but the last of a ``(..., C)`` tensor.

    Training mode normalises with the batch statistics (torch's two-pass
    variance; flax computes ``E[x²] − E[x]²``) and moves the running
    statistics toward the batch mean and the *biased* batch variance, as
    flax's ``nn.BatchNorm`` does; torch's own update uses the unbiased one.
    A bfloat16 input is normalised in float32 and the output is float32
    (flax's ``BatchNorm(dtype=float32)``).

    ``synced`` (set by :func:`amcontrast3d_tpu_torch.parallel.sync_batchnorm_`,
    the JAX modules' ``bn_axis_name``): the statistics are those of the
    global batch over ``process_group`` (None: the default group), flax's
    under ``axis_name`` (the mean of the ranks' means), the variance the
    global biased one without flax's E[x²] − E[x]² (:class:`_SyncedBatchNorm`)."""

    synced = False
    process_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x2 = x.reshape(-1, x.shape[-1]).float()
        if not self.training:
            return super().forward(x2).view(x.shape)
        if self.synced:
            return self._synced_forward(x2).view(x.shape)
        y = F.batch_norm(x2, None, None, self.weight, self.bias, True, 0.0,
                         self.eps)
        if moves_statistics():
            with torch.no_grad():
                var, mean = torch.var_mean(x2, dim=0, correction=0)
            self.move_statistics(mean, var)
        return y.view(x.shape)

    def move_statistics(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """flax's running update (momentum 0.9, the biased variance); not in
        a remat's recompute."""
        if not moves_statistics():
            return
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(mean.detach(), alpha=m)
            self.running_var.mul_(1 - m).add_(var.detach(), alpha=m)
            self.num_batches_tracked.add_(1)

    def _synced_forward(self, x2: torch.Tensor) -> torch.Tensor:
        return _SyncedBatchNorm.apply(x2, self.weight, self.bias, self)


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
        return x * keep / rounded(1 - self.rate, x.dtype)


class ConvBlock(nn.Module):
    """Linear (+BatchNorm) (+act) in ``conv-norm-act`` order; the bias is
    dropped when a norm follows (↔ ``create_convblock1d/2d``).  The Linear
    computes in ``dtype``; with a norm the block returns float32."""

    def __init__(self, in_channels: int, out_channels: int, norm_args=None,
                 act_args=None, order: str = "conv-norm-act",
                 bias: bool = True, dtype=None):
        super().__init__()
        if order != "conv-norm-act":
            raise NotImplementedError(f"order {order} not ported")
        norm = _norm_name(norm_args)
        if norm is not None and not norm.startswith(("bn", "syncbn")):
            raise NotImplementedError(f"norm {norm} not ported")
        self.act = create_act(act_args)
        self.Dense_0 = Dense(in_channels, out_channels,
                             bias=bias and norm is None, dtype=dtype)
        self.BatchNorm_0 = batch_norm(out_channels) if norm else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Dense_0(x)
        if self.BatchNorm_0 is not None:
            x = self.BatchNorm_0(x)
        return self.act(x) if self.act is not None else x

