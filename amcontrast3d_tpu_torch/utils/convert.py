"""Weights from the JAX package's flax variables into a port state_dict.

The port's submodules keep the flax names (``MLPBlocks_0``, ``ResBlock``'s
``LocalAggregation_0``, ``LayerNorm_0``, ``GroupNorm_0`` … too), so the
mapping is per leaf: a Dense ``kernel`` (in, out) becomes a Linear
``weight`` (out, in), a norm's ``scale``/``bias`` (BatchNorm, LayerNorm,
GroupNorm) become ``weight``/``bias`` and a BatchNorm's ``mean``/``var``
``running_mean``/``running_var``.

:func:`load_jax_train_state` and :func:`checkpoint_from_jax` carry a whole
trainer across: parameters, batch statistics, the AdamW moments and count,
and the epoch, so the port's trainer can start where the JAX trainer
stands.  The caller hands in numpy trees (``jax.tree_util.tree_map(
np.asarray, …)`` of ``state.params``, ``state.batch_stats`` and the
``ScaleByAdamState``'s ``mu``, ``nu``, ``count``); nothing here imports JAX.
"""
from __future__ import annotations

from collections import OrderedDict
from collections.abc import Mapping
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

_LEAF = {"kernel": "weight", "bias": "bias", "scale": "weight",
         "mean": "running_mean", "var": "running_var"}


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(value)


def from_jax_variables(variables: Mapping) -> Dict[str, torch.Tensor]:
    """flax ``{"params": …, "batch_stats": …}`` (leaves as numpy arrays)
    → an ``OrderedDict`` for ``model.load_state_dict``."""
    state: Dict[str, torch.Tensor] = OrderedDict()
    for collection in ("params", "batch_stats"):
        for path, arr in _leaves(variables.get(collection, {})):
            *modules, leaf = path
            if leaf not in _LEAF:
                raise KeyError(f"unmapped flax leaf {'/'.join(path)}")
            if leaf == "kernel":
                if arr.ndim != 2:
                    raise ValueError(f"{'/'.join(path)}: expected a Dense "
                                     f"kernel, got shape {arr.shape}")
                arr = arr.T
            prefix = ".".join(modules)
            state[f"{prefix}.{_LEAF[leaf]}"] = torch.from_numpy(
                np.ascontiguousarray(arr, dtype=np.float32))
            if leaf == "mean":
                state[f"{prefix}.num_batches_tracked"] = torch.tensor(0)
    return state


def load_jax_train_state(model: torch.nn.Module,
                         optimizer: Optional[torch.optim.Optimizer],
                         variables: Mapping, mu: Optional[Mapping] = None,
                         nu: Optional[Mapping] = None, count: int = 0) -> None:
    """Parameters and batch statistics into ``model`` (strictly: every
    tensor must be there), and optax's Adam moments ``mu``/``nu`` and step
    ``count`` into ``optimizer``, which must be the ``torch.optim.AdamW``
    of the ``adamw`` recipe over the model's parameters (another
    optimizer's state has other leaves: it raises, naming it)."""
    if (optimizer is not None and mu is not None
            and type(optimizer) is not torch.optim.AdamW):
        raise NotImplementedError(
            f"the JAX trainer's Adam moments go into torch.optim.AdamW only, "
            f"not into {type(optimizer).__name__}")
    model.load_state_dict(from_jax_variables(variables), strict=True)
    if optimizer is None or mu is None:
        return
    first = from_jax_variables({"params": mu})
    second = from_jax_variables({"params": nu})
    owned = {id(p) for g in optimizer.param_groups for p in g["params"]}
    for name, p in model.named_parameters():
        if id(p) not in owned:
            continue                              # a frozen parameter
        optimizer.state[p] = {
            "step": torch.tensor(float(count)),
            "exp_avg": first[name].to(p.device).clone(),
            "exp_avg_sq": second[name].to(p.device).clone()}


def checkpoint_from_jax(model: torch.nn.Module,
                        optimizer: Optional[torch.optim.Optimizer],
                        variables: Mapping, mu: Optional[Mapping] = None,
                        nu: Optional[Mapping] = None, count: int = 0,
                        epoch: int = 0, **extras) -> Dict:
    """The payload of one of the port's checkpoints (``torch.save`` it) that
    holds the JAX trainer's state: ``mode=resume`` from it carries on at
    ``epoch + 1`` with the step count ``count``, so the schedule and the
    dropout seeds continue where the JAX run stands."""
    load_jax_train_state(model, optimizer, variables, mu, nu, count)
    state = {"model": model.state_dict()}
    if optimizer is not None and mu is not None:
        state["optimizer"] = optimizer.state_dict()
    return {"state": state, "epoch": int(epoch), "step": int(count), **extras}
