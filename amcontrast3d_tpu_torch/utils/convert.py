"""Weights from the JAX package's flax variables into a port state_dict.

The port's submodules keep the flax names, so the mapping is per leaf:
a Dense ``kernel`` (in, out) becomes a Linear ``weight`` (out, in) and a
BatchNorm's ``scale``/``bias``/``mean``/``var`` become
``weight``/``bias``/``running_mean``/``running_var``.
"""
from __future__ import annotations

from collections import OrderedDict
from collections.abc import Mapping
from typing import Dict, Iterator, Tuple

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
