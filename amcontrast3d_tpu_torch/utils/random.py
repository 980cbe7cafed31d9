"""Reproducibility helpers (↔ ``amcontrast3d_tpu/utils/random.py``).

Seeds the host-side python and numpy RNGs used by the data pipeline and
PyTorch's global generator, and returns a ``torch.Generator`` seeded alike
(the counterpart of the root ``jax.random.PRNGKey``).  :func:`fold_in`
derives the seed of a sub-stream (a step, a rank) from a seed, as
``jax.random.fold_in`` derives a key.
"""
from __future__ import annotations

import random as _py_random

import numpy as np
import torch


def set_random_seed(seed: int = 0, deterministic: bool = False,
                    device="cpu") -> torch.Generator:
    _py_random.seed(seed)
    np.random.seed(seed % (2 ** 32))
    torch.manual_seed(seed)
    return torch.Generator(device).manual_seed(seed)


_MASK64 = 2 ** 64 - 1


def fold_in(seed: int, data: int) -> int:
    """The seed of stream ``data`` under ``seed`` (↔ ``jax.random.fold_in``):
    splitmix64's finaliser of ``seed · φ + data``, 63 bits.  Two seeds'
    streams are unrelated, not one sequence shifted, as ``seed + data``
    would make them (seed 42's step 100 would be seed 142's step 0)."""
    z = (seed * 0x9E3779B97F4A7C15 + data + 0x632BE59BD9B4E019) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1
