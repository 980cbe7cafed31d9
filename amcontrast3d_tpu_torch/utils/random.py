"""Reproducibility helpers (↔ ``amcontrast3d_tpu/utils/random.py``).

Seeds the host-side python and numpy RNGs used by the data pipeline and
PyTorch's global generator, and returns a ``torch.Generator`` seeded alike
(the counterpart of the root ``jax.random.PRNGKey``).
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
