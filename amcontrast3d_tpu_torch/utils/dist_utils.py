"""Distributed-info helpers (↔ ``amcontrast3d_tpu/utils/dist_utils.py``,
itself ↔ openpoints/utils/dist_utils.py:14-54).

One process a rank (:mod:`amcontrast3d_tpu_torch.parallel`): the rank and
the world size are the default process group's, and outside one a process
is rank 0 of 1.  ``reduce_tensor`` / ``gather_tensor`` are the mean and the
gather over the ranks, and the identity outside a group of more than one.
"""
from __future__ import annotations

import socket
from typing import Tuple

import torch

from .. import parallel


def get_dist_info(cfg=None) -> Tuple[int, int, bool]:
    """Returns (rank, world_size, distributed)."""
    rank, world_size = parallel.get_rank(), parallel.get_world_size()
    distributed = world_size > 1
    if cfg is not None:
        cfg.rank = rank
        cfg.world_size = world_size
        cfg.distributed = distributed
        cfg.mp = distributed
    return rank, world_size, distributed


def reduce_tensor(tensor: torch.Tensor) -> torch.Tensor:
    """The mean of ``tensor`` over the ranks (a new tensor)."""
    if parallel.get_world_size() == 1:
        return tensor
    out = tensor.clone()
    parallel.collective("all_reduce", out)
    return out / parallel.get_world_size()


def gather_tensor(tensor: torch.Tensor) -> torch.Tensor:
    """Every rank's ``tensor`` stacked on a new leading axis, in rank
    order (the identity outside a group of more than one, as JAX's outside
    a mapped context)."""
    if parallel.get_world_size() == 1:
        return tensor
    rows = [torch.empty_like(tensor) for _ in range(parallel.get_world_size())]
    parallel.collective("all_gather", rows, tensor.contiguous())
    return torch.stack(rows)


def find_free_port() -> int:
    s = socket.socket()
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    return port
