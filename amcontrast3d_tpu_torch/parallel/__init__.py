"""Data parallelism: one process per card (↔ ``amcontrast3d_tpu/parallel``).

The JAX package runs one process over a ``'dp'`` mesh under ``shard_map``;
the reference spawns one DDP process per GPU over NCCL
(``main_AA.py:857-865``).  The port takes the reference's form with the JAX
package's semantics: rank r of N holds the rows ``[r·B/N, (r+1)·B/N)`` of
the global batch (:func:`shard_batch`, JAX's ``P('dp')`` split), every
rank holds the same parameters (:func:`replicate` once after the build),
train-mode BatchNorms average their statistics over the ranks with the
gradient flowing through that average (:func:`sync_batchnorm_`,
:func:`all_reduce_mean`), the gradients are averaged in one all_reduce of
a flat buffer before the clip and AdamW (:func:`all_reduce_gradients_`),
and the metrics are averaged and the confusion matrix summed.

NCCL drives CUDA devices and gloo the CPU (and two ranks on one card,
which NCCL refuses).  :func:`launch` spawns the ranks of one host with a
``file://`` rendezvous; under ``torchrun`` the ranks come from its
environment (:func:`from_environment`).  Every collective the package
issues goes through :func:`collective` and is counted in :data:`COUNTS`.
"""
from __future__ import annotations

import datetime
import os
import tempfile
import time
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

# collectives issued by the package since the last reset_counts(), by kind
COUNTS: Dict[str, int] = {"all_reduce": 0, "broadcast": 0, "all_gather": 0,
                          "barrier": 0}


def reset_counts() -> None:
    for key in COUNTS:
        COUNTS[key] = 0


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def get_world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def from_environment() -> Optional[Tuple[int, int, int]]:
    """``(rank, world_size, local_rank)`` from ``torchrun``'s environment,
    or None outside it."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None
    rank = int(os.environ["RANK"])
    return (rank, int(os.environ["WORLD_SIZE"]),
            int(os.environ.get("LOCAL_RANK", rank)))


def requested_world_size(cfg, device_type: str) -> int:
    """The ranks a cfg asks for (↔ the JAX runner: data parallel on any
    host with more than one device unless ``distributed: False``):
    ``torchrun``'s ``WORLD_SIZE``; else 1 with ``distributed: False``; else
    every visible card, or ``world_size`` (default 1) on the CPU."""
    env = from_environment()
    if env is not None:
        return env[1]
    if cfg.get("distributed", None) is False:
        return 1
    if device_type == "cuda":
        return max(torch.cuda.device_count(), 1)
    return int(cfg.get("world_size") or 1)


def rank_device(device_type: str, local_rank: int) -> torch.device:
    """The device of a rank: ``cuda:{local_rank}``, or the CPU."""
    if device_type == "cuda":
        return torch.device("cuda", local_rank)
    return torch.device(device_type)


def init_process_group(rank: int, world_size: int, device: torch.device,
                       backend: Optional[str] = None,
                       init_method: Optional[str] = None) -> None:
    """Joins the default process group: NCCL for a CUDA device, gloo for
    the CPU unless ``backend`` says otherwise; ``init_method`` a
    ``file://`` path or, by default, ``torchrun``'s ``env://``."""
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if backend == "gloo":
        # the ranks of one host meet over the loopback interface
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    # the other ranks wait in a collective while rank 0 validates
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(minutes=60))


def destroy_process_group() -> None:
    if is_initialized():
        dist.destroy_process_group()


def collective(kind: str, tensor: torch.Tensor, *args, **kwargs):
    """``torch.distributed.<kind>(tensor, …)`` over the default group,
    counted in :data:`COUNTS`; a failure raises."""
    COUNTS[kind] += 1
    return getattr(dist, kind)(tensor, *args, **kwargs)


def barrier() -> None:
    if is_initialized():
        COUNTS["barrier"] += 1
        dist.barrier()


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; the cotangent is summed over the ranks too (the
    transpose of ``psum``), so each rank's input receives every rank's
    share of the gradient through the shared value."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        collective("all_reduce", y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        collective("all_reduce", g, group=ctx.group)
        return g, None


def all_reduce_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of ``x`` over the ranks, differentiable (↔ ``lax.pmean``):
    one all_reduce forward and one backward."""
    n = dist.get_world_size(group)
    return _AllReduceSum.apply(x, group) / n


def rank_rows(batch_size: int, rank: int, world_size: int) -> slice:
    """Rank ``rank``'s rows ``[r·B/N, (r+1)·B/N)`` of a global batch of
    ``batch_size`` (the JAX package's ``NamedSharding(P('dp'))`` split).
    Raises unless N divides the batch size."""
    if batch_size % world_size:
        raise ValueError(f"batch_size {batch_size} is not a multiple of the "
                         f"world size {world_size}: the data-parallel ranks "
                         "split the global batch into equal rows")
    per = batch_size // world_size
    return slice(rank * per, (rank + 1) * per)


def shard_batch(batch: Dict, rank: Optional[int] = None,
                world_size: Optional[int] = None) -> Dict:
    """Rank ``rank``'s rows (:func:`rank_rows`) of every array of a global
    batch."""
    rank = get_rank() if rank is None else rank
    world_size = get_world_size() if world_size is None else world_size
    rows = rank_rows(len(next(iter(batch.values()))), rank, world_size)
    return {k: v[rows] for k, v in batch.items()}


@torch.no_grad()
def replicate(module: torch.nn.Module, src: int = 0) -> torch.nn.Module:
    """Every parameter and buffer of ``module`` broadcast from rank
    ``src``, so all ranks start from its weights."""
    for t in list(module.parameters()) + list(module.buffers()):
        collective("broadcast", t.data, src=src)
    return module


def sync_batchnorm_(model: torch.nn.Module, group=None) -> torch.nn.Module:
    """Every BatchNorm of ``model`` (the channels-last BatchNorm and the
    fused tail's ``GroupStatsBN``) averages its train-mode statistics over
    ``group`` (None: the default process group, looked up at each call)
    (↔ ``convert_sync_batchnorm``; the JAX modules' ``bn_axis_name``)."""
    from ..models.layers import ChannelsLastBatchNorm
    for m in model.modules():
        if isinstance(m, ChannelsLastBatchNorm):
            m.synced = True
            m.process_group = group
    return model


@torch.no_grad()
def all_reduce_gradients_(params: Iterable[torch.Tensor]) -> None:
    """Each gradient replaced by its mean over the ranks (↔ ``pmean`` of
    the gradient tree): one all_reduce of one flat buffer.  Parameters
    without a gradient (frozen, or unused by this step's graph, which every
    rank shares) are left out."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    collective("all_reduce", flat)
    flat /= get_world_size()
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def reduce_metrics(loss: torch.Tensor, aux: Dict[str, torch.Tensor],
                   cm: torch.Tensor):
    """The loss and the aux metrics averaged over the ranks (one
    all_reduce) and the confusion matrix summed (one more); device tensors
    in, device tensors out, nothing read back to the host."""
    keys = list(aux)
    stacked = torch.stack([loss.float()] + [aux[k].float() for k in keys])
    collective("all_reduce", stacked)
    stacked /= get_world_size()
    collective("all_reduce", cm)
    return (stacked[0].to(loss.dtype),
            {k: stacked[i + 1].to(aux[k].dtype) for i, k in enumerate(keys)},
            cm)


def broadcast_floats(values, src: int = 0, device=None) -> list:
    """Host floats of rank ``src`` on every rank (one broadcast)."""
    t = torch.tensor(np.asarray(values, np.float64), device=device)
    collective("broadcast", t, src=src)
    return t.tolist()


def launch(fn: Callable, world_size: int, args: tuple = (),
           device_type: str = "cuda", backend: Optional[str] = None,
           devices: Optional[int] = None,
           timeout: Optional[float] = None) -> None:
    """Runs ``fn(rank, device, *args)`` in ``world_size`` spawned processes
    of this host, each in the default process group (a ``file://``
    rendezvous in a fresh temporary directory).  Rank r's device is
    ``cuda:{r % devices}`` (``devices``: the cards to spread over, all
    visible ones by default; 1 puts every rank on ``cuda:0``, which only
    gloo allows) or the CPU, where each rank takes its share of the cores
    for its intra-op threads.  Returns when every rank has ended; raises if
    any rank failed (the others are stopped), or, after ``timeout``
    seconds, stops them all and raises ``TimeoutError``."""
    import torch.multiprocessing as mp
    if device_type == "cuda":
        devices = devices or torch.cuda.device_count()
        if devices < 1:
            raise RuntimeError("no CUDA device to launch the ranks on")
        if world_size > devices and backend != "gloo":
            raise ValueError(f"world size {world_size} over {devices} cards: "
                             "NCCL takes one rank a card (gloo shares one)")
    with tempfile.TemporaryDirectory() as tmp:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        ranks = mp.spawn(_spread_entry, nprocs=world_size, join=False,
                         args=(world_size, fn, args, device_type, backend,
                               init_method, devices or 1))
        deadline = None if timeout is None else time.monotonic() + timeout
        while not ranks.join(timeout=1.0):
            if deadline is not None and time.monotonic() > deadline:
                for p in ranks.processes:
                    p.kill()
                    p.join()
                raise TimeoutError(f"the {world_size} ranks ran past "
                                   f"{timeout} s and were stopped")


def _spread_entry(rank, world_size, fn, args, device_type, backend,
                  init_method, devices):
    device = rank_device(device_type, rank % devices)
    if device.type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    init_process_group(rank, world_size, device, backend, init_method)
    try:
        fn(rank, device, *args)
    finally:
        destroy_process_group()
