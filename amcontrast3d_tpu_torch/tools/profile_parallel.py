"""Where a data-parallel rank's extra time goes, on NVIDIA GPUs.

    python3 -m amcontrast3d_tpu_torch.tools.profile_parallel [--runs R]
        [--ranks N]

N ranks over NCCL, one a card (default 1; spawned by ``parallel.launch``),
rank 0 printing: the host time of one ``all_reduce`` of 2·C floats (the
synced BatchNorm's backward) and of one ``all_gather`` of them (its
forward) against an in-place add of the same tensor, then a train-mode
BatchNorm call (forward and backward, and the forward alone) at a
point-level shape of the S3DIS step (4 × 24000 rows, C = 64) and at a
grouped one of the gather tail (4 × 24000 × 32 rows, C = 64): the plain
``ChannelsLastBatchNorm``, the synced one, and the synced one with its two
collectives left out (``parallel.collective`` a no-op: what the rest of
the synced arithmetic costs).  Each time is the median of R host-clock
reads around synchronised work, after three warm-up calls, with the card's
name and power limit.  Without a CUDA device it stops.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import time

import torch

from .. import parallel
from ..models.layers import batch_norm

SHAPES = ((4 * 24000, 64), (4 * 24000 * 32, 64))


def host_ms(fn, runs: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def _rank(rank: int, dev, runs: int, tag: str) -> None:
    small = torch.randn(2 * 64, device=dev)
    world = parallel.get_world_size()
    rows = [torch.empty_like(small) for _ in range(world)]
    calls = 100

    def reduce():
        for _ in range(calls):
            parallel.collective("all_reduce", small)

    def gather():
        for _ in range(calls):
            parallel.collective("all_gather", rows, small)

    def add():
        for _ in range(calls):
            small.add_(1.0)

    us = {name: host_ms(fn, runs) / calls * 1e3
          for name, fn in (("all_reduce", reduce), ("all_gather", gather),
                           ("add", add))}
    if rank == 0:
        print(f"{small.numel()} floats, NCCL at world size {world}: "
              f"all_reduce {us['all_reduce']:.1f} us a call, all_gather "
              f"{us['all_gather']:.1f}; an in-place add {us['add']:.1f} us "
              f"(host, {calls} a read, synchronised)  [{tag}]", flush=True)
    real = parallel.collective
    try:
        for n, c in SHAPES:
            x = torch.randn(n, c, device=dev).requires_grad_()
            g = torch.randn(n, c, device=dev)
            for label in ("plain", "synced", "synced without its collectives"):
                bn = batch_norm(c).to(dev).train()
                if label != "plain":
                    parallel.sync_batchnorm_(bn)
                parallel.collective = ((lambda *args, **kwargs: None)
                                       if "without" in label else real)

                def both():
                    bn(x).backward(g)

                def forward():
                    with torch.no_grad():
                        bn(x)

                ms = (host_ms(both, runs), host_ms(forward, runs))
                if rank == 0:
                    print(f"BatchNorm ({n}, {c}) {label} at world size "
                          f"{world}: forward and backward {ms[0]:.3f} ms, "
                          f"forward {ms[1]:.3f} ms  [{tag}]", flush=True)
    finally:
        parallel.collective = real


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--runs", type=int, default=20)
    parser.add_argument("--ranks", type=int, default=1)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_parallel: no CUDA device")
    tag = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    parallel.launch(_rank, args.ranks, (args.runs, tag), device_type="cuda",
                    backend="nccl", timeout=600)


if __name__ == "__main__":
    main()
