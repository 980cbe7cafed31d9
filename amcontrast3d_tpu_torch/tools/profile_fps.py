"""Time the batched FPS kernel on one NVIDIA GPU at every cluster size.

    python3 -m amcontrast3d_tpu_torch.tools.profile_fps [--batch B] [--runs R]

The batched kernel (``csrc/fps.cu``, the register-resident cluster kernel
of ``csrc/fps_cluster.cuh``) samples each of B clouds with one cluster of
S blocks.  This prints the card and how many clusters of each S it holds
at once, then for cloud sizes N from 256 to 163840 the time a pick (B
uniform clouds of N points → N / 4 picks, one launch, median of R runs
after a warm-up, CUDA events) at every S whose blocks hold N points, with
the S that ``ops.fps.fps_cluster_size`` takes; then the floor of a pick at
each S: B clouds of S × 512 points (one a thread) and as many picks, so the
sweep is next to nothing and the time is that of one reduction over the
cluster.  The gates of ``ops.fps.CLUSTER_GATES`` are read off this table
(``PERF.md`` §6).  Picks are checked against the dispatch's own at each N.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess

import torch

from .. import ops

SWEEP_N = (256, 512, 1024, 1500, 2048, 3072, 4096, 6000, 8192, 10240, 12288,
           16384, 20480, 24000, 32768, 40960, 49152, 64000, 81920, 98304,
           131072, 163840)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, runs: int) -> float:
    fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def capacity(dev) -> dict:
    """{S: clusters of S blocks the card holds at once}."""
    return dict(ops.fps._cluster_capacity(dev.index))


def floor_us(dev, b: int, s: int, runs: int) -> float:
    """us a pick of b clouds of s × 512 points (one a thread), as many
    picks: one reduction over a cluster of s blocks and a sweep of one
    point."""
    n = s * ops.fps.CLUSTER_THREADS
    xyz = torch.rand(b, n, 3, device=dev, generator=torch.Generator(dev)
                     .manual_seed(s)) * 4
    return cuda_ms(lambda: ops.fps._fps_cluster(xyz, n, s), runs) / n * 1e3


def sweep(dev, b: int, ns, runs: int) -> dict:
    """{N: {S: us a pick}} for b uniform clouds of N points → N / 4 picks at
    every S that holds N, the dispatch's picks checked against each S's."""
    gen = torch.Generator(dev).manual_seed(0)
    table = {}
    for n in ns:
        xyz = torch.rand(b, n, 3, device=dev, generator=gen) * 4
        npoint = max(1, n // 4)
        want = ops.furthest_point_sample(xyz, npoint)
        row = {}
        for s in ops.fps.CLUSTER_SIZES:
            if n > s * ops.fps.CLUSTER_THREADS * ops.fps.THREAD_POINTS:
                continue
            got = ops.fps._fps_cluster(xyz, npoint, s)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"fps at N={n}, S={s}: picks differ "
                                     "from the dispatch's")
            row[s] = cuda_ms(lambda: ops.fps._fps_cluster(xyz, npoint, s),
                             runs) / npoint * 1e3
        table[n] = row
    return table


def print_sweep(dev, b: int, table: dict, tag: str) -> None:
    cap = capacity(dev)
    for n, row in table.items():
        chosen = ops.fps.fps_cluster_size(b, n, cap)
        cells = ", ".join(f"S={s} {us:.3f}" for s, us in row.items())
        best = min(row, key=row.get)
        print(f"fps sweep B={b} N={n} -> {max(1, n // 4)}: us a pick {cells}; "
              f"fastest S={best}, dispatch S={chosen}  [{tag}]")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--runs", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_fps: no CUDA device")
    tag = card()
    print(tag)
    dev = torch.device("cuda", 0)
    print(f"clusters the card holds at once, by S: {capacity(dev)}  [{tag}]")
    print_sweep(dev, args.batch, sweep(dev, args.batch, SWEEP_N, args.runs), tag)
    for s in ops.fps.CLUSTER_SIZES:
        print(f"fps floor B={args.batch} S={s}: "
              f"{floor_us(dev, args.batch, s, args.runs):.3f} us a pick  [{tag}]")


if __name__ == "__main__":
    main()
