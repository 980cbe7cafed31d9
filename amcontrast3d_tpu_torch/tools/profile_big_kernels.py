"""Time the three whole-room kernels on one NVIDIA GPU at the shapes of a
155648-point subcloud, each beside the kernel it takes over from.

    python3 -m amcontrast3d_tpu_torch.tools.profile_big_kernels [--points N]

Prints the card, then per kernel the median device time (CUDA events):
the whole-room FPS per stage with its time per pick through the cluster
kernel and the grid kernel (cluster, grid, grid, cluster), the chunk-skipping
ball query against the scan-everything kernel at the first two stages, and
the chunk-skipping kNN (self-kNN, k = 24) against the scan-everything
kernel, on a room-like cloud (points on the faces of a box and in solid
boxes, on a 0.04 m grid) and on a uniform one.  Results are compared for
equality as they are timed.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess

import numpy as np
import torch

from .. import ops


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, runs: int = 5) -> float:
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


def room_cloud(rng, n: int) -> np.ndarray:
    """(1, n, 3) f32: the faces of a 7 x 6 x 3 m room and four solid boxes,
    one point per 0.04 m voxel at most."""
    pts = rng.rand(4 * n, 3) * [7, 6, 3]
    axis = rng.randint(0, 3, len(pts))
    side = rng.randint(0, 2, len(pts)) * np.array([7, 6, 3])[axis]
    pts[np.arange(len(pts)), axis] = side + 0.01 * rng.randn(len(pts))
    solid = rng.rand(n, 3) * [1.2, 1.0, 0.8] + \
        rng.randint(1, 5, (n, 1)) * [1.2, 1.0, 0.0]
    pts = np.concatenate([pts, solid])
    cell = np.floor(pts / 0.04).astype(np.int64)
    _, first = np.unique(cell, axis=0, return_index=True)
    pts = pts[rng.permutation(first)]
    if len(pts) < n:
        raise ValueError(f"room holds {len(pts)} voxels, fewer than {n}")
    return pts[None, :n].astype(np.float32)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--points", type=int, default=155648)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_big_kernels: no CUDA device")
    tag = card()
    print(tag)
    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(0)
    n = args.points
    clouds = {"room": room_cloud(rng, n),
              "uniform": (rng.rand(1, n, 3) * [7, 6, 3]).astype(np.float32)}
    for name, pts in clouds.items():
        p = torch.from_numpy(pts).to(dev)
        stages = [p]
        for s in range(1, 5):
            prev = stages[-1]
            npoint = prev.shape[1] // 4
            idx = ops.fps._fps_b1_grid(prev, npoint)
            line = f"{name} fps_b1 {prev.shape[1]} -> {npoint}:"
            for path in ("cluster", "grid", "grid", "cluster"):
                kernel = getattr(ops.fps, f"_fps_b1_{path}")
                got = kernel(prev, npoint)
                torch.cuda.synchronize()
                if not torch.equal(got, idx):
                    raise AssertionError("fps kernels disagree")
                ms = cuda_ms(lambda: kernel(prev, npoint), 3)
                line += f" {path} {ms:.3f} ms, {ms / npoint * 1e3:.3f} us a pick;"
            print(f"{line}  [{tag}]")
            stages.append(ops.gather_points(prev, idx).contiguous())
        for sup, q, r in ((stages[0], stages[1], 0.1), (stages[1], stages[1], 0.2),
                          (stages[1], stages[2], 0.2)):
            big = ops.ball_query_big(sup, q, r, 32)
            small = ops.ball_query_small(sup, q, r, 32)
            torch.cuda.synchronize()
            if not torch.equal(big, small):
                raise AssertionError("ball query kernels disagree")
            print(f"{name} ball query {q.shape[1]} x {sup.shape[1]} r={r}: big "
                  f"{cuda_ms(lambda: ops.ball_query_big(sup, q, r, 32)):.3f} ms, "
                  f"small {cuda_ms(lambda: ops.ball_query_small(sup, q, r, 32)):.3f}"
                  f" ms  [{tag}]")
        big, small = ops.knn_big(p, p, 24), ops.knn_small(p, p, 24)
        torch.cuda.synchronize()
        if not (torch.equal(big[0], small[0]) and torch.equal(big[1], small[1])):
            raise AssertionError("kNN kernels disagree")
        print(f"{name} self-kNN {n} k=24: big "
              f"{cuda_ms(lambda: ops.knn_big(p, p, 24)):.3f} ms, small "
              f"{cuda_ms(lambda: ops.knn_small(p, p, 24), 3):.3f} ms  [{tag}]")


if __name__ == "__main__":
    main()
