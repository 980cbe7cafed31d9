"""Time the whole-room kernels on one NVIDIA GPU, each beside the kernel
it takes over from.

    python3 -m amcontrast3d_tpu_torch.tools.profile_big_kernels [--points N]
    python3 -m amcontrast3d_tpu_torch.tools.profile_big_kernels --rungs

Without ``--rungs``: the three kernels of a 155648-point subcloud (below).
With ``--rungs``: the kernels of the buckets from 221184 up, on room-like
and uniform clouds: the chunk-pruned FPS (``csrc/fps_pruned.cu``) at
311296 -> 77824 and 1.2 M -> 4096 points beside the grid kernel of
``csrc/fps.cu`` (time and chunk visits a pick), and the chunk-pruned
interpolation (``csrc/interpolate_big.cu``) at fp0 of the 221184 and 311296
buckets (C = 128) and at fp1 of the 622592 bucket (155648 -> 38912,
C = 256) beside the listed scan of ``csrc/interpolate.cu`` over the two
clouds' layouts (one ``sort_stages``, as a forward makes them; time and
the share of chunk visits the pruned kernel skips), the crossing of the
two kernels at the rungs; picks and outputs are compared for equality.

Prints the card, then per kernel the median device time (CUDA events):
the whole-room FPS per stage with its time per pick through the cluster
kernel (at the dispatch's cluster size) and the grid kernel (cluster,
grid, grid, cluster), the listed
ball query at the first two stages over the stages' layouts (one sort, as
the encoder makes them) beside the same kernel sorting its support itself,
and the chunk-pruned kNN (self-kNN, k = 24), on a room-like cloud (points
on the faces of a box and in solid boxes, on a 0.04 m grid) and on a
uniform one.  Results are compared for equality as they are timed.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess

import numpy as np
import torch

from .. import ops
from ..ops import spatial


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


def room_cloud(rng, n: int, voxel: float = 0.04) -> np.ndarray:
    """(1, n, 3) f32: the faces of a 7 x 6 x 3 m room and four solid boxes,
    one point per ``voxel`` at most."""
    pts = rng.rand(4 * n, 3) * [7, 6, 3]
    axis = rng.randint(0, 3, len(pts))
    side = rng.randint(0, 2, len(pts)) * np.array([7, 6, 3])[axis]
    pts[np.arange(len(pts)), axis] = side + 0.01 * rng.randn(len(pts))
    solid = rng.rand(n, 3) * [1.2, 1.0, 0.8] + \
        rng.randint(1, 5, (n, 1)) * [1.2, 1.0, 0.0]
    pts = np.concatenate([pts, solid])
    cell = np.floor(pts / voxel).astype(np.int64)
    _, first = np.unique(cell, axis=0, return_index=True)
    pts = pts[rng.permutation(first)]
    if len(pts) < n:
        raise ValueError(f"room holds {len(pts)} voxels, fewer than {n}")
    return pts[None, :n].astype(np.float32)


def _equal(what: str, got, want) -> None:
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"{what}: {int((got != want).sum())} differ")


def rungs(dev, rng, tag: str) -> None:
    """The pruned FPS and the pruned interpolation beside the kernels they
    take over from."""
    # the rungs' subclouds come from ScanNet's 0.02 m voxels
    for name, pts in (("room", room_cloud(rng, 311296, 0.02)),
                      ("uniform", rng.rand(1, 311296, 3) * [7, 6, 3]),
                      ("uniform", rng.rand(1, 1200000, 3) * [7, 6, 3])):
        p = torch.from_numpy(pts.astype(np.float32)).to(dev)
        n = p.shape[1]
        npoint = n // 4 if n < 10 ** 6 else 4096
        visits = torch.zeros(1, dtype=torch.int64, device=dev)
        got = ops.furthest_point_sample_pruned(p, npoint, visits)
        _equal(f"fps {name} {n}", got, ops.fps._fps_b1_grid(p, npoint))
        ms = cuda_ms(lambda: ops.furthest_point_sample_pruned(p, npoint), 3)
        grid = cuda_ms(lambda: ops.fps._fps_b1_grid(p, npoint), 1)
        print(f"{name} fps {n} -> {npoint}: pruned {ms:.3f} ms = "
              f"{ms / npoint * 1e3:.3f} us a pick, {visits.item() / npoint:.2f} "
              f"chunk visits a pick of {-(-n // 64)}; grid {grid:.3f} ms = "
              f"{grid / npoint * 1e3:.3f} us a pick  [{tag}]")
    for n1, c in ((221184, 128), (311296, 128), (155648, 256)):
        for name, pts in (("room", room_cloud(rng, n1, 0.02)),
                          ("uniform", rng.rand(1, n1, 3) * [7, 6, 3])):
            p1 = torch.from_numpy(pts.astype(np.float32)).to(dev)
            n2 = n1 // 4
            p2 = ops.gather_points(p1, ops.furthest_point_sample(p1, n2)).contiguous()
            f2 = torch.from_numpy(rng.randn(1, n2, c).astype(np.float32)).to(dev)
            visits = torch.zeros(1, dtype=torch.int64, device=dev)
            out, idx, w = ops.three_interpolation_big(p1, p2, f2, True, visits)
            fine, coarse = spatial.sort_stages([p1, p2])
            l_out, l_idx, l_w = ops.three_interpolation_small(p1, p2, f2, True,
                                                              coarse, fine)
            for what, a, b in (("out", out, l_out), ("idx", idx, l_idx),
                               ("w", w, l_w)):
                _equal(f"interpolation {name} {n1} {what}", a, b)
            ms = cuda_ms(lambda: ops.three_interpolation_big(p1, p2, f2))
            listed = cuda_ms(lambda: ops.three_interpolation_small(
                p1, p2, f2, False, coarse, fine))
            pairs = n1 * -(-n2 // 64)
            print(f"{name} interpolation {n1} -> {n2}, C={c}: pruned {ms:.3f} "
                  f"ms (its own sort included), listed over the layouts "
                  f"{listed:.3f} ms, chunk visits the pruned kernel skips "
                  f"{100 * (1 - visits.item() / pairs):.3f} %, "
                  f"{visits.item() / n1:.2f} a fine point  [{tag}]")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--points", type=int, default=155648)
    ap.add_argument("--rungs", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_big_kernels: no CUDA device")
    tag = card()
    print(tag)
    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(0)
    if args.rungs:
        rungs(dev, rng, tag)
        return
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
            size = ops.fps.fps_cluster_size(
                1, prev.shape[1], ops.fps._cluster_capacity(dev.index))
            kernels = {
                "cluster": lambda: ops.fps._fps_b1_cluster(prev, npoint, size),
                "grid": lambda: ops.fps._fps_b1_grid(prev, npoint)}
            for path in ("cluster", "grid", "grid", "cluster"):
                got = kernels[path]()
                torch.cuda.synchronize()
                if not torch.equal(got, idx):
                    raise AssertionError("fps kernels disagree")
                ms = cuda_ms(kernels[path], 3)
                line += f" {path} {ms:.3f} ms, {ms / npoint * 1e3:.3f} us a pick;"
            print(f"{line}  [{tag}]")
            stages.append(ops.gather_points(prev, idx).contiguous())
        layouts = spatial.sort_stages(stages[:3])
        for si, qi, r in ((0, 1, 0.1), (1, 1, 0.2), (1, 2, 0.2)):
            sup, q, lay = stages[si], stages[qi], (layouts[si], layouts[qi])
            got = ops.ball_query(sup, q, r, 32, *lay)
            torch.cuda.synchronize()
            if not torch.equal(got, ops.ball_query(sup, q, r, 32)):
                raise AssertionError("the ball query differs with its layouts")
            print(f"{name} ball query {q.shape[1]} x {sup.shape[1]} r={r}: over "
                  f"the layouts {cuda_ms(lambda: ops.ball_query(sup, q, r, 32, *lay)):.3f}"
                  f" ms, sorting its support "
                  f"{cuda_ms(lambda: ops.ball_query(sup, q, r, 32)):.3f} ms  [{tag}]")
        print(f"{name} self-kNN {n} k=24: "
              f"{cuda_ms(lambda: ops.knn(p, p, 24)):.3f} ms  [{tag}]")


if __name__ == "__main__":
    main()
