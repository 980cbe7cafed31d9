"""Time the whole-room kernels on one NVIDIA GPU, each beside the kernel
it takes over from.

    python3 -m amcontrast3d_tpu_torch.tools.profile_big_kernels [--points N]
    python3 -m amcontrast3d_tpu_torch.tools.profile_big_kernels --rungs
    python3 -m amcontrast3d_tpu_torch.tools.profile_big_kernels --gates

Without ``--rungs``: the three kernels of a 155648-point subcloud (below).
With ``--rungs``: the kernels of the buckets from 221184 up, on room-like
and uniform clouds: the chunk-pruned FPS (``csrc/fps_pruned.cu``) at
311296 -> 77824 and 1.2 M -> 4096 points beside the grid kernel of
``csrc/fps.cu`` (time and chunk visits a pick), and the chunk-pruned
interpolation (``csrc/interpolate_big.cu``, a lane a fine point) at fp0 of
the 221184 and 311296 buckets (C = 128) and at fp1 of the 622592 bucket
(155648 -> 38912, C = 256) beside the listed scan of ``csrc/interpolate.cu``,
both over the two clouds' layouts (one ``sort_stages``, as a forward makes
them; time and the chunks a warp scanned); picks and outputs are compared
for equality.
With ``--gates``: the table the gates of the two large-shape interpolation
kernels are read from (:func:`gate_table`): at every decoder stage of the
S3DIS and ScanNet steps, of PointNet++'s eval forward, of two clouds of
22000 points (the gates' threshold) and of room subclouds from 106496 to
311296 points, each kernel's device time beside the kernel that shares its
calls.  ``--gates --only NAME`` reads the clouds of that name alone.

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


def _close(what: str, got, want) -> float:
    """Raises unless ``got`` is within 1e-5·(1+max|want|) of ``want``;
    returns the largest absolute difference."""
    err = (got - want).abs().max().item()
    if not err <= 1e-5 * (1 + want.abs().max().item()):
        raise AssertionError(f"{what}: max abs err {err}")
    return err


GATE_CHANNELS = (128, 256, 512, 1024)   # PointNeXt's coarse widths, fp0 ... fp3
# the clouds the gates of the two large-shape interpolation kernels are read
# on: (name, B, points a cloud, voxel of a room-like cloud or None for
# uniform in [0, 4]^3 / a 7 x 6 x 3 m room, the coarse widths of fp0 ...
# fp3).  Beside the steps and the subclouds: PointNet++'s eval forward
# (cfgs/s3dis/pointnet++.yaml, coarse widths 64 ... 512), and stages of
# 22000 fine points a call (fp0 of one 22000-point room, fp1 of 4 x 22000
# points at 256 channels) and 5500 (that room's fp1)
GATE_CLOUDS = (("S3DIS step", 4, 24000, None, GATE_CHANNELS),
               ("ScanNet step", 2, 64000, 0.02, GATE_CHANNELS),
               ("PointNet++ eval", 2, 24000, None, (64, 128, 256, 512)),
               ("below the gate", 4, 22000, None, GATE_CHANNELS),
               ("below the gate", 1, 22000, 0.04, GATE_CHANNELS),
               ("subcloud", 1, 106496, 0.04, GATE_CHANNELS),
               ("subcloud", 1, 155648, 0.04, GATE_CHANNELS),
               ("subcloud", 1, 221184, 0.02, GATE_CHANNELS),
               ("subcloud", 1, 311296, 0.02, GATE_CHANNELS),
               ("uniform subcloud", 1, 221184, None, GATE_CHANNELS),
               ("uniform subcloud", 1, 311296, None, GATE_CHANNELS))


def gate_stages(dev, rng, b: int, n: int, voxel) -> list:
    """The five stage clouds of a forward over ``b`` clouds of ``n`` points
    (each stage a quarter of the last, by the FPS dispatch)."""
    if voxel is None and b > 1:
        pts = rng.rand(b, n, 3) * 4
    elif voxel is None:
        pts = rng.rand(1, n, 3) * [7, 6, 3]
    elif b == 1:
        pts = room_cloud(rng, n, voxel)
    else:
        # a step's clouds differ: rooms on a grid of twice the voxel, scaled
        # by 0.5, 0.4, ... and shifted
        pts = np.concatenate([room_cloud(rng, n, 2 * voxel) * (0.5 - 0.1 * i)
                              + 0.3 * i for i in range(b)])
    stages = [torch.from_numpy(pts.astype(np.float32)).to(dev)]
    for _ in range(4):
        prev = stages[-1]
        idx = ops.furthest_point_sample(prev, prev.shape[1] // 4)
        stages.append(ops.gather_points(prev, idx).contiguous())
    return stages


# the kernels each side of the two gates launches, by name as the profiler
# shows them (the VJPs' memsets included)
GATE_KERNELS = {"forward": (("interp_big_kernel",), ("interp_kernel",)),
                "VJP": (("bin_rows", "sum_rows", "Memset"),
                        ("interp_bwd_kernel", "Memset"))}


def gate_table(dev, rng, tag: str, runs: int = 10, clouds=GATE_CLOUDS,
               device: bool = True) -> list:
    """The two large-shape interpolation kernels beside the kernels they
    share the calls with, at each decoder stage (stage s onto s - 1, over
    the forward's layouts of one ``sort_stages``) of ``clouds``: the
    forward of ``csrc/interpolate_big.cu`` against the listed scan of
    ``csrc/interpolate.cu`` (output, indices and weights identical; the
    indices identical to the twin's and the output within 1e-5·(1+max) of
    the plain interpolation on the same inputs), and
    the deterministic VJP of ``csrc/interpolate_bwd_big.cu`` (rows in the
    coarse layout's order; within 1e-5·(1+max) of the twin, the same bits
    twice) against the scatter of ``csrc/interpolate.cu`` (fine layout's
    order).  Each is read as its kernels' device time a call (the
    profiler, ``runs`` calls; with ``device`` only) and as the wrapper's
    (CUDA events around the call, median of ``runs``), in the order other,
    new, new, other; the gates are read from the device times.  Each line
    names the kernels the dispatch took in a forward and backward through
    ``three_interpolation`` (read off the launch counters, and held against
    ``forward_is_big`` and ``backward_is_big``).  Returns the rows (where,
    b, n1, n2, c, and device (NaN without ``device``) and wrapper ms of the
    forward's new and other kernel, then the VJP's)."""
    from .profile_scans import kernel_ms

    table = []
    for where, b, n, voxel, channels in clouds:
        stages = gate_stages(dev, rng, b, n, voxel)
        layouts = spatial.sort_stages(stages)
        for s, c in zip(range(1, 5), channels):
            p1, p2 = stages[s - 1], stages[s]
            fine, coarse = layouts[s - 1], layouts[s]
            n1, n2 = p1.shape[1], p2.shape[1]
            f2 = torch.from_numpy(rng.randn(b, n2, c).astype(np.float32)).to(dev)
            g = torch.from_numpy(rng.randn(b, n1, c).astype(np.float32)).to(dev)
            name = f"{where} {n} stage {s} B={b} {n2} -> {n1} C={c}"
            got = ops.three_interpolation_big(p1, p2, f2, True, None, coarse, fine)
            want = ops.three_interpolation_small(p1, p2, f2, True, coarse, fine)
            for what, x, y in zip(("out", "idx", "w"), got, want):
                _equal(f"{name} forward {what}", x, y)
            idx, w = want[1], want[2]
            _equal(f"{name} forward idx vs the twin", got[1],
                   ops.three_interpolation_weights(p1, p2)[0])
            _close(f"{name} forward vs plain", got[0],
                   ops.three_interpolation_plain(p1, p2, f2))
            order = fine.packed.view(torch.int32)[..., 3]
            rows = coarse.packed.view(torch.int32)[..., 3]
            new_b = ops.three_interpolation_backward_big(g, idx, w, n2, rows)
            _equal(f"{name} VJP, two runs", new_b,
                   ops.three_interpolation_backward_big(g, idx, w, n2, rows))
            err = _close(f"{name} VJP", new_b,
                         ops.three_interpolation_backward_plain(g, idx, w, n2))
            calls = {
                "forward": (lambda: ops.three_interpolation_big(
                    p1, p2, f2, False, None, coarse, fine),
                    lambda: ops.three_interpolation_small(
                        p1, p2, f2, False, coarse, fine)),
                "VJP": (lambda: ops.three_interpolation_backward_big(
                    g, idx, w, n2, rows),
                    lambda: ops.three_interpolation_backward_small(
                        g, idx, w, n2, order))}
            ms = {}
            for kind, (new, other) in calls.items():
                names = dict(zip((new, other), GATE_KERNELS[kind]))
                reads = {fn: ([], []) for fn in (new, other)}
                for fn in (other, new, new, other):
                    reads[fn][0].append(kernel_ms(fn, runs, names[fn])
                                        if device else float("nan"))
                    reads[fn][1].append(cuda_ms(fn, runs))
                ms[kind] = [statistics.median(x) for fn in (new, other)
                            for x in reads[fn]]
            fwd_big = ops.forward_is_big(b, n1, n2, c)
            bwd_big = ops.backward_is_big(b, n1, n2, c)
            counters = (ops.three_interpolation_big, ops.three_interpolation,
                        ops.three_interpolation_backward_big,
                        ops.three_interpolation_backward)
            before = [fn.launches for fn in counters]
            ops.three_interpolation(p1, p2, f2.clone().requires_grad_(),
                                    coarse, fine).backward(g)
            took = [fn.launches - n for fn, n in zip(counters, before)]
            if took != [fwd_big, not fwd_big, bwd_big, not bwd_big]:
                raise AssertionError(f"{name}: the dispatch launched {took}")
            fw, vj = ms["forward"], ms["VJP"]

            def read(dev_ms, wrap_ms):
                return (f"{dev_ms:.4f} ms device ({wrap_ms:.4f} wrapper)"
                        if device else f"{wrap_ms:.4f} ms wrapper")

            print(f"gate {name}: forward lane-a-point {read(*fw[:2])}, listed "
                  f"{read(*fw[2:])}, identical; the dispatch took the "
                  f"{'lane-a-point' if fwd_big else 'listed'} kernel.  VJP per-"
                  f"row lists {read(*vj[:2])}, two runs identical, max abs err "
                  f"{err}; scatter {read(*vj[2:])}; the dispatch took the "
                  f"{'per-row lists' if bwd_big else 'scatter'}  [{tag}]")
            table.append((where, b, n1, n2, c, *fw, *vj))
    return table


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
            fine, coarse = spatial.sort_stages([p1, p2])
            visits = torch.zeros(1, dtype=torch.int64, device=dev)
            out, idx, w = ops.three_interpolation_big(p1, p2, f2, True, visits,
                                                      coarse, fine)
            l_out, l_idx, l_w = ops.three_interpolation_small(p1, p2, f2, True,
                                                              coarse, fine)
            for what, a, b in (("out", out, l_out), ("idx", idx, l_idx),
                               ("w", w, l_w)):
                _equal(f"interpolation {name} {n1} {what}", a, b)
            ms = cuda_ms(lambda: ops.three_interpolation_big(
                p1, p2, f2, False, None, coarse, fine))
            own = cuda_ms(lambda: ops.three_interpolation_big(p1, p2, f2))
            listed = cuda_ms(lambda: ops.three_interpolation_small(
                p1, p2, f2, False, coarse, fine))
            pairs = n1 * -(-n2 // 64)
            print(f"{name} interpolation {n1} -> {n2}, C={c}: lane-a-point "
                  f"{ms:.3f} ms over the layouts ({own:.3f} sorting both clouds "
                  f"itself), listed over the layouts {listed:.3f} ms; the "
                  f"warps scanned {visits.item() / (n1 / 32):.2f} chunks each "
                  f"({100 * (1 - visits.item() * 32 / pairs):.3f} % of the "
                  f"(point, chunk) pairs skipped)  [{tag}]")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--points", type=int, default=155648)
    ap.add_argument("--rungs", action="store_true")
    ap.add_argument("--gates", action="store_true")
    ap.add_argument("--only", action="append", default=None,
                    help="with --gates: read only the clouds of this name")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_big_kernels: no CUDA device")
    tag = card()
    print(tag)
    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(0)
    if args.gates:
        gate_table(dev, rng, tag, clouds=[
            c for c in GATE_CLOUDS if args.only is None or c[0] in args.only])
        return
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
