"""Time the whole-room FPS on one NVIDIA GPU at every stage of the rooms'
buckets, each kernel beside the others.

    python3 -m amcontrast3d_tpu_torch.tools.profile_room_fps
        [--buckets 106496,155648,221184,311296] [--huge] [--runs R]
        [--handover T[,T...]] [--micro] [--gate]

A whole-scene subcloud forward samples its stage clouds with four B == 1
FPS calls, N → N / 4 from the bucket down (311296 → 77824 → 19456 → 4864
→ 1216).  For each bucket, on a room-like cloud (the faces of a 7 x 6 x 3
m room and four solid boxes, one point a voxel: 0.04 m below 221184 points
as S3DIS, 0.02 m from it as ScanNet, with 2 % of the points repeated) and
a uniform one, this prints per stage the median device time (CUDA events,
R runs after a warm-up) of: the dispatch (``furthest_point_sample_b1``),
the chunk-pruned kernel (``csrc/fps_pruned.cu``) with its chunk visits a
pick and its bound, the cluster kernel at the dispatch's cluster size and
at 16 blocks (to 163840 points), and the grid kernel of ``csrc/fps.cu``;
every pick is held against the grid kernel's.  ``--huge`` adds 1.2 M →
4096 (uniform and 64 Gaussian blobs).  The gate ``ops.fps.fps_is_pruned``
is read off this table (``PERF.md`` §6).  Without ``--handover`` and
``--micro`` it reads only what every package has, passing the cluster size
only where the wrapper takes it, so ``profile_ab.sh`` runs it over a
parent's package too.

``--handover T`` also times, at each stage, the kernel of
``tools/fps_handover.cu`` (the chunk-pruned kernel whose late picks run in
one block after the first pick that visits fewer than T chunks, handed
over on the device; not a path of the package): the pick J at which the
one block took over, its time, and the cost of a late pick (J on) against
the chunk-pruned kernel's, each the difference from the chunk-pruned
kernel's run to J picks.  ``--micro`` prints the clock cycles of the
pieces of a pick on one multiprocessor (``tools/fps_micro.cu``).
``--gate`` prints the chunk-pruned kernel's time over the grid kernel's
at N of 221184, 311296 (room-like), 600000 and 1.2 M (uniform), each at
npoint N/4, N/16, N/64, N/256 and 4096: the table ``PRUNED_MIN_SHARE``
is read from.
"""
from __future__ import annotations

import argparse
import inspect
import statistics
import subprocess

import numpy as np
import torch

from amcontrast3d_tpu_torch import ops

AB_BOTH_PACKAGES = True
BUCKETS = (106496, 155648, 221184, 311296)
HUGE_N, HUGE_PICKS = 1200000, 4096
CHUNK = 64
# float instructions: a distance, a running minimum and a compare a point
# (FPS_OPS), a box test (BOX_OPS); the card's float32 rate without FMA
FPS_OPS, BOX_OPS, PEAK_OPS, PEAK_BYTES = 10, 18, 33.5e12, 3.35e12


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


def room_cloud(rng, n: int, voxel: float) -> np.ndarray:
    """(1, n, 3) f32: the faces of a 7 x 6 x 3 m room (1 cm of noise) and
    four solid boxes, one point per ``voxel``, 2 % of the points repeated
    (as bucket padding repeats real points)."""
    pts = rng.rand(4 * n, 3) * [7, 6, 3]
    axis = rng.randint(0, 3, len(pts))
    side = rng.randint(0, 2, len(pts)) * np.array([7, 6, 3])[axis]
    pts[np.arange(len(pts)), axis] = side + 0.01 * rng.randn(len(pts))
    solid = rng.rand(n, 3) * [1.2, 1.0, 0.8] + \
        rng.randint(1, 5, (n, 1)) * [1.2, 1.0, 0.0]
    pts = np.concatenate([pts, solid])
    _, first = np.unique(np.floor(pts / voxel).astype(np.int64), axis=0,
                         return_index=True)
    if len(first) < n:
        raise ValueError(f"room holds {len(first)} voxels, fewer than {n}")
    pts = pts[rng.permutation(first)[:n]]
    pts[rng.randint(0, n, n // 50)] = pts[rng.randint(0, n, n // 50)]
    return pts[None].astype(np.float32)


def bound_ms(n: int, npoint: int, visits: int) -> float:
    """The least time of a chunk-pruned FPS on the card: its bytes (the
    cloud read once, the picks written) or its operations (a box test a
    chunk and pick, a point of each visited chunk), the larger."""
    nops = npoint * -(-n // CHUNK) * BOX_OPS + visits * CHUNK * FPS_OPS
    return max((n * 12 + npoint * 4) / PEAK_BYTES, nops / PEAK_OPS) * 1e3


def _equal(what: str, got, want) -> None:
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"{what}: {int((got != want).sum())} picks differ")


def stage_line(p, npoint: int, runs: int, takes_s: bool,
               handovers: tuple = ()):
    """One stage's kernels side by side, picks held against the grid's:
    (the line, the dispatch's ms); with ``handovers``, the handover
    kernel at each T beside the chunk-pruned kernel."""
    n = p.shape[1]
    fps = ops.fps
    want = fps._fps_b1_grid(p, npoint)
    parts = []

    def timed(name, fn, extra=""):
        _equal(f"{name} {n} -> {npoint}", fn(), want)
        ms = cuda_ms(fn, runs)
        parts.append(f"{name} {ms:.3f} ms = {ms / npoint * 1e3:.3f} us a pick"
                     f"{extra}")
        return ms

    dispatch = timed("dispatch", lambda: ops.furthest_point_sample_b1(p, npoint))
    visits = torch.zeros(1, dtype=torch.int64, device=p.device)
    ops.furthest_point_sample_pruned(p, npoint, visits)
    torch.cuda.synchronize()
    v = visits.item()
    pruned = timed("pruned",
                   lambda: ops.furthest_point_sample_pruned(p, npoint),
                   f" ({v / npoint:.2f} chunk visits a pick, bound "
                   f"{bound_ms(n, npoint, v):.4f} ms)")
    for t in handovers:
        parts.append(handover_part(p, npoint, runs, t, want, pruned))
    if n <= fps.CLUSTER_POINTS:
        s = fps.fps_cluster_size(1, n, fps._cluster_capacity(p.device.index))
        if takes_s:
            timed(f"cluster S={s}", lambda: fps._fps_b1_cluster(p, npoint, s))
            if s != 16:
                timed("cluster S=16", lambda: fps._fps_b1_cluster(p, npoint, 16))
        else:
            timed("cluster S=16", lambda: fps._fps_b1_cluster(p, npoint))
    timed("grid", lambda: fps._fps_b1_grid(p, npoint))
    return "; ".join(parts), dispatch


def handover_part(p, npoint: int, runs: int, t: int, want, pruned: float
                  ) -> str:
    """The handover kernel at T = ``t``: its picks held against ``want``,
    the pick J at which the one block took over, its time, and its late
    picks' cost against the chunk-pruned kernel's (``pruned`` ms), both less
    the chunk-pruned kernel's run to J picks."""
    from amcontrast3d_tpu_torch.tools import fps_handover

    def run():
        return fps_handover.furthest_point_sample_handover(p, npoint, t)

    got, first = run()
    _equal(f"handover T={t} {p.shape[1]} -> {npoint}", got, want)
    j = int(first.item())
    ms = cuda_ms(run, runs)
    text = f"handover T={t} {ms:.3f} ms, one block from pick {j}"
    if j < npoint:
        wide = cuda_ms(lambda: ops.furthest_point_sample_pruned(p, j), runs)
        late = npoint - j
        text += (f", a late pick {(ms - wide) / late * 1e3:.3f} us against "
                 f"the chunk-pruned kernel's {(pruned - wide) / late * 1e3:.3f}")
    return text


GATE_N = (221184, 311296, 600000, 1200000)


def gate_table(dev, rng, runs: int, tag: str) -> None:
    """The chunk-pruned kernel against the grid kernel over (N, npoint),
    picks held equal."""
    for n in GATE_N:
        pts = room_cloud(rng, n, 0.02) if n <= BUCKETS[-1] else \
            (rng.rand(1, n, 3) * [7, 6, 3]).astype(np.float32)
        p = torch.from_numpy(pts).to(dev)
        for npoint in sorted({n // 4, n // 16, n // 64, n // 256, 4096},
                             reverse=True):
            def pruned():
                return ops.furthest_point_sample_pruned(p, npoint)

            def grid():
                return ops.fps._fps_b1_grid(p, npoint)
            _equal(f"gate {n} -> {npoint}", pruned(), grid())
            r = 1 if npoint > 100000 else runs
            pm, gm = cuda_ms(pruned, r), cuda_ms(grid, r)
            print(f"gate {n} -> {npoint} (1/{n / npoint:.0f}): chunk-pruned "
                  f"{pm:.3f} ms, grid {gm:.3f} ms, ratio {pm / gm:.3f}  "
                  f"[{tag}]", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--buckets", default=",".join(map(str, BUCKETS)))
    ap.add_argument("--huge", action="store_true")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--handover", default="",
                    help="comma-separated T: time tools/fps_handover.cu too")
    ap.add_argument("--micro", action="store_true")
    ap.add_argument("--gate", action="store_true")
    args = ap.parse_args()
    handovers = tuple(int(t) for t in args.handover.split(",") if t)
    if not torch.cuda.is_available():
        raise SystemExit("profile_room_fps: no CUDA device")
    tag = card()
    print(tag)
    dev = torch.device("cuda", 0)
    takes_s = "s" in inspect.signature(ops.fps._fps_b1_cluster).parameters
    if args.micro:
        from amcontrast3d_tpu_torch.tools import fps_handover
        for name, cycles in fps_handover.micro(dev).items():
            print(f"micro {name}: {cycles} cycles  [{tag}]")
    rng = np.random.RandomState(0)
    for bucket in (int(b) for b in args.buckets.split(",") if b):
        voxel = 0.04 if bucket < 221184 else 0.02
        for name, pts in (("room", room_cloud(rng, bucket, voxel)),
                          ("uniform", (rng.rand(1, bucket, 3) * [7, 6, 3]
                                       ).astype(np.float32))):
            p = torch.from_numpy(pts).to(dev)
            total = 0.0
            for s in range(4):
                n, npoint = p.shape[1], p.shape[1] // 4
                line, ms = stage_line(p, npoint, args.runs, takes_s,
                                      handovers)
                total += ms
                print(f"{name} {bucket} stage {s} {n} -> {npoint}: {line}  "
                      f"[{tag}]")
                p = ops.gather_points(p, ops.furthest_point_sample_b1(p, npoint)
                                      ).contiguous()
            print(f"{name} {bucket}: the dispatch's four stages {total:.3f} ms "
                  f"a subcloud  [{tag}]")
    if args.gate:
        gate_table(dev, rng, args.runs, tag)
    if args.huge:
        blobs = rng.rand(64, 3) * [7, 6, 3]
        for name, pts in (
                ("uniform", rng.rand(1, HUGE_N, 3) * [7, 6, 3]),
                ("clustered", blobs[rng.randint(0, 64, HUGE_N)][None]
                 + 0.05 * rng.randn(1, HUGE_N, 3))):
            p = torch.from_numpy(pts.astype(np.float32)).to(dev)
            line, _ = stage_line(p, HUGE_PICKS, args.runs, takes_s,
                                 handovers)
            print(f"{name} {HUGE_N} -> {HUGE_PICKS}: {line}  [{tag}]")


if __name__ == "__main__":
    main()
