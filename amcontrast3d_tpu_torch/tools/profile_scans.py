"""Time the exact kNN (kernel 6), the three contrast kernels (the forward
14, the rows VJP 15, the support VJP 16), the ball query (kernel 2), the
CrossMask forward (kernel 18), the approx configuration's threshold
selection (14's selection mode) and label vote (17), and the interpolation
(kernel 3) and its VJP (kernel 9) on one NVIDIA GPU at the train steps'
shapes.

    python3 -m amcontrast3d_tpu_torch.tools.profile_scans [--crossing | --select | --interp] [--runs R]

For the S3DIS step (B = 4 clouds of 24000 points, uniform in [0, 4]³,
stages from FPS) it times the seven kNN calls of a step (the self-kNN of
stages 0-3 at k = 24, the label propagation from stage 0 at k = 4, 16, 64)
and the three contrast kernels at the four stages (C = 64, 128, 256, 512;
the forward also at C = 1, as the ground-truth ambiguity calls it), the
eight ball queries of a forward (per stage the set abstraction's, support
s − 1 and queries s at r = 0.1·2^(s−1), and the blocks' shared one on s at
twice that; k = 32) and the CrossMask forward at the four decoder stages
(k = 12, MIN), the selection at the four decoder stages (k = 24) and the
vote from stage 0 at stages 1-3 (k = 4, 16, 64, 13 classes); for the
ScanNet step (B = 2 × 64000 on a denser cube, r from 0.05) the self-kNN of
stages 1-3, the contrast kernels at the four stages, the eight ball
queries, the selection and the vote.  Each call prints
two times: the wrapper's, the median of R runs after a warm-up (CUDA events
around the call, so the host's launches and the wrapper's own work, a sort
or the sorted columns, count where the card waits on them), and the
kernel's own device time from ``torch.profiler`` over R runs.  Where the
package's wrapper takes a stage's sorted layout (``cloud=``), the five
stage layouts are made ahead by one sort, as the encoder makes them once a
forward, and the sort is timed on its own; a package that still has the
large-cloud kNN (kernel 7, ``knn_big``) times it beside kernel 6 on the
same inputs.
``--crossing`` times the kNN on the shapes where the JAX package's gate
``_BIG_N`` = 32768 would choose between the two kernels: the self-kNN
(k = 24, B = 2) at N = 16000, 24000, 32768 and 64000, the ScanNet step's
three label propagations from its 64000-point stage 0 (B = 2, queries the
FPS stages of 16000, 4000 and 1000 points, k = 4, 16, 64), and the
whole-scene boundary kNN (self, k = 24, B = 1) on room-like clouds of
155648, 221184 and 311296 points; the package's own dispatch, and each of
kernels 6 and 7 where the package has both.  It also times the ball query
(kernel device time) at the eight (M, N, r) of each step and at the three
pairs of a 155648-point room whose support passes that gate (38912 ×
155648 at r = 0.1, 38912 × 38912 and 9728 × 38912 at r = 0.2): the
package's dispatch, and its scan-everything kernel (``ball_query_small``)
and chunk-skipping one (``ball_query_big``) each where it has them; and
the selection and the vote (kernel device time) at the S3DIS step's stages
(24000, 6000, 1500, 375 points a cloud) and the ScanNet step's (2 × 64000
and its stages), over the stage layouts where the package's wrappers take
them: run over a parent's package by ``profile_ab.sh``, its dense kernels.
``--select`` times only those lines of the selection and the vote (the
wrapper and the kernel), at the same two steps' shapes.  ``--interp``
times only the interpolation and its VJP at the four decoder stages of
both steps (coarse C = 128, 256, 512, 1024): the forward over the two stage
layouts where the package's wrapper takes them, the VJP (the dispatch's
kernel: ScanNet's fp0 goes to the support-owned kernel 10) in the fine
layout's order where the wrapper takes one, and kernel 9 itself at every
stage in the caller's order and, where it takes one, in the layout's.

The script reads only what every version of the package has (``ops.knn``,
``ops.contrast_forward``, ``ops.contrast_grad_rows``,
``ops.contrast_grad_support``, ``ops.ball_query``, ``ops.refine_cross``,
``ops.contrast_select``, ``ops.label_vote``, and passes a layout only to a
wrapper whose signature takes it), so
``tools/profile_ab.sh`` runs it from the change's tree over the parent's
package too.
"""
from __future__ import annotations

import argparse
import inspect
import statistics
import subprocess

import numpy as np
import torch

from amcontrast3d_tpu_torch import ops
from amcontrast3d_tpu_torch.ops import spatial

KNN_K = 24
KNN_KERNELS = ("knn_kernel", "knn_big_kernel")   # the kNN kernels' names
UP_CHANNELS = (64, 128, 256, 512)
# profile_ab.sh runs this file from the change's tree over both packages
AB_BOTH_PACKAGES = True
# the contrast kernels: (label, wrapper, its kernel's name, takes g4)
CONTRAST = (("forward (14)", "contrast_forward", "contrast_fwd_kernel", False),
            ("rows VJP (15)", "contrast_grad_rows", "contrast_grad_rows_kernel", True),
            ("support VJP (16)", "contrast_grad_support",
             "contrast_grad_support_kernel", True))
CROSSING_N = (16000, 24000, 32768, 64000)
ROOM_N = (155648, 221184, 311296)
BALL_K, REFINE_K = 32, 12
# the ball-query kernels' names: the listed one, and the parent's two
BALL_KERNELS = ("ball_query_kernel", "ball_query_big_kernel")
# the selection's and the vote's kernels (listed or, in a parent, dense)
SELECT_KERNEL, VOTE_KERNEL, VOTE_CLASSES = "contrast_select_kernel", "label_vote_kernel", 13
# the interpolation's kernels: the forward (3), its VJP (9), the
# support-owned VJP (10); the coarse widths of fp0 ... fp3
INTERP_KERNEL, INTERP_BWD_KERNEL, INTERP_BWD_BIG_KERNEL = \
    "interp_kernel", "interp_bwd_kernel", "interp_bwd_big_kernel"
INTERP_CHANNELS = (128, 256, 512, 1024)


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


def kernel_ms(fn, runs: int, names, tries: int = 3) -> float:
    """Device ms a run of the kernels whose names hold one of ``names``.  A
    trace that holds none of them (the profiler drops a window's events
    now and then) is taken again, ``tries`` times in all; NaN if every
    trace missed them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        total, seen = 0.0, False
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", None)
            if us is None:   # the attribute's name before PyTorch 2.4
                us = e.self_cuda_time_total
            if e.device_type == DeviceType.CUDA and any(x in e.key for x in names):
                total, seen = total + us, seen or e.count > 0
        if seen and total > 0:
            return total / 1e3 / runs
    return float("nan")


def takes(wrapper, name: str) -> bool:
    """Whether ``wrapper`` takes the keyword ``name`` in this package."""
    return name in inspect.signature(wrapper).parameters


def stages_of(rng, dev, b: int, n: int, side: float, count: int = 4) -> list:
    p = torch.from_numpy((rng.rand(b, n, 3) * side).astype(np.float32)).to(dev)
    return fps_stages(p, count)


def fps_stages(p, count: int) -> list:
    """``p`` and the ``count`` − 1 clouds after it, each a quarter of the
    one before by FPS."""
    stages = [p]
    for _ in range(count - 1):
        prev = stages[-1]
        idx = ops.furthest_point_sample(prev, prev.shape[1] // 4)
        stages.append(ops.gather_points(prev, idx).contiguous())
    return stages


def room_cloud(rng, n: int, voxel: float = 0.02) -> torch.Tensor:
    """(1, n, 3) room-like cloud: the six faces of a 7 x 6 x 3 m room (1 cm
    of noise) and four solid boxes, one point per ``voxel``."""
    pts = rng.rand(4 * n, 3) * [7, 6, 3]
    axis = rng.randint(0, 3, len(pts))
    side = rng.randint(0, 2, len(pts)) * np.array([7, 6, 3])[axis]
    pts[np.arange(len(pts)), axis] = side + 0.01 * rng.randn(len(pts))
    solid = rng.rand(n, 3) * [1.2, 1.0, 0.8] + \
        rng.randint(1, 5, (n, 1)) * [1.2, 1.0, 0.0]
    pts = np.concatenate([pts, solid])
    _, first = np.unique(np.floor(pts / voxel).astype(np.int64), axis=0,
                         return_index=True)
    return torch.from_numpy(pts[rng.permutation(first)[:n]][None]
                            .astype(np.float32))


def crossing_line(name: str, sup, q, k: int, runs: int, layouts_on: bool) -> None:
    """The kNN on one call's inputs (over one layout of ``sup`` where the
    package takes one): kernel device time of its dispatch, and of kernels
    6 and 7 each where the package has both."""
    args = (sup, q, k) + ((spatial.sort_support(sup),) if layouts_on else ())
    times = [f"kNN {kernel_ms(lambda: ops.knn(*args), runs, KNN_KERNELS):.4f} ms"]
    for label, fn, names in (("kernel 6", "knn_small", ("knn_kernel",)),
                             ("kernel 7", "knn_big", ("knn_big_kernel",))):
        if hasattr(ops, fn):
            ms = kernel_ms(lambda: getattr(ops, fn)(*args), runs, names)
            times.append(f"{label} {ms:.4f} ms")
    print(f"{name} B={sup.shape[0]} M={q.shape[1]} N={sup.shape[1]} k={k}, "
          f"kernel device time: {', '.join(times)}")


def ball_args(sup, q, r, layouts):
    """The ball query's arguments: the support's and the queries' layouts
    where this package takes them (``layouts``: the pair, or None)."""
    kwargs = {}
    if layouts is not None and takes(ops.ball_query, "cloud"):
        kwargs["cloud"] = layouts[0]
        if takes(ops.ball_query, "query_cloud"):
            kwargs["query_cloud"] = layouts[1]
    return (sup, q, r, BALL_K), kwargs


def ball_line(sup, q, r, runs: int, layouts, crossing: bool = False) -> float:
    """Prints one ball query's times (with ``crossing``, the kernel device
    time of each ball-query kernel the package has, on the same inputs);
    returns the dispatch's kernel time."""
    args, kwargs = ball_args(sup, q, r, layouts)

    def call():
        return ops.ball_query(*args, **kwargs)
    ms = kernel_ms(call, runs, BALL_KERNELS)
    line = f"wrapper {cuda_ms(call, runs):.4f} ms, kernel {ms:.4f}"
    if crossing:
        line = f"kernel device time: ball query {ms:.4f} ms"
        for label, fn, names in (
                ("scan-everything kernel", "ball_query_small", ("ball_query_kernel",)),
                ("chunk-skipping kernel", "ball_query_big", ("ball_query_big_kernel",))):
            if hasattr(ops, fn):
                t = kernel_ms(lambda: getattr(ops, fn)(*args), runs, names)
                line += f", {label} {t:.4f} ms"
    print(f"  ball query B={sup.shape[0]} M={q.shape[1]} N={sup.shape[1]} "
          f"r={r} k={BALL_K}: {line}")
    return ms


def ball_calls(radius: float):
    """(support stage, query stage, r) of the eight ball queries of a
    forward over five stage clouds."""
    calls = []
    for s in range(1, 5):
        r = radius * 2 ** (s - 1)
        calls.append((s - 1, s, r))
        calls.append((s, s, 2 * r))
    return calls


def balls(stages, layouts, radius: float, runs: int, crossing: bool) -> float:
    total = 0.0
    for si, qi, r in ball_calls(radius):
        pair = None if layouts[si] is None else (layouts[si], layouts[qi])
        total += ball_line(stages[si], stages[qi], r, runs, pair, crossing)
    return total


def refine_line(rng, ps, c: int, runs: int, layout) -> float:
    """Prints the CrossMask forward's times on one decoder stage (MIN, a
    continuous ambiguity, the selection kept as a train step keeps it);
    returns its kernel time."""
    b, n, _ = ps.shape
    f = torch.from_numpy(rng.randn(b, n, c).astype(np.float32)).to(ps.device)
    a = torch.from_numpy(rng.rand(b, n).astype(np.float32)).to(ps.device)
    kwargs = {"cloud": layout} if layout is not None and \
        takes(ops.refine_cross, "cloud") else {}

    def call():
        return ops.refine_cross(ps, f, a, REFINE_K, "MIN", keep=True, **kwargs)
    ms = kernel_ms(call, runs, ("refine_cross_kernel",))
    print(f"  CrossMask forward B={b} N={n} C={c} k={REFINE_K}"
          f"{' over the layout' if kwargs else ''}: wrapper "
          f"{cuda_ms(call, runs):.4f} ms, kernel {ms:.4f}")
    return ms


def knn_line(sup, q, k, runs: int, layout) -> float:
    """Prints one kNN call's times; returns its kernel time."""
    args = (sup, q, k) + (() if layout is None else (layout,))

    def call():
        return ops.knn(*args)
    extra = ""
    if hasattr(ops, "knn_big"):
        def big():
            return ops.knn_big(*args)
        extra = (f"; kernel 7 (knn_big) {cuda_ms(big, runs):.4f} ms, kernel "
                 f"{kernel_ms(big, runs, ('knn_big_kernel',)):.4f}")
    ms = kernel_ms(call, runs, KNN_KERNELS)
    print(f"  knn B={sup.shape[0]} M={q.shape[1]} N={sup.shape[1]} k={k}: "
          f"wrapper {cuda_ms(call, runs):.4f} ms, kernel {ms:.4f}{extra}")
    return ms


def contrast_lines(rng, ps, c: int, runs: int, layout, kernels=CONTRAST) -> list:
    """Prints the contrast kernels' times on one stage; returns their kernel
    times in the order of ``kernels``."""
    b, n, _ = ps.shape
    dev = ps.device
    f = torch.nn.functional.normalize(torch.from_numpy(
        rng.randn(b, n, c).astype(np.float32)).to(dev), dim=-1)
    lab = torch.from_numpy(rng.randint(0, 13, (b, n)).astype(np.float32)).to(dev)
    kth = (ops.knn(ps, ps, KNN_K)[1][..., -1] * (1.0 + 1e-5)).contiguous()
    g4 = torch.from_numpy(rng.randn(b, n, 4).astype(np.float32)).to(dev)
    times = []
    for label, name, kernel, grad in kernels:
        wrapper = getattr(ops, name)
        args = (ps, f, lab, kth) + ((g4, 1 / 0.3, False) if grad
                                    else (1 / 0.3, False, False, True))
        kwargs = {}
        if layout is not None and takes(wrapper, "cloud"):
            kwargs["cloud"] = layout

        def call():
            return wrapper(*args, **kwargs)
        ms = kernel_ms(call, runs, (kernel,))
        times.append(ms)
        print(f"  contrast {label} B={b} N={n} C={c}"
              f"{' over the layout' if kwargs else ''}: wrapper "
              f"{cuda_ms(call, runs):.4f} ms, kernel {ms:.4f}")
    return times


def selection_lines(rng, stages, layouts, runs: int, wrapper_too: bool = True):
    """Prints the selection's times at the four decoder stages (k = 24)
    and the vote's from stage 0 at stages 1-3 (k = 4^s), over the stage
    layouts where this package's wrappers take them; returns their summed
    kernel times."""
    dev = stages[0].device
    b, n = stages[0].shape[:2]
    lab = torch.from_numpy(rng.randint(0, VOTE_CLASSES, (b, n)).astype(np.int32)).to(dev)
    sel_kw = takes(ops.contrast_select, "cloud")
    vote_kw = takes(ops.label_vote, "query_cloud")
    totals = [0.0, 0.0]
    for s, p in enumerate(stages[:4]):
        calls = [("selection (14)", SELECT_KERNEL, 0, f"N={p.shape[1]} k={KNN_K}",
                  lambda: ops.contrast_select(
                      p, KNN_K, **({"cloud": layouts[s]} if sel_kw and layouts[s] is not None
                                   else {})))]
        if s > 0:
            kw = ({"cloud": layouts[0], "query_cloud": layouts[s]}
                  if vote_kw and layouts[s] is not None else {})
            calls.append(("vote (17)", VOTE_KERNEL, 1,
                          f"M={p.shape[1]} N={n} k={4 ** s}",
                          lambda: ops.label_vote(stages[0], lab, p, 4 ** s,
                                                 VOTE_CLASSES, **kw)))
        for label, kernel, slot, shape, call in calls:
            ms = kernel_ms(call, runs, (kernel,))
            totals[slot] += ms
            line = f"wrapper {cuda_ms(call, runs):.4f} ms, kernel {ms:.4f}" \
                if wrapper_too else f"kernel device time {ms:.4f} ms"
            print(f"  {label} B={b} {shape}: {line}")
    print(f"  selection (14) summed over the four stages (kernel device time): "
          f"{totals[0]:.4f} ms; vote (17) summed over stages 1-3: {totals[1]:.4f} ms")
    return totals


def interp_lines(rng, stages, layouts, runs: int) -> None:
    """Prints the interpolation's times at the four decoder stages (stage s
    onto s − 1) over the two stage layouts where this package's wrapper
    takes them, and its VJP's: the dispatch in the fine layout's order
    where the wrapper takes one, and kernel 9 in the caller's order (and in
    the layout's); then the kernel times summed over the stages."""
    dev = stages[0].device
    b = stages[0].shape[0]
    fwd_kw = takes(ops.three_interpolation, "cloud")
    bwd_kw = takes(ops.three_interpolation_backward, "order")
    totals = [0.0, 0.0, 0.0]
    for s, c in zip(range(1, 5), INTERP_CHANNELS):
        p1, p2 = stages[s - 1], stages[s]
        n1, n2 = p1.shape[1], p2.shape[1]
        f2 = torch.from_numpy(rng.randn(b, n2, c).astype(np.float32)).to(dev)
        g = torch.from_numpy(rng.randn(b, n1, c).astype(np.float32)).to(dev)
        kw = ({"cloud": layouts[s], "query_cloud": layouts[s - 1]}
              if fwd_kw and layouts[s] is not None else {})
        _, idx, w = ops.three_interpolation_small(p1, p2, f2, True, **kw)
        order = ({"order": layouts[s - 1].packed.view(torch.int32)[..., 3]}
                 if bwd_kw and layouts[s - 1] is not None else {})

        def fwd():
            return ops.three_interpolation(p1, p2, f2, **kw)

        def bwd():
            return ops.three_interpolation_backward(g, idx, w, n2, **order)

        ms = kernel_ms(fwd, runs, (INTERP_KERNEL,))
        ms_b = kernel_ms(bwd, runs, (INTERP_BWD_KERNEL, INTERP_BWD_BIG_KERNEL))
        scatter = {"caller's order": kernel_ms(
            lambda: ops.three_interpolation_backward_small(g, idx, w, n2),
            runs, (INTERP_BWD_KERNEL,))}
        if order:
            scatter["layout order"] = kernel_ms(
                lambda: ops.three_interpolation_backward_small(g, idx, w, n2,
                                                               **order),
                runs, (INTERP_BWD_KERNEL,))
        totals[0] += ms
        totals[1] += ms_b
        totals[2] += list(scatter.values())[-1]
        print(f"  interpolation (3) B={b} {n2} -> {n1} C={c}"
              f"{' over the layouts' if kw else ''}: wrapper "
              f"{cuda_ms(fwd, runs):.4f} ms, kernel {ms:.4f}; VJP "
              f"{'(10) ' if ops.interpolate.backward_is_big(n1, c) else '(9) '}"
              f"{'in the layout order ' if order else ''}wrapper "
              f"{cuda_ms(bwd, runs):.4f} ms, kernel {ms_b:.4f}; kernel 9 "
              + ", ".join(f"in the {k} {v:.4f}" for k, v in scatter.items()))
    print(f"  interpolation (3) summed over the four stages (kernel device "
          f"time): {totals[0]:.4f} ms; its VJP as dispatched {totals[1]:.4f} ms; "
          f"kernel 9 at every stage in the step's order {totals[2]:.4f} ms")


def interp_steps(rng, dev, runs: int, layouts_on: bool) -> None:
    """The interpolation and its VJP at the S3DIS and the ScanNet step's
    stages (:func:`interp_lines`)."""
    for name, b, n in (("S3DIS", 4, 24000), ("ScanNet", 2, 64000)):
        forward = stages_of(rng, dev, b, n, 4.0, 5)
        layouts = spatial.sort_stages(forward) if layouts_on else [None] * 5
        print(f"{name} step's interpolation and its VJP:")
        interp_lines(rng, forward, layouts, runs)


def selection_steps(rng, dev, runs: int, layouts_on: bool,
                    wrapper_too: bool = True) -> None:
    """The selection and the vote at the S3DIS and the ScanNet step's
    stages (:func:`selection_lines`)."""
    for name, b, n in (("S3DIS", 4, 24000), ("ScanNet", 2, 64000)):
        forward = stages_of(rng, dev, b, n, 4.0, 5)
        layouts = spatial.sort_stages(forward) if layouts_on else [None] * 5
        print(f"{name} step's selection and vote:")
        selection_lines(rng, forward, layouts, runs, wrapper_too)


def step(rng, dev, name: str, b: int, n: int, side: float, runs: int,
         knn_calls, layouts_on: bool, radius: float, refine: bool) -> None:
    forward = stages_of(rng, dev, b, n, side, 5)
    stages = forward[:4]
    layouts = spatial.sort_stages(forward) if layouts_on else [None] * 5
    print(f"{name} (B={b}, N={n}):")
    if layouts_on:
        sort_ms = cuda_ms(lambda: spatial.sort_stages(forward), runs)
        print(f"  the five stage layouts by one sort: {sort_ms:.4f} ms")
    total = balls(forward, layouts, radius, runs, False)
    print(f"  ball queries summed (kernel device time): {total:.4f} ms")
    if refine:
        total = sum(refine_line(rng, p, UP_CHANNELS[s], runs, layouts[s])
                    for s, p in enumerate(stages))
        print(f"  CrossMask forward summed over the four stages (kernel "
              f"device time): {total:.4f} ms")
    total = 0.0
    for si, qi, k in knn_calls:
        total += knn_line(stages[si], stages[qi], k, runs, layouts[si])
    print(f"  kNN calls summed (kernel device time): {total:.4f} ms")
    totals = np.zeros(len(CONTRAST))
    for s, p in enumerate(stages):
        totals += contrast_lines(rng, p, UP_CHANNELS[s], runs, layouts[s])
    for (label, *_), total in zip(CONTRAST, totals):
        print(f"  contrast {label} summed over the four stages (kernel device "
              f"time): {total:.4f} ms")
    # one channel, as the ground-truth ambiguity calls the forward
    total = sum(contrast_lines(rng, p, 1, runs, layout, CONTRAST[:1])[0]
                for p, layout in zip(stages, layouts))
    print(f"  contrast forward (14) at C=1 summed over the four stages (kernel "
          f"device time): {total:.4f} ms")
    selection_lines(rng, forward, layouts, runs)
    interp_lines(rng, forward, layouts, runs)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--crossing", action="store_true",
                    help="the kNN and the ball query on both sides of the "
                         "JAX package's 32768-point gate")
    ap.add_argument("--select", action="store_true",
                    help="only the selection (14) and the vote (17)")
    ap.add_argument("--interp", action="store_true",
                    help="only the interpolation (3) and its VJP (9, 10)")
    ap.add_argument("--runs", type=int, default=11)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_scans needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    layouts_on = takes(ops.knn, "cloud")   # this package's kernels read layouts
    print(f"{card()}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"stage layouts made ahead: {layouts_on}")
    rng = np.random.RandomState(0)
    if args.crossing:
        for n in CROSSING_N:
            p = torch.from_numpy((rng.rand(2, n, 3) * 4).astype(np.float32)).to(dev)
            crossing_line("self-kNN", p, p, KNN_K, args.runs, layouts_on)
        stages = stages_of(rng, dev, 2, 64000, 4.0)
        for s in range(1, 4):
            crossing_line(f"ScanNet label call {s}", stages[0], stages[s],
                          4 ** s, args.runs, layouts_on)
        for n in ROOM_N:
            p = room_cloud(rng, n).to(dev)
            crossing_line("room self-kNN", p, p, KNN_K, args.runs, layouts_on)
        for name, b, n, radius in (("S3DIS", 4, 24000, 0.1),
                                   ("ScanNet", 2, 64000, 0.05)):
            forward = stages_of(rng, dev, b, n, 4.0, 5)
            layouts = spatial.sort_stages(forward) if layouts_on else [None] * 5
            print(f"{name} step's ball queries:")
            total = balls(forward, layouts, radius, args.runs, True)
            print(f"  summed (the dispatch's kernel device time): {total:.4f} ms")
        room = fps_stages(room_cloud(rng, ROOM_N[0], 0.04).to(dev), 3)
        layouts = spatial.sort_stages(room) if layouts_on else [None] * 3
        print(f"a room's ball queries above the gate ({ROOM_N[0]} points):")
        for si, qi, r in ((0, 1, 0.1), (1, 1, 0.2), (1, 2, 0.2)):
            pair = None if layouts[si] is None else (layouts[si], layouts[qi])
            ball_line(room[si], room[qi], r, args.runs, pair, True)
        selection_steps(rng, dev, args.runs, layouts_on, wrapper_too=False)
        return
    if args.select:
        selection_steps(rng, dev, args.runs, layouts_on)
        return
    if args.interp:
        interp_steps(rng, dev, args.runs, layouts_on)
        return
    s3dis = [(s, s, KNN_K) for s in range(4)] + [(0, s, 4 ** s) for s in range(1, 4)]
    step(rng, dev, "S3DIS step", 4, 24000, 4.0, args.runs, s3dis, layouts_on,
         0.1, True)
    # ScanNet: the self-kNN of stages 1-3 (stage 0's is not in the loss)
    step(rng, dev, "ScanNet step", 2, 64000, 4.0, args.runs,
         [(s, s, KNN_K) for s in range(1, 4)], layouts_on, 0.05, False)


if __name__ == "__main__":
    main()
