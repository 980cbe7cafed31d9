"""Where the time of the train step goes, on one CUDA device.

    python3 -m amcontrast3d_tpu_torch.tools.profile_train [--kind aa|mm]
        [--cfg cfgs/scannet/AMContrast3D-AA.yaml [--batch B]] [--loader]
        [--batches K]

Builds ``BaseSeg_AMContrast3D`` from ``cfgs/s3dis/AMContrast3D-AA.yaml``
with ``CrossEntropyAce`` or, with ``--kind mm``,
``BaseSeg_M_AMContrast3D`` from ``cfgs/s3dis/AMContrast3D-MM.yaml`` with
``CrossEntropyAcePre`` (PointNeXt-XL, random weights from a seeded
generator), the recipe's AdamW, cosine schedule and clip 10, fp32 with TF32
off, and runs ``make_train_step`` at B=4×24000 (uniform positions in
[0, 4]³, labels from a Voronoi partition into 13 regions; with
``--batches K`` the steps take K such batches in turn, as training takes a
new one each step, where the data-dependent work varies).  With ``--cfg``
it takes another recipe instead, and the batch from it: ``batch_size`` (or
``--batch``) crops of ``dataset.train.voxel_max`` points of Synthetic rooms
through the recipe's train transforms and the loader, so the geometry is a
room's (the ScanNet recipe: 2 × 64000 points at 0.02 m, 7 input channels,
20 classes).  It prints, each block tagged with the card's name and power
limit:

1. wall ms per train step (``torch.cuda.synchronize()`` on both sides):
   median and quartiles of 10 steps after 2 warm-up steps, train points/s
   and the peak device memory;
2. one step with every kernel replaced by its plain PyTorch twin;
3. device ms per step of each phase, from CUDA events on the stream over
   3 steps: forward, loss, backward, optimizer (the clip and the
   confusion matrix fall between them); and,
   inside the loss, the exact kNN kernel (the contrast thresholds and the
   stage-label propagation) and the contrast reductions; the
   interpolation VJP of kernel 10 inside the backward where the dispatch
   takes it (the per-row lists at fp0 and fp1 of both recipes; a parent's
   support-owned kernel at ScanNet's fp0); for ``mm`` also the CrossMask
   kernel inside the forward and
   its VJP inside the backward;
4. device ms per step of every CUDA kernel from ``torch.profiler`` over
   3 steps, their sum, and the card's idle share of the profiled wall
   time (the profiler's host work inflates it) and of the unprofiled
   median of block 1;
5. where the card idles, from one more trace of 3 steps (``idle_gaps``):
   every gap between two activities on the card's timeline, each put
   down to the launch of the activity after it.  A launch issued after the
   card fell idle means the host set the pace; the gap goes to the phase
   that launched it (forward, loss, backward, optimizer, each a
   ``record_function`` range, or none: the clip and the confusion matrix)
   and to the innermost operator around the launch.  It prints the idle ms
   a step, the host-paced share, each phase's and the top operators'
   idle ms, and the largest gaps.

With ``--loader`` it times the host side instead: one epoch of the recipe's
``NumpyLoader`` on Synthetic rooms (the recipe's workers and transforms)
alone, host seconds a batch, and then the same epoch with a train step on
each batch: seconds a step, and the seconds the loop waited on the loader.

Without a CUDA device it exits non-zero before measuring anything.
"""
from __future__ import annotations

import argparse
import bisect
import functools
import itertools
import json
import os
import statistics
import tempfile
from contextlib import ExitStack
from unittest import mock

import numpy as np
import torch

import time

from amcontrast3d_tpu_torch.tools.profile_eval import (
    CFGS, Phases, card, kernel_table, plain_ops, step_ms)

B, N, IN_CH, NUM_CLASSES = 4, 24000, 4, 13
SEED = 0
WARMUP, TIMED, PLAIN, PROFILED = 2, 10, 1, 3
STEPS_PER_EPOCH = 1000
# profile_ab.sh runs this file from the change's tree over both packages:
# it reads only what every version of the package has
AB_BOTH_PACKAGES = True
# activities on the card's timeline, and the host calls that launch them
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
NO_PHASE = "none (clip, metrics)"


def voronoi_labels(rng, pos: np.ndarray) -> np.ndarray:
    """(B, N) label of the nearest of 13 random centres in [0, 4]³: regions
    with interior and boundary points, as the rooms of a scene."""
    centres = rng.rand(pos.shape[0], NUM_CLASSES, 3) * 4
    return ((pos[:, :, None] - centres[:, None]) ** 2).sum(-1).argmin(-1)


def synthetic_batch(rng, dev) -> dict:
    """B clouds of N points uniform in [0, 4]³ with random features and
    Voronoi labels, on ``dev``."""
    pos = rng.rand(B, N, 3).astype(np.float32) * 4
    batch = {"pos": torch.from_numpy(pos),
             "x": torch.from_numpy(rng.rand(B, N, IN_CH).astype(np.float32)),
             "y": torch.from_numpy(voronoi_labels(rng, pos))}
    return {k: v.to(dev) for k, v in batch.items()}


# Synthetic rooms large enough that a crop holds the recipe's voxel_max
# points: raw points a room per voxel size (0.04 m: ~58000 voxels of 100000
# points; 0.02 m: ~190000 of 250000)
ROOM_POINTS = {0.04: 100000, 0.02: 250000}
LOADER_ROOMS, LOADER_LOOP = 4, 6


def synthetic_overrides(cfg, batch: int) -> None:
    """Point the recipe's dataset at Synthetic rooms that fill its crop."""
    common = cfg.dataset.common
    common.NAME = "Synthetic"
    common.num_rooms = LOADER_ROOMS
    common.n_points = ROOM_POINTS[common.voxel_size]
    common.num_classes = cfg.num_classes
    cfg.dataset.train.loop = LOADER_LOOP
    cfg.batch_size = batch


def loader_batches(cfg, dev):
    """The recipe's train loader and ``put(data)``, which turns one of its
    host batches into the step's device batch."""
    from amcontrast3d_tpu_torch.data import build_dataloader_from_cfg
    from amcontrast3d_tpu_torch.engine.runner import _prep_batch
    loader = build_dataloader_from_cfg(
        cfg.batch_size, cfg.dataset, cfg.get("dataloader"),
        cfg.get("datatransforms"), split="train", seed=SEED)

    def put(data):
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                for k, v in _prep_batch(data, cfg).items()}
    return loader, put


def time_loader(cfg, step, dev, tag: str) -> None:
    """An epoch of the loader alone, then with a train step a batch."""
    loader, put = loader_batches(cfg, dev)
    try:
        loader.set_epoch(1)
        t = time.perf_counter()
        n = sum(1 for _ in loader)
        alone = time.perf_counter() - t
        print(f"loader alone: {n} batches of {cfg.batch_size} x "
              f"{cfg.dataset.train.voxel_max} in {alone:.3f} s = "
              f"{alone / n:.3f} host s a batch ({loader.num_workers} workers, "
              f"first batch included)  [{tag}]")
        loader.set_epoch(2)
        waited, steps = 0.0, 0
        torch.cuda.synchronize()
        t0 = t = time.perf_counter()
        for data in loader:
            waited += time.perf_counter() - t
            step(put(data))
            steps += 1
            t = time.perf_counter()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        points = steps * cfg.batch_size * cfg.dataset.train.voxel_max
        print(f"loader + train step: {steps} steps in {wall:.3f} s = "
              f"{wall / steps:.3f} s a step = {points / wall:.1f} train "
              f"points/s through the loader; the loop waited {waited:.3f} s "
              f"on the loader ({waited / wall:.1%})  [{tag}]")
    finally:
        loader.close()


def annotated(name: str, fn):
    """``fn`` inside a ``record_function`` range ``name``, which the trace
    of :func:`idle_gaps` reads (a few microseconds a call otherwise)."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return run


def _innermost(ops, starts, t: float) -> str:
    """The name of the latest-starting op of ``ops`` (sorted by start)
    running at ``t``: on one thread, the innermost."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - 5000), -1):
        if ops[j]["ts"] + ops[j].get("dur", 0) >= t:
            return ops[j]["name"]
    return "no operator"


def gap_table(events, phases) -> dict:
    """The card's idle gaps in a chrome trace's complete events (µs): the
    idle time, the host-paced part of it (the activity after the gap was
    launched after the card fell idle), that part by phase (the
    ``record_function`` range among ``phases`` around the launch) and by
    the innermost operator around the launch on its thread, as (µs,
    gaps), the host-paced gaps as (µs, phase, operator, activity), and the
    timeline's span."""
    device = sorted((e for e in events if e.get("cat") in DEVICE_CATS),
                    key=lambda e: e["ts"])
    launch = {e["args"]["correlation"]: e for e in events
              if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    by_tid = {}
    for e in events:
        if e.get("cat") == "cpu_op":
            by_tid.setdefault(e["tid"], []).append(e)
    for ops in by_tid.values():
        ops.sort(key=lambda e: e["ts"])
    starts = {tid: [e["ts"] for e in ops] for tid, ops in by_tid.items()}
    spans = [(e["ts"], e["ts"] + e.get("dur", 0), e["name"]) for e in events
             if e.get("cat") in ("user_annotation", "cpu_op") and e["name"] in phases]
    out = {"idle": 0.0, "paced": 0.0, "phase": {}, "op": {}, "gaps": [], "span": 0.0}
    if not device:
        return out
    first, end = device[0]["ts"], device[0]["ts"] + device[0].get("dur", 0)
    for e in device[1:]:
        gap, idle_from = e["ts"] - end, end
        end = max(end, e["ts"] + e.get("dur", 0))
        if gap <= 0:
            continue
        out["idle"] += gap
        call = launch.get(e.get("args", {}).get("correlation"))
        if call is None or call["ts"] + call.get("dur", 0) < idle_from:
            continue   # launched before the card fell idle: not the host's
        out["paced"] += gap
        at, tid = call["ts"], call["tid"]
        phase = next((name for a, b, name in spans if a <= at <= b), NO_PHASE)
        op = _innermost(by_tid.get(tid, []), starts.get(tid, []), at)
        for table, key in ((out["phase"], phase), (out["op"], op)):
            us, count = table.get(key, (0.0, 0))
            table[key] = (us + gap, count + 1)
        out["gaps"].append((gap, phase, op, e["name"]))
    out["span"] = end - first
    return out


def idle_gaps(step, batch, n: int, phases, tag: str, top: int = 12) -> None:
    """Prints where the card idles over ``n`` traced steps (section 5 of the
    module's doc); ``phases`` names the ``record_function`` ranges."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            step(batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3 / n
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    finally:
        os.remove(path)
    g = gap_table(events, phases)
    print(f"idle gaps over {n} traced steps (wall {wall:.3f} ms a step; the "
          f"card's timeline {g['span'] / 1e3 / n:.3f} ms a step): idle "
          f"{g['idle'] / 1e3 / n:.3f} ms a step, {g['paced'] / 1e3 / n:.3f} of "
          f"it host-paced (launched after the card fell idle)  [{tag}]")
    for key, title in (("phase", "phase"), ("op", "operator around the launch")):
        print(f"  host-paced idle by {title}, ms a step (gaps a step):")
        for key, (us, count) in sorted(g[key].items(), key=lambda kv: -kv[1][0])[:top]:
            print(f"    {us / 1e3 / n:9.3f} ms  ({count / n:7.1f})  {key[:100]}")
    print("  largest host-paced gaps, ms (phase; operator; the activity after):")
    for gap, phase, op, name in sorted(g["gaps"], reverse=True)[:top]:
        print(f"    {gap / 1e3:9.3f} ms  {phase}; {op[:60]}; {name[:60]}")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--kind", choices=sorted(CFGS), default="aa")
    parser.add_argument("--cfg", default=None,
                        help="a recipe; the batch comes from it")
    parser.add_argument("--batch", type=int, default=None,
                        help="clouds a batch (default: the cfg's batch_size)")
    parser.add_argument("--batches", type=int, default=1,
                        help="synthetic batches the steps take in turn "
                             "(default 1: the same batch every step)")
    parser.add_argument("--loader", action="store_true",
                        help="time the loader and the loop that it feeds")
    args = parser.parse_args()
    kind = args.kind
    if args.batches > 1 and (args.cfg or args.loader):
        parser.error("--batches takes the synthetic batch only")
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: no CUDA device")
    from amcontrast3d_tpu_torch.engine import make_train_step
    from amcontrast3d_tpu_torch.loss import aef, build_criterion_from_cfg, contrast
    from amcontrast3d_tpu_torch.models import build_model_from_cfg, init_weights_, refine
    from amcontrast3d_tpu_torch.ops import interpolate as ops_interpolate
    from amcontrast3d_tpu_torch.ops import refine as ops_refine
    from amcontrast3d_tpu_torch.optim import build_optimizer_from_cfg
    from amcontrast3d_tpu_torch.scheduler import as_step_schedule, build_scheduler_from_cfg
    from amcontrast3d_tpu_torch.utils.config import EasyConfig

    tag = card()
    print(f"{tag}; torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = EasyConfig()
    cfg.load(args.cfg or str(CFGS[kind]), recursive=True)
    model = build_model_from_cfg(cfg.model)
    init_weights_(model, torch.Generator().manual_seed(SEED))
    model = model.to(dev)
    rng = np.random.RandomState(SEED)
    np.random.seed(SEED)
    if args.cfg or args.loader:
        synthetic_overrides(cfg, args.batch or (cfg.batch_size if args.cfg
                                                else B))
        loader, put = loader_batches(cfg, dev)
        try:
            batch = put(next(iter(loader)))
        finally:
            loader.close()
    else:
        batch = synthetic_batch(rng, dev)
    nb, n = batch["y"].shape
    phases = Phases()
    criterion_args = (cfg.criterion_args_AcePre if kind == "mm"
                      else cfg.criterion_args_Ace)
    criterion = phases.span("loss", annotated(
        "loss", build_criterion_from_cfg(criterion_args)))
    optimizer = build_optimizer_from_cfg(cfg.optimizer, model, lr=cfg.lr)
    optimizer.step = phases.span("optimizer", annotated("optimizer", optimizer.step))
    model.forward = phases.span("forward", annotated("forward", model.forward))
    lr_fn, _ = build_scheduler_from_cfg(cfg)
    step = make_train_step(model, criterion, optimizer,
                           as_step_schedule(lr_fn, STEPS_PER_EPOCH), kind,
                           cfg.num_classes, cfg.ignore_index,
                           cfg.ambiguity_args, cfg.grad_norm_clip,
                           torch.Generator(dev).manual_seed(SEED))
    if args.batches > 1:   # each step the next of a few batches, in turn
        turn = itertools.cycle(
            [batch] + [synthetic_batch(rng, dev) for _ in range(args.batches - 1)])
        one_batch_step = step

        def step(_batch):
            return one_batch_step(next(turn))
    print(f"{kind.upper()} train step at B={nb}x{n}, "
          f"{sum(p.numel() for p in model.parameters())} parameters, "
          f"{cfg.cfg_path if 'cfg_path' in cfg else args.cfg or CFGS[kind]}")

    step_ms(step, batch, WARMUP)
    if args.loader:
        time_loader(cfg, step, dev, tag)
        return
    torch.cuda.reset_peak_memory_stats()
    ts = step_ms(step, batch, TIMED)
    q1, _, q3 = statistics.quantiles(ts, n=4)
    med = statistics.median(ts)
    print(f"kernels: median {med:.3f} ms (q1 {q1:.3f}, q3 {q3:.3f}, min "
          f"{min(ts):.3f}, max {max(ts):.3f}, n={TIMED}) = "
          f"{nb * n / med * 1e3:.1f} train points/s; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB  [{tag}]")

    with plain_ops():
        torch.cuda.reset_peak_memory_stats()
        ts = step_ms(step, batch, PLAIN)
    print(f"plain ops: {ts} ms; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB  [{tag}]")

    phases.spans.clear()
    with ExitStack() as stack:
        for module in (contrast, aef):
            stack.enter_context(mock.patch.object(
                module, "knn", phases.span("kNN kernel (in loss)", module.knn)))
        stack.enter_context(mock.patch.object(
            contrast, "contrast_reductions",
            phases.span("contrast reductions fwd (in loss)",
                        contrast.contrast_reductions)))
        stack.enter_context(mock.patch.object(
            refine, "dual_masks_cross",
            phases.span("CrossMask kernel (in forward)",
                        refine.dual_masks_cross)))
        stack.enter_context(mock.patch.object(
            ops_refine, "refine_cross_backward",
            phases.span("CrossMask VJP kernel (in backward)",
                        ops_refine.refine_cross_backward)))
        stack.enter_context(mock.patch.object(
            ops_interpolate, "three_interpolation_backward_big",
            phases.span("interpolation VJP, kernel 10 (in backward)",
                        ops_interpolate.three_interpolation_backward_big)))
        stack.enter_context(mock.patch.object(
            torch.Tensor, "backward",
            phases.span("backward", torch.Tensor.backward)))
        wall = statistics.median(step_ms(step, batch, PROFILED))
    ms = {k: v / PROFILED for k, v in phases.ms().items()}
    print(f"phases, device ms per step over {PROFILED} steps (wall median "
          f"{wall:.3f} ms)  [{tag}]")
    for name in ("forward", "CrossMask kernel (in forward)", "loss",
                 "kNN kernel (in loss)", "contrast reductions fwd (in loss)",
                 "backward", "CrossMask VJP kernel (in backward)",
                 "interpolation VJP, kernel 10 (in backward)", "optimizer"):
        if name not in ms and name.startswith(("CrossMask", "interpolation")):
            continue
        print(f"  {ms.get(name, 0.0):9.3f} ms  {ms.get(name, 0.0) / wall:6.1%}  {name}")

    wall, rows = kernel_table(step, batch, PROFILED)
    busy = sum(t for t, _, _ in rows)
    print(f"profiled {PROFILED} steps: wall {wall:.3f} ms/step, kernel device "
          f"time {busy:.3f} ms/step, idle share {1 - busy / wall:.4f} (of the "
          f"unprofiled median {1 - busy / med:.4f}), "
          f"{sum(c for _, c, _ in rows):.0f} launches/step  [{tag}]")
    for t, count, key in rows[:40]:
        print(f"  {t:9.3f} ms  x{count:6.1f}  {key[:120]}")
    with mock.patch.object(torch.Tensor, "backward",
                           annotated("backward", torch.Tensor.backward)):
        idle_gaps(step, batch, PROFILED,
                  ("forward", "loss", "backward", "optimizer"), tag)


if __name__ == "__main__":
    main()
