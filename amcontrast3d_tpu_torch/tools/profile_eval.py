"""Where the time of the eval forward goes, on one CUDA device.

    python3 -m amcontrast3d_tpu_torch.tools.profile_eval [--kind aa|mm]

Builds ``BaseSeg_AMContrast3D`` from ``cfgs/s3dis/AMContrast3D-AA.yaml``
or, with ``--kind mm``, ``BaseSeg_M_AMContrast3D`` from
``cfgs/s3dis/AMContrast3D-MM.yaml`` (PointNeXt-XL, random weights from a
seeded generator), fp32 with TF32 off, and runs the eval step at
B=4×24000 on uniform positions in [0, 4]³.  It prints, each block tagged
with the card's name and power limit:

1. wall ms per eval step (``torch.cuda.synchronize()`` on both sides):
   median and quartiles of 20 steps after 3 warm-up steps, and the peak
   device memory;
2. the same for 3 steps with the plain PyTorch twins in place of the
   kernels (FPS, ball query, interpolation, the CrossMask feature);
3. for ``mm``, device ms per forward of the CrossMask kernel (CUDA events
   around its calls) and the refine rate;
4. device ms per forward of every CUDA kernel from ``torch.profiler``
   over 3 steps, their sum, and the card's idle share of the wall time
   (1 − kernel time / wall time).

Without a CUDA device it exits non-zero before measuring anything.
"""
from __future__ import annotations

import argparse
import functools
import statistics
import subprocess
import time
from collections import defaultdict
from contextlib import ExitStack, contextmanager
from pathlib import Path
from unittest import mock

import numpy as np
import torch

B, N, IN_CH, NUM_CLASSES = 4, 24000, 4, 13
SEED = 0
_S3DIS = Path(__file__).resolve().parents[2] / "cfgs" / "s3dis"
CFGS = {"aa": _S3DIS / "AMContrast3D-AA.yaml",
        "mm": _S3DIS / "AMContrast3D-MM.yaml"}
CFG = CFGS["aa"]
WARMUP, TIMED, PLAIN, PROFILED = 3, 20, 3, 3


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


class Phases:
    """CUDA events around the phases of a step; ``ms()`` sums each
    phase's device time over the recorded calls."""

    def __init__(self):
        self.spans = defaultdict(list)

    def span(self, name, fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            self.spans[name].append((start, end))
            return out
        return wrapped

    def ms(self) -> dict:
        torch.cuda.synchronize()
        return {k: sum(s.elapsed_time(e) for s, e in v)
                for k, v in self.spans.items()}


@contextmanager
def plain_ops():
    """Route every kernel op of the model and the loss to its plain
    PyTorch twin (the twins' backward included)."""
    from .. import ops
    from ..engine import evaluate
    from ..loss import aef, contrast
    from ..models import apm, pointnext, refine
    from ..ops import group, interpolate
    with ExitStack() as stack:
        for name, plain in (("furthest_point_sample", ops.furthest_point_sample_plain),
                            ("ball_query", ops.ball_query_plain),
                            ("three_interpolation", ops.three_interpolation_plain)):
            stack.enter_context(mock.patch.object(pointnext, name, plain))
        stack.enter_context(mock.patch.object(contrast, "contrast_reductions",
                                              ops.contrast_reductions_plain))
        stack.enter_context(mock.patch.object(refine, "dual_masks_cross",
                                              ops.dual_masks_cross_plain))
        for module in (aef, contrast, apm, pointnext, group, interpolate,
                       evaluate):
            stack.enter_context(mock.patch.object(module, "knn", ops.knn_plain))
        yield


def step_ms(step, batch, n: int) -> list:
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return times


def _device_us(event) -> float:
    # the attribute was renamed from self_cuda_time_total in PyTorch 2.4
    if hasattr(event, "self_device_time_total"):
        return event.self_device_time_total
    return event.self_cuda_time_total


def kernel_table(step, batch, n: int):
    """(wall ms per step, [(device ms per step, launches per step, kernel)])
    over ``n`` profiled steps, kernel events only."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            step(batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3 / n
    # kernels only: a ``record_function`` range (the optimizer's) also has
    # a device span, which covers kernels that are counted already
    rows = [(_device_us(e) / 1e3 / n, e.count / n, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and _device_us(e) > 0
            and not getattr(e, "is_user_annotation", False)
            and not e.key.startswith("Optimizer.")]
    return wall, sorted(rows, reverse=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--kind", choices=sorted(CFGS), default="aa")
    kind = parser.parse_args().kind
    if not torch.cuda.is_available():
        raise SystemExit("profile_eval: no CUDA device")
    from ..engine import make_eval_step
    from ..models import build_model_from_cfg, init_weights_, refine
    from ..utils.config import EasyConfig

    tag = card()
    print(f"{tag}; torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = EasyConfig()
    cfg.load(str(CFGS[kind]), recursive=True)
    model = build_model_from_cfg(cfg.model)
    init_weights_(model, torch.Generator().manual_seed(SEED))
    model = model.to(dev).eval()
    rng = np.random.RandomState(SEED)
    batch = {"pos": torch.from_numpy(rng.rand(B, N, 3).astype(np.float32) * 4),
             "x": torch.from_numpy(rng.rand(B, N, IN_CH).astype(np.float32)),
             "y": torch.from_numpy(rng.randint(0, NUM_CLASSES, (B, N)))}
    batch = {k: v.to(dev) for k, v in batch.items()}
    step = make_eval_step(model, cfg.num_classes)
    print(f"{kind.upper()} eval step at B={B}x{N}, "
          f"{sum(p.numel() for p in model.parameters())} parameters")

    step_ms(step, batch, WARMUP)
    torch.cuda.reset_peak_memory_stats()
    ts = step_ms(step, batch, TIMED)
    q1, _, q3 = statistics.quantiles(ts, n=4)
    print(f"kernels: median {statistics.median(ts):.3f} ms (q1 {q1:.3f}, q3 "
          f"{q3:.3f}, min {min(ts):.3f}, max {max(ts):.3f}, n={TIMED}); peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB  [{tag}]")

    with plain_ops():
        torch.cuda.reset_peak_memory_stats()
        ts = step_ms(step, batch, PLAIN)
    print(f"plain ops: median {statistics.median(ts):.3f} ms {ts}; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB  [{tag}]")

    if kind == "mm":
        phases = Phases()
        with mock.patch.object(refine, "dual_masks_cross", phases.span(
                "CrossMask kernel", refine.dual_masks_cross)):
            wall = statistics.median(step_ms(step, batch, PROFILED))
        with torch.inference_mode():
            rate = model(batch["pos"], batch["x"])[2].item()
        print(f"phases, device ms per forward over {PROFILED} steps (wall "
              f"median {wall:.3f} ms); refine rate {rate:.3f} %  [{tag}]")
        for name, ms in phases.ms().items():
            print(f"  {ms / PROFILED:9.3f} ms  {ms / PROFILED / wall:6.1%}  {name}")

    wall, rows = kernel_table(step, batch, PROFILED)
    busy = sum(ms for ms, _, _ in rows)
    print(f"profiled {PROFILED} steps: wall {wall:.3f} ms/step, kernel device "
          f"time {busy:.3f} ms/step, idle share {1 - busy / wall:.4f}, "
          f"{sum(c for _, c, _ in rows):.0f} launches/step  [{tag}]")
    for ms, count, key in rows:
        print(f"  {ms:9.3f} ms  x{count:6.1f}  {key[:120]}")


if __name__ == "__main__":
    main()
