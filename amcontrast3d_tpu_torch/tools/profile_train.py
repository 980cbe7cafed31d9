"""Where the time of the AA train step goes, on one CUDA device.

    python3 -m amcontrast3d_tpu_torch.tools.profile_train

Builds ``BaseSeg_AMContrast3D`` from ``cfgs/s3dis/AMContrast3D-AA.yaml``
(PointNeXt-XL, random weights from a seeded generator) with the recipe's
``CrossEntropyAce``, AdamW, cosine schedule and clip 10, fp32 with TF32
off, and runs ``make_train_step`` at B=4×24000 (uniform positions in
[0, 4]³, labels from a Voronoi partition into 13 regions).  It prints,
each block tagged with the card's name and power limit:

1. wall ms per train step (``torch.cuda.synchronize()`` on both sides):
   median and quartiles of 10 steps after 2 warm-up steps, train points/s
   and the peak device memory;
2. one step with every kernel replaced by its plain PyTorch twin;
3. device ms per step of each phase, from CUDA events on the stream over
   3 steps: forward, loss, backward, optimizer (the clip and the
   confusion matrix fall between them); and,
   inside the loss, the plain exact kNN (the contrast thresholds and the
   stage-label propagation) and the contrast reductions;
4. device ms per step of every CUDA kernel from ``torch.profiler`` over
   3 steps, their sum, and the card's idle share of the wall time.

Without a CUDA device it exits non-zero before measuring anything.
"""
from __future__ import annotations

import statistics
from collections import defaultdict
from contextlib import ExitStack
from unittest import mock

import numpy as np
import torch

from .profile_eval import CFG, card, kernel_table, plain_ops, step_ms

B, N, IN_CH, NUM_CLASSES = 4, 24000, 4, 13
SEED = 0
WARMUP, TIMED, PLAIN, PROFILED = 2, 10, 1, 3
STEPS_PER_EPOCH = 1000


class _Phases:
    """CUDA events around the phases of a step; ``ms()`` sums each
    phase's device time over the recorded steps."""

    def __init__(self):
        self.spans = defaultdict(list)

    def span(self, name, fn):
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


def voronoi_labels(rng, pos: np.ndarray) -> np.ndarray:
    """(B, N) label of the nearest of 13 random centres in [0, 4]³: regions
    with interior and boundary points, as the rooms of a scene."""
    centres = rng.rand(pos.shape[0], NUM_CLASSES, 3) * 4
    return ((pos[:, :, None] - centres[:, None]) ** 2).sum(-1).argmin(-1)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: no CUDA device")
    from ..engine import make_train_step
    from ..loss import aef, build_criterion_from_cfg, contrast
    from ..models import build_model_from_cfg, init_weights_
    from ..optim import build_optimizer_from_cfg
    from ..scheduler import as_step_schedule, build_scheduler_from_cfg
    from ..utils.config import EasyConfig

    tag = card()
    print(f"{tag}; torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = EasyConfig()
    cfg.load(str(CFG), recursive=True)
    model = build_model_from_cfg(cfg.model)
    init_weights_(model, torch.Generator().manual_seed(SEED))
    model = model.to(dev)
    rng = np.random.RandomState(SEED)
    pos = rng.rand(B, N, 3).astype(np.float32) * 4
    batch = {"pos": torch.from_numpy(pos),
             "x": torch.from_numpy(rng.rand(B, N, IN_CH).astype(np.float32)),
             "y": torch.from_numpy(voronoi_labels(rng, pos))}
    batch = {k: v.to(dev) for k, v in batch.items()}
    phases = _Phases()
    criterion = phases.span("loss", build_criterion_from_cfg(cfg.criterion_args_Ace))
    optimizer = build_optimizer_from_cfg(cfg.optimizer, model, lr=cfg.lr)
    optimizer.step = phases.span("optimizer", optimizer.step)
    forward = model.forward
    model.forward = phases.span("forward", forward)
    lr_fn, _ = build_scheduler_from_cfg(cfg)
    step = make_train_step(model, criterion, optimizer,
                           as_step_schedule(lr_fn, STEPS_PER_EPOCH), "aa",
                           cfg.num_classes, cfg.ignore_index,
                           cfg.ambiguity_args, cfg.grad_norm_clip,
                           torch.Generator(dev).manual_seed(SEED))
    print(f"AA train step at B={B}x{N}, "
          f"{sum(p.numel() for p in model.parameters())} parameters")

    step_ms(step, batch, WARMUP)
    torch.cuda.reset_peak_memory_stats()
    ts = step_ms(step, batch, TIMED)
    q1, _, q3 = statistics.quantiles(ts, n=4)
    med = statistics.median(ts)
    print(f"kernels: median {med:.3f} ms (q1 {q1:.3f}, q3 {q3:.3f}, min "
          f"{min(ts):.3f}, max {max(ts):.3f}, n={TIMED}) = "
          f"{B * N / med * 1e3:.1f} train points/s; peak "
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
                module, "knn", phases.span("plain kNN (in loss)", module.knn)))
        stack.enter_context(mock.patch.object(
            contrast, "contrast_reductions",
            phases.span("contrast reductions fwd (in loss)",
                        contrast.contrast_reductions)))
        stack.enter_context(mock.patch.object(
            torch.Tensor, "backward",
            phases.span("backward", torch.Tensor.backward)))
        wall = statistics.median(step_ms(step, batch, PROFILED))
    ms = {k: v / PROFILED for k, v in phases.ms().items()}
    print(f"phases, device ms per step over {PROFILED} steps (wall median "
          f"{wall:.3f} ms)  [{tag}]")
    for name in ("forward", "loss", "plain kNN (in loss)",
                 "contrast reductions fwd (in loss)", "backward", "optimizer"):
        print(f"  {ms.get(name, 0.0):9.3f} ms  {ms.get(name, 0.0) / wall:6.1%}  {name}")

    wall, rows = kernel_table(step, batch, PROFILED)
    busy = sum(t for t, _, _ in rows)
    print(f"profiled {PROFILED} steps: wall {wall:.3f} ms/step, kernel device "
          f"time {busy:.3f} ms/step, idle share {1 - busy / wall:.4f}, "
          f"{sum(c for _, c, _ in rows):.0f} launches/step  [{tag}]")
    for t, count, key in rows[:40]:
        print(f"  {t:9.3f} ms  x{count:6.1f}  {key[:120]}")


if __name__ == "__main__":
    main()
