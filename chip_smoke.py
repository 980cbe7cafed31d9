"""Smoke run of the PyTorch port on one NVIDIA GPU: build, check, time.

    python3 chip_smoke.py

1. prints the card (nvidia-smi name and power limit) and the PyTorch and
   CUDA versions, and turns TF32 off;
2. builds the CUDA kernels of ``amcontrast3d_tpu_torch/csrc`` (set-up time);
3. runs each kernel at the shapes of the AA train step at B=4×24000 (stage
   positions from FPS, on a uniform and a clustered cloud) and holds it
   against its plain PyTorch twin on the card, timing both (median of 11
   kernel runs and 3 plain runs after a warm-up, CUDA events):
   FPS picks and ball-query indices identical; interpolation forward
   within 1e-5·(1+max|out|) and its backward within 1e-5·(1+max|df|);
   contrast forward counts and threshold identical and its sums within
   1e-5·(1+max|ref|); both halves of the contrast VJP within
   1e-4·(1+max|df|);
4. drives the eval main path: ``BaseSeg_AMContrast3D`` built from
   ``cfgs/s3dis/AMContrast3D-AA.yaml`` (PointNeXt-XL, width 64, blocks
   [1,4,7,4,4], random weights from a seeded generator) through
   ``make_eval_step`` on 5 batches of 4×24000 points (an untimed warm-up
   batch first); checks finite logits, confusion-matrix totals and the
   kernels' launch counts per forward, then repeats one forward with the
   plain ops and compares;
5. drives the train main path: the same model with ``CrossEntropyAce``,
   AdamW, the cosine schedule and clip 10 from the cfg, dropout from a
   seeded generator, through ``make_train_step`` for 1 untimed and 5 timed
   steps on 4×24000 points labelled by a Voronoi partition into 13
   regions; checks finite losses, changed parameters, confusion-matrix
   totals and each kernel's launches per step, then runs one step from one
   state with the kernels and one with every kernel's plain twin and
   compares stage positions, losses and gradients;
6. prints one JSON line of per-kernel results and, last, the device line.

Any failure raises, so the exit code is non-zero; without a CUDA device it
stops before printing any result.
"""
from __future__ import annotations

import copy
import json
import os
import statistics
import subprocess
import sys
import time
from contextlib import ExitStack

import numpy as np
import torch

B, N, IN_CH, NUM_CLASSES, N_BATCHES, N_TRAIN = 4, 24000, 4, 13, 5, 5
SEED = 0
REPO = os.path.dirname(os.path.abspath(__file__))
CFG = os.path.join(REPO, "cfgs", "s3dis", "AMContrast3D-AA.yaml")
TIMING_RUNS, PLAIN_RUNS = 11, 3
# the schedule's epoch length; the 6 steps here stay in epoch 1
STEPS_PER_EPOCH = 1000
# kernel vs plain train step, relative L2 of the gradients (see PERF.md)
GRAD_TOL = 1e-4
KERNELS = (  # name, source, the TPU kernel it replaces
    ("fps", "amcontrast3d_tpu_torch/csrc/fps.cu",
     "amcontrast3d_tpu/ops/fps_pallas.py:61"),
    ("ball_query", "amcontrast3d_tpu_torch/csrc/ball_query.cu",
     "amcontrast3d_tpu/ops/knn_pallas.py:184"),
    ("three_interpolation", "amcontrast3d_tpu_torch/csrc/interpolate.cu",
     "amcontrast3d_tpu/ops/interpolate_pallas.py:65"),
    ("three_interpolation_backward", "amcontrast3d_tpu_torch/csrc/interpolate.cu",
     "amcontrast3d_tpu/ops/interpolate_pallas.py:206"),
    ("contrast_forward", "amcontrast3d_tpu_torch/csrc/contrast.cu",
     "amcontrast3d_tpu/ops/contrast_pallas.py:124"),
    ("contrast_grad_rows", "amcontrast3d_tpu_torch/csrc/contrast.cu",
     "amcontrast3d_tpu/ops/contrast_pallas.py:306"),
    ("contrast_grad_support", "amcontrast3d_tpu_torch/csrc/contrast.cu",
     "amcontrast3d_tpu/ops/contrast_pallas.py:360"),
)
EVAL_LAUNCHES = {"fps": 4, "ball_query": 8, "three_interpolation": 4}
TRAIN_LAUNCHES = {"fps": 4, "ball_query": 8, "three_interpolation": 4,
                  "three_interpolation_backward": 4, "contrast_forward": 4,
                  "contrast_grad_rows": 4, "contrast_grad_support": 4}


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, runs: int = TIMING_RUNS) -> float:
    """Median device time of ``fn()`` in ms over ``runs`` runs, after one
    warm-up run."""
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


def clouds(rng) -> dict:
    """Uniform positions in [0, 4]³ (as ``__graft_entry__._batch``) and a
    clustered cloud: 64 Gaussian blobs of σ 0.05, so balls are dense."""
    uniform = rng.rand(B, N, 3).astype(np.float32) * 4
    centres = rng.rand(B, 64, 3) * 4
    pick = rng.randint(0, 64, (B, N))
    blobs = np.take_along_axis(centres, pick[..., None], 1) \
        + 0.05 * rng.randn(B, N, 3)
    return {"uniform": uniform, "clustered": blobs.astype(np.float32)}


def check_close(name: str, got, want, tol: float) -> float:
    err = (got - want).abs().max().item()
    bound = tol * (1 + want.abs().max().item())
    if not err <= bound:
        raise AssertionError(f"{name}: max abs err {err} > {bound}")
    return err


def kernel_phases(ops, dev, rng, tag: str) -> dict:
    """Each kernel at the slice's shapes against its plain twin; returns
    {name: [max abs err, kernel ms, plain ms]}, times summed over the
    stages (per forward for the first three, per train step for the
    rest), on the uniform cloud."""
    from amcontrast3d_tpu_torch.models.pointnext import to_full_list
    from amcontrast3d_tpu_torch.tools.profile_train import voronoi_labels

    radii = to_full_list(0.1, [1, 4, 7, 4, 4], [1, 4, 4, 4, 4], 2)
    channels = [128, 256, 512, 1024]           # coarse C of fp0 … fp3
    up_channels = [64, 128, 256, 512]          # decoder stage widths
    results = {name: [0.0, 0.0, 0.0] for name, _, _ in KERNELS}

    def timed(name, cloud, kernel, plain):
        if cloud == "uniform":
            results[name][1] += cuda_ms(kernel)
            results[name][2] += cuda_ms(plain, PLAIN_RUNS)

    def note(name, err):
        results[name][0] = max(results[name][0], err)

    for cloud, pts in clouds(rng).items():
        p = torch.from_numpy(pts).to(dev)
        stages = [p]
        for s in range(1, 5):                  # 24000 → 6000 → 1500 → 375 → 93
            prev = stages[-1]
            npoint = prev.shape[1] // 4
            got = ops.furthest_point_sample(prev, npoint)
            want = ops.furthest_point_sample_plain(prev, npoint)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                bad = int((got != want).sum())
                raise AssertionError(f"fps {cloud} stage {s}: {bad} picks differ")
            note("fps", (got - want).abs().max().item())
            timed("fps", cloud, lambda: ops.furthest_point_sample(prev, npoint),
                  lambda: ops.furthest_point_sample_plain(prev, npoint))
            stages.append(ops.gather_points(prev, got).contiguous())
        for s in range(1, 5):
            sup, q = stages[s - 1], stages[s]
            for support, query, r in ((sup, q, radii[s][0]), (q, q, radii[s][1])):
                got = ops.ball_query(support, query, r, 32)
                want = ops.ball_query_plain(support, query, r, 32)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    bad = int((got != want).sum())
                    raise AssertionError(f"ball query {cloud} stage {s} r={r}: "
                                         f"{bad} indices differ")
                note("ball_query", (got - want).abs().max().item())
                timed("ball_query", cloud,
                      lambda: ops.ball_query(support, query, r, 32),
                      lambda: ops.ball_query_plain(support, query, r, 32))
        for s in range(1, 5):
            p1, p2 = stages[s - 1], stages[s]
            f2 = torch.from_numpy(rng.randn(B, p2.shape[1], channels[s - 1])
                                  .astype(np.float32)).to(dev)
            got = ops.three_interpolation(p1, p2, f2)
            want = ops.three_interpolation_plain(p1, p2, f2)
            note("three_interpolation", check_close(
                f"interpolation {cloud} stage {s}", got, want, 1e-5))
            timed("three_interpolation", cloud,
                  lambda: ops.three_interpolation(p1, p2, f2),
                  lambda: ops.three_interpolation_plain(p1, p2, f2))
            # the backward on the indices and weights the forward keeps
            idx, w = ops.three_interpolation_weights(p1, p2)
            g = torch.from_numpy(rng.randn(B, p1.shape[1], channels[s - 1])
                                 .astype(np.float32)).to(dev)
            n2 = p2.shape[1]
            got = ops.three_interpolation_backward(g, idx, w, n2)
            want = ops.three_interpolation_backward_plain(g, idx, w, n2)
            note("three_interpolation_backward", check_close(
                f"interpolation backward {cloud} stage {s}", got, want, 1e-5))
            timed("three_interpolation_backward", cloud,
                  lambda: ops.three_interpolation_backward(g, idx, w, n2),
                  lambda: ops.three_interpolation_backward_plain(g, idx, w, n2))
        labels = voronoi_labels(rng, pts)
        lab0 = torch.from_numpy(labels.astype(np.float32)).to(dev)
        for s in range(4):                     # the contrast stages
            ps = stages[s]
            lab = lab0 if s == 0 else lab0.gather(
                1, ops.knn(stages[0], ps, 1)[0][..., 0].long())
            f = torch.nn.functional.normalize(torch.from_numpy(
                rng.randn(B, ps.shape[1], up_channels[s]).astype(np.float32))
                .to(dev), dim=-1)
            kth = (ops.knn(ps, ps, 24)[1][..., -1] * (1.0 + 1e-5)).contiguous()
            args = (ps, f, lab, kth, 1 / 0.3, False, False, True)
            got = ops.contrast_forward(*args)
            want = ops.contrast_forward_plain(*args)
            torch.cuda.synchronize()
            if not (torch.equal(got[..., 4:6], want[..., 4:6])
                    and torch.equal(got[..., 8], want[..., 8])):
                raise AssertionError(f"contrast {cloud} stage {s}: counts or "
                                     "threshold differ")
            note("contrast_forward", max(check_close(
                f"contrast column {c} {cloud} stage {s}", got[..., c],
                want[..., c], 1e-5) for c in (0, 1, 6, 7)))
            timed("contrast_forward", cloud, lambda: ops.contrast_forward(*args),
                  lambda: ops.contrast_forward_plain(*args))
            g4 = torch.from_numpy(rng.randn(B, ps.shape[1], 4)
                                  .astype(np.float32)).to(dev)
            gargs = (ps, f, lab, kth, g4, 1 / 0.3, False)
            for name, kern, plain in (
                    ("contrast_grad_rows", ops.contrast_grad_rows,
                     ops.contrast_grad_rows_plain),
                    ("contrast_grad_support", ops.contrast_grad_support,
                     ops.contrast_grad_support_plain)):
                note(name, check_close(f"{name} {cloud} stage {s}",
                                       kern(*gargs), plain(*gargs), 1e-4))
                timed(name, cloud, lambda: kern(*gargs), lambda: plain(*gargs))
    for k, (err, ms, plain_ms) in results.items():
        print(f"kernel {k}: matches plain on uniform and clustered clouds "
              f"(max abs err {err}); summed over stages {ms:.4f} ms vs plain "
              f"{plain_ms:.4f} ms  [{tag}]")
    return results


def wrappers(ops) -> dict:
    return {"fps": ops.furthest_point_sample, "ball_query": ops.ball_query,
            "three_interpolation": ops.three_interpolation,
            "three_interpolation_backward": ops.three_interpolation_backward,
            "contrast_forward": ops.contrast_forward,
            "contrast_grad_rows": ops.contrast_grad_rows,
            "contrast_grad_support": ops.contrast_grad_support}


def eval_path(ops, cfg, model, dev, rng, tag):
    from amcontrast3d_tpu_torch.engine import make_eval_step
    from amcontrast3d_tpu_torch.tools.profile_eval import plain_ops

    model.eval()
    step = make_eval_step(model, cfg.num_classes)
    batches = [{"pos": torch.from_numpy(rng.rand(B, N, 3).astype(np.float32) * 4),
                "x": torch.from_numpy(rng.rand(B, N, IN_CH).astype(np.float32)),
                "y": torch.from_numpy(rng.randint(0, NUM_CLASSES, (B, N)))}
               for _ in range(N_BATCHES + 1)]
    batches = [{k: v.to(dev) for k, v in b.items()} for b in batches]
    counted = wrappers(ops)
    for fn in counted.values():
        fn.launches = 0
    forward_ms = []
    for i, batch in enumerate(batches):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = step(batch)
        torch.cuda.synchronize()
        if i:   # batch 0 warms cuBLAS and the allocator up, untimed
            forward_ms.append((time.perf_counter() - t) * 1e3)
        logits, cm = out["logits"], out["cm"]
        if logits.shape != (B, N, NUM_CLASSES) or not torch.isfinite(logits).all():
            raise AssertionError(f"bad logits {tuple(logits.shape)}")
        if int(cm.sum()) != B * N:
            raise AssertionError(f"confusion matrix counts {int(cm.sum())}")
    launches = {k: fn.launches for k, fn in counted.items()}
    per_forward = {k: v / len(batches) for k, v in launches.items() if v}
    if per_forward != EVAL_LAUNCHES:
        raise AssertionError(f"launches per forward {per_forward}")
    print(f"eval main path: {len(batches)} eval steps at B={B}x{N}, launches "
          f"per forward {per_forward}")

    with torch.inference_mode():
        logits_k, stages_k = model(batches[0]["pos"], batches[0]["x"])
        with plain_ops():
            logits_p, stages_p = model(batches[0]["pos"], batches[0]["x"])
    for s, (pk, pp) in enumerate(zip(stages_k["p"], stages_p["p"])):
        if not torch.equal(pk, pp):
            raise AssertionError(f"stage {s} positions differ from the plain ops")
    err = (logits_k - logits_p).abs().max().item()
    tol = 1e-4 * (1 + logits_p.abs().max().item())
    if not err <= tol:
        raise AssertionError(f"logits vs plain ops: max abs err {err} > {tol}")
    print(f"eval main path vs plain ops on the card: stage positions identical, "
          f"logits max abs err {err} (tol {tol})")
    med = statistics.median(forward_ms)
    print(f"eval forward B={B}x{N}: per-batch ms {forward_ms}; median "
          f"{med:.3f} ms = {B * N / med * 1e3:.1f} points/s  [{tag}]")


def train_batch(rng, dev) -> dict:
    from amcontrast3d_tpu_torch.tools.profile_train import voronoi_labels

    pos = rng.rand(B, N, 3).astype(np.float32) * 4
    batch = {"pos": torch.from_numpy(pos),
             "x": torch.from_numpy(rng.rand(B, N, IN_CH).astype(np.float32)),
             "y": torch.from_numpy(voronoi_labels(rng, pos))}
    return {k: v.to(dev) for k, v in batch.items()}


def make_step(cfg, model, optimizer, dev, seed):
    from amcontrast3d_tpu_torch.engine import make_train_step
    from amcontrast3d_tpu_torch.loss import build_criterion_from_cfg
    from amcontrast3d_tpu_torch.scheduler import (as_step_schedule,
                                                  build_scheduler_from_cfg)
    lr_fn, _ = build_scheduler_from_cfg(cfg)
    return make_train_step(
        model, build_criterion_from_cfg(cfg.criterion_args_Ace), optimizer,
        as_step_schedule(lr_fn, STEPS_PER_EPOCH), "aa", cfg.num_classes,
        cfg.ignore_index, cfg.ambiguity_args, cfg.grad_norm_clip,
        torch.Generator(dev).manual_seed(seed))


def train_path(ops, cfg, model, dev, rng, tag) -> dict:
    """The train main path; returns the kernels' launches in it."""
    from amcontrast3d_tpu_torch.optim import build_optimizer_from_cfg

    optimizer = build_optimizer_from_cfg(cfg.optimizer, model, lr=cfg.lr)
    step = make_step(cfg, model, optimizer, dev, SEED)
    batches = [train_batch(rng, dev) for _ in range(N_TRAIN + 1)]
    start = [p.detach().clone() for p in model.parameters()]
    counted = wrappers(ops)
    for fn in counted.values():
        fn.launches = 0
    step_ms, losses = [], []
    for i, batch in enumerate(batches):
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = step(batch)
        torch.cuda.synchronize()
        if i:   # step 0 warms cuBLAS and the allocator up, untimed
            step_ms.append((time.perf_counter() - t) * 1e3)
        losses.append(out["loss"].item())
        if not np.isfinite(losses[-1]):
            raise AssertionError(f"train step {i}: loss {losses[-1]}")
        if int(out["cm"].sum()) != B * N:
            raise AssertionError(f"train step {i}: confusion matrix counts "
                                 f"{int(out['cm'].sum())}")
    launches = {k: fn.launches for k, fn in counted.items()}
    per_step = {k: v / len(batches) for k, v in launches.items()}
    if per_step != TRAIN_LAUNCHES:
        raise AssertionError(f"launches per train step {per_step}")
    moved = sum(int(not torch.equal(a, p.detach()))
                for a, p in zip(start, model.parameters()))
    if moved != len(start):
        raise AssertionError(f"only {moved} of {len(start)} parameters changed")
    peak = torch.cuda.max_memory_allocated() / 2**30
    med = statistics.median(step_ms)
    print(f"train main path: {len(batches)} steps at B={B}x{N}, losses "
          f"{losses}, all {moved} parameter tensors changed, launches per "
          f"step {per_step}")
    print(f"train step B={B}x{N}: per-step ms {step_ms}; median {med:.3f} ms "
          f"= {B * N / med * 1e3:.1f} train points/s; peak "
          f"{peak:.3f} GiB  [{tag}]")
    train_vs_plain(ops, cfg, model, optimizer, dev, batches[0], tag)
    return launches


def train_vs_plain(ops, cfg, model, optimizer, dev, batch, tag):
    """One step from one state with the kernels and one with the twins."""
    from amcontrast3d_tpu_torch.optim import build_optimizer_from_cfg
    from amcontrast3d_tpu_torch.tools.profile_eval import plain_ops

    runs = {}
    for name in ("kernels", "plain"):
        m = copy.deepcopy(model)
        opt = build_optimizer_from_cfg(cfg.optimizer, m, lr=cfg.lr)
        opt.load_state_dict(optimizer.state_dict())
        stages = {}
        hook = m.register_forward_hook(
            lambda mod, inp, out: stages.update(p=out[1]["p"]))
        step = make_step(cfg, m, opt, dev, SEED + 1)
        with (plain_ops() if name == "plain" else ExitStack()):
            torch.cuda.synchronize()
            t = time.perf_counter()
            loss = step(batch)["loss"].item()
            torch.cuda.synchronize()
        hook.remove()
        runs[name] = {"loss": loss, "p": stages["p"],
                      "ms": (time.perf_counter() - t) * 1e3,
                      "grads": [p.grad.detach().clone() for p in m.parameters()]}
    k, p = runs["kernels"], runs["plain"]
    for s, (a, b) in enumerate(zip(k["p"], p["p"])):
        if not torch.equal(a, b):
            raise AssertionError(f"train stage {s} positions differ from plain")
    rel_loss = abs(k["loss"] - p["loss"]) / abs(p["loss"])
    if not rel_loss <= 1e-4:
        raise AssertionError(f"train loss {k['loss']} vs plain {p['loss']}")
    num = den = worst = 0.0
    for a, b in zip(k["grads"], p["grads"]):
        d = (a - b).double().norm().item()
        n = b.double().norm().item()
        num, den = num + d * d, den + n * n
        worst = max(worst, d / max(n, 1e-30))
    rel_grad = (num / den) ** 0.5
    if not rel_grad <= GRAD_TOL:
        raise AssertionError(f"train gradients vs plain: relative L2 "
                             f"{rel_grad} > {GRAD_TOL}")
    print(f"train step vs plain ops on the card: stage positions identical, "
          f"loss {k['loss']} vs {p['loss']} (rel {rel_loss:.3e}), gradients "
          f"relative L2 {rel_grad:.3e} over all parameters (worst tensor "
          f"{worst:.3e}); step {k['ms']:.1f} ms vs plain {p['ms']:.1f} ms  "
          f"[{tag}]")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    sys.path.insert(0, REPO)
    from amcontrast3d_tpu_torch import ops
    from amcontrast3d_tpu_torch.models import build_model_from_cfg, init_weights_
    from amcontrast3d_tpu_torch.ops import _build
    from amcontrast3d_tpu_torch.utils.config import EasyConfig

    tag = card()
    print(tag)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    t0 = time.perf_counter()
    _build.load_library()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.2f} s: "
          f"{_build.library_path()}")
    print(_build.library_path().with_suffix(".log").read_text().strip())

    rng = np.random.RandomState(SEED)
    kernels = kernel_phases(ops, dev, rng, tag)

    cfg = EasyConfig()
    cfg.load(CFG, recursive=True)
    model = build_model_from_cfg(cfg.model)
    init_weights_(model, torch.Generator().manual_seed(SEED))
    model = model.to(dev)
    eval_path(ops, cfg, model, dev, rng, tag)
    launches = train_path(ops, cfg, model, dev, rng, tag)

    rows = [{"name": k, "route": "cuda", "source": src, "replaces": tpu,
             "launches": launches[k], "max_abs_err": kernels[k][0],
             "ms": kernels[k][1], "plain_ms": kernels[k][2]}
            for k, src, tpu in KERNELS]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
