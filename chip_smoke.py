"""Smoke run of the PyTorch port on one NVIDIA GPU: build, check, time.

    python3 chip_smoke.py

1. prints the card (nvidia-smi name and power limit) and the PyTorch and
   CUDA versions, and turns TF32 off;
2. builds the CUDA kernels of ``amcontrast3d_tpu_torch/csrc`` (set-up time);
3. runs each kernel at the shapes of the AA eval forward at B=4×24000 and
   holds it against its plain PyTorch twin on the card (FPS picks and
   ball-query indices identical; interpolation within 1e-5·(1+max|out|)),
   timing both (median of 11 runs after a warm-up, CUDA events);
4. drives the main path: ``BaseSeg_AMContrast3D`` built from
   ``cfgs/s3dis/AMContrast3D-AA.yaml`` (PointNeXt-XL, width 64, blocks
   [1,4,7,4,4], random weights from a seeded generator) through
   ``make_eval_step`` on 5 batches of 4×24000 points; checks finite logits,
   confusion-matrix totals and the kernels' launch counts per forward (an
   untimed warm-up batch first, counted with the others), then
   repeats one forward with the plain ops and compares;
5. prints one JSON line of per-kernel results and, last, the device line.

Any failure raises, so the exit code is non-zero; without a CUDA device it
stops before printing any result.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from contextlib import ExitStack
from unittest import mock

import numpy as np
import torch

B, N, IN_CH, NUM_CLASSES, N_BATCHES = 4, 24000, 4, 13, 5
SEED = 0
REPO = os.path.dirname(os.path.abspath(__file__))
CFG = os.path.join(REPO, "cfgs", "s3dis", "AMContrast3D-AA.yaml")
TIMING_RUNS = 11


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


def kernel_phases(ops, dev, rng, tag: str) -> dict:
    """Each kernel at the slice's shapes against its plain twin."""
    from amcontrast3d_tpu_torch.models.pointnext import to_full_list

    radii = to_full_list(0.1, [1, 4, 7, 4, 4], [1, 4, 4, 4, 4], 2)
    channels = [128, 256, 512, 1024]           # coarse C of fp0 … fp3
    results = {"fps": [0.0, 0.0, 0.0], "ball_query": [0.0, 0.0, 0.0],
               "three_interpolation": [0.0, 0.0, 0.0]}
    for name, cloud in clouds(rng).items():
        p = torch.from_numpy(cloud).to(dev)
        stages = [p]
        for s in range(1, 5):                  # 24000 → 6000 → 1500 → 375 → 93
            prev = stages[-1]
            npoint = prev.shape[1] // 4
            got = ops.furthest_point_sample(prev, npoint)
            want = ops.furthest_point_sample_plain(prev, npoint)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                bad = int((got != want).sum())
                raise AssertionError(f"fps {name} stage {s}: {bad} picks differ")
            results["fps"][0] = max(results["fps"][0],
                                    (got - want).abs().max().item())
            if name == "uniform":
                results["fps"][1] += cuda_ms(
                    lambda: ops.furthest_point_sample(prev, npoint))
                results["fps"][2] += cuda_ms(
                    lambda: ops.furthest_point_sample_plain(prev, npoint), 10)
            stages.append(ops.gather_points(prev, got).contiguous())
        for s in range(1, 5):
            sup, q = stages[s - 1], stages[s]
            for support, query, r in ((sup, q, radii[s][0]), (q, q, radii[s][1])):
                got = ops.ball_query(support, query, r, 32)
                want = ops.ball_query_plain(support, query, r, 32)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    bad = int((got != want).sum())
                    raise AssertionError(f"ball query {name} stage {s} r={r}: "
                                         f"{bad} indices differ")
                results["ball_query"][0] = max(results["ball_query"][0],
                                               (got - want).abs().max().item())
                if name == "uniform":
                    results["ball_query"][1] += cuda_ms(
                        lambda: ops.ball_query(support, query, r, 32))
                    results["ball_query"][2] += cuda_ms(
                        lambda: ops.ball_query_plain(support, query, r, 32))
        for s in range(1, 5):
            p1, p2 = stages[s - 1], stages[s]
            f2 = torch.from_numpy(rng.randn(B, p2.shape[1], channels[s - 1])
                                  .astype(np.float32)).to(dev)
            got = ops.three_interpolation(p1, p2, f2)
            want = ops.three_interpolation_plain(p1, p2, f2)
            err = (got - want).abs().max().item()
            tol = 1e-5 * (1 + want.abs().max().item())
            if not err <= tol:
                raise AssertionError(f"interpolation {name} stage {s}: max abs "
                                     f"err {err} > {tol}")
            results["three_interpolation"][0] = max(
                results["three_interpolation"][0], err)
            if name == "uniform":
                results["three_interpolation"][1] += cuda_ms(
                    lambda: ops.three_interpolation(p1, p2, f2))
                results["three_interpolation"][2] += cuda_ms(
                    lambda: ops.three_interpolation_plain(p1, p2, f2))
    for k, (err, ms, plain_ms) in results.items():
        print(f"kernel {k}: matches plain on uniform and clustered clouds "
              f"(max abs err {err}); per forward {ms:.4f} ms vs plain "
              f"{plain_ms:.4f} ms  [{tag}]")
    return results


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    sys.path.insert(0, REPO)
    from amcontrast3d_tpu_torch import ops
    from amcontrast3d_tpu_torch.engine import make_eval_step
    from amcontrast3d_tpu_torch.models import build_model_from_cfg, init_weights_
    from amcontrast3d_tpu_torch.models import pointnext
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

    # ---- main path: the AA eval step at B=4×24000 ----------------------
    cfg = EasyConfig()
    cfg.load(CFG, recursive=True)
    model = build_model_from_cfg(cfg.model)
    init_weights_(model, torch.Generator().manual_seed(SEED))
    model = model.to(dev).eval()
    step = make_eval_step(model, cfg.num_classes)
    batches = [{"pos": torch.from_numpy(rng.rand(B, N, 3).astype(np.float32) * 4),
                "x": torch.from_numpy(rng.rand(B, N, IN_CH).astype(np.float32)),
                "y": torch.from_numpy(rng.randint(0, NUM_CLASSES, (B, N)))}
               for _ in range(N_BATCHES + 1)]
    batches = [{k: v.to(dev) for k, v in b.items()} for b in batches]
    wrappers = {"fps": ops.furthest_point_sample, "ball_query": ops.ball_query,
                "three_interpolation": ops.three_interpolation}
    for fn in wrappers.values():
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
    launches = {k: fn.launches for k, fn in wrappers.items()}
    per_forward = {k: v / len(batches) for k, v in launches.items()}
    if per_forward != {"fps": 4, "ball_query": 8, "three_interpolation": 4}:
        raise AssertionError(f"launches per forward {per_forward}")
    print(f"main path: {len(batches)} eval steps at B={B}x{N}, launches per "
          f"forward {per_forward}")

    with torch.inference_mode():
        logits_k, stages_k = model(batches[0]["pos"], batches[0]["x"])
        with ExitStack() as stack:
            for name, plain in (("furthest_point_sample", ops.furthest_point_sample_plain),
                                ("ball_query", ops.ball_query_plain),
                                ("three_interpolation", ops.three_interpolation_plain)):
                stack.enter_context(mock.patch.object(pointnext, name, plain))
            logits_p, stages_p = model(batches[0]["pos"], batches[0]["x"])
    for s, (pk, pp) in enumerate(zip(stages_k["p"], stages_p["p"])):
        if not torch.equal(pk, pp):
            raise AssertionError(f"stage {s} positions differ from the plain ops")
    err = (logits_k - logits_p).abs().max().item()
    tol = 1e-4 * (1 + logits_p.abs().max().item())
    if not err <= tol:
        raise AssertionError(f"logits vs plain ops: max abs err {err} > {tol}")
    print(f"main path vs plain ops on the card: stage positions identical, "
          f"logits max abs err {err} (tol {tol})")

    med = statistics.median(forward_ms)
    print(f"eval forward B={B}x{N}: per-batch ms {forward_ms}; median "
          f"{med:.3f} ms = {B * N / med * 1e3:.1f} points/s  [{tag}]")

    rows = [{"name": k, "route": "cuda", "source": src, "replaces": tpu,
             "launches": launches[k], "max_abs_err": kernels[k][0],
             "ms": kernels[k][1], "plain_ms": kernels[k][2]}
            for k, src, tpu in (
                ("fps", "amcontrast3d_tpu_torch/csrc/fps.cu",
                 "amcontrast3d_tpu/ops/fps_pallas.py:61"),
                ("ball_query", "amcontrast3d_tpu_torch/csrc/ball_query.cu",
                 "amcontrast3d_tpu/ops/knn_pallas.py:184"),
                ("three_interpolation", "amcontrast3d_tpu_torch/csrc/interpolate.cu",
                 "amcontrast3d_tpu/ops/interpolate_pallas.py:65"))]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
