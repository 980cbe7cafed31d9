"""Smoke run of the PyTorch port on one NVIDIA GPU: build, check, time.

    python3 chip_smoke.py

1. prints the card (nvidia-smi name and power limit) and the PyTorch and
   CUDA versions, and turns TF32 off;
2. builds the CUDA kernels of ``amcontrast3d_tpu_torch/csrc`` (set-up time);
3. runs each of the ten kernels at the shapes of the AA and MM train steps
   at B=4×24000 (stage positions from FPS, on a uniform and a clustered
   cloud) and holds it against its plain PyTorch twin on the card, timing
   both (median of 11 kernel runs and 3 plain runs after a warm-up, CUDA
   events) and, where one PyTorch call computes the same function, that
   call as a yardstick (``library_ms``; the port never calls it):
   FPS picks and ball-query indices identical; interpolation forward
   within 1e-5·(1+max|out|) and its backward within 1e-5·(1+max|df|);
   contrast forward counts and threshold identical and its sums within
   1e-5·(1+max|ref|); both halves of the contrast VJP within
   1e-4·(1+max|df|); the exact kNN's indices and d² identical at the seven
   (M, N, k) of a train step; the CrossMask feature at the four decoder
   shapes, for both fusions, with a continuous ambiguity and with one full
   of exact zeros and ties: its selection and the MIN rows identical,
   MIN_ALL0 within 1e-5·(1+max); its VJP (float atomics) within
   1e-5·(1+max|df|).  Each kernel's bound is worked out beside it: the
   larger of its bytes (inputs read once, outputs written once) over
   3.35 TB/s and its float32 instructions over 33.5 T/s (132 SMs × 128
   lanes × 1.98 GHz; the kernels run without FMA), counted from this run's
   data where the work depends on it;
4. drives the AA eval path: ``BaseSeg_AMContrast3D`` built from
   ``cfgs/s3dis/AMContrast3D-AA.yaml`` (PointNeXt-XL, width 64, blocks
   [1,4,7,4,4], random weights from a seeded generator) through
   ``make_eval_step`` on 5 batches of 4×24000 points (an untimed warm-up
   batch first); checks finite logits, confusion-matrix totals and the
   kernels' launch counts per forward, then repeats one forward with the
   plain ops and compares;
5. drives the AA train path: the same model with ``CrossEntropyAce``,
   AdamW, the cosine schedule and clip 10 from the cfg, dropout from a
   seeded generator, through ``make_train_step`` for 1 untimed and 5 timed
   steps on 4×24000 points labelled by a Voronoi partition into 13
   regions; checks finite losses, changed parameters, confusion-matrix
   totals and each kernel's launches per step, then runs one step from one
   state with the kernels and one with every kernel's plain twin and
   compares stage positions, losses and gradients;
6. drives the MM eval path and the MM train path in the same way:
   ``BaseSeg_M_AMContrast3D`` from ``cfgs/s3dis/AMContrast3D-MM.yaml`` (the
   APM towers and the masked refinement, ``CrossEntropyAcePre``), the cfg
   as it is for the timed runs, which print the refine rate.  With random
   weights the predicted ambiguity sits near 0.5, below the cfg's
   threshold 0.9, so a wrong CrossMask row would change nothing there: the
   two comparisons with the plain ops run on a copy whose threshold is the
   median predicted ambiguity of the batch (eval) or 0.5 (train, where the
   BatchNorm ahead of the last sigmoid centres it), and assert a refine
   rate strictly between 0 and 100 and a non-zero gradient out of the
   CrossMask VJP;
7. prints one JSON line of per-kernel results and, last, the device line.

Any failure raises, so the exit code is non-zero; without a CUDA device it
stops before printing any result.
"""
from __future__ import annotations

import copy
import functools
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

B, N, IN_CH, NUM_CLASSES, N_BATCHES, N_TRAIN = 4, 24000, 4, 13, 5, 5
SEED = 0
REPO = os.path.dirname(os.path.abspath(__file__))
CFGS = {kind: os.path.join(REPO, "cfgs", "s3dis", f"AMContrast3D-{kind.upper()}.yaml")
        for kind in ("aa", "mm")}
TIMING_RUNS, PLAIN_RUNS = 11, 3
# the schedule's epoch length; the 6 steps here stay in epoch 1
STEPS_PER_EPOCH = 1000
# kernel vs plain train step, relative L2 of the gradients (see PERF.md)
GRAD_TOL = 1e-4
# the card's peaks for the bounds: HBM bytes/s, and float32 instructions/s
# without FMA (half of the 67 TFLOP/s that count an FMA as two)
PEAK_BYTES, PEAK_OPS = 3.35e12, 33.5e12
PAIR_OPS = 9          # 3 sub, 3 mul, 2 add, 1 compare per distance test
KNN_K, REFINE_K = 24, 12
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
    ("knn", "amcontrast3d_tpu_torch/csrc/knn.cu",
     "amcontrast3d_tpu/ops/knn_pallas.py:58"),
    ("refine_cross", "amcontrast3d_tpu_torch/csrc/refine.cu",
     "amcontrast3d_tpu/ops/contrast_pallas.py:951"),
    ("refine_cross_backward", "amcontrast3d_tpu_torch/csrc/refine.cu",
     "amcontrast3d_tpu/ops/contrast_pallas.py:1091"),
)
EVAL_LAUNCHES = {"fps": 4, "ball_query": 8, "three_interpolation": 4}
TRAIN_LAUNCHES = {**EVAL_LAUNCHES, "three_interpolation_backward": 4,
                  "contrast_forward": 4, "contrast_grad_rows": 4,
                  "contrast_grad_support": 4, "knn": 7}
LAUNCHES = {
    "aa eval": EVAL_LAUNCHES,
    "aa train": TRAIN_LAUNCHES,
    "mm eval": {**EVAL_LAUNCHES, "refine_cross": 4},
    "mm train": {**TRAIN_LAUNCHES, "refine_cross": 4,
                 "refine_cross_backward": 4},
}


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


def check_equal(name: str, got, want) -> float:
    """Raises unless ``got`` equals ``want``; returns the largest absolute
    difference of the pair as measured (0.0 when they are equal)."""
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: {int((got != want).sum())} of "
                             f"{got.numel()} values differ")
    return (got.to(torch.float64) - want.to(torch.float64)).abs().max().item()


def kernel_phases(ops, dev, rng, tag: str) -> dict:
    """Each kernel at the slice's shapes against its plain twin; returns
    {name: {err, ms, plain_ms, library_ms, bytes, ops}}: the largest error
    over both clouds, and on the uniform cloud the times, bytes and float
    instructions summed over the stages (per forward for the first three,
    per train step for the rest)."""
    from amcontrast3d_tpu_torch.models.pointnext import to_full_list
    from amcontrast3d_tpu_torch.tools.profile_train import voronoi_labels

    radii = to_full_list(0.1, [1, 4, 7, 4, 4], [1, 4, 4, 4, 4], 2)
    channels = [128, 256, 512, 1024]           # coarse C of fp0 … fp3
    up_channels = [64, 128, 256, 512]          # decoder stage widths
    results = {name: {"err": None, "ms": 0.0, "plain_ms": 0.0,
                      "library_ms": None, "bytes": 0.0, "ops": 0.0}
               for name, _, _ in KERNELS}

    def timed(name, cloud, kernel, plain, nbytes, nops, library=None):
        if cloud != "uniform":
            return
        r = results[name]
        r["ms"] += cuda_ms(kernel)
        r["plain_ms"] += cuda_ms(plain, PLAIN_RUNS)
        r["bytes"] += float(nbytes)
        r["ops"] += float(nops)
        if library is not None:
            r["library_ms"] = (r["library_ms"] or 0.0) + cuda_ms(library, PLAIN_RUNS)

    def note(name, err):
        # None until a compared pair's difference has been measured
        results[name]["err"] = max(results[name]["err"] or 0.0, err)

    def randn(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev)

    for cloud, pts in clouds(rng).items():
        p = torch.from_numpy(pts).to(dev)
        stages = [p]
        for s in range(1, 5):                  # 24000 → 6000 → 1500 → 375 → 93
            prev = stages[-1]
            n, npoint = prev.shape[1], prev.shape[1] // 4
            got = ops.furthest_point_sample(prev, npoint)
            note("fps", check_equal(
                f"fps {cloud} stage {s}", got,
                ops.furthest_point_sample_plain(prev, npoint)))
            # per pick: a distance, a running minimum and an argmax compare
            timed("fps", cloud, lambda: ops.furthest_point_sample(prev, npoint),
                  lambda: ops.furthest_point_sample_plain(prev, npoint),
                  B * (n * 12 + npoint * 4), B * npoint * n * (PAIR_OPS + 1))
            stages.append(ops.gather_points(prev, got).contiguous())
        for s in range(1, 5):
            sup, q = stages[s - 1], stages[s]
            for support, query, r in ((sup, q, radii[s][0]), (q, q, radii[s][1])):
                got = ops.ball_query(support, query, r, 32)
                note("ball_query", check_equal(
                    f"ball query {cloud} stage {s} r={r}", got,
                    ops.ball_query_plain(support, query, r, 32)))
                # a query stops at its 32nd hit; a ball with fewer (its last
                # slot repeats the first) scans the whole support
                ns, nq = support.shape[1], query.shape[1]
                scanned = torch.where(got[..., -1] == got[..., 0], ns,
                                      got[..., -1] + 1).sum().item()
                timed("ball_query", cloud,
                      lambda: ops.ball_query(support, query, r, 32),
                      lambda: ops.ball_query_plain(support, query, r, 32),
                      B * ((ns + nq) * 12 + nq * 32 * 4), scanned * PAIR_OPS)
        for s in range(1, 5):
            p1, p2 = stages[s - 1], stages[s]
            n1, n2, c = p1.shape[1], p2.shape[1], channels[s - 1]
            f2 = randn(B, n2, c)
            got = ops.three_interpolation(p1, p2, f2)
            want = ops.three_interpolation_plain(p1, p2, f2)
            note("three_interpolation", check_close(
                f"interpolation {cloud} stage {s}", got, want, 1e-5))
            timed("three_interpolation", cloud,
                  lambda: ops.three_interpolation(p1, p2, f2),
                  lambda: ops.three_interpolation_plain(p1, p2, f2),
                  B * ((n1 + n2) * 12 + (n1 + n2) * c * 4),
                  B * n1 * (n2 * PAIR_OPS + c * 5))
            # the backward on the indices and weights the forward keeps
            idx, w = ops.three_interpolation_weights(p1, p2)
            g = randn(B, n1, c)
            got = ops.three_interpolation_backward(g, idx, w, n2)
            want = ops.three_interpolation_backward_plain(g, idx, w, n2)
            note("three_interpolation_backward", check_close(
                f"interpolation backward {cloud} stage {s}", got, want, 1e-5))
            rows = (idx.long() + n2 * torch.arange(B, device=dev)[:, None, None]
                    ).reshape(-1)
            contrib = (w[..., None] * g[:, :, None, :]).reshape(-1, c)
            timed("three_interpolation_backward", cloud,
                  lambda: ops.three_interpolation_backward(g, idx, w, n2),
                  lambda: ops.three_interpolation_backward_plain(g, idx, w, n2),
                  B * (n1 * (c * 4 + 24) + n2 * c * 4), B * n1 * c * 6,
                  lambda: torch.zeros(B * n2, c, device=dev).index_add_(
                      0, rows, contrib))
        labels = voronoi_labels(rng, pts)
        lab0 = torch.from_numpy(labels.astype(np.float32)).to(dev)
        # the seven kNN calls of a train step: 4 self-kNN for the contrast
        # thresholds and 3 label propagations from stage 0
        knn_calls = [(stages[s], stages[s], KNN_K) for s in range(4)] + \
            [(stages[0], stages[s], 4 ** s) for s in range(1, 4)]
        for sup, q, k in knn_calls:
            got_i, got_d = ops.knn(sup, q, k)
            want_i, want_d = ops.knn_plain(sup, q, k)
            name = f"knn {cloud} M={q.shape[1]} N={sup.shape[1]} k={k}"
            note("knn", check_equal(f"{name} indices", got_i, want_i))
            note("knn", check_equal(f"{name} d2", got_d, want_d))
            ns, nq = sup.shape[1], q.shape[1]
            timed("knn", cloud, lambda: ops.knn(sup, q, k),
                  lambda: ops.knn_plain(sup, q, k),
                  B * ((ns + nq) * 12 + nq * k * 8), B * nq * ns * PAIR_OPS,
                  lambda: torch.topk(torch.cdist(q, sup).square_(), min(k, ns),
                                     largest=False))
        for s in range(4):                     # the contrast stages
            ps = stages[s]
            n, c = ps.shape[1], up_channels[s]
            lab = lab0 if s == 0 else lab0.gather(
                1, ops.knn(stages[0], ps, 1)[0][..., 0].long())
            f = torch.nn.functional.normalize(randn(B, n, c), dim=-1)
            kth = (ops.knn(ps, ps, KNN_K)[1][..., -1] * (1.0 + 1e-5)).contiguous()
            args = (ps, f, lab, kth, 1 / 0.3, False, False, True)
            got = ops.contrast_forward(*args)
            want = ops.contrast_forward_plain(*args)
            check_equal(f"contrast counts {cloud} stage {s}", got[..., 4:6],
                        want[..., 4:6])
            check_equal(f"contrast threshold {cloud} stage {s}", got[..., 8],
                        want[..., 8])
            note("contrast_forward", max(check_close(
                f"contrast column {col} {cloud} stage {s}", got[..., col],
                want[..., col], 1e-5) for col in (0, 1, 6, 7)))
            members = got[..., 4:6].sum().item()
            scan = B * n * n * PAIR_OPS
            io = B * n * (12 + 4 * c + 8)
            timed("contrast_forward", cloud, lambda: ops.contrast_forward(*args),
                  lambda: ops.contrast_forward_plain(*args),
                  io + B * n * 36, scan + members * (2 * c + 12))
            g4 = randn(B, n, 4)
            gargs = (ps, f, lab, kth, g4, 1 / 0.3, False)
            for name, kern, plain in (
                    ("contrast_grad_rows", ops.contrast_grad_rows,
                     ops.contrast_grad_rows_plain),
                    ("contrast_grad_support", ops.contrast_grad_support,
                     ops.contrast_grad_support_plain)):
                note(name, check_close(f"{name} {cloud} stage {s}",
                                       kern(*gargs), plain(*gargs), 1e-4))
                timed(name, cloud, lambda: kern(*gargs), lambda: plain(*gargs),
                      io + B * n * (16 + 4 * c), scan + members * (4 * c + 12))
        for s in range(3, -1, -1):             # the decoder's refinements
            ps = stages[s]
            n, c = ps.shape[1], up_channels[s]
            f, g = randn(B, n, c), randn(B, n, c)
            a_cont = torch.from_numpy(rng.rand(B, n).astype(np.float32)).to(dev)
            a_ties = torch.where(a_cont < 0.4, 0.0, torch.round(a_cont * 4) / 4)
            for a in (a_cont, a_ties):
                for fusion in ("MIN", "MIN_ALL0"):
                    name = f"refine {fusion} {cloud} stage {s}"
                    got, sel = ops.refine_cross(ps, f, a, REFINE_K, fusion, keep=True)
                    want, sel_p = ops.refine_cross_plain(ps, f, a, REFINE_K, fusion)
                    check_equal(f"{name} selection", sel, sel_p)
                    note("refine_cross",
                         check_equal(f"{name} rows", got, want)
                         if fusion == "MIN"
                         else check_close(name, got, want, 1e-5))
                    scale = 1.0 if fusion == "MIN" else 1.0 / (REFINE_K - 1)
                    note("refine_cross_backward", check_close(
                        f"{name} backward",
                        ops.refine_cross_backward(g, sel, scale),
                        ops.refine_cross_backward_plain(g, sel, scale), 1e-5))
            # timed as the cfg runs it: MIN on the continuous ambiguity
            timed("refine_cross", cloud,
                  lambda: ops.refine_cross(ps, f, a_cont, REFINE_K, "MIN", keep=True),
                  lambda: ops.refine_cross_plain(ps, f, a_cont, REFINE_K, "MIN"),
                  B * n * (12 + 4 + 8 * c + 4), B * n * n * PAIR_OPS)
            sel = ops.refine_cross(ps, f, a_cont, REFINE_K, "MIN", keep=True)[1]
            rows = (sel.long() + n * torch.arange(B, device=dev)[:, None, None]
                    ).reshape(-1)
            timed("refine_cross_backward", cloud,
                  lambda: ops.refine_cross_backward(g, sel, 1.0),
                  lambda: ops.refine_cross_backward_plain(g, sel, 1.0),
                  B * n * (8 * c + 4), B * n * c,
                  lambda: torch.zeros(B * n, c, device=dev).index_add_(
                      0, rows, g.view(-1, c)))
    for k, r in results.items():
        if r["err"] is None:
            raise AssertionError(f"kernel {k}: no compared pair was measured")
        r["bound_ms"] = max(r["bytes"] / PEAK_BYTES, r["ops"] / PEAK_OPS) * 1e3
        r["bound_by"] = ("bytes" if r["bytes"] / PEAK_BYTES > r["ops"] / PEAK_OPS
                         else "operations")
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        print(f"kernel {k}: matches plain on uniform and clustered clouds "
              f"(max abs err {r['err']}); summed over stages {r['ms']:.4f} ms "
              f"vs plain {r['plain_ms']:.4f} ms, library call {lib}, bound "
              f"{r['bound_ms']:.4f} ms by {r['bound_by']} ({r['bytes']:.4g} "
              f"bytes, {r['ops']:.4g} float instructions)  [{tag}]")
    return results


def wrappers(ops) -> dict:
    return {"fps": ops.furthest_point_sample, "ball_query": ops.ball_query,
            "three_interpolation": ops.three_interpolation,
            "three_interpolation_backward": ops.three_interpolation_backward,
            "contrast_forward": ops.contrast_forward,
            "contrast_grad_rows": ops.contrast_grad_rows,
            "contrast_grad_support": ops.contrast_grad_support,
            "knn": ops.knn, "refine_cross": ops.refine_cross,
            "refine_cross_backward": ops.refine_cross_backward}


def reset_counts(ops) -> dict:
    counted = wrappers(ops)
    for fn in counted.values():
        fn.launches = 0
    return counted


def check_launches(path: str, counted: dict, runs: int) -> dict:
    """The kernels' launches in a path's run, held against the expected
    number per forward or step."""
    launches = {k: fn.launches for k, fn in counted.items()}
    per_run = {k: v / runs for k, v in launches.items() if v}
    if per_run != LAUNCHES[path]:
        raise AssertionError(f"{path}: launches per run {per_run}, expected "
                             f"{LAUNCHES[path]}")
    return launches


def with_threshold(model, threshold: float):
    """A copy of an MM model whose SelfMask starts at ``threshold``."""
    m = copy.deepcopy(model)
    m.decoder.threshold = float(threshold)
    return m


def eval_path(ops, cfg, model, dev, rng, tag, kind: str) -> dict:
    """The eval main path of ``kind``; returns the kernels' launches in it."""
    from amcontrast3d_tpu_torch.engine import make_eval_step
    from amcontrast3d_tpu_torch.tools.profile_eval import plain_ops

    path = f"{kind} eval"
    model.eval()
    step = make_eval_step(model, cfg.num_classes)
    batches = [{"pos": torch.from_numpy(rng.rand(B, N, 3).astype(np.float32) * 4),
                "x": torch.from_numpy(rng.rand(B, N, IN_CH).astype(np.float32)),
                "y": torch.from_numpy(rng.randint(0, NUM_CLASSES, (B, N)))}
               for _ in range(N_BATCHES + 1)]
    batches = [{k: v.to(dev) for k, v in b.items()} for b in batches]
    counted = reset_counts(ops)
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
    launches = check_launches(path, counted, len(batches))
    print(f"{path} main path: {len(batches)} eval steps at B={B}x{N}, launches "
          f"per forward {LAUNCHES[path]}")

    pos, x = batches[0]["pos"], batches[0]["x"]
    note = ""
    with torch.inference_mode():
        if kind == "mm":
            _, stages, rate = model(pos, x)
            if not 0 <= rate.item() <= 100:
                raise AssertionError(f"refine rate {rate.item()}")
            threshold = torch.cat([a.reshape(-1) for a in stages["ambiguity"]]
                                  ).median().item()
            note = (f"refine rate {rate.item():.3f} % at the cfg's threshold "
                    f"{model.decoder.threshold}; compared at threshold "
                    f"{threshold:.6f}, ")
            model = with_threshold(model, threshold)
        out_k = model(pos, x)
        with plain_ops():
            out_p = model(pos, x)
    if kind == "mm":
        rate = out_k[2].item()
        if not (0 < rate < 100 and rate == out_p[2].item()):
            raise AssertionError(f"refine rate {rate} vs plain {out_p[2].item()}")
        note += f"refine rate {rate:.3f} %, "
    for s, (pk, pp) in enumerate(zip(out_k[1]["p"], out_p[1]["p"])):
        if not torch.equal(pk, pp):
            raise AssertionError(f"stage {s} positions differ from the plain ops")
    err = (out_k[0] - out_p[0]).abs().max().item()
    tol = 1e-4 * (1 + out_p[0].abs().max().item())
    if not err <= tol:
        raise AssertionError(f"logits vs plain ops: max abs err {err} > {tol}")
    print(f"{path} main path vs plain ops on the card: {note}stage positions "
          f"identical, logits max abs err {err} (tol {tol})")
    med = statistics.median(forward_ms)
    print(f"{path} forward B={B}x{N}: per-batch ms {forward_ms}; median "
          f"{med:.3f} ms = {B * N / med * 1e3:.1f} points/s  [{tag}]")
    return launches


def zero_gradient_biases(model) -> set:
    """Names of the biases of a ``Dense_i`` whose output goes straight into
    its sibling ``BatchNorm_i`` in train mode (the APM towers): the batch
    mean cancels them, so their exact gradient is zero."""
    names = set()
    for prefix, mod in model.named_modules():
        for child, sub in mod.named_children():
            norm = child.replace("Dense_", "BatchNorm_")
            if (child.startswith("Dense_") and hasattr(mod, norm)
                    and isinstance(sub, torch.nn.Linear) and sub.bias is not None):
                names.add(f"{prefix}.{child}.bias" if prefix else f"{child}.bias")
    return names


def train_batch(rng, dev) -> dict:
    from amcontrast3d_tpu_torch.tools.profile_train import voronoi_labels

    pos = rng.rand(B, N, 3).astype(np.float32) * 4
    batch = {"pos": torch.from_numpy(pos),
             "x": torch.from_numpy(rng.rand(B, N, IN_CH).astype(np.float32)),
             "y": torch.from_numpy(voronoi_labels(rng, pos))}
    return {k: v.to(dev) for k, v in batch.items()}


def make_step(cfg, model, optimizer, dev, seed, kind: str):
    from amcontrast3d_tpu_torch.engine import make_train_step
    from amcontrast3d_tpu_torch.loss import build_criterion_from_cfg
    from amcontrast3d_tpu_torch.scheduler import (as_step_schedule,
                                                  build_scheduler_from_cfg)
    lr_fn, _ = build_scheduler_from_cfg(cfg)
    criterion_args = (cfg.criterion_args_AcePre if kind == "mm"
                      else cfg.criterion_args_Ace)
    return make_train_step(
        model, build_criterion_from_cfg(criterion_args), optimizer,
        as_step_schedule(lr_fn, STEPS_PER_EPOCH), kind, cfg.num_classes,
        cfg.ignore_index, cfg.ambiguity_args, cfg.grad_norm_clip,
        torch.Generator(dev).manual_seed(seed))


def train_path(ops, cfg, model, dev, rng, tag, kind: str) -> dict:
    """The train main path of ``kind``; returns the kernels' launches in it."""
    from amcontrast3d_tpu_torch.optim import build_optimizer_from_cfg

    path = f"{kind} train"
    terms = ("loss",) if kind == "aa" else (
        "loss", "loss_seg", "loss_ce", "loss_contrast", "loss_reg")
    optimizer = build_optimizer_from_cfg(cfg.optimizer, model, lr=cfg.lr)
    step = make_step(cfg, model, optimizer, dev, SEED, kind)
    batches = [train_batch(rng, dev) for _ in range(N_TRAIN + 1)]
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    counted = reset_counts(ops)
    step_ms, losses, rates = [], [], []
    for i, batch in enumerate(batches):
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = step(batch)
        torch.cuda.synchronize()
        if i:   # step 0 warms cuBLAS and the allocator up, untimed
            step_ms.append((time.perf_counter() - t) * 1e3)
        losses.append({k: out[k].item() for k in terms})
        if not all(np.isfinite(v) for v in losses[-1].values()):
            raise AssertionError(f"{path} step {i}: {losses[-1]}")
        if kind == "mm":
            rates.append(out["refine_rate"].item())
            if not 0 <= rates[-1] <= 100:
                raise AssertionError(f"{path} step {i}: refine rate {rates[-1]}")
        if int(out["cm"].sum()) != B * N:
            raise AssertionError(f"{path} step {i}: confusion matrix counts "
                                 f"{int(out['cm'].sum())}")
    launches = check_launches(path, counted, len(batches))
    still = [n for n, p in model.named_parameters()
             if torch.equal(start[n], p.detach())]
    # a bias ahead of a BatchNorm has an exact gradient of zero, so only
    # rounding noise moves it: every other tensor has to move, the APM's
    # weights and its BatchNorm scales and shifts too
    exempt = zero_gradient_biases(model)
    if set(still) - exempt:
        raise AssertionError(f"{path}: parameters did not change: "
                             f"{sorted(set(still) - exempt)}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    med = statistics.median(step_ms)
    print(f"{path} main path: {len(batches)} steps at B={B}x{N}, losses "
          f"{losses}, {len(start) - len(still)} of {len(start)} parameter "
          f"tensors changed (unchanged, each a bias ahead of a BatchNorm: "
          f"{still}), launches per "
          f"step {LAUNCHES[path]}"
          + (f", refine rate % {rates}" if kind == "mm" else ""))
    print(f"{path} step B={B}x{N}: per-step ms {step_ms}; median {med:.3f} ms "
          f"= {B * N / med * 1e3:.1f} train points/s; peak "
          f"{peak:.3f} GiB  [{tag}]")
    train_vs_plain(cfg, model, optimizer, dev, batches[0], tag, kind)
    return launches


def train_vs_plain(cfg, model, optimizer, dev, batch, tag, kind: str):
    """One step from one state with the kernels and one with the twins."""
    from amcontrast3d_tpu_torch.ops import refine as ops_refine
    from amcontrast3d_tpu_torch.optim import build_optimizer_from_cfg
    from amcontrast3d_tpu_torch.tools.profile_eval import plain_ops

    runs = {}
    for name in ("kernels", "plain"):
        m = with_threshold(model, 0.5) if kind == "mm" else copy.deepcopy(model)
        opt = build_optimizer_from_cfg(cfg.optimizer, m, lr=cfg.lr)
        opt.load_state_dict(optimizer.state_dict())
        stages, vjp_max = {}, []
        hook = m.register_forward_hook(
            lambda mod, inp, out: stages.update(p=out[1]["p"]))
        step = make_step(cfg, m, opt, dev, SEED + 1, kind)

        @functools.wraps(ops_refine.refine_cross_backward)
        def recording_vjp(*args, _fn=ops_refine.refine_cross_backward):
            df = _fn(*args)
            vjp_max.append(df.abs().max())
            return df

        with ExitStack() as stack:
            if name == "plain":
                stack.enter_context(plain_ops())
            else:
                stack.enter_context(mock.patch.object(
                    ops_refine, "refine_cross_backward", recording_vjp))
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = step(batch)
            loss = out["loss"].item()
            torch.cuda.synchronize()
        hook.remove()
        runs[name] = {"loss": loss, "p": stages["p"],
                      "ms": (time.perf_counter() - t) * 1e3,
                      "rate": out["refine_rate"].item() if kind == "mm" else None,
                      "vjp_max": [v.item() for v in vjp_max],
                      "grads": [p.grad.detach().clone() for p in m.parameters()]}
    k, p = runs["kernels"], runs["plain"]
    note = ""
    if kind == "mm":
        if not (0 < k["rate"] < 100 and k["rate"] == p["rate"]):
            raise AssertionError(f"refine rate {k['rate']} vs plain {p['rate']}")
        if len(k["vjp_max"]) != 4 or not max(k["vjp_max"]) > 0:
            raise AssertionError("no gradient came out of the CrossMask VJP: "
                                 f"{k['vjp_max']}")
        note = (f"threshold 0.5, refine rate {k['rate']:.3f} %, CrossMask VJP "
                f"max |df| per stage {k['vjp_max']}, ")
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
    print(f"{kind} train step vs plain ops on the card: {note}stage positions "
          f"identical, loss {k['loss']} vs {p['loss']} (rel {rel_loss:.3e}), "
          f"gradients relative L2 {rel_grad:.3e} over all parameters (worst "
          f"tensor {worst:.3e}); step {k['ms']:.1f} ms vs plain "
          f"{p['ms']:.1f} ms  [{tag}]")


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

    by_path = {}
    for kind in ("aa", "mm"):
        cfg = EasyConfig()
        cfg.load(CFGS[kind], recursive=True)
        model = build_model_from_cfg(cfg.model)
        init_weights_(model, torch.Generator().manual_seed(SEED))
        model = model.to(dev)
        by_path[f"{kind} eval"] = eval_path(ops, cfg, model, dev, rng, tag, kind)
        by_path[f"{kind} train"] = train_path(ops, cfg, model, dev, rng, tag, kind)
        del model
        torch.cuda.empty_cache()

    rows = [{"name": k, "route": "cuda", "source": src, "replaces": tpu,
             "launches": sum(counts[k] for counts in by_path.values()),
             "launches_by_path": {path: counts[k]
                                  for path, counts in by_path.items()},
             "max_abs_err": kernels[k]["err"], "ms": kernels[k]["ms"],
             "plain_ms": kernels[k]["plain_ms"],
             "bound_ms": kernels[k]["bound_ms"],
             "bound_by": kernels[k]["bound_by"],
             "library_ms": kernels[k]["library_ms"]}
            for k, src, tpu in KERNELS]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
