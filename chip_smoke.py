"""Smoke run of the PyTorch port on one NVIDIA GPU: build, check, time.

    python3 chip_smoke.py

1. prints the card (nvidia-smi name and power limit) and the PyTorch and
   CUDA versions, and turns TF32 off;
2. builds the CUDA kernels of ``amcontrast3d_tpu_torch/csrc`` (set-up time);
3. runs each of the ten kernels of the step functions at the shapes of the
   AA and MM train steps at B=4×24000 (stage positions from FPS, on a uniform and a clustered
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
   ``make_eval_step`` on 3 batches of 4×24000 points (an untimed warm-up
   batch first); checks finite logits, confusion-matrix totals and the
   kernels' launch counts per forward, then repeats one forward with the
   plain ops and compares;
5. drives the AA train path: the same model with ``CrossEntropyAce``,
   AdamW, the cosine schedule and clip 10 from the cfg, dropout from a
   seeded generator, through ``make_train_step`` for 1 untimed and 3 timed
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
7. runs the three whole-room kernels at the shapes of a 155648-point
   subcloud (B = 1), on a room-like cloud (the faces of a room and solid
   boxes on a 0.04 m grid, with repeated points) and a uniform one: the
   whole-room FPS at the four stages (its cluster kernel, and its grid
   kernel beside it) and at 1.2 M points (the grid kernel; 4096 picks, on a
   uniform and a clustered cloud), picks identical to the twin; the
   chunk-skipping ball query at the three (M, N, r) pairs whose support
   exceeds 32768 points, indices identical to the twin and to the
   scan-everything kernel, with the share of chunk visits it skips; the
   chunk-skipping kNN (self-kNN, k = 24), indices and d² identical to the
   twin and to the scan-everything kernel.  Each with its time, the twin's
   (one run), the bound and, for the kNN, ``topk`` of ``cdist``² in tiles.
   The two chunk-skipping kernels' bounds count what this run's data needs
   of a box-pruned scan: 18 float instructions per (query, chunk) box test
   and 9 per point of the chunks whose bound admits them;
8. drives the whole-scene test path through ``engine.cli.main_cli``
   (``mode=test``, ``miou_B_I=True``) at full width: AA on two Synthetic
   rooms of 250000 raw points whose voxel-rank subclouds (91478 and 130575
   points) pad to the buckets 106496 and 155648, MM on the first room; the
   weights are seeded random ones written with ``save_checkpoint`` and read
   back through ``pretrained_path=``.  Checks finite logits, the
   confusion-matrix total against the rooms' points, boundary + inner
   totals against the sum of subcloud sizes, the launches per subcloud
   forward, the results CSV and the checkpoint round trip (identical
   logits); then scores one subcloud again with every kernel's plain twin
   (stage positions identical, logits within 1e-4·(1+max|logit|), boundary
   mask identical; MM at the cfg's threshold and at the median predicted
   ambiguity).  Prints per room the wall time, the voted points per
   second, the split host prep / forward / voting / boundary kNN and the
   peak device memory;
9. runs the kernels of the ScanNet recipe's train step at its shapes
   (B = 2 clouds of 64000 points on a 0.02 m grid, 16000 coarse points):
   the support-owned interpolation VJP at (2, 64000 → 16000, C = 128)
   against its twin within 1e-5·(1+max|df2|) and against itself (two runs,
   identical bits), and at a shape that is a multiple of no tile with a
   support row no query selects (exactly 0), with its time, its bound, the
   twin's and ``index_add_``'s time and the scatter kernel's on the same
   input, and both kernels again at the S3DIS recipe's largest shape
   (4, 24000 → 6000, C = 128); the batched FPS 2 × 64000 → 16000 (one
   cluster a cloud), picks identical to the twin, and the grid kernel cloud
   by cloud beside it; the three contrast kernels at (2, 64000, 64), the
   large-cloud kNN (64000², k = 24) and ball query (16000 × 64000,
   r = 0.05) at B = 2 against their twins;
10. drives the train CLI at full width through ``engine.cli.main_cli`` on
   Synthetic rooms, with the recipes' loaders (6 workers), train transforms,
   schedules and checkpoints: the ScanNet recipe
   (``cfgs/scannet/AMContrast3D-AA.yaml``: B = 2 × 64000, 7 input channels,
   20 classes, multistep with the milestones pulled in to epochs 2 and 3)
   for two epochs of 4 steps with validation each epoch, then
   ``mode=resume`` from ``latest`` for a third; and the S3DIS recipe, AA and
   MM, for two epochs of 3 steps at B = 4 × 24000.  Checks finite losses, the
   confusion-matrix totals, the learning rate of every epoch (the resumed
   one included), ``scalars.jsonl``, the launches per train step (ScanNet:
   the support-owned VJP once, the scatter kernel 3 times, the batched
   cluster FPS once; S3DIS: the scatter kernel 4 times and the support-owned
   one never) and per validation forward, parameters that moved, identical
   logits from the ``latest`` checkpoint read back, and one ScanNet train
   step with the kernels against one with every plain twin from the same
   state (some labels ignored).  Prints per recipe the step time and the
   train points/s through the loader, the bare step's beside it, the
   seconds the loop waited on the loader and the peak device memory;
11. prints one JSON line of per-kernel results and, last, the device line.

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
import tempfile
import time
from contextlib import ExitStack
from unittest import mock

import numpy as np
import torch

B, N, IN_CH, NUM_CLASSES, N_BATCHES, N_TRAIN = 4, 24000, 4, 13, 3, 3
SEED = 0
REPO = os.path.dirname(os.path.abspath(__file__))
CFGS = {kind: os.path.join(REPO, "cfgs", "s3dis", f"AMContrast3D-{kind.upper()}.yaml")
        for kind in ("aa", "mm")}
TIMING_RUNS, PLAIN_RUNS = 11, 3
# the schedule's epoch length; the 4 steps here stay in epoch 1
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
    ("fps_b1", "amcontrast3d_tpu_torch/csrc/fps_b1.cu",
     "amcontrast3d_tpu/ops/fps_pallas.py:87"),
    ("knn_big", "amcontrast3d_tpu_torch/csrc/knn_big.cu",
     "amcontrast3d_tpu/ops/knn_pallas.py:117"),
    ("ball_query_big", "amcontrast3d_tpu_torch/csrc/ball_query_big.cu",
     "amcontrast3d_tpu/ops/knn_pallas.py:224"),
    ("three_interpolation_backward_big",
     "amcontrast3d_tpu_torch/csrc/interpolate_bwd_big.cu",
     "amcontrast3d_tpu/ops/interpolate_pallas.py:220"),
)
STEP_KERNELS = KERNELS[:10]      # the kernels of the four step paths
# the whole-scene paths: Synthetic rooms of SCENE_POINTS raw points from the
# dataset's seed 0; the first two voxelise (0.04 m) to 91478 and 130575
# points, which pad to the buckets 106496 and 155648
SCENE_POINTS, SCENE_ROOMS, SCENE_BUCKETS = 250000, {"aa": 2, "mm": 1}, (106496, 155648)
BIG_N = 32768                    # ops/knn.py::_BIG_N
ROOM_N, HUGE_N, HUGE_PICKS = 155648, 1200000, 4096
FPS_OPS = PAIR_OPS + 1           # a distance, a running minimum, a compare
BOX_OPS = 18                     # 6 sub, 6 max, 3 mul, 2 add, 1 compare
CHUNK = 64                       # ops/spatial.py::CHUNK
EVAL_LAUNCHES = {"fps": 4, "ball_query": 8, "three_interpolation": 4}
TRAIN_LAUNCHES = {**EVAL_LAUNCHES, "three_interpolation_backward": 4,
                  "contrast_forward": 4, "contrast_grad_rows": 4,
                  "contrast_grad_support": 4, "knn": 7}
# the ScanNet recipe: 2 x 64000 -> 16000 -> 4000 -> 1000 -> 250; only the
# 64000-point support exceeds BIG_N (one ball query, one self-kNN and the
# three label propagations), fp0's backward exceeds the query-buffer gate,
# and the first FPS exceeds the batched kernel's shared memory
SCANNET_CFG = os.path.join(REPO, "cfgs", "scannet", "AMContrast3D-AA.yaml")
SCANNET_B, SCANNET_N, SCANNET_CLASSES = 2, 64000, 20
SCANNET_LAUNCHES = {
    "fps_b1": 1, "fps": 3, "ball_query_big": 1, "ball_query": 7,
    "three_interpolation": 4, "three_interpolation_backward_big": 1,
    "three_interpolation_backward": 3, "contrast_forward": 4,
    "contrast_grad_rows": 4, "contrast_grad_support": 4, "knn_big": 4, "knn": 3}
CLI_LIMIT_S = 420     # a train CLI phase that hangs (a worker pool) is cut
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
               for name, _, _ in STEP_KERNELS}

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
    return finish_kernels(results, "uniform and clustered", tag)


def finish_kernels(results: dict, clouds_note: str, tag: str) -> dict:
    """Work out each kernel's bound from its bytes and operations, print
    its line and return ``results``."""
    for k, r in results.items():
        if r["err"] is None:
            raise AssertionError(f"kernel {k}: no compared pair was measured")
        r["bound_ms"] = max(r["bytes"] / PEAK_BYTES, r["ops"] / PEAK_OPS) * 1e3
        r["bound_by"] = ("bytes" if r["bytes"] / PEAK_BYTES > r["ops"] / PEAK_OPS
                         else "operations")
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        print(f"kernel {k}: matches plain on {clouds_note} clouds "
              f"(max abs err {r['err']}); summed over stages {r['ms']:.4f} ms "
              f"vs plain {r['plain_ms']:.4f} ms, library call {lib}, bound "
              f"{r['bound_ms']:.4f} ms by {r['bound_by']} ({r['bytes']:.4g} "
              f"bytes, {r['ops']:.4g} float instructions)  [{tag}]")
    return results


def timed_once(fn):
    """``fn()`` and its device time in ms (one run, no warm-up: for the
    plain twins at whole-room sizes, which take seconds)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def room_cloud(rng, n: int) -> np.ndarray:
    """(1, n, 3) f32 room-like cloud: the six faces of a 7 x 6 x 3 m room
    (1 cm of noise) and four solid boxes, one point per 0.04 m voxel, 2 % of
    the points repeated (as bucket padding repeats real points)."""
    pts = rng.rand(4 * n, 3) * [7, 6, 3]
    axis = rng.randint(0, 3, len(pts))
    side = rng.randint(0, 2, len(pts)) * np.array([7, 6, 3])[axis]
    pts[np.arange(len(pts)), axis] = side + 0.01 * rng.randn(len(pts))
    solid = rng.rand(n, 3) * [1.2, 1.0, 0.8] + \
        rng.randint(1, 5, (n, 1)) * [1.2, 1.0, 0.0]
    pts = np.concatenate([pts, solid])
    _, first = np.unique(np.floor(pts / 0.04).astype(np.int64), axis=0,
                         return_index=True)
    if len(first) < n:
        raise AssertionError(f"room holds {len(first)} voxels, fewer than {n}")
    pts = pts[rng.permutation(first)[:n]]
    pts[rng.randint(0, n, n // 50)] = pts[rng.randint(0, n, n // 50)]
    return pts[None].astype(np.float32)


def chunk_visits(spatial, support, query, limit, strict: bool):
    """(visits, pairs): the (query, chunk) pairs whose box lower bound lies
    below ``limit`` (``<`` if strict, else ``<=``; a number or one per
    query), the chunks any box-pruned scan has to read, and all pairs."""
    cloud = spatial.sort_support(support)
    visits = 0
    for s in range(0, query.shape[1], 4096):
        lb = spatial.bbox_lb(query[:, s:s + 4096, None, :], cloud.boxes[:, None])
        lim = limit[:, s:s + 4096, None] if torch.is_tensor(limit) else limit
        visits += int((lb < lim if strict else lb <= lim).sum())
    return visits, query.shape[1] * cloud.boxes.shape[1]


def scene_kernel_phases(ops, dev, rng, tag: str) -> dict:
    """The three whole-room kernels against their twins (and against the
    scan-everything kernels they take over from) at the shapes of a
    155648-point subcloud; returns the same records as ``kernel_phases``,
    with the times of the room-like cloud."""
    from amcontrast3d_tpu_torch.ops import spatial

    results = {name: {"err": None, "ms": 0.0, "plain_ms": 0.0,
                      "library_ms": None, "bytes": 0.0, "ops": 0.0}
               for name in ("fps_b1", "knn_big", "ball_query_big")}

    def note(name, err):
        results[name]["err"] = max(results[name]["err"] or 0.0, err)

    def add(name, timed, ms, plain_ms, nbytes, nops):
        if timed:
            r = results[name]
            r["ms"] += ms
            r["plain_ms"] += plain_ms
            r["bytes"] += float(nbytes)
            r["ops"] += float(nops)

    clouds = {"room": room_cloud(rng, ROOM_N),
              "uniform": (rng.rand(1, ROOM_N, 3) * [7, 6, 3]).astype(np.float32)}
    for cloud, pts in clouds.items():
        timed = cloud == "room"
        stages = [torch.from_numpy(pts).to(dev)]
        for s in range(1, 5):              # 155648 → 38912 → 9728 → 2432 → 608
            prev = stages[-1]
            n, npoint = prev.shape[1], prev.shape[1] // 4
            got = ops.furthest_point_sample_b1(prev, npoint)
            want, plain_ms = timed_once(
                lambda: ops.furthest_point_sample_plain(prev, npoint))
            note("fps_b1", check_equal(f"fps_b1 {cloud} stage {s}", got, want))
            # these sizes take the cluster kernel; the grid kernel beside it
            check_equal(f"fps_b1 {cloud} stage {s}, the grid kernel",
                        ops.fps._fps_b1_grid(prev, npoint), want)
            ms = cuda_ms(lambda: ops.furthest_point_sample_b1(prev, npoint), 5)
            grid_ms = cuda_ms(lambda: ops.fps._fps_b1_grid(prev, npoint), 3)
            print(f"fps_b1 {cloud} {n} -> {npoint}: {ms:.3f} ms = "
                  f"{ms / npoint * 1e3:.3f} us a pick (one cluster), the grid "
                  f"kernel {grid_ms:.3f} ms = {grid_ms / npoint * 1e3:.3f} us a "
                  f"pick, plain {plain_ms:.1f} ms  [{tag}]")
            add("fps_b1", timed, ms, plain_ms, n * 12 + npoint * 4,
                npoint * n * FPS_OPS)
            stages.append(ops.gather_points(prev, got).contiguous())
        for sup, q, r in ((stages[0], stages[1], 0.1), (stages[1], stages[1], 0.2),
                          (stages[1], stages[2], 0.2)):
            ns, nq = sup.shape[1], q.shape[1]
            name = f"ball_query_big {cloud} {nq} x {ns} r={r}"
            got = ops.ball_query_big(sup, q, r, 32)
            want, plain_ms = timed_once(lambda: ops.ball_query_plain(sup, q, r, 32))
            note("ball_query_big", check_equal(f"{name} vs plain", got, want))
            check_equal(f"{name} vs the scan-everything kernel", got,
                        ops.ball_query_small(sup, q, r, 32))
            ms = cuda_ms(lambda: ops.ball_query_big(sup, q, r, 32))
            small_ms = cuda_ms(lambda: ops.ball_query_small(sup, q, r, 32))
            # what this data needs: a box test per (query, chunk) and a
            # distance test per point of the chunks that reach into the ball;
            # beside it the dense scan in index order of the small-cloud
            # kernel: to the 32nd hit, or the whole support
            visits, pairs = chunk_visits(spatial, sup, q,
                                         float(np.float32(r * r)), True)
            scanned = torch.where(got[..., -1] == got[..., 0], ns,
                                  got[..., -1] + 1).sum().item()
            print(f"{name}: {ms:.3f} ms, scan-everything kernel {small_ms:.3f} "
                  f"ms (its bound {scanned * PAIR_OPS / PEAK_OPS * 1e3:.3f} ms), "
                  f"plain {plain_ms:.1f} ms, chunk visits skipped "
                  f"{100 * (1 - visits / pairs):.3f} %  [{tag}]")
            add("ball_query_big", timed, ms, plain_ms,
                (ns + nq) * 12 + nq * 32 * 4,
                pairs * BOX_OPS + visits * CHUNK * PAIR_OPS)
        p = stages[0]
        name = f"knn_big {cloud} self-kNN {ROOM_N} k={KNN_K}"
        got_i, got_d = ops.knn_big(p, p, KNN_K)
        (want_i, want_d), plain_ms = timed_once(lambda: ops.knn_plain(p, p, KNN_K))
        note("knn_big", check_equal(f"{name} indices", got_i, want_i))
        note("knn_big", check_equal(f"{name} d2", got_d, want_d))
        small_i, small_d = ops.knn_small(p, p, KNN_K)
        check_equal(f"{name} indices vs the scan-everything kernel", got_i, small_i)
        check_equal(f"{name} d2 vs the scan-everything kernel", got_d, small_d)
        ms = cuda_ms(lambda: ops.knn_big(p, p, KNN_K))
        small_ms = cuda_ms(lambda: ops.knn_small(p, p, KNN_K), 3)

        def library():
            for s in range(0, ROOM_N, 2048):
                torch.topk(torch.cdist(p[:, s:s + 2048], p).square_(), KNN_K,
                           largest=False)
        library_ms = cuda_ms(library, 1)
        # what this data needs: a box test per (query, chunk) and a distance
        # test per point of the chunks whose bound is not above the query's
        # final k-th d²; beside it the dense scan of the small-cloud kernel
        visits, pairs = chunk_visits(spatial, p, p, got_d[..., -1], False)
        print(f"{name}: {ms:.3f} ms, scan-everything kernel {small_ms:.3f} ms "
              f"(its bound {ROOM_N * ROOM_N * PAIR_OPS / PEAK_OPS * 1e3:.3f} ms), "
              f"plain {plain_ms:.1f} ms, topk(cdist^2) in tiles "
              f"{library_ms:.1f} ms, chunk visits needed "
              f"{visits / ROOM_N:.2f} a query of {pairs // ROOM_N}  [{tag}]")
        add("knn_big", timed, ms, plain_ms, 2 * ROOM_N * 12 + ROOM_N * KNN_K * 8,
            pairs * BOX_OPS + visits * CHUNK * PAIR_OPS)
        if timed:
            results["knn_big"]["library_ms"] = library_ms
    # above 2^20 points, a few thousand picks (the twin the same ones)
    blobs = rng.rand(64, 3) * [7, 6, 3]
    huge = {"uniform": rng.rand(1, HUGE_N, 3) * [7, 6, 3],
            "clustered": blobs[rng.randint(0, 64, HUGE_N)][None]
            + 0.05 * rng.randn(1, HUGE_N, 3)}
    for cloud, pts in huge.items():
        p = torch.from_numpy(pts.astype(np.float32)).to(dev)
        got = ops.furthest_point_sample_b1(p, HUGE_PICKS)
        want, plain_ms = timed_once(
            lambda: ops.furthest_point_sample_plain(p, HUGE_PICKS))
        note("fps_b1", check_equal(f"fps_b1 {cloud} {HUGE_N}", got, want))
        ms = cuda_ms(lambda: ops.furthest_point_sample_b1(p, HUGE_PICKS), 3)
        print(f"fps_b1 {cloud} {HUGE_N} -> {HUGE_PICKS}: {ms:.3f} ms = "
              f"{ms / HUGE_PICKS * 1e3:.3f} us a pick (the grid kernel), plain "
              f"{plain_ms:.1f} ms  [{tag}]")
    return finish_kernels(results, "room-like and uniform", tag)


def scannet_kernel_phases(ops, dev, rng, tag: str) -> dict:
    """The kernels of the ScanNet recipe's train step at its shapes, B = 2
    clouds of 64000 points that differ; returns the record of the
    support-owned interpolation VJP (the other kernels' records come from the
    phases at their own main shapes)."""
    results = {"three_interpolation_backward_big": {
        "err": None, "ms": 0.0, "plain_ms": 0.0, "library_ms": None,
        "bytes": 0.0, "ops": 0.0}}
    r10 = results["three_interpolation_backward_big"]
    nb, n1 = SCANNET_B, SCANNET_N
    # two rooms on a 0.02 m grid, the second one smaller and shifted
    pts = np.concatenate([room_cloud(rng, n1) * 0.5,
                          room_cloud(rng, n1) * 0.4 + 0.3])
    p = torch.from_numpy(pts.astype(np.float32)).to(dev)

    # the batched FPS above the shared-memory limit of fps.cu
    npoint = n1 // 4
    got = ops.furthest_point_sample(p, npoint)
    want, plain_ms = timed_once(lambda: ops.furthest_point_sample_plain(p, npoint))
    check_equal(f"fps {nb}x{n1} -> {npoint}", got, want)
    one_by_one = torch.cat([ops.fps._fps_b1_grid(p[b:b + 1], npoint)
                            for b in range(nb)])
    check_equal(f"fps {nb}x{n1} -> {npoint}, the grid kernel cloud by cloud",
                one_by_one, want)
    ms = cuda_ms(lambda: ops.furthest_point_sample(p, npoint), 5)
    grid_ms = cuda_ms(lambda: [ops.fps._fps_b1_grid(p[b:b + 1], npoint)
                               for b in range(nb)], 3)
    print(f"fps {nb}x{n1} -> {npoint}: picks identical to the twin; one cluster "
          f"a cloud in one launch {ms:.3f} ms = {ms / npoint * 1e3:.3f} us a "
          f"pick, the grid kernel cloud by cloud ({nb} launches) {grid_ms:.3f} "
          f"ms, plain {plain_ms:.1f} ms, bound "
          f"{nb * npoint * n1 * FPS_OPS / PEAK_OPS * 1e3:.3f} ms by operations  "
          f"[{tag}]")
    q = ops.gather_points(p, got).contiguous()

    # the interpolation VJP: ScanNet's fp0, then S3DIS's fp0
    def vjp_case(p1, p2, c, timed: bool):
        b, m1, m2 = p1.shape[0], p1.shape[1], p2.shape[1]
        idx, w = ops.three_interpolation_weights(p1, p2)
        g = torch.from_numpy(rng.randn(b, m1, c).astype(np.float32)).to(dev)
        name = f"interpolation backward ({b}, {m1} -> {m2}, C={c})"
        got = ops.three_interpolation_backward_big(g, idx, w, m2)
        again = ops.three_interpolation_backward_big(g, idx, w, m2)
        want = ops.three_interpolation_backward_plain(g, idx, w, m2)
        err = check_close(f"{name} support-owned vs plain", got, want, 1e-5)
        check_equal(f"{name} support-owned, two runs", got, again)
        check_close(f"{name} scatter vs plain",
                    ops.three_interpolation_backward_small(g, idx, w, m2),
                    want, 1e-5)
        r10["err"] = max(r10["err"] or 0.0, err)
        rows = (idx.long() + m2 * torch.arange(b, device=dev)[:, None, None]
                ).reshape(-1)
        contrib = (w[..., None] * g[:, :, None, :]).reshape(-1, c)
        big_ms = cuda_ms(lambda: ops.three_interpolation_backward_big(g, idx, w, m2))
        small_ms = cuda_ms(
            lambda: ops.three_interpolation_backward_small(g, idx, w, m2))
        plain_ms = cuda_ms(
            lambda: ops.three_interpolation_backward_plain(g, idx, w, m2), PLAIN_RUNS)
        lib_ms = cuda_ms(lambda: torch.zeros(b * m2, c, device=dev).index_add_(
            0, rows, contrib), PLAIN_RUNS)
        nbytes = b * (m1 * (c * 4 + 24) + m2 * c * 4)
        nops = b * m1 * c * 6
        bound = max(nbytes / PEAK_BYTES, nops / PEAK_OPS) * 1e3
        gate = "support-owned" if ops.interpolate.backward_is_big(m1, c) \
            else "scatter"
        print(f"{name}: the support-owned kernel {big_ms:.4f} ms, the scatter "
              f"kernel {small_ms:.4f} ms (the dispatch takes the {gate} one), "
              f"plain {plain_ms:.4f} ms, index_add_ {lib_ms:.4f} ms, bound "
              f"{bound:.4f} ms; max abs err {err}, two runs identical  [{tag}]")
        if timed:
            r10.update(ms=big_ms, plain_ms=plain_ms, library_ms=lib_ms,
                       bytes=float(nbytes), ops=float(nops))

    vjp_case(p, q, 128, timed=True)
    uni = torch.from_numpy(rng.rand(B, N, 3).astype(np.float32) * 4).to(dev)
    uni_q = ops.gather_points(uni, ops.furthest_point_sample(uni, N // 4)).contiguous()
    vjp_case(uni, uni_q, 128, timed=False)
    # a multiple of no tile; coarse row 7 lies far away, so no query selects it
    odd, odd_q = p[:, :4099].contiguous(), q[:, :1031].clone()
    odd_q[:, 7] += 100.0
    idx, w = ops.three_interpolation_weights(odd, odd_q)
    g = torch.from_numpy(rng.randn(nb, 4099, 200).astype(np.float32)).to(dev)
    got = ops.three_interpolation_backward_big(g, idx, w, 1031)
    r10["err"] = max(r10["err"], check_close(
        "interpolation backward (2, 4099 -> 1031, C=200)", got,
        ops.three_interpolation_backward_plain(g, idx, w, 1031), 1e-5))
    if (idx == 7).any() or got[:, 7].any():
        raise AssertionError("an unselected support row is not zero")

    # the large-cloud kernels with two clouds a call
    for name, sup, query, k in (("self-kNN", p, p, KNN_K),
                                ("label propagation", p, q, 4)):
        got_i, got_d = ops.knn(sup, query, k)
        (want_i, want_d), plain_ms = timed_once(lambda: ops.knn_plain(sup, query, k))
        check_equal(f"knn_big B={nb} {name} indices", got_i, want_i)
        check_equal(f"knn_big B={nb} {name} d2", got_d, want_d)
        ms = cuda_ms(lambda: ops.knn(sup, query, k), 5)
        print(f"knn_big B={nb} {name} {query.shape[1]} x {n1} k={k}: identical "
              f"to the twin, {ms:.3f} ms vs plain {plain_ms:.1f} ms  [{tag}]")
    got = ops.ball_query(p, q, 0.05, 32)
    want, plain_ms = timed_once(lambda: ops.ball_query_plain(p, q, 0.05, 32))
    check_equal(f"ball_query_big B={nb} {npoint} x {n1} r=0.05", got, want)
    ms = cuda_ms(lambda: ops.ball_query(p, q, 0.05, 32), 5)
    print(f"ball_query_big B={nb} {npoint} x {n1} r=0.05: identical to the "
          f"twin, {ms:.3f} ms vs plain {plain_ms:.1f} ms  [{tag}]")

    # the contrast kernels: n * n is past 2^31
    c = 64
    f = torch.nn.functional.normalize(torch.from_numpy(
        rng.randn(nb, n1, c).astype(np.float32)).to(dev), dim=-1)
    lab = torch.from_numpy(rng.randint(0, SCANNET_CLASSES, (nb, n1))
                           .astype(np.float32)).to(dev)
    lab[:, ::9] = -100.0
    kth = (ops.knn(p, p, KNN_K)[1][..., -1] * (1.0 + 1e-5)).contiguous()
    args = (p, f, lab, kth, 1 / 0.5, False, False, True)
    got = ops.contrast_forward(*args)
    want, plain_ms = timed_once(lambda: ops.contrast_forward_plain(*args))
    check_equal("contrast counts at 64000", got[..., 4:6], want[..., 4:6])
    check_equal("contrast threshold at 64000", got[..., 8], want[..., 8])
    err = max(check_close(f"contrast column {col} at 64000", got[..., col],
                          want[..., col], 1e-5) for col in (0, 1, 6, 7))
    line = [f"forward {cuda_ms(lambda: ops.contrast_forward(*args), 3):.3f} ms "
            f"vs plain {plain_ms:.1f} ms (max abs err {err})"]
    g4 = torch.from_numpy(rng.randn(nb, n1, 4).astype(np.float32)).to(dev)
    gargs = (p, f, lab, kth, g4, 1 / 0.5, False)
    for name, kern, plain in (("rows", ops.contrast_grad_rows,
                               ops.contrast_grad_rows_plain),
                              ("support", ops.contrast_grad_support,
                               ops.contrast_grad_support_plain)):
        want, plain_ms = timed_once(lambda: plain(*gargs))
        err = check_close(f"contrast_grad_{name} at 64000", kern(*gargs), want, 1e-4)
        line.append(f"{name} {cuda_ms(lambda: kern(*gargs), 3):.3f} ms vs plain "
                    f"{plain_ms:.1f} ms (max abs err {err})")
    print(f"contrast kernels at ({nb}, {n1}, {c}), "
          f"bound {nb * n1 * n1 * PAIR_OPS / PEAK_OPS * 1e3:.3f} ms each by "
          f"operations: {'; '.join(line)}  [{tag}]")
    return finish_kernels(results, "two room-like", tag)


def wrappers(ops) -> dict:
    return {"fps": ops.furthest_point_sample, "ball_query": ops.ball_query,
            "three_interpolation": ops.three_interpolation,
            "three_interpolation_backward": ops.three_interpolation_backward,
            "contrast_forward": ops.contrast_forward,
            "contrast_grad_rows": ops.contrast_grad_rows,
            "contrast_grad_support": ops.contrast_grad_support,
            "knn": ops.knn, "refine_cross": ops.refine_cross,
            "refine_cross_backward": ops.refine_cross_backward,
            "fps_b1": ops.furthest_point_sample_b1, "knn_big": ops.knn_big,
            "ball_query_big": ops.ball_query_big,
            "three_interpolation_backward_big":
                ops.three_interpolation_backward_big}


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


def forward_vs_plain(model, pos, x, kind: str, path: str) -> None:
    """One forward with the kernels and one with every kernel's plain twin:
    stage positions identical, logits within 1e-4·(1+max|logit|); for MM at
    the median predicted ambiguity, where CrossMask rows matter."""
    from amcontrast3d_tpu_torch.tools.profile_eval import plain_ops

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


def eval_path(ops, cfg, model, dev, rng, tag, kind: str) -> dict:
    """The eval main path of ``kind``; returns the kernels' launches in it."""
    from amcontrast3d_tpu_torch.engine import make_eval_step

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

    forward_vs_plain(model, batches[0]["pos"], batches[0]["x"], kind, path)
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


def scene_launches(clouds: list, kind: str) -> dict:
    """The launches the whole-scene test must have made: per subcloud
    forward 4 FPS calls, 8 ball queries (two per stage; those whose support
    exceeds BIG_N go to the chunk-skipping kernel), 4 interpolations, for MM
    4 CrossMask calls, and one boundary kNN over the subcloud's points."""
    want = {"fps_b1": 0, "ball_query_big": 0, "ball_query": 0,
            "three_interpolation": 0, "knn_big": 0, "knn": 0}
    if kind == "mm":
        want["refine_cross"] = 0
    for cloud in clouds:
        for n, nb in zip(cloud["subclouds"], cloud["buckets"]):
            sizes = [nb // 4 ** s for s in range(5)]
            supports = [sizes[s - 1] for s in range(1, 5)] + sizes[1:]
            big = sum(ns > BIG_N for ns in supports)
            want["fps_b1"] += 4
            want["ball_query_big"] += big
            want["ball_query"] += 8 - big
            want["three_interpolation"] += 4
            want["knn_big" if n > BIG_N else "knn"] += 1
            if kind == "mm":
                want["refine_cross"] += 4
    return {k: v for k, v in want.items() if v}


def scene_path(ops, kind: str, dev, tag: str, workdir: str) -> dict:
    """The whole-scene test of ``kind`` through ``main_cli``; returns the
    kernels' launches in it."""
    from amcontrast3d_tpu_torch.engine import Runner, evaluate
    from amcontrast3d_tpu_torch.engine.cli import load_cfg, main_cli, parse_args
    from amcontrast3d_tpu_torch.models import init_weights_
    from amcontrast3d_tpu_torch.tools.profile_eval import plain_ops
    from amcontrast3d_tpu_torch.transforms import build_transforms_from_cfg
    from amcontrast3d_tpu_torch.utils import EasyConfig, save_checkpoint

    path = f"{kind} scene"
    argv = ["--kind", kind, "--cfg", CFGS[kind], "mode=test",
            "dataset.common.NAME=Synthetic",
            f"dataset.common.num_rooms={SCENE_ROOMS[kind]}",
            f"dataset.common.n_points={SCENE_POINTS}",
            "ambiguity_args.miou_B_I=True", f"root_dir={workdir}", f"seed={SEED}"]
    cfg = load_cfg(*parse_args(argv))
    # seeded random weights, handed to the CLI as a checkpoint
    runner = Runner(cfg, kind=kind, device=dev)
    init_weights_(runner.model, torch.Generator().manual_seed(SEED))
    ck = EasyConfig()
    ck.update({"run_name": f"smoke_{kind}", "ckpt_dir": workdir})
    ckpt = save_checkpoint(ck, {"model": runner.model.state_dict()}, 0)

    counted = reset_counts(ops)
    torch.cuda.reset_peak_memory_stats()
    results = main_cli(None, argv + [f"pretrained_path={ckpt}"])
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counted.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30

    clouds = results["clouds"]
    buckets = sorted({nb for c in clouds for nb in c["buckets"]})
    sizes = [n for c in clouds for n in c["subclouds"]]
    if len(clouds) != SCENE_ROOMS[kind] or not set(buckets) <= set(SCENE_BUCKETS) \
            or (kind == "aa" and buckets != list(SCENE_BUCKETS)):
        raise AssertionError(f"{path}: {len(clouds)} rooms, buckets {buckets}")
    if not all(73729 <= n <= 155648 for n in sizes):
        raise AssertionError(f"{path}: subcloud sizes {sorted(set(sizes))}")
    if not all(c["finite"] for c in clouds):
        raise AssertionError(f"{path}: logits are not finite")
    points = sum(c["points"] for c in clouds)
    if results["cm"].total != points:
        raise AssertionError(f"{path}: confusion matrix counts "
                             f"{results['cm'].total} of {points} points")
    split = results["cm_boundary"].total + results["cm_inner"].total
    if split != sum(sizes):
        raise AssertionError(f"{path}: boundary + inner counts {split}, "
                             f"subclouds hold {sum(sizes)}")
    want = scene_launches(clouds, kind)
    if {k: v for k, v in launches.items() if v} != want:
        raise AssertionError(f"{path}: launches {launches}, expected {want}")
    rows = open(results["csv_path"]).read().splitlines()
    if len(rows) != 2 or not rows[0].startswith("method,Area,OA,mACC,mIoU"):
        raise AssertionError(f"{path}: results CSV {rows}")
    print(f"{path} main path: main_cli mode=test on {len(clouds)} Synthetic "
          f"rooms, {len(sizes)} subcloud forwards, launches {want}; mIoU "
          f"{results['miou']:.3f} boundary {results['boundary'][0]:.3f} inner "
          f"{results['inner'][0]:.3f} (random weights); results in "
          f"{os.path.basename(results['csv_path'])}")
    for i, c in enumerate(clouds):
        wall = c["prep_s"] + c["forward_s"] + c["vote_s"] + c["boundary_s"]
        print(f"{path} room {i}: {c['points']} raw points, {c['voxels']} voxels, "
              f"{len(c['subclouds'])} subclouds of {c['subclouds'][0]} points in "
              f"bucket {c['buckets'][0]}; wall {wall:.3f} s = "
              f"{c['points'] / wall:.1f} voted points/s "
              f"({sum(c['subclouds']) / wall:.1f} scored points/s); host prep "
              f"{c['prep_s']:.3f} s, forward {c['forward_s']:.3f} s "
              f"({c['forward_s'] / len(c['subclouds']) * 1e3:.1f} ms a subcloud), "
              f"voting {c['vote_s']:.3f} s, boundary kNN and metrics "
              f"{c['boundary_s']:.3f} s; peak {peak:.3f} GiB  [{tag}]")

    # one subcloud of the last room again: the checkpoint round trip, the
    # plain twins, the boundary mask
    np.random.seed(0)
    for item in evaluate.generate_data_list(cfg):
        coord, feat, label, idx_points, *_ = evaluate.load_data(item, cfg)
    part = evaluate.prepare_parts(
        coord, feat, idx_points[:1], cfg,
        build_transforms_from_cfg("val", cfg.datatransforms))[0]
    idx_part, n, nb, pos, x = part
    batch = runner.put_batch({"pos": pos[None], "x": x[None]})
    loaded = Runner(cfg, kind=kind, device=dev)
    if loaded.load_pretrained(ckpt) != 0:
        raise AssertionError(f"{path}: checkpoint epoch")
    check_equal(f"{path} logits after the checkpoint round trip",
                loaded.predict_fn()(batch), runner.predict_fn()(batch))
    forward_vs_plain(runner.model, batch["pos"], batch["x"], kind,
                     f"{path} subcloud of {n} points in bucket {nb}")
    nsample = cfg.ambiguity_args["nsample"]
    args = (pos[:n], label[idx_part].astype(np.int64), nsample, cfg.num_classes,
            cfg.get("ignore_index"), dev)
    mask_k, idx_k = evaluate.posmask_searching(*args)
    with plain_ops():
        mask_p, idx_p = evaluate.posmask_searching(*args)
    if not (np.array_equal(mask_k, mask_p) and np.array_equal(idx_k, idx_p)):
        raise AssertionError(f"{path}: boundary neighbourhoods differ from plain")
    s = mask_k.sum(-1)
    print(f"{path}: checkpoint round trip gives identical logits; boundary "
          f"neighbourhoods (k={nsample}) identical to the plain kNN, "
          f"{int(np.logical_and(0 < s, s < nsample).sum())} of {n} points on "
          f"a boundary")
    return launches


def val_forward_launches(n: int, kind: str) -> dict:
    """The launches of one validation forward of a whole cloud padded to
    ``n`` points (B = 1)."""
    sizes = [n // 4 ** s for s in range(5)]
    big = sum(ns > BIG_N for ns in sizes[:4] + sizes[1:])
    want = {"fps_b1": 4, "ball_query_big": big, "ball_query": 8 - big,
            "three_interpolation": 4}
    if kind == "mm":
        want["refine_cross"] = 4
    return {k: v for k, v in want.items() if v}


def run_train_cli(ops, argv: list, kind: str):
    """``main_cli`` in a training mode with the counts set to 0 just before
    and read just after; returns (results, the runner ``main_cli`` made, the
    launches of the training steps alone, those of the validations, the
    padded sizes of the validated clouds, all launches of the run)."""
    from amcontrast3d_tpu_torch.engine import cli, runner as runner_mod

    made, val_counts, val_sizes = [], {}, []

    class CountingRunner(runner_mod.Runner):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

        def _padded_logits(self, batch):
            before = {k: fn.launches for k, fn in counted.items()}
            out = super()._padded_logits(batch)
            for k, fn in counted.items():
                val_counts[k] = val_counts.get(k, 0) + fn.launches - before[k]
            val_sizes.append(out[1]["y"].shape[1])
            return out

    import faulthandler
    counted = reset_counts(ops)
    faulthandler.dump_traceback_later(CLI_LIMIT_S, exit=True)
    try:
        with mock.patch.object(cli, "Runner", CountingRunner):
            results = cli.main_cli(kind, argv)
    finally:
        faulthandler.cancel_dump_traceback_later()
    torch.cuda.synchronize()
    total = {k: fn.launches for k, fn in counted.items()}
    train = {k: v - val_counts.get(k, 0) for k, v in total.items()}
    return results, made[0], train, val_counts, val_sizes, total


def check_train_cli(path, results, train, val_counts, val_sizes, per_step,
                    epochs, steps, batch_points, lrs, kind):
    """The checks every train CLI run shares; returns the timing records."""
    timing = results["timing"]
    if [t["epoch"] for t in timing] != list(epochs) or \
            any(t["steps"] != steps for t in timing):
        raise AssertionError(f"{path}: epochs {timing}")
    for t, lr in zip(timing, lrs):
        if not np.isfinite(t["loss"]):
            raise AssertionError(f"{path}: epoch {t['epoch']} loss {t['loss']}")
        if t["cm_total"] != steps * batch_points:
            raise AssertionError(f"{path}: confusion matrix counts "
                                 f"{t['cm_total']} in epoch {t['epoch']}")
        if not abs(t["lr"] - lr) <= 1e-9 * lr:
            raise AssertionError(f"{path}: epoch {t['epoch']} ran at lr "
                                 f"{t['lr']}, the schedule gives {lr}")
    n_steps = steps * len(timing)
    got = {k: v / n_steps for k, v in train.items() if v}
    if got != per_step:
        raise AssertionError(f"{path}: launches per train step {got}, "
                             f"expected {per_step}")
    want_val = {}
    for n in val_sizes:
        for k, v in val_forward_launches(n, kind).items():
            want_val[k] = want_val.get(k, 0) + v
    if {k: v for k, v in val_counts.items() if v} != want_val:
        raise AssertionError(f"{path}: validation launches {val_counts}, "
                             f"expected {want_val}")
    if not (np.isfinite(results["val_miou"]) and np.isfinite(results["best_val"])):
        raise AssertionError(f"{path}: results {results}")
    return timing


def scalar_rows(run_dir: str) -> dict:
    rows = {}
    with open(os.path.join(run_dir, "scalars.jsonl")) as f:
        for line in f:
            row = json.loads(line)
            rows.setdefault(row["tag"], {})[row["step"]] = row["value"]
    return rows


def bare_step_ms(runner, batch, n: int = 3) -> float:
    """Median wall ms of the runner's train step on one device batch."""
    step = runner.train_step_fn()
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def report_train_cli(path, timing, runner, batch, peak, workers, tag):
    last = timing[-1]
    b, n = batch["y"].shape
    through = last["steps"] * b * n / last["train_seconds"]
    bare = bare_step_ms(runner, batch)
    epochs = [(t["epoch"], round(t["train_seconds"], 3),
               round(t["loader_wait_seconds"], 3)) for t in timing]
    print(f"{path}: last epoch {last['steps']} steps of B={b}x{n} in "
          f"{last['train_seconds']:.3f} s = "
          f"{last['train_seconds'] / last['steps'] * 1e3:.1f} ms a step = "
          f"{through:.1f} train points/s through the loader ({workers} "
          f"workers), the loop waited {last['loader_wait_seconds']:.3f} s on "
          f"the loader; the bare step {bare:.3f} ms = "
          f"{b * n / bare * 1e3:.1f} train points/s; epochs "
          f"{epochs} (epoch, s, s waited); peak {peak:.3f} GiB  [{tag}]")


def loader_batch(runner, seed: int) -> dict:
    """One device batch of the runner's recipe through its train loader."""
    from amcontrast3d_tpu_torch.data import build_dataloader_from_cfg
    from amcontrast3d_tpu_torch.engine.runner import _prep_batch

    cfg = runner.cfg
    loader = build_dataloader_from_cfg(
        cfg.batch_size, cfg.dataset, None, cfg.get("datatransforms"),
        split="train", seed=seed)
    loader.prefetch = False      # one batch, made here, no thread left behind
    np.random.seed(seed)
    return runner.put_batch(_prep_batch(next(iter(loader)), cfg))


def scannet_cli_path(ops, dev, tag: str, workdir: str) -> dict:
    """The ScanNet recipe through the train CLI: two epochs, a resumed third;
    returns the kernels' launches in it."""
    from amcontrast3d_tpu_torch.engine import Runner
    from amcontrast3d_tpu_torch.optim import build_optimizer_from_cfg

    path, kind, steps = "scannet aa train cli", "aa", 4
    argv = ["--cfg", SCANNET_CFG, "dataset.common.NAME=Synthetic",
            "dataset.common.num_rooms=4", "dataset.common.n_points=250000",
            f"dataset.common.num_classes={SCANNET_CLASSES}",
            "dataset.train.loop=2", "dataset.val.num_rooms=2",
            "dataset.val.n_points=100000", "dataset.val.presample=False",
            "decay_epochs=[2,3]", f"root_dir={workdir}", f"seed={SEED}"]
    torch.cuda.reset_peak_memory_stats()
    results, runner, train, val, sizes, total = run_train_cli(
        ops, argv + ["epochs=2"], kind)
    cfg = runner.cfg
    if (cfg.batch_size, cfg.dataset.train.voxel_max, cfg.num_classes,
            cfg.ignore_index, cfg.model.encoder_args.in_channels) != \
            (SCANNET_B, SCANNET_N, SCANNET_CLASSES, -100, 7):
        raise AssertionError(f"{path}: not the ScanNet recipe")
    timing = check_train_cli(path, results, train, val, sizes, SCANNET_LAUNCHES,
                             (1, 2), steps, SCANNET_B * SCANNET_N,
                             (1e-3, 1e-4), kind)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"{path} main path: main_cli mode=train, 2 epochs of {steps} steps at "
          f"B={SCANNET_B}x{SCANNET_N}, {cfg.dataloader.num_workers} loader "
          f"workers as the cfg, launches per train step {SCANNET_LAUNCHES}; "
          f"validation of {len(sizes)} whole clouds padded to {sorted(set(sizes))} "
          f"points, launches {({k: v for k, v in val.items() if v})}; losses "
          f"{[t['loss'] for t in timing]}, lr {[t['lr'] for t in timing]}, val "
          f"mIoU {results['val_miou']:.3f} (best {results['best_val']:.3f} at "
          f"epoch {results['best_epoch']})")

    # the weights moved, and the latest checkpoint gives them back
    fresh = Runner(cfg, kind=kind, device=dev)
    trained = dict(runner.model.named_parameters())
    still = [n for n, p_ in fresh.model.named_parameters()
             if torch.equal(p_, trained[n])]
    if set(still) - zero_gradient_biases(runner.model):
        raise AssertionError(f"{path}: parameters did not change: {still}")
    ckpts = {k: os.path.join(cfg.ckpt_dir, f"{cfg.run_name}_ckpt_{k}.ckpt")
             for k in ("latest", "best")}
    # best is written with the first epoch that scores above 0 (random
    # weights a few steps old may score 0 on every class)
    if not os.path.exists(ckpts["latest"]) or \
            os.path.exists(ckpts["best"]) != (results["best_epoch"] >= 1):
        raise AssertionError(f"{path}: checkpoints {os.listdir(cfg.ckpt_dir)}, "
                             f"best epoch {results['best_epoch']}")
    if fresh.load_pretrained(ckpts["latest"]) != 2:
        raise AssertionError(f"{path}: checkpoint epoch")
    batch = loader_batch(runner, SEED + 5)
    check_equal(f"{path} logits after the checkpoint round trip",
                fresh.predict_fn()({"pos": batch["pos"], "x": batch["x"]}),
                runner.predict_fn()({"pos": batch["pos"], "x": batch["x"]}))
    scalars = scalar_rows(cfg.run_dir)
    if sorted(scalars["lr"]) != [1, 2] or \
            not {"train_loss", "train_miou", "val_miou", "best_val"} <= set(scalars):
        raise AssertionError(f"{path}: scalars {scalars}")
    report_train_cli(path, timing, runner, batch, peak,
                     cfg.dataloader.num_workers, tag)

    # one step with the kernels against one with every plain twin, from the
    # trained state, some labels ignored
    ignored = dict(batch)
    ignored["y"] = batch["y"].clone()
    ignored["y"][:, ::11] = cfg.ignore_index
    train_vs_plain(cfg, runner.model, runner.optimizer, dev, ignored, tag, kind)
    del fresh
    torch.cuda.empty_cache()

    # resume from latest for a third epoch: the schedule carries on
    results3, runner3, train3, val3, sizes3, total3 = run_train_cli(
        ops, argv + ["epochs=3", "mode=resume",
                     f"pretrained_path={ckpts['latest']}"], kind)
    check_train_cli(f"{path} resumed", results3, train3, val3, sizes3,
                    SCANNET_LAUNCHES, (3,), steps, SCANNET_B * SCANNET_N,
                    (1e-5,), kind)
    if runner3.cfg.run_dir != cfg.run_dir or \
            runner3.train_step_fn().state["step"] != 3 * steps or \
            sorted(scalar_rows(cfg.run_dir)["lr"]) != [1, 2, 3]:
        raise AssertionError(f"{path}: the resumed run did not carry on in "
                             f"{cfg.run_dir}")
    print(f"{path}: parameters moved, latest written (best at epoch "
          f"{results['best_epoch']}), the latest "
          f"checkpoint gives identical logits; mode=resume ran epoch 3 in the "
          f"same run directory from step {2 * steps} at lr "
          f"{results3['timing'][0]['lr']} (loss {results3['timing'][0]['loss']})")
    return {k: total[k] + total3[k] for k in total}


def s3dis_cli_path(ops, kind: str, dev, tag: str, workdir: str) -> dict:
    """The S3DIS recipe through the train CLI for two short epochs (the
    first starts the workers and warms the card up, the second is the one
    reported) with its full train transform list; returns the kernels'
    launches in it."""
    path, steps = f"s3dis {kind} train cli", 3
    argv = ["--cfg", CFGS[kind], "dataset.common.NAME=Synthetic",
            "dataset.common.num_rooms=4", "dataset.common.n_points=100000",
            "dataset.train.loop=3", "dataset.val.num_rooms=1",
            "dataset.val.presample=False", f"batch_size={B}", "epochs=2",
            f"root_dir={workdir}", f"seed={SEED}"]
    torch.cuda.reset_peak_memory_stats()
    results, runner, train, val, sizes, total = run_train_cli(ops, argv, kind)
    cfg = runner.cfg
    names = list(cfg.datatransforms.train)
    if len(names) != 8 or "PointCloudRotation" not in names:
        raise AssertionError(f"{path}: train transforms {names}")
    per_step = dict(LAUNCHES[f"{kind} train"])
    timing = check_train_cli(path, results, train, val, sizes, per_step,
                             (1, 2), steps, B * N,
                             (runner.lr_fn(1), runner.lr_fn(2)), kind)
    peak = torch.cuda.max_memory_allocated() / 2**30
    note = f", refine rate {results['refine_rate']} %" if kind == "mm" else ""
    print(f"{path} main path: main_cli mode=train, 2 epochs of {steps} steps at "
          f"B={B}x{N} with the train transforms {names}, launches per train "
          f"step {per_step} (the support-owned interpolation VJP: "
          f"{train['three_interpolation_backward_big']}); losses "
          f"{[t['loss'] for t in timing]}, val mIoU {results['val_miou']:.3f}{note}")
    report_train_cli(path, timing, runner, loader_batch(runner, SEED + 6), peak,
                     cfg.dataloader.num_workers, tag)
    return total


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
    kernels.update(scene_kernel_phases(ops, dev, rng, tag))
    kernels.update(scannet_kernel_phases(ops, dev, rng, tag))

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
    with tempfile.TemporaryDirectory() as workdir:
        for kind in ("aa", "mm"):
            by_path[f"{kind} scene"] = scene_path(ops, kind, dev, tag, workdir)
            torch.cuda.empty_cache()
        by_path["scannet aa train cli"] = scannet_cli_path(ops, dev, tag, workdir)
        torch.cuda.empty_cache()
        for kind in ("aa", "mm"):
            by_path[f"s3dis {kind} train cli"] = s3dis_cli_path(
                ops, kind, dev, tag, workdir)
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
