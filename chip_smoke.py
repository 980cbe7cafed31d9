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
   FPS picks and ball-query indices identical (FPS printed per stage with
   its time a pick, the cluster size the dispatch takes and the floor of
   picks × one reduction over that cluster, read at every cluster size
   with one point a thread; then the batched FPS kernel's time a pick
   against N at every cluster size, B = 4 and B = 8, the table its gates
   are read from); the listed ball query at the eight (M, N, r) of a
   forward over the stages' layouts (one sort of the five stage clouds, as
   the encoder sorts them), indices identical to the twin, the same bits
   twice, with its pruned bound (the chunks whose box reaches into a ball)
   and the dense one (a scan in index order to each query's 32nd hit); the
   listed interpolation forward at the four decoder stages over both
   stages' layouts (stage s onto s - 1), and the lane-a-point forward at
   fp0 and fp1 (where the gate sends them), indices identical to the
   twin's, weights and output within 1e-5·(1+max|out|), each timed at the
   stages the dispatch gives it with the bound of the work the function
   needs (a distance test per point of the chunks whose bound is not above
   each fine point's 3rd d², then the weighted sum) beside the dense one;
   the scatter backward in the fine layout's order at every stage and the
   per-row-lists backward at fp0 and fp1 (the same bits twice) within
   1e-5·(1+max|df|), each timed where the dispatch takes it;
   the three chunk-pruned contrast kernels over the stage's sorted layout:
   the forward's counts and threshold identical and its sums within
   1e-5·(1+max|ref|), both halves of the VJP within 1e-4·(1+max|df|), each
   the same bits over two runs; the exact kNN's indices and d²
   identical at the seven (M, N, k) of a train step, each over its
   support's layout (the four stages by one sort, as the loss sorts them);
   the chunk-pruned kernels again on a 1/128 m grid at the stage
   sizes (d² ties at every k-th); the CrossMask feature at the four decoder
   shapes over each stage's layout (its self-kNN is the kNN's listed
   scan), for both fusions, with a continuous ambiguity and with one full
   of exact zeros and ties: its selection and the MIN rows identical,
   MIN_ALL0 within 1e-5·(1+max), the same bits twice, with its pruned and
   dense bounds; its VJP (float atomics) within 1e-5·(1+max|df|).  Each kernel's bound is worked out beside it: the
   larger of its bytes (inputs read once, outputs written once) over
   3.35 TB/s and its float32 instructions over 33.5 T/s (132 SMs × 128
   lanes × 1.98 GHz; the kernels run without FMA), counted from this run's
   data where the work depends on it: the listed chunk-pruned scans (kNN,
   the three contrast kernels) a box test per (block of 8 points, chunk),
   one per chunk a point reads (its bound admits it) and a distance test
   per point of those chunks, with the dense bound (every pair) printed
   beside it and kept as ``dense_bound_ms``; the three layout kernels
   (``csrc/layout.cu``: the keys and the packing of the four stage layouts
   around one sort, the contrast kernels' sorted columns at each stage)
   identical to their twins and
   every layout identical to ``sort_support`` of its stage, timed per step;
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
   median of the batch's distinct predicted ambiguities (eval) or 0.5 (train, where the
   BatchNorm ahead of the last sigmoid centres it), and assert a refine
   rate strictly between 0 and 100 and a non-zero gradient out of the
   CrossMask VJP;
7. runs the whole-room FPS at every stage (N → N / 4, four times) of the
   buckets 106496, 155648, 221184 and 311296 (B = 1), on a room-like cloud
   (the faces of a room and solid boxes, one point a voxel: 0.04 m to
   155648 points, 0.02 m from 221184, with repeated points) and a uniform
   one, through the dispatch (a cluster of ``csrc/fps.cu``'s kernel at its
   cluster size to 163840 points, the chunk-pruned kernel above), picks
   identical to the twin and to the grid kernel, each stage with its time,
   us a pick, chunk visits a pick and bound, and beside it every other
   kernel that takes the size (the grid kernel, the chunk-pruned kernel)
   and the one-block handover kernel of ``tools/fps_handover.cu`` (a
   measurement tool, not a path of the package) with the pick at which its
   one block took over, each holding the twin's picks; and at 1.2 M points
   (4096 picks, uniform and clustered), which the dispatch sends to
   ``csrc/fps.cu``'s grid kernel; then the three whole-room kernels at the
   shapes of a 155648-point subcloud, on its room-like and uniform stage
   clouds: the listed
   interpolation at the subcloud's four decoder stages over their layouts,
   indices identical to the twin's, output within 1e-5·(1+max|out|); the
   listed ball query at the three (M, N, r) pairs whose support exceeds
   the JAX package's 32768-point gate, indices identical to the twin, with
   the share of chunk visits it skips; the
   room's boundary kNN (self-kNN, k = 24) through kernel 6, indices and d²
   identical to the twin.  Each with its time, the twin's (one run), the
   bound and, for the kNN, ``topk`` of ``cdist``² in tiles.  The
   chunk-skipping kernels' bounds count what this run's data needs of a
   box-pruned scan: 18 float instructions per (query, chunk) box test (the
   kNN and the ball query: per block of 8 queries and chunk, and per chunk
   a query reads) and 9 per point of the chunks whose bound admits them;
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
   peak device memory (the checks are written once for every room of 8
   and 13: the buckets and the sizes within them, finite logits, the
   totals, the launches, the plain rescoring);
9. runs the kernels of the ScanNet recipe's train step at its shapes
   (B = 2 clouds of 64000 points on a 0.02 m grid, 16000 coarse points):
   the listed interpolation at its four decoder stages and the lane-a-point
   one at fp0 and fp1 (indices identical to the twin's, output within
   1e-5·(1+max|out|)), each with the time of the kernel the dispatch
   takes; the interpolation VJP over per-row lists
   (kernel 10, the coarse rows in their layout's order) at
   (2, 64000 → 16000, C = 128) against its twin within 1e-5·(1+max|df2|)
   and against itself (two runs, identical bits, and the same bits in
   index order), and at a shape that is a multiple of no tile with a
   support row no query selects (exactly 0), with its time, its bound, the
   twin's and ``index_add_``'s time and the scatter kernel's (kernel 9) on
   the same input (in the fine layout's order), and both kernels again at
   the S3DIS recipe's largest shape (4, 24000 → 6000, C = 128); the batched FPS 2 × 64000 → 16000 (one
   cluster a cloud, ``csrc/fps.cu``), picks identical to the twin, and the
   grid kernel cloud by cloud beside it; the three contrast kernels at
   (2, 64000, 64) (each over the cloud's layout, the forward's counts
   identical, the same bits twice, with its pruned bound), the kNN at the
   64000-point stage 0
   (64000², k = 24, and 16000 × 64000, k = 4) and the ball query
   (16000 × 64000, r = 0.05) at B = 2 against their twins; the kNN at
   the self-kNN of stages 1-3 (16000, 4000, 1000) beside ``topk`` of
   ``cdist``²;
10. drives the train CLI at full width through ``engine.cli.main_cli`` on
   Synthetic rooms, with the recipes' loaders (6 workers), train transforms,
   schedules and checkpoints: the ScanNet recipe
   (``cfgs/scannet/AMContrast3D-AA.yaml``: B = 2 × 64000, 7 input channels,
   20 classes, multistep with the milestones pulled in to epochs 2 and 3)
   for two epochs of 4 steps with validation each epoch, then
   ``mode=resume`` from ``latest`` for a third; and the S3DIS recipe, AA and
   MM, for two epochs of 3 steps at B = 4 × 24000.  Checks finite losses, the
   confusion-matrix totals, the learning rate of every epoch (the resumed
   one included), ``scalars.jsonl``, the launches per train step (both
   recipes: the lane-a-point forward and the per-row-lists VJP at fp0 and
   fp1, the listed forward and the scatter at fp2 and fp3; ScanNet's
   batched FPS 4 times) and per validation forward (the interpolation's
   split by the gates at the cloud's size), parameters that moved, identical
   logits from the ``latest`` checkpoint read back, and one ScanNet train
   step with the kernels against one with every plain twin from the same
   state (some labels ignored).  Prints per recipe the step time and the
   train points/s through the loader, the bare step's beside it, the
   seconds the loop waited on the loader and the peak device memory;
11. runs the kernels of the rungs from the 221184 bucket up against their
   twins and against the kernels they take over from: the chunk-pruned FPS
   at 311296 -> 77824 (a room-like cloud on a 0.02 m grid with repeated
   points, and a uniform one) and at 1.2 M -> 4096 (uniform and clustered),
   picks identical to the twin and to the grid kernel, with the chunk
   visits a pick, the bound (18 float instructions a box test, 10 a point
   of a visited chunk) and the floor of picks x one cluster-wide reduction;
   the lane-a-point interpolation (kernels 11-13) at fp0 of the 221184 and
   311296 buckets (C = 128) and at (155648 -> 38912, C = 256), coarse
   points from FPS, over both clouds' layouts (one sort) and sorting for
   itself: output, indices and weights identical to the listed
   ``interpolate.cu``'s, indices identical to the twin's, output within
   1e-5·(1+max|out|) of the twin, with its time beside the listed
   kernel's, the twin's, the bound (the coordinates and f2 read once, the
   rows written once, a distance test per point of the chunks the data
   needs, the weighted sum) and the chunk visits, and the gradient through its saved triples (the dispatch's
   per-row-lists VJP) within 1e-5·(1+max|df2|) of the twin's; kNN at
   k = 256 through both kNN kernels (two passes of 128 slots), identical
   to the twin; then the gate table of the two large-shape interpolation
   kernels (``gate_phase``): every decoder stage of the S3DIS and ScanNet
   steps, PointNet++'s eval forward, two clouds of 22000 points and room
   subclouds of 106496 to 311296 points, each kernel beside the one that
   shares its calls, the new forward's indices and output held against the
   twin's, and the kernels the dispatch took held against the gates;
12. drives ``--kind base``: ``BaseSeg`` over PointNet++ from
   ``cfgs/s3dis/pointnet++.yaml`` at B = 2 x 24000, one eval forward timed,
   its launches, and one forward against the plain twins;
13. drives the whole-scene test of the ScanNet recipe through ``main_cli``
   as in 8, on one Synthetic room a bucket: AA on a room of 250000 raw
   points (every subcloud in bucket 221184) and of 400000 (bucket 311296),
   MM (``cfgs/scannet/AMContrast3D-MM.yaml``) on the 250000-point room;
   the launches per subcloud forward include the chunk-pruned FPS at the
   first stage (both buckets are above 163840 points; each call sorts its
   cloud with the two layout kernels) and the lane-a-point interpolation
   at fp0 and fp1 (as at every bucket);
14. runs the four kernels of the approx configuration and the fused
   aggregation at the S3DIS step's shapes against their twins
   (``approx_kernel_phases``): the threshold selection at the four decoder
   stages (k = 24) and the contrast forward and rows VJP on its thresholds,
   also at C = 1 as ``ambiguity_head`` calls them; the label vote at stages
   1-3; both listed scans over the stage layouts of one sort, as the loss
   hands them on (the vote: stage 0's and the query stage's), thresholds
   and labels identical to the twins, with the listed bound (the chunks
   within each query's threshold, once: the vote's design lists them
   twice, which its line prints apart) beside the dense one,
   and again at the ScanNet step's shapes (2 x 64000 and its stages); the
   fused aggregation's forward (train: moments and tie count; and eval) and
   backward at each of PointNeXt-XL's 19 separable aggregations, the
   queries in their stage layout's order, on both clouds and on the ScanNet
   step's rooms (2 x 64000, 0.04 m grid): ext and the tie count identical
   to the twin, su, sq and du within 1e-5·(1+max), each cloud's time a
   step printed beside its bound; then cells of the fused aggregation's
   gate table (``tools/profile_aggregation.py``: the ScanNet step and the
   311296-point subcloud, the fused tail against the gather tail at every
   shape, the dispatch's choice);
15. after each kind's exact paths (4-6), drives them again in the approx
   configuration (``set_knn_backend('approx')``: the selection and the vote
   instead of the kNN) and, for AA, the train step and the eval forward with
   the fused aggregation on (``set_agg_fused('on')``), each with its
   launches per step, against the plain ops as in 5 and 6, timed with its
   peak memory, and the approx + fused AA train step at the ScanNet
   recipe's shapes (``cfgs/scannet/AMContrast3D-AA.yaml``, 2 rooms of 64000
   points; every separable aggregation fused, stage 1's set abstraction
   over the 64000-point stage 0 included), then prints
   every step of the kind side by side; the switches go back to their
   defaults after each phase;
16. the bfloat16 recipe (``use_amp``), which the JAX package builds with
   ``dtype=jnp.bfloat16``: (a) the bfloat16 forms of the fused
   aggregation's kernels (a bfloat16 ``u``) at the S3DIS step's 19
   separable aggregations against their twins (ext and the tie count
   identical, the moments within 1e-5·(1+max), the VJP's float32 sums within
   1e-5·(1+max|du|), du their rounding and within a bfloat16 ulp of the
   twin's), each timed beside the float32 form on the same values
   (``bf16_aggregation_phase``); after each kind's float32 paths, the same
   model at bfloat16 with the same weights (``bf16_model``): (c) the AA and
   MM eval forwards (logits bfloat16, within BF16_LOGIT_TOL·(1+max|logit|)
   of the plain ops), (b, d) the AA train step, exact / gather and approx +
   fused (the bfloat16 forms 19 + 19 a step), and the MM train step, each
   against the plain ops from one state (stage positions identical, the
   loss within BF16_LOSS_TOL·(1+|loss|), each parameter's gradient within
   BF16_GRAD_TOL relative L2), timed with their peak memory beside the
   float32 steps of the same call;
17. (e) the AA train step with ``encoder_args.remat`` and
   ``ambiguity_args.remat`` at B = 4 and 8 clouds of 24000 points
   (``remat_phase``): one step from one state with and without (twice):
   losses, BatchNorm statistics and launches identical, gradients as close
   to the step without as two steps without are; then 3 timed steps after 1
   each way with the peak memory;
18. (f) the S3DIS AA recipe through the train CLI as in 10 with
   ``use_amp=True`` (two epochs of 3 steps, a bfloat16 model checked);
19. data parallelism (``dp_phase``; the ranks are child processes from
   ``amcontrast3d_tpu_torch.parallel.launch``, and a rank that fails, or
   ranks that hang past DP_LIMIT_S, fail the run): (a) the AA train step
   at full width over NCCL at the world size of the card count, each
   rank's rows the same B/world clouds of 24000 points (B = 4x24000 on one
   card), (b) two gloo ranks on ``cuda:0`` (and, on a host of two cards or
   more, two NCCL ranks on two cards): the AA and MM train steps, default
   tail and approx + fused (kernels 20 and 21 on the synced statistics),
   and the AA approx + fused step at ``use_amp``'s bfloat16 (the kernels'
   bfloat16 forms), each rank on the whole batch (the global batch tiled
   twice); every step with dropout off, from the seeded state, held on
   rank 0 against one process on one copy whose BatchNorms sync over a
   group of that rank alone (the same arithmetic: loss, gradients and
   BatchNorm statistics within DP_TOL relative; bfloat16 gradients within
   DP_BF16_GRAD_TOL) and, at float32, against the plain one-process step
   (loss and statistics within DP_TOL, gradients within DP_PLAIN_GRAD_TOL
   relative L2: the synced BatchNorm normalises by the inference kernel,
   the plain one by the training kernel, which round apart, and max-pool
   near-ties move gradients; (a) prints the spread of two plain steps
   whose features differ by one ulp beside it; at bfloat16 that spread is
   of the order of the gradients, so the errors are printed with no
   bound); before the steps, on every launch, the synced BatchNorm of the
   ranks against the plain one on the global rows (``dp_bn_check``: the
   independent check that holds at float32 and bfloat16 inputs, within
   DP_TOL, the bfloat16 input gradient within DP_BN_BF16_TOL); each step
   with its launches a step on every rank (the one-process step's) and
   the collectives a step, and the step ms of 3 timed steps for (a)
   (beside the plain step's in the same process) and for (b)'s
   DP_TIMED_PATH; (c) the whole-scene test of one S3DIS room (250000 raw
   points) on the two gloo ranks (each bucket's subclouds shared, the
   logits gathered to rank 0, which votes): voted labels identical to one
   process's at every point, with each rank's launches and the wall time
   beside one process's;
20. prints one JSON line of per-kernel results (the bfloat16 forms of
   kernels 20 and 21 in rows of their own; the data-parallel ranks'
   launches under ``launches_by_path`` as ``dp …``) and, last, the device
   line.

Any failure raises, so the exit code is non-zero; without a CUDA device it
stops before printing any result.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
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
    # at every N: it also takes the JAX package's large-cloud kernel's place
    ("ball_query", "amcontrast3d_tpu_torch/csrc/ball_query.cu",
     "amcontrast3d_tpu/ops/knn_pallas.py:184, :224"),
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
    # at every N: it also takes the JAX package's large-cloud kernel's place
    ("knn", "amcontrast3d_tpu_torch/csrc/knn.cu",
     "amcontrast3d_tpu/ops/knn_pallas.py:58, :117"),
    ("refine_cross", "amcontrast3d_tpu_torch/csrc/refine.cu",
     "amcontrast3d_tpu/ops/contrast_pallas.py:951"),
    ("refine_cross_backward", "amcontrast3d_tpu_torch/csrc/refine.cu",
     "amcontrast3d_tpu/ops/contrast_pallas.py:1091"),
    # one cloud, both of fps.cu's forms: a cluster of its register-resident
    # kernel to 163840 points, else its grid kernel (where fps_pruned.cu does
    # not take it)
    ("fps_b1", "amcontrast3d_tpu_torch/csrc/fps.cu",
     "amcontrast3d_tpu/ops/fps_pallas.py:87"),
    ("three_interpolation_backward_big",
     "amcontrast3d_tpu_torch/csrc/interpolate_bwd_big.cu",
     "amcontrast3d_tpu/ops/interpolate_pallas.py:220"),
    # also every room stage above one cluster's 163840 points
    ("fps_pruned", "amcontrast3d_tpu_torch/csrc/fps_pruned.cu",
     "amcontrast3d_tpu/ops/fps_pallas.py:257, :87"),
    # one kernel for the seed, the threshold and the accumulation kernels
    ("three_interpolation_big", "amcontrast3d_tpu_torch/csrc/interpolate_big.cu",
     "amcontrast3d_tpu/ops/interpolate_pallas.py:332, :350, :267"),
    # the selection pass of _fwd_kernel (has_kth=False); the reductions
    # then run in contrast_forward
    ("contrast_select", "amcontrast3d_tpu_torch/csrc/contrast_select.cu",
     "amcontrast3d_tpu/ops/contrast_pallas.py:159"),
    ("label_vote", "amcontrast3d_tpu_torch/csrc/vote.cu",
     "amcontrast3d_tpu/ops/contrast_pallas.py:767"),
    ("aggregate_forward", "amcontrast3d_tpu_torch/csrc/aggregate.cu",
     "amcontrast3d_tpu/ops/aggregate_pallas.py:172"),
    ("aggregate_backward", "amcontrast3d_tpu_torch/csrc/aggregate.cu",
     "amcontrast3d_tpu/ops/aggregate_pallas.py:222"),
    # the train step's stage layouts and the support VJP's columns: no TPU
    # kernel, the JAX package's XLA code ahead of the Pallas kernels
    ("layout_keys", "amcontrast3d_tpu_torch/csrc/layout.cu",
     "amcontrast3d_tpu/ops/contrast_pallas.py:558 (XLA, not a kernel)"),
    ("layout_pack", "amcontrast3d_tpu_torch/csrc/layout.cu",
     "amcontrast3d_tpu/ops/contrast_pallas.py:578 (XLA, not a kernel)"),
    ("support_layout", "amcontrast3d_tpu_torch/csrc/layout.cu",
     "amcontrast3d_tpu/ops/contrast_pallas.py:686 (XLA, not a kernel)"),
    # the bfloat16 forms of kernels 20 and 21 (use_amp's u): the same TPU
    # kernels at a bf16 u (grouped_slot_reduce, aggregate_pallas.py:491)
    ("aggregate_forward_bf16", "amcontrast3d_tpu_torch/csrc/aggregate.cu",
     "amcontrast3d_tpu/ops/aggregate_pallas.py:172"),
    ("aggregate_backward_bf16", "amcontrast3d_tpu_torch/csrc/aggregate.cu",
     "amcontrast3d_tpu/ops/aggregate_pallas.py:222"),
)
STEP_KERNELS = KERNELS[:10]      # the kernels of the four step paths
# the step's large-shape interpolation kernels: fp0 and fp1 by the gates
BIG_INTERP_KERNELS = tuple(k for k in KERNELS if k[0] in (
    "three_interpolation_big", "three_interpolation_backward_big"))
APPROX_KERNELS = KERNELS[14:18]  # the approx configuration, the fused tail
LAYOUT_KERNELS = KERNELS[18:21]  # the layouts every forward and step make
BF16_KERNELS = KERNELS[21:]      # use_amp's forms of the fused tail
# the whole-scene paths: Synthetic rooms of SCENE_POINTS raw points from the
# dataset's seed 0; the first two voxelise (0.04 m) to 91478 and 130575
# points, which pad to the buckets 106496 and 155648
SCENE_POINTS, SCENE_ROOMS, SCENE_BUCKETS = 250000, {"aa": 2, "mm": 1}, (106496, 155648)
ROOM_N, HUGE_N, HUGE_PICKS = 155648, 1200000, 4096
ROOM_BUCKETS = (106496, 155648, 221184, 311296)   # every room stage's FPS
FPS_OPS = PAIR_OPS + 1           # a distance, a running minimum, a compare
BOX_OPS = 18                     # 6 sub, 6 max, 3 mul, 2 add, 1 compare
CHUNK = 64                       # ops/spatial.py::CHUNK
LIST_POINTS = 8                  # points a block lists: chunk_list.cuh::kListWarps
# a forward samples its five stage clouds first and sorts them once (two
# layout kernels around a sort) for the ball queries, the CrossMask and the
# loss
SORT_LAUNCHES = {"layout_keys": 1, "layout_pack": 1}
# the decoder's coarse widths at fp0 ... fp3; by the port's gates
# (ops/interpolate.py: forward_is_big, backward_is_big) fp0 and fp1 of both
# recipes' steps go to the lane-a-point forward and the per-row-lists VJP,
# fp2 and fp3 to the listed forward and the scatter
FP_CHANNELS = (128, 256, 512, 1024)
EVAL_LAUNCHES = {"fps": 4, "ball_query": 8, "three_interpolation": 2,
                 "three_interpolation_big": 2, **SORT_LAUNCHES}
# a train step also gathers the support VJP's columns at each stage
TRAIN_LAUNCHES = {**EVAL_LAUNCHES, "three_interpolation_backward": 2,
                  "three_interpolation_backward_big": 2,
                  "contrast_forward": 4, "contrast_grad_rows": 4,
                  "contrast_grad_support": 4, "knn": 7, "support_layout": 4}
# the ScanNet recipe: 2 x 64000 -> 16000 -> 4000 -> 1000 -> 250; the
# batched FPS takes all four stages, the listed ball query all eight, the
# interpolation and its VJP split as at B = 4 x 24000
SCANNET_CFG = os.path.join(REPO, "cfgs", "scannet", "AMContrast3D-AA.yaml")
SCANNET_B, SCANNET_N, SCANNET_CLASSES = 2, 64000, 20
SCANNET_LAUNCHES = TRAIN_LAUNCHES
CLI_LIMIT_S = 420     # a train CLI phase that hangs (a worker pool) is cut
# the rungs from the 221184 bucket up (ScanNet recipe, 0.02 m voxels): a
# Synthetic room of RUNG_ROOMS[bucket] raw points voxelises to subclouds in
# that bucket; the chunk-pruned FPS at its first stage, the lane-a-point
# interpolation at fp0 (coarse C = 128) and fp1
SCANNET_MM_CFG = os.path.join(REPO, "cfgs", "scannet", "AMContrast3D-MM.yaml")
RUNG_ROOMS = {221184: 250000, 311296: 400000}
RUNG_FPS = ((311296, 77824), (HUGE_N, HUGE_PICKS))
RUNG_INTERP = ((221184, 128), (311296, 128), (155648, 256))   # (N1, C), N2 = N1/4
KNN_WIDE = 256                   # beyond one kNN launch's 128 slots
# cfgs/s3dis/pointnet++.yaml (BaseSeg over PointNet++) at B = 2 x 24000
POINTNET2_CFG = os.path.join(REPO, "cfgs", "s3dis", "pointnet++.yaml")
BASE_B = 2
# PointNeXt-XL's separable aggregations: a set abstraction and then its
# stage's InvResMLP blocks, at the widths of encoder stages 1-4
XL_WIDTHS, XL_BLOCKS, AGG_K = (128, 256, 512, 1024), (3, 6, 3, 3), 32
UP_CHANNELS = (64, 128, 256, 512)          # decoder stage widths
AGG_LAUNCHES = sum(XL_BLOCKS) + len(XL_BLOCKS)
# the approx configuration: no kNN, the selection a contrast stage, the vote
# at stages 1-3; the fused tail: every separable aggregation
APPROX_LAUNCHES = {k: v for k, v in TRAIN_LAUNCHES.items() if k != "knn"}
APPROX_LAUNCHES.update(contrast_select=4, label_vote=3)
STEP_TIMES = {}   # path: (median ms, peak GiB), for the side-by-side line
# seconds of the fused aggregation's phases at ScanNet's shapes and of its
# gate cells, printed with the run's total
FUSED_PHASE_S = {}
LAUNCHES = {
    "aa eval": EVAL_LAUNCHES,
    "aa train": TRAIN_LAUNCHES,
    "mm eval": {**EVAL_LAUNCHES, "refine_cross": 4},
    "mm train": {**TRAIN_LAUNCHES, "refine_cross": 4,
                 "refine_cross_backward": 4},
    # PointNet++'s decoder: coarse widths 512, 256, 128, 64 at fp3 ... fp0,
    # so at B = 2 x 24000 only fp0 passes the forward's gate
    "base eval": {"fps": 4, "ball_query": 4, "three_interpolation": 3,
                  "three_interpolation_big": 1, **SORT_LAUNCHES},
    "aa train approx": APPROX_LAUNCHES,
    "aa train approx fused": {**APPROX_LAUNCHES, "aggregate_forward": AGG_LAUNCHES,
                              "aggregate_backward": AGG_LAUNCHES},
    "aa eval fused": {**EVAL_LAUNCHES, "aggregate_forward": AGG_LAUNCHES},
    # every separable aggregation, the set abstraction over the 64000-point
    # stage 0 too (the port's rule; the JAX package's VMEM rule kept it on
    # the gather tail)
    "scannet aa train approx fused": {**APPROX_LAUNCHES,
                                      "aggregate_forward": AGG_LAUNCHES,
                                      "aggregate_backward": AGG_LAUNCHES},
    "mm train approx": {**APPROX_LAUNCHES, "refine_cross": 4,
                        "refine_cross_backward": 4},
    # use_amp (a bfloat16 model): the same kernels, the fused tail's u in
    # bfloat16 through the bfloat16 forms
    "aa train bf16": TRAIN_LAUNCHES,
    "aa train bf16 approx fused": {**APPROX_LAUNCHES,
                                   "aggregate_forward_bf16": AGG_LAUNCHES,
                                   "aggregate_backward_bf16": AGG_LAUNCHES},
    "aa eval bf16": EVAL_LAUNCHES,
    "mm eval bf16": {**EVAL_LAUNCHES, "refine_cross": 4},
    "mm train bf16": {**TRAIN_LAUNCHES, "refine_cross": 4,
                      "refine_cross_backward": 4},
}
# data parallelism: each rank runs the kernels of the one-process step
LAUNCHES["mm train approx fused"] = {
    **LAUNCHES["mm train approx"], "aggregate_forward": AGG_LAUNCHES,
    "aggregate_backward": AGG_LAUNCHES}
# (kind, kNN backend, fused tail, use_amp) of (b)'s train steps; the last
# takes kernels 20 and 21's bfloat16 forms on the synced statistics
DP_PATHS = (("aa", "auto", "off", False), ("aa", "approx", "on", False),
            ("mm", "auto", "off", False), ("mm", "approx", "on", False),
            ("aa", "approx", "on", True))
DP_TOL = 1e-4        # a rank's step against one process's, relative
# the data-parallel step's gradients against the plain one-process step's,
# relative L2: the synced BatchNorm (the inference kernel on the gathered
# statistics) rounds apart from the plain one (the training kernel), and
# max-pool near-ties route some gradients elsewhere; two plain steps whose
# features differ by one ulp are 3.5e-2 apart (NVIDIA H100 80GB HBM3,
# 700.00 W; PERF.md §6 PR 18)
DP_PLAIN_GRAD_TOL = 1e-1
DP_TIMED = 3         # timed steps after the compared one
# (b)'s path whose steps are timed on the shared card (the others: the
# compared step alone)
DP_TIMED_PATH = ("aa", "approx", "on", False)
# a bfloat16 input's gradient through the synced BatchNorm against the
# plain one's: both bfloat16 roundings of float32 sums that agree to
# DP_TOL, so an element may land one ulp apart (2^-8 of the largest, twice)
DP_BN_BF16_TOL = 2.0 ** -7
DP_WEIGHTS = {}      # kind: the seeded weights, the same at bfloat16
DP_LIMIT_S = 420     # the ranks of a data-parallel phase that hang are cut
# the bfloat16 paths against their plain twins (the same bfloat16 model):
# eval logits within BF16_LOGIT_TOL·(1+max|logit|), a step's loss within
# 1e-2·(1+|loss|) and each parameter's gradient within BF16_GRAD_TOL
# relative L2: a float32 sum the kernels order otherwise rounds to another
# bfloat16 value now and then, and that ulp travels on (PERF.md §6)
BF16_LOGIT_TOL, BF16_LOSS_TOL, BF16_GRAD_TOL = 1e-2, 1e-2, 5e-2
# but for the fused tail's W_dp: its gradient is the difference of the
# support's and the queries' terms, W_dp·p_j − W_dp·p_i summed over the
# slots, each from bfloat16 du and dqp (as in the JAX tail), which cancel:
# an ulp of du where the kernel's and the twin's float32 sums round apart
# moves it by 5-30 % (NVIDIA H100 80GB HBM3, 700.00 W)
BF16_FUSED_WDP_TOL = 0.5
# at bfloat16 (use_amp): the gradients against one copy within
# BF16_GRAD_TOL (the float-atomic float32 sums of the backward round to
# bfloat16 apart now and then, and the ulp travels: two plain bf16 steps
# on one input are 2.2-4.6e-2 apart).  Against the plain step no bound
# holds at bfloat16: one ulp of the features moves the first bf16 step's
# gradients by 1.39 relative L2 (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md
# §6 PR 18), so the errors are printed and the independent check is the
# BatchNorm's alone (dp_bn_check)
DP_BF16_GRAD_TOL = BF16_GRAD_TOL
REMAT_BATCHES = (4, 8)           # the remat phase's clouds of N points


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


def tally(kernels):
    """(results, timed, note) for a phase of ``kernels``: ``timed`` adds a
    kernel's time, its twin's, a library call's, bytes and float
    instructions on the uniform cloud and returns the kernel's time (None
    on another cloud); ``note`` keeps the largest error of a
    compared pair (None until one is measured)."""
    results = {name: {"err": None, "ms": 0.0, "plain_ms": 0.0,
                      "library_ms": None, "bytes": 0.0, "ops": 0.0}
               for name, _, _ in kernels}

    def timed(name, cloud, kernel, plain, nbytes, nops, library=None):
        if cloud != "uniform":
            return None
        r = results[name]
        ms = cuda_ms(kernel)
        r["ms"] += ms
        r["plain_ms"] += cuda_ms(plain, PLAIN_RUNS)
        r["bytes"] += float(nbytes)
        r["ops"] += float(nops)
        if library is not None:
            r["library_ms"] = (r["library_ms"] or 0.0) + cuda_ms(library, PLAIN_RUNS)
        return ms

    def note(name, err):
        results[name]["err"] = max(results[name]["err"] or 0.0, err)

    return results, timed, note


def kernel_phases(ops, dev, rng, tag: str) -> dict:
    """Each kernel at the slice's shapes against its plain twin; returns
    {name: {err, ms, plain_ms, library_ms, bytes, ops}}: the largest error
    over both clouds, and on the uniform cloud the times, bytes and float
    instructions summed over the stages (per forward for the first three,
    per train step for the rest).  The interpolation and its VJP are timed
    at the stages the dispatch gives each kernel: the lane-a-point forward
    and the per-row-lists VJP at fp0 and fp1, the listed forward and the
    scatter at fp2 and fp3."""
    from amcontrast3d_tpu_torch.models.pointnext import to_full_list
    from amcontrast3d_tpu_torch.ops import spatial
    from amcontrast3d_tpu_torch.tools import profile_fps
    from amcontrast3d_tpu_torch.tools.profile_train import voronoi_labels

    radii = to_full_list(0.1, [1, 4, 7, 4, 4], [1, 4, 4, 4, 4], 2)
    channels = [128, 256, 512, 1024]           # coarse C of fp0 … fp3
    up_channels = UP_CHANNELS
    results, timed, note = tally(STEP_KERNELS + BIG_INTERP_KERNELS)

    def randn(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev)

    # the batched FPS: the clusters the card holds, the floor of a pick at
    # each cluster size (one point a thread: one reduction over the
    # cluster), and the time a pick against N that its gates come from
    capacity = profile_fps.capacity(dev)
    floors = {s: profile_fps.floor_us(dev, B, s, 5)
              for s in ops.fps.CLUSTER_SIZES}
    print(f"fps: clusters the card holds at once by size {capacity}; floor "
          f"of a pick at B={B} by size (us) "
          f"{ {s: round(us, 3) for s, us in floors.items()} }  [{tag}]")
    for b, ns in ((B, profile_fps.SWEEP_N), (8, (1500, 6000, 24000))):
        profile_fps.print_sweep(dev, b, profile_fps.sweep(dev, b, ns, 3), tag)
    fps_ms = fps_floor = 0.0
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
            ms = timed("fps", cloud, lambda: ops.furthest_point_sample(prev, npoint),
                       lambda: ops.furthest_point_sample_plain(prev, npoint),
                       B * (n * 12 + npoint * 4), B * npoint * n * (PAIR_OPS + 1))
            if ms is not None:
                size = ops.fps.fps_cluster_size(B, n, capacity)
                floor = npoint * floors[size] / 1e3
                fps_ms, fps_floor = fps_ms + ms, fps_floor + floor
                print(f"fps stage {s} B={B} {n} -> {npoint}: clusters of "
                      f"{size} blocks, {ms:.3f} ms = {ms / npoint * 1e3:.3f} us "
                      f"a pick, floor of picks x one reduction {floor:.3f} ms  "
                      f"[{tag}]")
            stages.append(ops.gather_points(prev, got).contiguous())
        # the five stage clouds sorted by one sort, as the encoder sorts them
        forward_layouts = spatial.sort_stages(stages)
        for s in range(1, 5):
            for si, qi, r in ((s - 1, s, radii[s][0]), (s, s, radii[s][1])):
                ball_scan(ops, spatial, stages[si], stages[qi],
                          forward_layouts[si], forward_layouts[qi], r, cloud,
                          f"{cloud} stage {s}", note, timed, results, tag)
        for s in range(1, 5):
            # stage s onto s - 1 over both stages' layouts, as the decoder
            # hands them on
            p1, p2 = stages[s - 1], stages[s]
            fine, coarse = forward_layouts[s - 1], forward_layouts[s]
            n1, n2, c = p1.shape[1], p2.shape[1], channels[s - 1]
            f2 = randn(B, n2, c)
            err, big_err, idx, w, needed, listed, dense = interp_scan(
                ops, spatial, p1, p2, f2, coarse, fine, f"{cloud} stage {s}")
            note("three_interpolation", err)
            # each forward kernel timed where the dispatch takes it
            big = ops.forward_is_big(B, n1, n2, c)
            fwd = "three_interpolation_big" if big else "three_interpolation"
            if big:
                note(fwd, big_err)
                kernel = functools.partial(ops.three_interpolation_big, p1, p2,
                                           f2, False, None, coarse, fine)
            else:
                kernel = functools.partial(ops.three_interpolation_small, p1,
                                           p2, f2, False, coarse, fine)
            ms = timed(fwd, cloud, kernel,
                       lambda: ops.three_interpolation_plain(p1, p2, f2),
                       B * ((n1 + n2) * 12 + (n1 + n2) * c * 4), needed)
            if ms is not None:
                r = results[fwd]
                r["dense_ops"] = r.get("dense_ops", 0.0) + dense
                print(f"interpolation {cloud} stage {s} (B={B}, {n2} -> {n1}, "
                      f"C={c}): {fwd} {ms:.4f} ms, bound dense "
                      f"{dense / PEAK_OPS * 1e3:.4f} / the data's chunks "
                      f"{needed / PEAK_OPS * 1e3:.4f} ms by operations (the "
                      f"listed design's {listed / PEAK_OPS * 1e3:.4f})  [{tag}]")
            # the backward on the indices and weights the forward kept: the
            # scatter in the order the forward took the fine points (their
            # layout's), the per-row lists in the coarse layout's order
            order = fine.packed.view(torch.int32)[..., 3]
            rows_order = coarse.packed.view(torch.int32)[..., 3]
            g = randn(B, n1, c)
            want = ops.three_interpolation_backward_plain(g, idx, w, n2)
            got = ops.three_interpolation_backward_small(g, idx, w, n2, order)
            note("three_interpolation_backward", check_close(
                f"interpolation backward {cloud} stage {s}", got, want, 1e-5))
            bwd = ("three_interpolation_backward_big"
                   if ops.backward_is_big(B, n1, n2, c)
                   else "three_interpolation_backward")
            if bwd == "three_interpolation_backward_big":
                got = ops.three_interpolation_backward_big(g, idx, w, n2,
                                                           rows_order)
                note(bwd, check_close(f"interpolation backward {cloud} stage "
                                      f"{s} per-row lists", got, want, 1e-5))
                check_equal(f"interpolation backward {cloud} stage {s} "
                            f"per-row lists, two runs", got,
                            ops.three_interpolation_backward_big(
                                g, idx, w, n2, rows_order))
                kernel = functools.partial(
                    ops.three_interpolation_backward_big, g, idx, w, n2,
                    rows_order)
            else:
                kernel = functools.partial(
                    ops.three_interpolation_backward_small, g, idx, w, n2,
                    order)
            rows = (idx.long() + n2 * torch.arange(B, device=dev)[:, None, None]
                    ).reshape(-1)
            contrib = (w[..., None] * g[:, :, None, :]).reshape(-1, c)
            timed(bwd, cloud, kernel,
                  lambda: ops.three_interpolation_backward_plain(g, idx, w, n2),
                  B * (n1 * (c * 4 + 24) + n2 * c * 4), B * n1 * c * 6,
                  lambda: torch.zeros(B * n2, c, device=dev).index_add_(
                      0, rows, contrib))
        labels = voronoi_labels(rng, pts)
        lab0 = torch.from_numpy(labels.astype(np.float32)).to(dev)
        # the loss reads the forward's layouts of the four decoder stages
        layouts = forward_layouts[:4]
        knn_scans(ops, spatial, stages, layouts, cloud, note, timed, results, tag)
        for s in range(4):                     # the contrast stages
            ps = stages[s]
            n, c = ps.shape[1], up_channels[s]
            lab = lab0 if s == 0 else lab0.gather(
                1, ops.knn(stages[0], ps, 1)[0][..., 0].long())
            f = torch.nn.functional.normalize(randn(B, n, c), dim=-1)
            kth = (ops.knn(ps, ps, KNN_K)[1][..., -1] * (1.0 + 1e-5)).contiguous()
            g4 = randn(B, n, 4)
            members = query_scans(ops, spatial, (ps, f, lab, kth, g4), layouts[s],
                                  cloud, f"{cloud} stage {s}", note, timed,
                                  results, tag)
            support_scan(ops, spatial, (ps, f, lab, kth, g4, 1 / 0.3, False),
                         layouts[s], members, cloud, f"{cloud} stage {s}", note,
                         timed, results, tag)
        for s in range(3, -1, -1):             # the decoder's refinements
            ps, layout = stages[s], forward_layouts[s]
            n, c = ps.shape[1], up_channels[s]
            f, g = randn(B, n, c), randn(B, n, c)
            a_cont = torch.from_numpy(rng.rand(B, n).astype(np.float32)).to(dev)
            a_ties = torch.where(a_cont < 0.4, 0.0, torch.round(a_cont * 4) / 4)
            for a in (a_cont, a_ties):
                for fusion in ("MIN", "MIN_ALL0"):
                    name = f"refine {fusion} {cloud} stage {s}"
                    got, sel = ops.refine_cross(ps, f, a, REFINE_K, fusion,
                                                keep=True, cloud=layout)
                    want, sel_p = ops.refine_cross_plain(ps, f, a, REFINE_K, fusion)
                    check_equal(f"{name} selection", sel, sel_p)
                    note("refine_cross",
                         check_equal(f"{name} rows", got, want)
                         if fusion == "MIN"
                         else check_close(name, got, want, 1e-5))
                    again, sel2 = ops.refine_cross(ps, f, a, REFINE_K, fusion,
                                                   keep=True, cloud=layout)
                    check_equal(f"{name}, two runs", again, got)
                    check_equal(f"{name} selection, two runs", sel2, sel)
                    scale = 1.0 if fusion == "MIN" else 1.0 / (REFINE_K - 1)
                    note("refine_cross_backward", check_close(
                        f"{name} backward",
                        ops.refine_cross_backward(g, sel, scale),
                        ops.refine_cross_backward_plain(g, sel, scale), 1e-5))
            # timed as the cfg runs it: MIN on the continuous ambiguity,
            # over the stage's layout; the bound of the listed self-kNN
            # (k = 12) beside the dense one (every pair)
            kth12 = ops.knn(ps, ps, REFINE_K, layout)[1][..., -1]
            visits, pairs = chunk_visits(spatial, ps, ps, kth12, False, layout)
            dense_ops = B * n * n * PAIR_OPS
            pruned_ops = listed_ops(visits, pairs, B, n)
            ms = timed("refine_cross", cloud,
                       lambda: ops.refine_cross(ps, f, a_cont, REFINE_K, "MIN",
                                                keep=True, cloud=layout),
                       lambda: ops.refine_cross_plain(ps, f, a_cont, REFINE_K, "MIN"),
                       B * n * (12 + 4 + 8 * c + 4), pruned_ops)
            if ms is not None:
                results["refine_cross"]["dense_ops"] = \
                    results["refine_cross"].get("dense_ops", 0.0) + dense_ops
                print(f"refine_cross MIN {cloud} stage {s} (B={B}, N={n}, "
                      f"C={c}): {ms:.4f} ms, bound dense "
                      f"{dense_ops / PEAK_OPS * 1e3:.4f} / pruned "
                      f"{pruned_ops / PEAK_OPS * 1e3:.4f} ms, chunk visits "
                      f"needed {visits / (B * n):.2f} a point of "
                      f"{pairs // (B * n)}  [{tag}]")
            sel = ops.refine_cross(ps, f, a_cont, REFINE_K, "MIN", keep=True,
                                   cloud=layout)[1]
            rows = (sel.long() + n * torch.arange(B, device=dev)[:, None, None]
                    ).reshape(-1)
            timed("refine_cross_backward", cloud,
                  lambda: ops.refine_cross_backward(g, sel, 1.0),
                  lambda: ops.refine_cross_backward_plain(g, sel, 1.0),
                  B * n * (8 * c + 4), B * n * c,
                  lambda: torch.zeros(B * n, c, device=dev).index_add_(
                      0, rows, g.view(-1, c)))
    print(f"fps the four stages at B={B}: {fps_ms:.3f} ms, floor of picks x "
          f"one reduction {fps_floor:.3f} ms  [{tag}]")
    grid_scans(ops, spatial, dev, rng, note, tag)
    return finish_kernels(results, "uniform, clustered and 1/128 m grid", tag)


def ball_scan(ops, spatial, support, query, layout, query_layout, r, cloud,
              where, note, timed, results, tag, k: int = 32):
    """Kernel 2 (the listed ball query, ``csrc/ball_query.cu``) over the
    support's and the queries' layouts against its twin: indices identical,
    the same bits twice.  With ``timed``, timed with the dense bound (a scan
    in index order stops at a query's k-th hit, or reads the whole support)
    and the pruned one (:func:`listed_ops`: the chunks whose box reaches
    into the ball)."""
    nb, ns, nq = support.shape[0], support.shape[1], query.shape[1]
    name = f"ball query {where} {nq} x {ns} r={r}"
    got = ops.ball_query(support, query, r, k, layout, query_layout)
    note("ball_query", check_equal(
        name, got, ops.ball_query_plain(support, query, r, k)))
    check_equal(f"{name}, two runs",
                ops.ball_query(support, query, r, k, layout, query_layout), got)
    scanned = torch.where(got[..., -1] == got[..., 0], ns,
                          got[..., -1] + 1).sum().item()
    visits, pairs = chunk_visits(spatial, support, query,
                                 float(np.float32(r * r)), True, layout)
    dense_ops = scanned * PAIR_OPS
    pruned_ops = listed_ops(visits, pairs, nb, nq)
    if timed is None:
        return
    ms = timed("ball_query", cloud,
               lambda: ops.ball_query(support, query, r, k, layout, query_layout),
               lambda: ops.ball_query_plain(support, query, r, k),
               nb * ((ns + nq) * 12 + nq * k * 4), pruned_ops)
    if ms is not None:
        results["ball_query"]["dense_ops"] = \
            results["ball_query"].get("dense_ops", 0.0) + dense_ops
        print(f"{name} (B={nb}): {ms:.4f} ms, bound dense "
              f"{dense_ops / PEAK_OPS * 1e3:.4f} / pruned "
              f"{pruned_ops / PEAK_OPS * 1e3:.4f} ms, chunk visits needed "
              f"{visits / (nb * nq):.2f} a query of {pairs // (nb * nq)}  [{tag}]")


def interp_scan(ops, spatial, p1, p2, f2, coarse, fine, where):
    """Kernel 3 (the listed scan of ``csrc/interpolate.cu``) over the coarse
    stage's layout, the fine points in their own layout's order, against
    its twin: indices identical, weights and output within 1e-5·(1+max),
    the same bits sorting for itself; where ``forward_is_big`` sends the
    stage to kernels 11-13 (``csrc/interpolate_big.cu``), that kernel too
    against the same twin on the same inputs.  Returns (the listed scan's
    max abs err, the lane-a-point kernel's or None, the kept indices and
    weights, and the float instructions of the work the data needs (a
    distance test per point of the chunks whose box bound is not above each
    fine point's 3rd d², then 5 a channel for the weighted sum), of the
    listed design (:func:`listed_ops`: box tests as well) and of a dense
    scan (every pair))."""
    nb, n1, n2, c = p1.shape[0], p1.shape[1], p2.shape[1], f2.shape[-1]
    name = f"interpolation {where} {n2} -> {n1} C={c}"
    out, idx, w = ops.three_interpolation_small(p1, p2, f2, True, coarse, fine)
    want_i, want_w = ops.three_interpolation_weights(p1, p2)
    check_equal(f"{name} indices", idx, want_i)
    check_close(f"{name} weights", w, want_w, 1e-5)
    plain = ops.three_interpolation_plain(p1, p2, f2)
    err = check_close(name, out, plain, 1e-5)
    check_equal(f"{name}, sorting for itself",
                ops.three_interpolation_small(p1, p2, f2)[0], out)
    big_err = None
    if ops.forward_is_big(nb, n1, n2, c):
        b_out, b_idx, b_w = ops.three_interpolation_big(p1, p2, f2, True, None,
                                                        coarse, fine)
        check_equal(f"{name} lane-a-point indices", b_idx, want_i)
        check_close(f"{name} lane-a-point weights", b_w, want_w, 1e-5)
        big_err = check_close(f"{name} lane-a-point", b_out, plain, 1e-5)
    d3 = ops.knn(p2, p1, 3, coarse)[1][..., 2]
    visits, pairs = chunk_visits(spatial, p2, p1, d3, False, coarse)
    work = nb * n1 * c * 5
    return (err, big_err, idx, w, visits * CHUNK * PAIR_OPS + work,
            listed_ops(visits, pairs, nb, n1) + work,
            nb * n1 * n2 * PAIR_OPS + work)


def interp_stages(ops, spatial, stages, where, tag, rng) -> None:
    """The forward kernels at the four decoder stages of ``stages`` (five
    clouds) over one sort of them, against the twin (:func:`interp_scan`:
    kernel 3 at every stage, kernels 11-13 where ``forward_is_big`` sends
    the stage), each with the dispatch's time and the bounds of the work
    the data needs and of a dense scan."""
    dev, nb = stages[0].device, stages[0].shape[0]
    layouts = spatial.sort_stages(stages)
    for s, c in zip(range(1, 5), (128, 256, 512, 1024)):
        p1, p2 = stages[s - 1], stages[s]
        f2 = torch.from_numpy(rng.randn(nb, p2.shape[1], c).astype(np.float32)
                              ).to(dev)
        err, big_err, _, _, needed, _, dense = interp_scan(
            ops, spatial, p1, p2, f2, layouts[s], layouts[s - 1],
            f"{where} stage {s}")
        ms = cuda_ms(lambda: ops.three_interpolation(p1, p2, f2, layouts[s],
                                                     layouts[s - 1]), 5)
        big = (f"; the lane-a-point kernel's indices identical to the twin, "
               f"max abs err {big_err}" if big_err is not None else "")
        took = "lane-a-point" if big_err is not None else "listed"
        print(f"interpolation {where} stage {s} (B={nb}, {p2.shape[1]} -> "
              f"{p1.shape[1]}, C={c}): the listed scan's indices identical to "
              f"the twin, max abs err {err}{big}; the dispatch ({took}) "
              f"{ms:.4f} ms over the layouts, bound dense "
              f"{dense / PEAK_OPS * 1e3:.4f} / the data's chunks "
              f"{needed / PEAK_OPS * 1e3:.4f} ms  [{tag}]")


def layout_kernel_phases(ops, dev, tag: str) -> dict:
    """The three layout kernels of a train step (``csrc/layout.cu``) at the
    S3DIS step's five stage clouds (B=4x24000, stages from FPS, a uniform
    and a clustered cloud), as the encoder sorts them, and at the ScanNet
    step's (2 x 64000, a 1/128 m grid): keys and frames, then the packed
    points, codes, indices and boxes, identical to their twins on the same
    inputs, every layout identical to ``sort_support`` of its stage alone;
    the support VJP's sorted (label, threshold) and chunk maxima at the
    four decoder stages identical to the twin's.  Timed per S3DIS step (one
    sort of the five stages, the columns at four), bound by bytes."""
    from amcontrast3d_tpu_torch.ops import spatial

    results, timed, note = tally(LAYOUT_KERNELS)
    rng = np.random.RandomState(SEED + 9)   # leaves the other phases' data as it was
    step = clouds(rng)
    step["grid"] = (rng.randint(0, 40, (SCANNET_B, SCANNET_N, 3)) / 128
                    ).astype(np.float32)
    for cloud, pts in step.items():
        stages = [torch.from_numpy(pts).to(dev)]
        for _ in range(4):
            prev = stages[-1]
            stages.append(ops.gather_points(prev, ops.furthest_point_sample(
                prev, prev.shape[1] // 4)).contiguous())
        b, sizes = stages[0].shape[0], tuple(p.shape[1] for p in stages)
        points = torch.cat([p.reshape(-1, 3) for p in stages])
        rows, nc = points.shape[0], sum(b * -(-n // CHUNK) for n in sizes)
        keys, frame = spatial.layout_keys(points, b, sizes)
        want = spatial.layout_keys_plain(points, b, sizes)
        note("layout_keys", max(check_equal(f"layout keys {cloud}", keys, want[0]),
                                check_equal(f"layout frame {cloud}", frame, want[1])))
        timed("layout_keys", cloud, lambda: spatial.layout_keys(points, b, sizes),
              lambda: spatial.layout_keys_plain(points, b, sizes),
              rows * (12 + 8) + frame.numel() * 4, rows * 12)
        skeys, perm = torch.sort(keys, stable=True)
        got = spatial.layout_pack(points, perm, skeys, b, sizes)
        want = spatial.layout_pack_plain(points, perm, skeys, b, sizes)
        note("layout_pack", max(check_equal(f"layout {field} {cloud}", g, w)
                                for field, g, w in zip(
                                    ("packed", "codes", "index", "boxes"), got, want)))
        timed("layout_pack", cloud,
              lambda: spatial.layout_pack(points, perm, skeys, b, sizes),
              lambda: spatial.layout_pack_plain(points, perm, skeys, b, sizes),
              rows * (8 + 12 + 8 + 16 + 8 + 8) + nc * 24, rows * 6)
        layouts = spatial.sort_stages(stages)
        for s, (p, layout) in enumerate(zip(stages, layouts)):
            ref = spatial.sort_support(p)
            for field in ("packed", "boxes", "codes", "lo", "scale", "perm"):
                check_equal(f"sort_stages {cloud} stage {s} {field}",
                            getattr(layout, field), getattr(ref, field))
            if s == 4:   # the contrast's stages are the first four
                continue
            n = p.shape[1]
            lab = torch.from_numpy(rng.randint(0, NUM_CLASSES, (b, n))
                                   .astype(np.float32)).to(dev)
            kth = (ops.knn(p, p, KNN_K, layout)[1][..., -1]
                   * (1.0 + 1e-5)).contiguous()
            got = ops.contrast.support_layout(layout, lab, kth)
            want = ops.contrast.support_layout_plain(layout, lab, kth)
            note("support_layout", max(
                check_equal(f"support columns {cloud} stage {s}", got[0], want[0]),
                check_equal(f"support chunk maxima {cloud} stage {s}", got[1],
                            want[1])))
            timed("support_layout", cloud,
                  lambda: ops.contrast.support_layout(layout, lab, kth),
                  lambda: ops.contrast.support_layout_plain(layout, lab, kth),
                  b * n * (8 + 4 + 4 + 8) + b * -(-n // CHUNK) * 4, b * n)
        if cloud == "uniform":
            sort_ms = cuda_ms(lambda: spatial.sort_stages(stages))
            one_ms = cuda_ms(lambda: [spatial.sort_support(p) for p in stages])
            print(f"the five stage layouts at B={b} {sizes}: by sort_stages "
                  f"(two kernels and a sort) {sort_ms:.4f} ms, by sort_support "
                  f"a stage {one_ms:.4f} ms  [{tag}]")
    print(f"layouts: every stage layout of sort_stages identical to "
          f"sort_support of its stage (uniform and clustered at B={B}x{N}, a "
          f"1/128 m grid at {SCANNET_B}x{SCANNET_N})  [{tag}]")
    return finish_kernels(results, "uniform, clustered and 1/128 m grid", tag)


def knn_scans(ops, spatial, stages, layouts, cloud, note, timed, results, tag):
    """Kernel 6 at the seven kNN calls of a train step (4 self-kNN for the
    contrast thresholds, 3 label propagations from stage 0), each over its
    support's layout as the loss hands it on: indices and d² identical to
    the twin; on the uniform cloud timed beside the twin and ``topk`` of
    ``cdist``² on the same inputs, with the dense bound (every pair) and the pruned one (:func:`listed_ops`: the
    chunks whose bound is not above the query's final k-th)."""
    calls = [(s, s, KNN_K) for s in range(4)] + \
        [(0, s, 4 ** s) for s in range(1, 4)]
    for si, qi, k in calls:
        sup, q, layout = stages[si], stages[qi], layouts[si]
        got_i, got_d = ops.knn(sup, q, k, layout)
        want_i, want_d = ops.knn_plain(sup, q, k)
        name = f"knn {cloud} M={q.shape[1]} N={sup.shape[1]} k={k}"
        note("knn", check_equal(f"{name} indices", got_i, want_i))
        note("knn", check_equal(f"{name} d2", got_d, want_d))
        nb, ns, nq = sup.shape[0], sup.shape[1], q.shape[1]
        visits, pairs = chunk_visits(spatial, sup, q, got_d[..., -1], False,
                                     layout)
        dense_ops = nb * nq * ns * PAIR_OPS
        pruned_ops = listed_ops(visits, pairs, nb, nq)
        ms = timed("knn", cloud, lambda: ops.knn(sup, q, k, layout),
                   lambda: ops.knn_plain(sup, q, k),
                   nb * ((ns + nq) * 12 + nq * k * 8), pruned_ops,
                   lambda: torch.topk(torch.cdist(q, sup).square_(), min(k, ns),
                                      largest=False))
        if ms is None:
            continue
        results["knn"]["dense_ops"] = results["knn"].get("dense_ops", 0.0) + dense_ops
        print(f"{name}: {ms:.4f} ms, bound dense {dense_ops / PEAK_OPS * 1e3:.4f} / "
              f"pruned {pruned_ops / PEAK_OPS * 1e3:.4f}"
              f" ms, chunk visits needed {visits / (nb * nq):.2f} a query of "
              f"{pairs // (nb * nq)}  [{tag}]")


def query_scans(ops, spatial, stage, layout, cloud, where, note, timed,
                results, tag, tinv: float = 1 / 0.3) -> int:
    """Kernels 14 and 15 over the stage's layout against their twins: the
    forward's counts and column 8 identical and its sums within
    1e-5·(1+max|ref|), the rows half within 1e-4·(1+max|df|), each the
    same bits over two runs.  With ``timed``, timed with the dense bound
    (every pair) and the pruned one (:func:`listed_ops`: the chunks whose
    bound is not above the point's own threshold, then the members'
    feature work).  Returns the member pairs the forward counted."""
    p, f, lab, kth, g4 = stage
    nb, n, c = f.shape
    args = (p, f, lab, kth, tinv, False, False, True)
    got = ops.contrast_forward(*args, cloud=layout)
    want = ops.contrast_forward_plain(*args)
    check_equal(f"contrast counts {where}", got[..., 4:6], want[..., 4:6])
    check_equal(f"contrast threshold {where}", got[..., 8], want[..., 8])
    note("contrast_forward", max(check_close(
        f"contrast column {col} {where}", got[..., col], want[..., col], 1e-5)
        for col in (0, 1, 6, 7)))
    check_equal(f"contrast_forward {where}, two runs",
                ops.contrast_forward(*args, cloud=layout), got)
    gargs = (p, f, lab, kth, g4, tinv, False)
    rows = ops.contrast_grad_rows(*gargs, cloud=layout)
    note("contrast_grad_rows", check_close(
        f"contrast_grad_rows {where}", rows, ops.contrast_grad_rows_plain(*gargs),
        1e-4))
    check_equal(f"contrast_grad_rows {where}, two runs",
                ops.contrast_grad_rows(*gargs, cloud=layout), rows)
    members = int(got[..., 4:6].sum().item())
    if timed is None:
        return members
    visits, pairs = chunk_visits(spatial, p, p, kth, False, layout)
    io = nb * n * (12 + 4 * c + 8)
    for name, kernel, plain, nbytes, work in (
            ("contrast_forward", lambda: ops.contrast_forward(*args, cloud=layout),
             lambda: ops.contrast_forward_plain(*args), io + nb * n * 36, 2 * c + 12),
            ("contrast_grad_rows",
             lambda: ops.contrast_grad_rows(*gargs, cloud=layout),
             lambda: ops.contrast_grad_rows_plain(*gargs), io + nb * n * (16 + 4 * c),
             4 * c + 12)):
        dense_ops = nb * n * n * PAIR_OPS + members * work
        pruned_ops = listed_ops(visits, pairs, nb, n) + members * work
        ms = timed(name, cloud, kernel, plain, nbytes, pruned_ops)
        if ms is not None:
            results[name]["dense_ops"] = results[name].get("dense_ops", 0.0) + dense_ops
            print(f"{name} {where} (B={nb}, N={n}, C={c}): {ms:.4f} ms, bound "
                  f"dense {dense_ops / PEAK_OPS * 1e3:.4f} / pruned "
                  f"{pruned_ops / PEAK_OPS * 1e3:.4f} ms, chunk visits needed "
                  f"{visits / (nb * n):.2f} a point of {pairs // (nb * n)}  [{tag}]")
    return members


def support_scan(ops, spatial, gargs, layout, members, cloud, where, note,
                 timed, results, tag):
    """Kernel 16 over the stage's layout against its twin (1e-4·(1+max|df|))
    and against itself (two runs, the same bits); timed with the dense
    bound (every pair) and the pruned one (:func:`listed_ops`: the chunks
    whose bound is not above the chunk's largest threshold, then the
    members' feature work)."""
    p, f, lab, kth = gargs[:4]
    nb, n, c = f.shape
    name = "contrast_grad_support"
    got = ops.contrast_grad_support(*gargs, cloud=layout)
    note(name, check_close(f"{name} {where}", got,
                           ops.contrast_grad_support_plain(*gargs), 1e-4))
    check_equal(f"{name} {where}, two runs",
                ops.contrast_grad_support(*gargs, cloud=layout), got)
    cmax = ops.contrast.support_layout(layout, lab, kth)[1]
    visits, pairs = chunk_visits(spatial, p, p, cmax[:, None, :], False, layout)
    dense_ops = nb * n * n * PAIR_OPS + members * (4 * c + 12)
    pruned_ops = listed_ops(visits, pairs, nb, n) + members * (4 * c + 12)
    if timed is None:
        return
    ms = timed(name, cloud, lambda: ops.contrast_grad_support(*gargs, cloud=layout),
               lambda: ops.contrast_grad_support_plain(*gargs),
               nb * n * (12 + 4 * c + 8) + nb * n * (16 + 4 * c), pruned_ops)
    if ms is not None:
        results[name]["dense_ops"] = results[name].get("dense_ops", 0.0) + dense_ops
        print(f"{name} {where} (B={nb}, N={n}, C={c}): {ms:.4f} ms, bound dense "
              f"{dense_ops / PEAK_OPS * 1e3:.4f} / pruned "
              f"{pruned_ops / PEAK_OPS * 1e3:.4f} ms, chunk visits needed "
              f"{visits / (nb * n):.2f} a point of {pairs // (nb * n)}  [{tag}]")


def grid_scans(ops, spatial, dev, rng, note, tag):
    """Kernels 6, 14, 15 and 16 at the step's stage sizes on a 1/128 m grid
    (d² ties at every k-th, repeated points, equal Morton codes across
    chunk edges): the seven kNN calls identical to the twin, the contrast
    kernels as :func:`query_scans` and :func:`support_scan` hold them."""
    stages = [torch.from_numpy((rng.randint(0, 40, (B, N >> (2 * s), 3)) / 128)
                               .astype(np.float32)).to(dev) for s in range(4)]
    layouts = spatial.sort_stages(stages)
    for si, qi, k in [(s, s, KNN_K) for s in range(4)] + \
            [(0, s, 4 ** s) for s in range(1, 4)]:
        sup, q = stages[si], stages[qi]
        got_i, got_d = ops.knn(sup, q, k, layouts[si])
        want_i, want_d = ops.knn_plain(sup, q, k)
        name = f"knn grid M={q.shape[1]} N={sup.shape[1]} k={k}"
        note("knn", check_equal(f"{name} indices", got_i, want_i))
        note("knn", check_equal(f"{name} d2", got_d, want_d))
    for s, p in enumerate(stages):
        n, c = p.shape[1], UP_CHANNELS[s]
        f = torch.nn.functional.normalize(torch.from_numpy(
            rng.randn(B, n, c).astype(np.float32)).to(dev), dim=-1)
        lab = torch.from_numpy(rng.randint(0, NUM_CLASSES, (B, n))
                               .astype(np.float32)).to(dev)
        kth = (ops.knn(p, p, KNN_K, layouts[s])[1][..., -1]
               * (1.0 + 1e-5)).contiguous()
        g4 = torch.from_numpy(rng.randn(B, n, 4).astype(np.float32)).to(dev)
        query_scans(ops, spatial, (p, f, lab, kth, g4), layouts[s], "grid",
                    f"grid stage {s}", note, None, None, tag)
        gargs = (p, f, lab, kth, g4, 1 / 0.3, False)
        support_scan(ops, spatial, gargs, layouts[s], 0, "grid",
                     f"grid stage {s}", note, None, None, tag)
    print(f"kernels 6, 14, 15 and 16 on a 1/128 m grid at the stage sizes: kNN "
          f"identical to the twin at the seven calls, the contrast forward's "
          f"counts and threshold identical, its sums within 1e-5, both VJP "
          f"halves within 1e-4, each repeatable, at the four stages  [{tag}]")


def finish_kernels(results: dict, clouds_note: str, tag: str) -> dict:
    """Work out each kernel's bound from its bytes and operations, print
    its line and return ``results``."""
    for k, r in results.items():
        if r["err"] is None:
            raise AssertionError(f"kernel {k}: no compared pair was measured")
        r["bound_ms"] = max(r["bytes"] / PEAK_BYTES, r["ops"] / PEAK_OPS) * 1e3
        r["bound_by"] = ("bytes" if r["bytes"] / PEAK_BYTES > r["ops"] / PEAK_OPS
                         else "operations")
        dense = ""
        if "dense_ops" in r:   # a chunk-pruned kernel: the bound of every pair too
            r["dense_bound_ms"] = max(r["bytes"] / PEAK_BYTES,
                                      r["dense_ops"] / PEAK_OPS) * 1e3
            dense = f", dense bound {r['dense_bound_ms']:.4f} ms"
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        print(f"kernel {k}: matches plain on {clouds_note} clouds "
              f"(max abs err {r['err']}); summed over stages {r['ms']:.4f} ms "
              f"vs plain {r['plain_ms']:.4f} ms, library call {lib}, bound "
              f"{r['bound_ms']:.4f} ms by {r['bound_by']} ({r['bytes']:.4g} "
              f"bytes, {r['ops']:.4g} float instructions){dense}  [{tag}]")
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


def room_cloud(rng, n: int, voxel: float = 0.04) -> np.ndarray:
    """(1, n, 3) f32 room-like cloud: the six faces of a 7 x 6 x 3 m room
    (1 cm of noise) and four solid boxes, one point per ``voxel``, 2 % of
    the points repeated (as bucket padding repeats real points)."""
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
        raise AssertionError(f"room holds {len(first)} voxels, fewer than {n}")
    pts = pts[rng.permutation(first)[:n]]
    pts[rng.randint(0, n, n // 50)] = pts[rng.randint(0, n, n // 50)]
    return pts[None].astype(np.float32)


def listed_ops(visits: int, pairs: int, nb: int, nq: int) -> int:
    """Float instructions of a scan in the listed design of kernels 6 and
    16 (``csrc/chunk_list.cuh``): each block of LIST_POINTS points tests
    every chunk's box once against theirs, each point then tests the box
    of every chunk it reads (``visits``, of ``pairs`` = nb·nq·nc from
    :func:`chunk_visits`) and every point of those chunks."""
    nc = pairs // (nb * nq)
    return ((nb * -(-nq // LIST_POINTS) * nc + visits) * BOX_OPS
            + visits * CHUNK * PAIR_OPS)


def chunk_visits(spatial, support, query, limit, strict: bool, cloud=None):
    """(visits, pairs): the (query, chunk) pairs whose box lower bound lies
    below ``limit`` (``<`` if strict, else ``<=``; a number, one per query
    (B, M), or one per chunk (B, 1, nc)), the chunks any box-pruned scan has
    to read, and all pairs; over ``cloud``, the support's layout, when
    given."""
    if cloud is None:
        cloud = spatial.sort_support(support)
    visits = 0
    for s in range(0, query.shape[1], 4096):
        lb = spatial.bbox_lb(query[:, s:s + 4096, None, :], cloud.boxes[:, None])
        lim = limit
        if torch.is_tensor(limit) and limit.dim() == 2:
            lim = limit[:, s:s + 4096, None]
        visits += int((lb < lim if strict else lb <= lim).sum())
    return visits, query.shape[0] * query.shape[1] * cloud.boxes.shape[1]


def room_fps_stages(ops, dev, rng, bucket: int, cloud: str, note, add,
                    tag: str) -> list:
    """The whole-room FPS at the four stages of a subcloud in ``bucket``
    (N → N / 4; a room-like cloud on the bucket's voxel, 0.04 m as S3DIS to
    155648 points and 0.02 m as ScanNet from 221184, or a uniform one):
    the dispatch's picks identical to the twin and to the grid kernel, its
    time, us a pick, chunk visits a pick (the chunk-pruned kernel), bound
    and route; beside it every other kernel that takes the size, under its
    own name, and the one-block handover kernel of ``tools/fps_handover.cu``
    (not a path of the package) with the pick at which its one block took
    over, each holding the twin's picks; returns the five stage clouds."""
    from amcontrast3d_tpu_torch.tools import fps_handover

    voxel = 0.04 if bucket <= ROOM_N else 0.02
    pts = room_cloud(rng, bucket, voxel) if cloud == "room" else \
        (rng.rand(1, bucket, 3) * [7, 6, 3]).astype(np.float32)
    stages = [torch.from_numpy(pts).to(dev)]
    fps = ops.fps
    for s in range(4):
        prev = stages[-1]
        n, npoint = prev.shape[1], prev.shape[1] // 4
        pruned = ops.fps_is_pruned(1, n, npoint)
        name = "fps_pruned" if pruned else "fps_b1"
        got = ops.furthest_point_sample_b1(prev, npoint)
        want, plain_ms = timed_once(
            lambda: ops.furthest_point_sample_plain(prev, npoint))
        err = check_equal(f"{name} {cloud} {bucket} stage {s}", got, want)
        if not pruned:
            note("fps_b1", err)
        ms = cuda_ms(lambda: ops.furthest_point_sample_b1(prev, npoint), 3)
        visits = torch.zeros(1, dtype=torch.int64, device=dev)
        fps.furthest_point_sample_pruned(prev, npoint, visits)
        v = visits.item()
        size = fps.fps_cluster_size(1, n, fps._cluster_capacity(dev.index))
        if pruned:
            nops = npoint * -(-n // CHUNK) * BOX_OPS + v * CHUNK * FPS_OPS
            route = (f"chunk-pruned, {v / npoint:.2f} chunk visits a pick of "
                     f"{-(-n // CHUNK)}")
        else:
            nops = npoint * n * FPS_OPS
            route = f"one cluster of {size} blocks"
        bound = max((n * 12 + npoint * 4) / PEAK_BYTES, nops / PEAK_OPS) * 1e3
        # every kernel that takes this size, each under its own name
        others = {"grid kernel": lambda: fps._fps_b1_grid(prev, npoint)}
        if not pruned:
            others["chunk-pruned kernel"] = \
                lambda: fps.furthest_point_sample_pruned(prev, npoint)
        elif size is not None:
            others[f"cluster of {size} blocks"] = \
                lambda: fps._fps_b1_cluster(prev, npoint, size)
        line = []
        for other, fn in others.items():
            check_equal(f"{name} {cloud} {bucket} stage {s}, the {other}",
                        fn(), want)
            o_ms = cuda_ms(fn, 1 if other == "grid kernel" and n > ROOM_N
                           else 3)
            line.append(f"the {other} {o_ms:.3f} ms = "
                        f"{o_ms / npoint * 1e3:.3f} us a pick")
        handover, first = fps_handover.furthest_point_sample_handover(
            prev, npoint)
        check_equal(f"handover {cloud} {bucket} stage {s}", handover, want)
        h_ms = cuda_ms(lambda: fps_handover.furthest_point_sample_handover(
            prev, npoint), 3)
        line.append(f"the one-block handover kernel (T = "
                    f"{fps_handover.HANDOVER}) {h_ms:.3f} ms = "
                    f"{h_ms / npoint * 1e3:.3f} us a pick, one block from pick "
                    f"{int(first.item())}")
        print(f"{name} {cloud} {bucket} stage {s} {n} -> {npoint}: picks "
              f"identical to the twin and to the grid kernel; {route}: "
              f"{ms:.3f} ms = {ms / npoint * 1e3:.3f} us a pick, bound "
              f"{bound:.4f} ms; {'; '.join(line)}; plain {plain_ms:.1f} ms  "
              f"[{tag}]")
        if bucket == ROOM_N:
            add("fps_b1", cloud == "room", ms, plain_ms, n * 12 + npoint * 4,
                nops)
        stages.append(ops.gather_points(prev, got).contiguous())
    return stages


def scene_kernel_phases(ops, dev, rng, tag: str) -> dict:
    """The three whole-room kernels against their twins (and against the
    kernels they take over from) at the shapes of a
    155648-point subcloud; returns the same records as ``kernel_phases``,
    with the times of the room-like cloud."""
    from amcontrast3d_tpu_torch.ops import spatial

    results = {name: {"err": None, "ms": 0.0, "plain_ms": 0.0,
                      "library_ms": None, "bytes": 0.0, "ops": 0.0}
               for name in ("fps_b1",)}

    def note(name, err):
        results[name]["err"] = max(results[name]["err"] or 0.0, err)

    def add(name, timed, ms, plain_ms, nbytes, nops):
        if timed:
            r = results[name]
            r["ms"] += ms
            r["plain_ms"] += plain_ms
            r["bytes"] += float(nbytes)
            r["ops"] += float(nops)

    # the whole-room FPS at every stage of the four buckets: its JSON row is
    # the 155648-point subcloud's four stages (room-like)
    room_stages = {}
    for bucket in ROOM_BUCKETS:
        for cloud in ("room", "uniform"):
            stages = room_fps_stages(ops, dev, rng, bucket, cloud, note, add,
                                     tag)
            if bucket == ROOM_N:
                room_stages[cloud] = stages
    for cloud, stages in room_stages.items():
        timed = cloud == "room"
        # the subcloud forward's interpolation at its four stages (kernel
        # 3's JSON row is the S3DIS step's)
        interp_stages(ops, spatial, stages, f"{cloud} room", tag, rng)
        # the ball queries whose support passes the JAX package's large-cloud
        # gate, over the stages' layouts (kernel 2's JSON row is the step's
        # eight calls)
        layouts = spatial.sort_stages(stages[:3])
        for si, qi, r in ((0, 1, 0.1), (1, 1, 0.2), (1, 2, 0.2)):
            sup, q = stages[si], stages[qi]
            ns, nq = sup.shape[1], q.shape[1]
            name = f"ball_query {cloud} {nq} x {ns} r={r}"
            got = ops.ball_query(sup, q, r, 32, layouts[si], layouts[qi])
            want, plain_ms = timed_once(lambda: ops.ball_query_plain(sup, q, r, 32))
            check_equal(f"{name} vs plain", got, want)
            ms = cuda_ms(lambda: ops.ball_query(sup, q, r, 32, layouts[si],
                                                layouts[qi]))
            # what this data needs of the listed scan, and beside it a dense
            # scan in index order: to the 32nd hit, or the whole support
            visits, pairs = chunk_visits(spatial, sup, q,
                                         float(np.float32(r * r)), True,
                                         layouts[si])
            scanned = torch.where(got[..., -1] == got[..., 0], ns,
                                  got[..., -1] + 1).sum().item()
            print(f"{name}: identical to the twin, {ms:.3f} ms, bound dense "
                  f"{scanned * PAIR_OPS / PEAK_OPS * 1e3:.3f} / pruned "
                  f"{listed_ops(visits, pairs, 1, nq) / PEAK_OPS * 1e3:.3f} ms, "
                  f"plain {plain_ms:.1f} ms, chunk visits skipped "
                  f"{100 * (1 - visits / pairs):.3f} %  [{tag}]")
        # the boundary kNN of a whole room: kernel 6 at a room's size (its
        # JSON row is the train step's seven calls)
        p = stages[0]
        name = f"knn {cloud} self-kNN {ROOM_N} k={KNN_K}"
        got_i, got_d = ops.knn(p, p, KNN_K)
        (want_i, want_d), plain_ms = timed_once(lambda: ops.knn_plain(p, p, KNN_K))
        check_equal(f"{name} indices", got_i, want_i)
        check_equal(f"{name} d2", got_d, want_d)
        ms = cuda_ms(lambda: ops.knn(p, p, KNN_K))

        def library():
            for s in range(0, ROOM_N, 2048):
                torch.topk(torch.cdist(p[:, s:s + 2048], p).square_(), KNN_K,
                           largest=False)
        library_ms = cuda_ms(library, 1)
        visits, pairs = chunk_visits(spatial, p, p, got_d[..., -1], False)
        print(f"{name}: identical to the twin, {ms:.3f} ms, bound dense "
              f"{ROOM_N * ROOM_N * PAIR_OPS / PEAK_OPS * 1e3:.3f} / pruned "
              f"{listed_ops(visits, pairs, 1, ROOM_N) / PEAK_OPS * 1e3:.3f} ms, "
              f"plain {plain_ms:.1f} ms, topk(cdist^2) in tiles "
              f"{library_ms:.1f} ms, chunk visits needed "
              f"{visits / ROOM_N:.2f} a query of {pairs // ROOM_N}  [{tag}]")
    # above 2^20 points, a few thousand picks (the twin the same ones): the
    # dispatch sends them to the grid kernel, whose sweep beats the
    # chunk-pruned kernel's first picks there (rung_kernel_phases holds
    # both)
    for cloud, pts in huge_clouds(rng).items():
        p = torch.from_numpy(pts).to(dev)
        if ops.fps_is_pruned(1, HUGE_N, HUGE_PICKS):
            raise AssertionError("the rule sends 1.2 M -> 4096 to the pruned "
                                 "kernel")
        got = ops.furthest_point_sample_b1(p, HUGE_PICKS)
        want, plain_ms = timed_once(
            lambda: ops.furthest_point_sample_plain(p, HUGE_PICKS))
        note("fps_b1", check_equal(f"fps_b1 {cloud} {HUGE_N}", got, want))
        ms = cuda_ms(lambda: ops.furthest_point_sample_b1(p, HUGE_PICKS), 3)
        print(f"fps_b1 {cloud} {HUGE_N} -> {HUGE_PICKS}: {ms:.3f} ms = "
              f"{ms / HUGE_PICKS * 1e3:.3f} us a pick (csrc/fps.cu's grid kernel), plain "
              f"{plain_ms:.1f} ms  [{tag}]")
    return finish_kernels(results, "room-like and uniform", tag)


def huge_clouds(rng) -> dict:
    """Two clouds of HUGE_N points in a 7 x 6 x 3 m room: uniform, and 64
    Gaussian blobs of σ 0.05 m."""
    blobs = rng.rand(64, 3) * [7, 6, 3]
    return {"uniform": (rng.rand(1, HUGE_N, 3) * [7, 6, 3]).astype(np.float32),
            "clustered": (blobs[rng.randint(0, 64, HUGE_N)][None]
                          + 0.05 * rng.randn(1, HUGE_N, 3)).astype(np.float32)}


def scannet_kernel_phases(ops, dev, rng, tag: str) -> None:
    """The kernels of the ScanNet recipe's train step at its shapes, B = 2
    clouds of 64000 points that differ, against their twins, with times
    (the kernels' records come from the S3DIS step's phase, the main
    path's shapes)."""
    from amcontrast3d_tpu_torch.ops import spatial

    nb, n1 = SCANNET_B, SCANNET_N
    # two rooms on a 0.02 m grid, the second one smaller and shifted
    pts = np.concatenate([room_cloud(rng, n1) * 0.5,
                          room_cloud(rng, n1) * 0.4 + 0.3])
    p = torch.from_numpy(pts.astype(np.float32)).to(dev)

    # the batched FPS at the recipe's first stage
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
    size = ops.fps.fps_cluster_size(nb, n1, ops.fps._cluster_capacity(dev.index))
    print(f"fps {nb}x{n1} -> {npoint}: picks identical to the twin; one cluster "
          f"of {size} blocks a cloud in one launch {ms:.3f} ms = "
          f"{ms / npoint * 1e3:.3f} us a "
          f"pick, the grid kernel cloud by cloud ({nb} launches) {grid_ms:.3f} "
          f"ms, plain {plain_ms:.1f} ms, bound "
          f"{nb * npoint * n1 * FPS_OPS / PEAK_OPS * 1e3:.3f} ms by operations  "
          f"[{tag}]")
    q = ops.gather_points(p, got).contiguous()
    # the forward's interpolation at the recipe's four decoder stages
    stages = [p, q]
    for _ in range(3):
        prev = stages[-1]
        stages.append(ops.gather_points(prev, ops.furthest_point_sample(
            prev, prev.shape[1] // 4)).contiguous())
    interp_stages(ops, spatial, stages, f"ScanNet B={nb}", tag, rng)

    # the interpolation VJP: ScanNet's fp0, then S3DIS's fp0
    def vjp_case(p1, p2, c):
        b, m1, m2 = p1.shape[0], p1.shape[1], p2.shape[1]
        fine, coarse = spatial.sort_stages([p1, p2])
        idx, w = ops.three_interpolation_weights(p1, p2)
        g = torch.from_numpy(rng.randn(b, m1, c).astype(np.float32)).to(dev)
        name = f"interpolation backward ({b}, {m1} -> {m2}, C={c})"
        # the coarse rows in their layout's order, the fine points in theirs,
        # as a step hands them on
        rows = coarse.packed.view(torch.int32)[..., 3]
        order = fine.packed.view(torch.int32)[..., 3]
        got = ops.three_interpolation_backward_big(g, idx, w, m2, rows)
        again = ops.three_interpolation_backward_big(g, idx, w, m2, rows)
        want = ops.three_interpolation_backward_plain(g, idx, w, m2)
        err = check_close(f"{name} per-row lists vs plain", got, want, 1e-5)
        check_equal(f"{name} per-row lists, two runs", got, again)
        check_equal(f"{name} per-row lists in index order",
                    ops.three_interpolation_backward_big(g, idx, w, m2), got)
        check_close(f"{name} scatter vs plain",
                    ops.three_interpolation_backward_small(g, idx, w, m2, order),
                    want, 1e-5)
        flat = (idx.long() + m2 * torch.arange(b, device=dev)[:, None, None]
                ).reshape(-1)
        contrib = (w[..., None] * g[:, :, None, :]).reshape(-1, c)
        big_ms = cuda_ms(lambda: ops.three_interpolation_backward_big(
            g, idx, w, m2, rows))
        small_ms = cuda_ms(
            lambda: ops.three_interpolation_backward_small(g, idx, w, m2, order))
        plain_ms = cuda_ms(
            lambda: ops.three_interpolation_backward_plain(g, idx, w, m2), PLAIN_RUNS)
        lib_ms = cuda_ms(lambda: torch.zeros(b * m2, c, device=dev).index_add_(
            0, flat, contrib), PLAIN_RUNS)
        nbytes = b * (m1 * (c * 4 + 24) + m2 * c * 4)
        nops = b * m1 * c * 6
        bound = max(nbytes / PEAK_BYTES, nops / PEAK_OPS) * 1e3
        gate = "per-row lists" if ops.backward_is_big(b, m1, m2, c) \
            else "scatter"
        print(f"{name}: the per-row-lists kernel {big_ms:.4f} ms (coarse rows "
              f"in their layout's order), the scatter kernel {small_ms:.4f} ms "
              f"in the fine layout's order (the dispatch takes the {gate} "
              f"one), plain {plain_ms:.4f} ms, index_add_ {lib_ms:.4f} ms, "
              f"bound {bound:.4f} ms; max abs err {err}, two runs identical  "
              f"[{tag}]")

    vjp_case(p, q, 128)
    uni = torch.from_numpy(rng.rand(B, N, 3).astype(np.float32) * 4).to(dev)
    uni_q = ops.gather_points(uni, ops.furthest_point_sample(uni, N // 4)).contiguous()
    vjp_case(uni, uni_q, 128)
    # a multiple of no tile; coarse row 7 lies far away, so no query selects it
    odd, odd_q = p[:, :4099].contiguous(), q[:, :1031].clone()
    odd_q[:, 7] += 100.0
    idx, w = ops.three_interpolation_weights(odd, odd_q)
    g = torch.from_numpy(rng.randn(nb, 4099, 200).astype(np.float32)).to(dev)
    got = ops.three_interpolation_backward_big(g, idx, w, 1031)
    check_close("interpolation backward (2, 4099 -> 1031, C=200)", got,
                ops.three_interpolation_backward_plain(g, idx, w, 1031), 1e-5)
    if (idx == 7).any() or got[:, 7].any():
        raise AssertionError("an unselected support row is not zero")

    # the kNN kernel at the 64000-point stage 0, two clouds a call
    for name, sup, query, k in (("self-kNN", p, p, KNN_K),
                                ("label propagation", p, q, 4)):
        got_i, got_d = ops.knn(sup, query, k)
        (want_i, want_d), plain_ms = timed_once(lambda: ops.knn_plain(sup, query, k))
        check_equal(f"knn B={nb} {name} indices", got_i, want_i)
        check_equal(f"knn B={nb} {name} d2", got_d, want_d)
        ms = cuda_ms(lambda: ops.knn(sup, query, k), 5)
        print(f"knn B={nb} {name} {query.shape[1]} x {n1} k={k}: identical "
              f"to the twin, {ms:.3f} ms vs plain {plain_ms:.1f} ms  [{tag}]")
    # kernel 6 at the recipe's stages 1-3 (self-kNN, k = 24, over the stage's
    # layout), beside topk of cdist² on the same inputs
    sp = q
    for s in range(1, 4):
        if s > 1:
            sp = ops.gather_points(sp, ops.furthest_point_sample(
                sp, sp.shape[1] // 4)).contiguous()
        ns = sp.shape[1]
        layout = spatial.sort_support(sp)
        got_i, got_d = ops.knn(sp, sp, KNN_K, layout)
        (want_i, want_d), plain_ms = timed_once(
            lambda: ops.knn_plain(sp, sp, KNN_K))
        check_equal(f"knn B={nb} stage {s} self-kNN {ns} indices", got_i, want_i)
        check_equal(f"knn B={nb} stage {s} self-kNN {ns} d2", got_d, want_d)
        ms = cuda_ms(lambda: ops.knn(sp, sp, KNN_K, layout), 5)
        lib_ms = cuda_ms(lambda: torch.topk(torch.cdist(sp, sp).square_(),
                                            KNN_K, largest=False), 1)
        visits, pairs = chunk_visits(spatial, sp, sp, got_d[..., -1], False,
                                     layout)
        print(f"knn B={nb} stage {s} self-kNN {ns} k={KNN_K}: identical to the "
              f"twin, {ms:.4f} ms, "
              f"topk(cdist^2) {lib_ms:.3f} ms, plain {plain_ms:.1f} ms, bound "
              f"dense {nb * ns * ns * PAIR_OPS / PEAK_OPS * 1e3:.4f} / pruned "
              f"{listed_ops(visits, pairs, nb, ns) / PEAK_OPS * 1e3:.4f}"
              f" ms  [{tag}]")
    got = ops.ball_query(p, q, 0.05, 32)
    want, plain_ms = timed_once(lambda: ops.ball_query_plain(p, q, 0.05, 32))
    check_equal(f"ball_query B={nb} {npoint} x {n1} r=0.05", got, want)
    ms = cuda_ms(lambda: ops.ball_query(p, q, 0.05, 32), 5)
    print(f"ball_query B={nb} {npoint} x {n1} r=0.05: identical to the "
          f"twin, {ms:.3f} ms (sorting its support) vs plain {plain_ms:.1f} ms  "
          f"[{tag}]")

    # the contrast kernels: n * n is past 2^31
    c = 64
    f = torch.nn.functional.normalize(torch.from_numpy(
        rng.randn(nb, n1, c).astype(np.float32)).to(dev), dim=-1)
    lab = torch.from_numpy(rng.randint(0, SCANNET_CLASSES, (nb, n1))
                           .astype(np.float32)).to(dev)
    lab[:, ::9] = -100.0
    layout = spatial.sort_support(p)
    kth = (ops.knn(p, p, KNN_K, layout)[1][..., -1] * (1.0 + 1e-5)).contiguous()
    g4 = torch.from_numpy(rng.randn(nb, n1, 4).astype(np.float32)).to(dev)
    members = query_scans(ops, spatial, (p, f, lab, kth, g4), layout, "room",
                          "at 64000", lambda *_: None, None, None, tag, 1 / 0.5)
    args = (p, f, lab, kth, 1 / 0.5, False, False, True)
    gargs = (p, f, lab, kth, g4, 1 / 0.5, False)
    visits, pairs = chunk_visits(spatial, p, p, kth, False, layout)
    line = []
    for name, work, kernel, plain in (
            ("forward", 2 * c + 12, lambda: ops.contrast_forward(*args, cloud=layout),
             lambda: ops.contrast_forward_plain(*args)),
            ("rows", 4 * c + 12, lambda: ops.contrast_grad_rows(*gargs, cloud=layout),
             lambda: ops.contrast_grad_rows_plain(*gargs))):
        _, plain_ms = timed_once(plain)
        pruned = listed_ops(visits, pairs, nb, n1) + members * work
        line.append(f"{name} {cuda_ms(kernel, 3):.3f} ms over the layout, "
                    f"identical counts and the same bits twice, vs plain "
                    f"{plain_ms:.1f} ms, its pruned bound "
                    f"{pruned / PEAK_OPS * 1e3:.3f} ms ({visits / (nb * n1):.2f} "
                    f"chunk visits a point of {pairs // (nb * n1)})")
    want, plain_ms = timed_once(lambda: ops.contrast_grad_support_plain(*gargs))
    got = ops.contrast_grad_support(*gargs, cloud=layout)
    err = check_close("contrast_grad_support at 64000", got, want, 1e-4)
    check_equal("contrast_grad_support at 64000, two runs", got,
                ops.contrast_grad_support(*gargs, cloud=layout))
    cmax = ops.contrast.support_layout(layout, lab, kth)[1]
    visits, pairs = chunk_visits(spatial, p, p, cmax[:, None, :], False, layout)
    pruned = listed_ops(visits, pairs, nb, n1) + members * (4 * c + 12)
    ms = cuda_ms(lambda: ops.contrast_grad_support(*gargs, cloud=layout), 3)
    line.append(f"support {ms:.3f} ms over the layout, the same bits twice, vs "
                f"plain {plain_ms:.1f} ms (max abs err {err}), its pruned bound "
                f"{pruned / PEAK_OPS * 1e3:.3f} ms ({visits / (nb * n1):.2f} "
                f"chunk visits a point of {pairs // (nb * n1)})")
    print(f"contrast kernels at ({nb}, {n1}, {c}), dense "
          f"bound {nb * n1 * n1 * PAIR_OPS / PEAK_OPS * 1e3:.3f} ms each by "
          f"operations: {'; '.join(line)}  [{tag}]")


def rung_kernel_phases(ops, dev, rng, tag: str) -> dict:
    """The kernels of the rungs from the 221184 bucket up against their
    twins and against the kernels they take over from; returns the record
    of the chunk-pruned FPS (the room-like 311296-point cloud), prints the
    lane-a-point interpolation's (fp0 of the 221184 and 311296 buckets, fp1
    of the 622592 one; its record comes from the step's fp0 and fp1), and
    holds kNN beyond 128 neighbours."""
    from amcontrast3d_tpu_torch.ops import spatial

    results = {"fps_pruned": {"err": None, "ms": 0.0, "plain_ms": 0.0,
                              "library_ms": None, "bytes": 0.0, "ops": 0.0}}

    def note(name, err):
        results[name]["err"] = max(results[name]["err"] or 0.0, err)

    # the floor of a pick: one cluster-wide reduction, read off the cluster
    # kernel of fps.cu with 16 blocks and 4 points a thread (16 x 512 x 4)
    tiny = torch.from_numpy(rng.rand(1, 16 * 512 * 4, 3).astype(np.float32)).to(dev)
    floor_us = cuda_ms(lambda: ops.fps._fps_b1_cluster(
        tiny, tiny.shape[1], 16), 3) / tiny.shape[1] * 1e3
    print(f"one cluster-wide reduction a pick (fps.cu's 16-block cluster, "
          f"{tiny.shape[1]} points, as many picks): {floor_us:.3f} us  [{tag}]")

    clouds = {("room", 311296): room_cloud(rng, 311296, 0.02),
              ("uniform", 311296): (rng.rand(1, 311296, 3) * [7, 6, 3]
                                    ).astype(np.float32)}
    clouds.update({(name, HUGE_N): pts for name, pts in huge_clouds(rng).items()})
    for (cloud, n), pts in clouds.items():
        npoint = dict(RUNG_FPS)[n]
        p = torch.from_numpy(pts).to(dev)
        visits = torch.zeros(1, dtype=torch.int64, device=dev)
        got = ops.furthest_point_sample_pruned(p, npoint, visits)
        want, plain_ms = timed_once(lambda: ops.furthest_point_sample_plain(p, npoint))
        note("fps_pruned", check_equal(f"fps_pruned {cloud} {n}", got, want))
        check_equal(f"fps_pruned {cloud} {n} vs the grid kernel", got,
                    ops.fps._fps_b1_grid(p, npoint))
        ms = cuda_ms(lambda: ops.furthest_point_sample_pruned(p, npoint), 3)
        grid_ms = cuda_ms(lambda: ops.fps._fps_b1_grid(p, npoint), 1)
        nc = -(-n // CHUNK)
        nops = npoint * nc * BOX_OPS + visits.item() * CHUNK * FPS_OPS
        bound = max((n * 12 + npoint * 4) / PEAK_BYTES, nops / PEAK_OPS) * 1e3
        print(f"fps_pruned {cloud} {n} -> {npoint}: picks identical to the twin "
              f"and to the grid kernel; {ms:.3f} ms = {ms / npoint * 1e3:.3f} us "
              f"a pick, {visits.item() / npoint:.2f} chunk visits a pick of "
              f"{nc}; the grid kernel {grid_ms:.3f} ms = "
              f"{grid_ms / npoint * 1e3:.3f} us a pick; plain {plain_ms:.1f} "
              f"ms; bound {bound:.3f} ms by operations, floor of picks x one "
              f"reduction {npoint * floor_us / 1e3:.3f} ms  [{tag}]")
        if cloud == "room":
            results["fps_pruned"].update(
                ms=ms, plain_ms=plain_ms, bytes=float(n * 12 + npoint * 4),
                ops=float(nops))

    for n1, c in RUNG_INTERP:
        for cloud in ("room", "uniform"):
            pts = room_cloud(rng, n1, 0.02) if cloud == "room" else \
                (rng.rand(1, n1, 3) * [7, 6, 3]).astype(np.float32)
            p1 = torch.from_numpy(pts).to(dev)
            n2 = n1 // 4
            p2 = ops.gather_points(p1, ops.furthest_point_sample(p1, n2)).contiguous()
            f2 = torch.from_numpy(rng.randn(1, n2, c).astype(np.float32)).to(dev)
            name = f"interpolation_big {cloud} {n1} -> {n2}, C={c}"
            if not ops.forward_is_big(1, n1, n2, c):
                raise AssertionError(f"{name}: the dispatch rule says listed")
            # both clouds' layouts by one sort, as a forward makes them
            fine, coarse = spatial.sort_stages([p1, p2])
            visits = torch.zeros(1, dtype=torch.int64, device=dev)
            out, idx, w = ops.three_interpolation_big(p1, p2, f2, True, visits,
                                                      coarse, fine)
            l_out, l_idx, l_w = ops.three_interpolation_small(p1, p2, f2, True,
                                                              coarse, fine)
            err = check_equal(f"{name} vs interpolate.cu", out, l_out)
            check_equal(f"{name} indices vs interpolate.cu", idx, l_idx)
            check_equal(f"{name} weights vs interpolate.cu", w, l_w)
            check_equal(f"{name} without keep", ops.three_interpolation_big(
                p1, p2, f2, False, None, coarse, fine)[0], out)
            check_equal(f"{name} sorting for itself",
                        ops.three_interpolation_big(p1, p2, f2)[0], out)
            want_i, want_w = ops.three_interpolation_weights(p1, p2)
            check_equal(f"{name} indices vs the twin", idx, want_i)
            check_close(f"{name} weights vs the twin", w, want_w, 1e-5)
            want, plain_ms = timed_once(
                lambda: ops.three_interpolation_plain(p1, p2, f2))
            err = max(err, check_close(f"{name} vs plain", out, want, 1e-5))
            ms = cuda_ms(lambda: ops.three_interpolation_big(
                p1, p2, f2, False, None, coarse, fine))
            listed_ms = cuda_ms(lambda: ops.three_interpolation_small(
                p1, p2, f2, False, coarse, fine), 3)
            # the bound, of the work the function needs: a distance test per
            # point of the chunks whose bound is not above each fine point's
            # 3rd d² (what this data needs), 5 float instructions a channel;
            # the coordinates and f2 read once, the rows written once
            d3 = ops.knn(p2, p1, 3, coarse)[1][..., 2]
            needed, pairs = chunk_visits(spatial, p2, p1, d3, False, coarse)
            nbytes = (n1 + n2) * 12 + (n1 + n2) * c * 4
            nops = needed * CHUNK * PAIR_OPS + 5 * n1 * c
            bound = max(nbytes / PEAK_BYTES, nops / PEAK_OPS) * 1e3
            print(f"{name}: output, indices and weights identical to "
                  f"interpolate.cu's and the twin's indices, max abs err vs "
                  f"plain {err}; the lane-a-point kernel {ms:.4f} ms over the "
                  f"layouts, interpolate.cu over the layouts {listed_ms:.4f} "
                  f"ms, plain {plain_ms:.1f} ms, bound {bound:.4f} ms "
                  f"({100 * bound / ms:.1f} % of it); chunk visits: a warp "
                  f"(32 fine points) scanned {visits.item() / -(-n1 // 32):.2f}, "
                  f"the data needs {needed / n1:.2f} a fine point of "
                  f"{pairs // n1}  [{tag}]")
            if cloud == "room" and n1 == 221184:
                # the gradient through the big forward's saved triples and
                # the dispatch's VJP (the per-row lists at this shape)
                g = torch.from_numpy(rng.randn(1, n1, c).astype(np.float32)).to(dev)
                fk = f2.clone().requires_grad_()
                fp = f2.clone().requires_grad_()
                before = (ops.three_interpolation_big.launches,
                          ops.three_interpolation_backward_big.launches)
                ops.three_interpolation(p1, p2, fk, coarse, fine).backward(g)
                if (ops.three_interpolation_big.launches,
                        ops.three_interpolation_backward_big.launches) != \
                        (before[0] + 1, before[1] + 1):
                    raise AssertionError(f"{name}: the autograd path missed it")
                ops.three_interpolation_plain(p1, p2, fp).backward(g)
                gerr = check_close(f"{name} gradient vs plain", fk.grad,
                                   fp.grad, 1e-5)
                print(f"{name}: gradient through the saved triples (the "
                      f"per-row-lists VJP), max abs err vs plain {gerr}  "
                      f"[{tag}]")

    # kNN beyond one launch's 128 slots: passes
    room = torch.from_numpy(room_cloud(rng, 40000)).to(dev)
    for sup in (room, room[:, :6000].contiguous()):
        q = sup[:, ::7].contiguous()
        got_i, got_d = ops.knn(sup, q, KNN_WIDE)
        want_i, want_d = ops.knn_plain(sup, q, KNN_WIDE)
        check_equal(f"knn {sup.shape[1]} k={KNN_WIDE} indices", got_i, want_i)
        check_equal(f"knn {sup.shape[1]} k={KNN_WIDE} d2", got_d, want_d)
        print(f"knn {q.shape[1]} x {sup.shape[1]} k={KNN_WIDE}: "
              f"indices and d2 identical to the twin (2 passes of 128)  [{tag}]")
    return finish_kernels(results, "room-like and uniform", tag)


def gate_phase(ops, dev, tag: str) -> None:
    """The gate table of the two large-shape interpolation kernels
    (``tools/profile_big_kernels.py --gates`` reads the gates from the same
    table with device times): every decoder stage of the S3DIS and ScanNet
    steps, PointNet++'s eval forward, two clouds of 22000 points and room
    subclouds of 106496 to 311296 points, each kernel beside the one that
    shares its calls (wrapper times, 3 runs in the order other, new, new,
    other), the forward's outputs identical, the new one's indices the
    twin's and its output within 1e-5·(1+max) of the plain interpolation,
    the VJP the same bits twice and within 1e-5·(1+max) of the twin, and the
    kernels the dispatch took through ``three_interpolation`` (forward and
    backward) held against ``forward_is_big`` and ``backward_is_big``."""
    from amcontrast3d_tpu_torch.tools import profile_big_kernels

    rng = np.random.RandomState(SEED + 15)   # leaves the other phases' data
    clouds = [c for c in profile_big_kernels.GATE_CLOUDS
              if not c[0].startswith("uniform")]
    profile_big_kernels.gate_table(dev, rng, tag, 3, clouds, device=False)


def approx_kernel_phases(ops, dev, rng, tag: str) -> dict:
    """The four kernels of the approx configuration and the fused tail at
    the S3DIS step's shapes (B=4x24000, stages from FPS, a uniform and a
    clustered cloud) against their twins: the selection at the four
    decoder stages (k = 24, over the stage's layout), and the contrast
    forward and rows VJP on its thresholds over the stage layouts, at the
    decoder widths and at C = 1 (as ``ambiguity_head`` calls them): the
    thresholds and counts identical, the sums within 1e-5·(1+max|ref|), the
    rows within 1e-4·(1+max|df|), each the same bits twice;
    the vote at stages 1-3 (k = 4, 16, 64, 13 classes, over stage 0's
    layout and the query stage's), labels identical; both again at the
    ScanNet step's shapes (:func:`scannet_selections`);
    the aggregation forward and backward at each of PointNeXt-XL's 19
    separable aggregations on both clouds and on the ScanNet step's rooms
    (:func:`aggregation_scan`).  Times and bounds summed per train step
    (the JSON row: the uniform cloud); the backward's library yardstick is
    ``index_add_`` of its (B·M·K, C) rows."""
    from amcontrast3d_tpu_torch.ops import spatial
    from amcontrast3d_tpu_torch.tools import profile_big_kernels
    from amcontrast3d_tpu_torch.tools.profile_train import voronoi_labels

    results, timed, note = tally(APPROX_KERNELS)

    def randn(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev)

    for cloud, pts in clouds(rng).items():
        stages = [torch.from_numpy(pts).to(dev)]
        for _ in range(4):
            prev = stages[-1]
            idx = ops.furthest_point_sample(prev, prev.shape[1] // 4)
            stages.append(ops.gather_points(prev, idx).contiguous())
        lab0 = torch.from_numpy(voronoi_labels(rng, pts).astype(np.int32)).to(dev)
        p0 = stages[0]
        # the five stage layouts of one sort, as the forward makes them and
        # the loss hands them to the selection and the vote
        layouts = spatial.sort_stages(stages)
        for s in range(1, 4):                  # the vote at stages 1-3
            selection_scan(ops, spatial, p0, stages[s], 4 ** s, layouts[0],
                           layouts[s], lab0, cloud, f"{cloud} stage {s}", note,
                           timed, results, tag)
        for s in range(4):                     # the contrast stages
            ps = stages[s]
            n = ps.shape[1]
            thr = selection_scan(ops, spatial, ps, ps, KNN_K, layouts[s], None,
                                 None, cloud, f"{cloud} stage {s}", note, timed,
                                 results, tag)
            lab = (lab0 if s == 0 else
                   ops.label_vote(p0, lab0, ps, 4 ** s, NUM_CLASSES, layouts[0],
                                  layouts[s])).float()
            f = torch.nn.functional.normalize(randn(B, n, UP_CHANNELS[s]), dim=-1)
            g4 = torch.randn(B, n, 4, device=dev,
                             generator=torch.Generator(dev).manual_seed(s))
            for feats, tinv in ((f, 1 / 0.3), (torch.zeros(B, n, 1, device=dev), 1.0)):
                query_scans(ops, spatial, (ps, feats, lab, thr, g4), layouts[s],
                            cloud, f"on the selection {cloud} stage {s} "
                            f"C={feats.shape[-1]}", lambda *_: None, None, None,
                            tag, tinv)
        aggregation_scan(ops, spatial, stages, layouts, 0.1, cloud,
                         f"S3DIS step {cloud}", note, timed, tag)
    scannet_selections(ops, spatial, dev, rng, note, tag)
    t = time.perf_counter()
    stages = profile_big_kernels.gate_stages(dev, rng, SCANNET_B, SCANNET_N, 0.02)
    aggregation_scan(ops, spatial, stages, spatial.sort_stages(stages), 0.05,
                     "scannet", f"ScanNet step {SCANNET_B}x{SCANNET_N} rooms",
                     note, timed, tag)
    FUSED_PHASE_S["ScanNet aggregations"] = time.perf_counter() - t
    return finish_kernels(results, "uniform and clustered (and ScanNet's)", tag)


def aggregation_scan(ops, spatial, stages, layouts, radius, cloud, where, note,
                     timed, tag) -> None:
    """Both fused-aggregation kernels at PointNeXt-XL's 19 separable
    aggregations over a step's five stage clouds (per stage s = 1 ... 4 the
    set abstraction, support s - 1 onto the queries of s, and the stage's
    InvResMLP blocks on the grouping of s onto itself; ball query at the
    cfg's radii from ``radius``, K = 32, mixed ``sgn``), the queries in their
    stage layout's order as the encoder hands it on, against the twins: ext
    and the tie count identical, su and sq within 1e-5·(1+max) (train
    forward), ext identical again in eval mode, du (float atomics) within
    1e-5·(1+max|du|).  Prints each kernel's time a step (wrapper, CUDA
    events, median of 11) beside its bound; on the uniform cloud ``timed``
    also keeps the twins' and ``index_add_``'s times for the JSON row."""
    from amcontrast3d_tpu_torch.models.pointnext import to_full_list

    radii = to_full_list(radius, [1, 4, 7, 4, 4], [1, 4, 4, 4, 4], 2)
    dev, b = stages[0].device, stages[0].shape[0]
    gen = torch.Generator(dev).manual_seed(SEED + 16)

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    spent = {"aggregate_forward": [0.0, 0.0, 0.0],    # ms, bytes, ops
             "aggregate_backward": [0.0, 0.0, 0.0]}
    for s in range(1, 5):
        sup, q, c = stages[s - 1], stages[s], XL_WIDTHS[s - 1]
        m = q.shape[1]
        order = spatial.index_bits(layouts[s])
        groups = [(sup, ops.ball_query(sup, q, radii[s][0], AGG_K, layouts[s - 1],
                                       layouts[s]))]
        groups += [(q, ops.ball_query(q, q, radii[s][1], AGG_K, layouts[s]))] \
            * XL_BLOCKS[s - 1]
        gamma = randn(b * m * AGG_K, c)
        for j, (support, idx) in enumerate(groups):
            ns = support.shape[1]
            u, qp = randn(b, ns, c), randn(b, m, c)
            sgn = torch.where(randn(c) < 0, -1.0, 1.0)
            g3 = [randn(b, m, c) for _ in range(3)]
            name = f"aggregation {where} stage {s} #{j} ({m}, {ns}, {AGG_K}, {c})"
            ext, su, sq, ties = ops.aggregate_forward(u, idx, sgn, qp, order=order,
                                                      keep_ties=True)
            want = ops.aggregate_forward_plain(u, idx, sgn, qp, keep_ties=True)
            err = check_equal(f"{name} ext", ext, want[0])
            check_equal(f"{name} ties", ties, want[3])
            err = max(err, check_close(f"{name} su", su, want[1], 1e-5),
                      check_close(f"{name} sq", sq, want[2], 1e-5))
            check_equal(f"{name} eval ext", ops.aggregate_forward(
                u, idx, sgn, need_stats=False, order=order)[0], want[0])
            note("aggregate_forward", err)
            du = ops.aggregate_backward(u, idx, qp, ext, ties, *g3, order=order)
            note("aggregate_backward", check_close(
                f"{name} du", du,
                ops.aggregate_backward_plain(u, idx, qp, ext, ties, *g3), 1e-5))
            # inputs read once, outputs written once: u, idx and sgn; the
            # forward's qp, ext, su, sq (4 B) and ties (1 B) a query and
            # channel; the VJP's qp, ext, g_ext, g_sum, g_sq and ties, du
            io = b * (ns * c * 4 + m * AGG_K * 4 + c * 4)
            slots = b * m * AGG_K * c
            work = {"aggregate_forward": (io + b * m * c * 17, slots * 6),
                    "aggregate_backward": (io + b * m * c * 21 + b * ns * c * 4,
                                           slots * 12)}
            kernel = {"aggregate_forward": lambda: ops.aggregate_forward(
                          u, idx, sgn, qp, order=order, keep_ties=True),
                      "aggregate_backward": lambda: ops.aggregate_backward(
                          u, idx, qp, ext, ties, *g3, order=order)}
            plain = {"aggregate_forward": lambda: ops.aggregate_forward_plain(
                         u, idx, sgn, qp, keep_ties=True),
                     "aggregate_backward": lambda: ops.aggregate_backward_plain(
                         u, idx, qp, ext, ties, *g3)}
            rows = (idx.long() + ns * torch.arange(b, device=dev)[:, None, None]
                    ).reshape(-1)
            library = {"aggregate_forward": None,
                       "aggregate_backward": lambda: torch.zeros(
                           b * ns, c, device=dev).index_add_(0, rows, gamma)}
            for k, (nbytes, nops) in work.items():
                ms = timed(k, cloud, kernel[k], plain[k], nbytes, nops, library[k])
                spent[k][0] += cuda_ms(kernel[k]) if ms is None else ms
                spent[k][1] += nbytes
                spent[k][2] += nops
        del gamma
    for k, (ms, nbytes, nops) in spent.items():
        bound = max(nbytes / PEAK_BYTES, nops / PEAK_OPS) * 1e3
        print(f"{k} {where}: 19 aggregations, the queries in their layouts' "
              f"order: {ms:.4f} ms a step (wrapper, median of {TIMING_RUNS}), "
              f"bound {bound:.4f} ms ({'bytes' if nbytes / PEAK_BYTES >= nops / PEAK_OPS else 'operations'}); "
              f"ext and ties identical to the twin, su, sq and du within "
              f"1e-5·(1+max)  [{tag}]")


def selection_scan(ops, spatial, support, query, k, layout, query_layout,
                   labels, cloud, where, note, timed, results, tag):
    """Kernel 14's selection (``labels`` None: the queries are the support)
    or kernel 17 over the stage layouts, as the loss calls them, against
    the twin: thresholds or labels identical; ``timed`` (on the uniform
    cloud) with the dense bound (the selection every pair, the vote every (query,
    support) pair once) and the listed one (:func:`listed_ops`: the chunks
    whose bound lies within the query's threshold, once: the function needs
    one distance test a point of them, though the vote's design lists and
    scans them twice, the selection and the count, which its line prints
    apart as the design's cost).  Returns the thresholds."""
    nb, ns, nq = support.shape[0], support.shape[1], query.shape[1]
    thr = ops.contrast.kth_distinct_plain(support, query, k)
    if labels is None:
        name, run = "contrast_select", lambda: ops.contrast_select(query, k, layout)
        plain = lambda: ops.contrast_select_plain(query, k)
        nbytes = nb * nq * 16
    else:
        name = "label_vote"
        run = lambda: ops.label_vote(support, labels, query, k, NUM_CLASSES,
                                     layout, query_layout)
        plain = lambda: ops.label_vote_plain(support, labels, query, k, NUM_CLASSES)
        nbytes = nb * (ns * 16 + nq * 16)
    got = run()
    note(name, check_equal(f"{name} {where} {nq} x {ns} k={k}", got,
                           thr if labels is None else plain()))
    visits, pairs = chunk_visits(spatial, support, query, thr, False, layout)
    dense_ops = nb * nq * ns * PAIR_OPS
    pruned_ops = listed_ops(visits, pairs, nb, nq)
    ms = timed(name, cloud, run, plain, nbytes, pruned_ops)
    if ms is not None:
        results[name]["dense_ops"] = results[name].get("dense_ops", 0.0) + dense_ops
        design = "" if labels is None else (
            f" (the design's two lists, selection and count: "
            f"{2 * pruned_ops / PEAK_OPS * 1e3:.4f} ms)")
        print(f"{name} {where} {nq} x {ns} k={k} (B={nb}): {ms:.4f} ms, bound "
              f"dense {dense_ops / PEAK_OPS * 1e3:.4f} / listed "
              f"{pruned_ops / PEAK_OPS * 1e3:.4f} ms{design}, chunk visits needed "
              f"{visits / (nb * nq):.2f} a query of {pairs // (nb * nq)}  [{tag}]")
    return thr


def scannet_selections(ops, spatial, dev, rng, note, tag):
    """Kernels 14's selection and 17 at the ScanNet step's shapes (B = 2 x
    64000 on a 0.02 m grid, stages from FPS) over one sort's stage
    layouts: the selection at the four stages, the vote at stages 1-3,
    identical to the twins, each timed (kernel and twin, one run each)."""
    nb, n = SCANNET_B, SCANNET_N
    pts = (rng.randint(0, 200, (nb, n, 3)) * 0.02).astype(np.float32)
    stages = [torch.from_numpy(pts).to(dev)]
    for _ in range(3):
        prev = stages[-1]
        stages.append(ops.gather_points(prev, ops.furthest_point_sample(
            prev, prev.shape[1] // 4)).contiguous())
    layouts = spatial.sort_stages(stages)
    lab = torch.from_numpy(rng.randint(0, SCANNET_CLASSES, (nb, n))
                           .astype(np.int32)).to(dev)
    line = []
    for s, (p, layout) in enumerate(zip(stages, layouts)):
        got, ms = timed_once(lambda: ops.contrast_select(p, KNN_K, layout))
        want, plain_ms = timed_once(lambda: ops.contrast_select_plain(p, KNN_K))
        note("contrast_select", check_equal(
            f"contrast_select ScanNet stage {s} {p.shape[1]}", got, want))
        line.append(f"selection {p.shape[1]} {ms:.3f} ms (plain {plain_ms:.1f})")
        if s == 0:
            continue
        got, ms = timed_once(lambda: ops.label_vote(
            stages[0], lab, p, 4 ** s, SCANNET_CLASSES, layouts[0], layout))
        want, plain_ms = timed_once(lambda: ops.label_vote_plain(
            stages[0], lab, p, 4 ** s, SCANNET_CLASSES))
        note("label_vote", check_equal(
            f"label_vote ScanNet stage {s} {p.shape[1]} x {n}", got, want))
        line.append(f"vote {p.shape[1]} x {n} k={4 ** s} {ms:.3f} ms "
                    f"(plain {plain_ms:.1f})")
    print(f"selection and vote at ScanNet's shapes (B={nb}, a 0.02 m grid), "
          f"identical to the twins, one run each: {'; '.join(line)}  [{tag}]")


def wrappers(ops) -> dict:
    return {"fps": ops.furthest_point_sample, "ball_query": ops.ball_query,
            "three_interpolation": ops.three_interpolation,
            "three_interpolation_backward": ops.three_interpolation_backward,
            "contrast_forward": ops.contrast_forward,
            "contrast_grad_rows": ops.contrast_grad_rows,
            "contrast_grad_support": ops.contrast_grad_support,
            "knn": ops.knn, "refine_cross": ops.refine_cross,
            "refine_cross_backward": ops.refine_cross_backward,
            "fps_b1": ops.furthest_point_sample_b1,
            "three_interpolation_backward_big":
                ops.three_interpolation_backward_big,
            "fps_pruned": ops.furthest_point_sample_pruned,
            "three_interpolation_big": ops.three_interpolation_big,
            "contrast_select": ops.contrast_select, "label_vote": ops.label_vote,
            "aggregate_forward": ops.aggregate_forward,
            "aggregate_backward": ops.aggregate_backward,
            "aggregate_forward_bf16": ops.aggregate_forward_bf16,
            "aggregate_backward_bf16": ops.aggregate_backward_bf16,
            "layout_keys": ops.spatial.layout_keys,
            "layout_pack": ops.spatial.layout_pack,
            "support_layout": ops.contrast.support_layout}


@contextlib.contextmanager
def configuration(knn_backend: str = "auto", agg_fused: str = "off"):
    """The process-wide switches of the approx configuration and the fused
    aggregation, set for a phase and back at their defaults after it."""
    from amcontrast3d_tpu_torch.ops.aggregate import set_agg_fused
    from amcontrast3d_tpu_torch.ops.knn import set_knn_backend

    set_knn_backend(knn_backend)
    set_agg_fused(agg_fused)
    try:
        yield
    finally:
        set_knn_backend("auto")
        set_agg_fused("off")


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


def interp_split(ops, b: int, n: int) -> dict:
    """The interpolation's launches in one decoder forward over ``b`` clouds
    of ``n`` points (stages n, n // 4, ...; stage s onto s - 1 at coarse
    width FP_CHANNELS[s - 1]), by the port's gate."""
    sizes = [n // 4 ** s for s in range(len(FP_CHANNELS) + 1)]
    big = sum(ops.forward_is_big(b, sizes[s], sizes[s + 1], c)
              for s, c in enumerate(FP_CHANNELS))
    split = {"three_interpolation": len(FP_CHANNELS) - big,
             "three_interpolation_big": big}
    return {k: v for k, v in split.items() if v}


def with_threshold(model, threshold: float):
    """A copy of an MM model whose SelfMask starts at ``threshold``."""
    m = copy.deepcopy(model)
    m.decoder.threshold = float(threshold)
    return m


def forward_vs_plain(model, pos, x, kind: str, path: str,
                     tol: float = 1e-4) -> None:
    """One forward with the kernels and one with every kernel's plain twin:
    stage positions identical, logits within tol·(1+max|logit|); for MM
    at the cfg's threshold and again at the median predicted ambiguity,
    where CrossMask rows matter."""
    from amcontrast3d_tpu_torch.tools.profile_eval import plain_ops

    models, notes = [model], [""]
    if kind == "mm":
        with torch.inference_mode():
            _, stages, rate = model(pos, x)
        if not 0 <= rate.item() <= 100:
            raise AssertionError(f"refine rate {rate.item()}")
        # the median of the distinct values: a bfloat16 tower's few distinct
        # ambiguities can put half the points on the plain median, and every
        # point at or above it
        values = torch.cat([a.reshape(-1) for a in stages["ambiguity"]]).unique()
        threshold = values[len(values) // 2].item()
        models.append(with_threshold(model, threshold))
        notes = [f"at the cfg's threshold {model.decoder.threshold}: ",
                 f"at the median of the {len(values)} distinct predicted "
                 f"ambiguities {threshold:.6f}: "]
    for m, note in zip(models, notes):
        with torch.inference_mode():
            out_k = m(pos, x)
            with plain_ops():
                out_p = m(pos, x)
        if kind == "mm":
            rate = out_k[2].item()
            if not (rate == out_p[2].item() and 0 <= rate <= 100
                    and (m is model or 0 < rate < 100)):
                raise AssertionError(f"refine rate {rate} vs plain "
                                     f"{out_p[2].item()}")
            note += f"refine rate {rate:.3f} %, "
        for s, (pk, pp) in enumerate(zip(out_k[1]["p"], out_p[1]["p"])):
            if not torch.equal(pk, pp):
                raise AssertionError(f"stage {s} positions differ from the plain ops")
        err = (out_k[0] - out_p[0]).abs().max().item()
        bound = tol * (1 + out_p[0].abs().max().item())
        if not err <= bound:
            raise AssertionError(f"logits vs plain ops: max abs err {err} > {bound}")
        print(f"{path} main path vs plain ops on the card: {note}stage "
              f"positions identical, logits ({out_k[0].dtype}) max abs err "
              f"{err} (tol {bound})")


def eval_path(ops, cfg, model, dev, rng, tag, kind: str, path: str = None,
              tol: float = 1e-4) -> dict:
    """The eval main path of ``kind`` (``path`` names its launch table);
    returns the kernels' launches in it.  ``tol``: of the logits against
    the plain ops."""
    from amcontrast3d_tpu_torch.engine import make_eval_step

    path = path or f"{kind} eval"
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

    forward_vs_plain(model, batches[0]["pos"], batches[0]["x"], kind, path, tol)
    med = statistics.median(forward_ms)
    STEP_TIMES[path] = (med, None)
    print(f"{path} forward B={B}x{N}: per-batch ms {forward_ms}; median "
          f"{med:.3f} ms = {B * N / med * 1e3:.1f} points/s  [{tag}]")
    return launches


def base_path(ops, dev, rng, tag: str) -> dict:
    """``--kind base``: ``BaseSeg`` over PointNet++ from
    ``cfgs/s3dis/pointnet++.yaml`` at full width (seeded random weights),
    one warm-up and one timed eval forward at B = 2 x 24000 through
    ``make_eval_step``; launches per forward, then one forward against the
    plain twins (stage positions identical, logits within
    1e-4·(1+max|logit|)).  Returns the kernels' launches."""
    from amcontrast3d_tpu_torch.engine import make_eval_step
    from amcontrast3d_tpu_torch.models import build_model_from_cfg, init_weights_
    from amcontrast3d_tpu_torch.tools.profile_eval import plain_ops
    from amcontrast3d_tpu_torch.utils.config import EasyConfig

    path = "base eval"
    cfg = EasyConfig()
    cfg.load(POINTNET2_CFG, recursive=True)
    model = build_model_from_cfg(cfg.model)
    init_weights_(model, torch.Generator().manual_seed(SEED))
    model = model.to(dev).eval()
    step = make_eval_step(model, cfg.num_classes)
    batch = {"pos": rng.rand(BASE_B, N, 3).astype(np.float32) * 4,
             "x": rng.rand(BASE_B, N, IN_CH).astype(np.float32),
             "y": rng.randint(0, cfg.num_classes, (BASE_B, N))}
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    counted = reset_counts(ops)
    for i in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = step(batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        if out["logits"].shape != (BASE_B, N, cfg.num_classes) or \
                not torch.isfinite(out["logits"]).all():
            raise AssertionError(f"{path}: bad logits")
        if int(out["cm"].sum()) != BASE_B * N:
            raise AssertionError(f"{path}: confusion matrix counts")
    launches = check_launches(path, counted, 2)
    stages = []
    hook = model.encoder.register_forward_hook(
        lambda mod, inp, out_: stages.append(out_[0]))
    with torch.inference_mode():
        logits_k = model(batch["pos"], batch["x"])
        with plain_ops():
            logits_p = model(batch["pos"], batch["x"])
    hook.remove()
    for s, (pk, pp) in enumerate(zip(*stages)):
        if not torch.equal(pk, pp):
            raise AssertionError(f"{path}: stage {s} positions differ from plain")
    err = (logits_k - logits_p).abs().max().item()
    tol = 1e-4 * (1 + logits_p.abs().max().item())
    if not err <= tol:
        raise AssertionError(f"{path}: logits vs plain ops {err} > {tol}")
    print(f"{path} main path: BaseSeg over PointNet++ "
          f"({os.path.relpath(POINTNET2_CFG, REPO)}, "
          f"{sum(p.numel() for p in model.parameters())} parameters) at "
          f"B={BASE_B}x{N}, launches per forward {LAUNCHES[path]}; forward "
          f"{ms:.3f} ms = {BASE_B * N / ms * 1e3:.1f} points/s; vs plain ops: "
          f"stage positions identical, logits max abs err {err} (tol {tol})  "
          f"[{tag}]")
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


def train_batch(rng, dev, b: int = B) -> dict:
    from amcontrast3d_tpu_torch.tools.profile_train import voronoi_labels

    pos = rng.rand(b, N, 3).astype(np.float32) * 4
    batch = {"pos": torch.from_numpy(pos),
             "x": torch.from_numpy(rng.rand(b, N, IN_CH).astype(np.float32)),
             "y": torch.from_numpy(voronoi_labels(rng, pos))}
    return {k: v.to(dev) for k, v in batch.items()}


def make_step(cfg, model, optimizer, dev, seed, kind: str,
              distributed: bool = False):
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
        torch.Generator(dev).manual_seed(seed), distributed=distributed)


def train_path(ops, cfg, model, dev, rng, tag, kind: str, path: str = None,
               batches: list = None, bf16: bool = False) -> dict:
    """The train main path of ``kind`` (``path`` names its launch table) on
    ``batches`` (the first untimed; by default N_TRAIN + 1 of
    :func:`train_batch`); returns the kernels' launches in it.  ``bf16``:
    a bfloat16 model, held to the plain ops at the bfloat16 tolerances."""
    from amcontrast3d_tpu_torch.optim import build_optimizer_from_cfg

    path = path or f"{kind} train"
    terms = ("loss",) if kind == "aa" else (
        "loss", "loss_seg", "loss_ce", "loss_contrast", "loss_reg")
    optimizer = build_optimizer_from_cfg(cfg.optimizer, model, lr=cfg.lr)
    step = make_step(cfg, model, optimizer, dev, SEED, kind)
    batches = batches or [train_batch(rng, dev) for _ in range(N_TRAIN + 1)]
    b, n = batches[0]["y"].shape
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
        if int(out["cm"].sum()) != b * n:
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
    STEP_TIMES[path] = (med, peak)
    print(f"{path} main path: {len(batches)} steps at B={b}x{n}, losses "
          f"{losses}, {len(start) - len(still)} of {len(start)} parameter "
          f"tensors changed (unchanged, each a bias ahead of a BatchNorm: "
          f"{still}), launches per "
          f"step {LAUNCHES[path]}"
          + (f", refine rate % {rates}" if kind == "mm" else ""))
    print(f"{path} step B={b}x{n}: per-step ms {step_ms}; median {med:.3f} ms "
          f"= {b * n / med * 1e3:.1f} train points/s; peak "
          f"{peak:.3f} GiB  [{tag}]")
    train_vs_plain(cfg, model, optimizer, dev, batches[0], tag, kind, path,
                   bf16)
    return launches


def scannet_fused_path(ops, dev, rng, tag: str) -> dict:
    """The approx + fused AA train step at the ScanNet recipe's shapes:
    ``cfgs/scannet/AMContrast3D-AA.yaml`` at full width (seeded random
    weights, 7 input channels, 20 classes), B = 2 rooms of 64000 points on
    a 0.04 m grid (``profile_big_kernels.gate_stages``' step clouds) with
    Voronoi labels, 1 untimed and 2 timed steps through
    ``make_train_step`` with the selection, the vote and the fused tail on
    (every separable aggregation, the set abstraction over the 64000-point
    stage 0 too, which the JAX package's VMEM rule keeps on the gather
    tail): finite losses, the launches per step, then one step against the
    plain ops from one state (loss and gradients within 1e-4).
    Returns the kernels' launches in it."""
    from amcontrast3d_tpu_torch.models import build_model_from_cfg, init_weights_
    from amcontrast3d_tpu_torch.tools.profile_big_kernels import room_cloud
    from amcontrast3d_tpu_torch.tools.profile_train import voronoi_labels
    from amcontrast3d_tpu_torch.utils.config import EasyConfig

    t = time.perf_counter()
    cfg = EasyConfig()
    cfg.load(SCANNET_CFG, recursive=True)
    model = build_model_from_cfg(cfg.model)
    init_weights_(model, torch.Generator().manual_seed(SEED))
    model = model.to(dev)
    batches = []
    for _ in range(3):
        pos = np.concatenate([room_cloud(rng, SCANNET_N, 0.04) * (0.5 - 0.1 * i)
                              + 0.3 * i for i in range(SCANNET_B)])
        batch = {"pos": pos, "x": rng.rand(SCANNET_B, SCANNET_N, 7).astype(np.float32),
                 "y": voronoi_labels(rng, pos)}
        batches.append({k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
    with configuration(knn_backend="approx", agg_fused="on"):
        launches = train_path(ops, cfg, model, dev, rng, tag, "aa",
                              "scannet aa train approx fused", batches)
    del model
    torch.cuda.empty_cache()
    FUSED_PHASE_S["ScanNet fused step"] = time.perf_counter() - t
    return launches


def agg_gate_phase(dev, tag: str) -> None:
    """Cells of the fused aggregation's gate table
    (``tools/profile_aggregation.py --gates`` reads the rule from the whole
    table): the ScanNet step (train) and the 311296-point subcloud (eval),
    where the JAX package's VMEM rule keeps stage 0 (and the subcloud's
    stage 1) on the gather tail; every separable aggregation shape, the
    fused tail against the gather tail (device time a call, CUDA events,
    2 runs a read in the order gather, fused, fused, gather: the kernels'
    device time, which decides, and the wall time), the two outputs within
    1e-3·(1+max), and the dispatch's choice."""
    from amcontrast3d_tpu_torch.tools import profile_aggregation

    t = time.perf_counter()
    rng = np.random.RandomState(SEED + 16)   # leaves the other phases' data
    cells = [c for c in profile_aggregation.GATE_CLOUDS
             if c[0] == "ScanNet step" or c[2] == 311296]
    rows = profile_aggregation.gate_table(dev, rng, tag, 2, cells)
    lost = [r for r in rows if not r[8] < r[9]]   # device time
    FUSED_PHASE_S["gate cells"] = time.perf_counter() - t
    print(f"aggregation gate cells: {len(rows)} shapes in "
          f"{FUSED_PHASE_S['gate cells']:.1f} s; the fused tail lost at "
          f"{[r[:3] for r in lost]}  [{tag}]")


def train_vs_plain(cfg, model, optimizer, dev, batch, tag, kind: str,
                   path: str = None, bf16: bool = False):
    """One step from one state with the kernels and one with the twins:
    stage positions identical; in float32 the loss within 1e-4 relative and
    the gradients within GRAD_TOL relative L2 over all parameters; a
    bfloat16 model's loss within BF16_LOSS_TOL·(1+|loss|) and each
    parameter's gradient within BF16_GRAD_TOL relative L2 (but the biases
    ahead of a BatchNorm, whose exact gradient is 0)."""
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
    if not (abs(k["loss"] - p["loss"]) <= BF16_LOSS_TOL * (1 + abs(p["loss"]))
            if bf16 else rel_loss <= 1e-4):
        raise AssertionError(f"train loss {k['loss']} vs plain {p['loss']}")
    from amcontrast3d_tpu_torch.ops.aggregate import agg_fused_enabled

    num = den = worst = 0.0
    exempt = zero_gradient_biases(model) if bf16 else set()
    off, w_dp = {}, {}
    for name, a, b in zip([n for n, _ in model.named_parameters()],
                          k["grads"], p["grads"]):
        d = (a - b).double().norm().item()
        n = b.double().norm().item()
        num, den = num + d * d, den + n * n
        tol = BF16_GRAD_TOL
        if bf16 and agg_fused_enabled() and name.endswith("w_dp.weight"):
            tol = BF16_FUSED_WDP_TOL
            w_dp[name] = d / max(n, 1e-30)
        elif name not in exempt:
            worst = max(worst, d / max(n, 1e-30))
        if bf16 and name not in exempt and not d <= tol * n:
            off[name] = d / max(n, 1e-30)
    rel_grad = (num / den) ** 0.5
    if off:
        raise AssertionError(f"train gradients vs plain at bfloat16 beyond "
                             f"{BF16_GRAD_TOL} relative L2: {off}")
    if not bf16 and not rel_grad <= GRAD_TOL:
        raise AssertionError(f"train gradients vs plain: relative L2 "
                             f"{rel_grad} > {GRAD_TOL}")
    if w_dp:
        note += (f"the fused tail's W_dp gradients relative L2 "
                 f"{min(w_dp.values()):.3e} to {max(w_dp.values()):.3e} (tol "
                 f"{BF16_FUSED_WDP_TOL}), ")
    print(f"{path or kind + ' train'} step vs plain ops on the card: {note}stage positions "
          f"identical, loss {k['loss']} vs {p['loss']} (rel {rel_loss:.3e}), "
          f"gradients relative L2 {rel_grad:.3e} over all parameters (worst "
          f"tensor {worst:.3e}); step {k['ms']:.1f} ms vs plain "
          f"{p['ms']:.1f} ms  [{tag}]")


def scene_launches(ops, clouds: list, kind: str) -> dict:
    """The launches the whole-scene test must have made: per subcloud
    forward 4 FPS calls (those ``fps_is_pruned`` names through the
    chunk-pruned kernel, each sorting its cloud with the two layout
    kernels), one sort of the stage clouds (two layout kernels), 8 ball
    queries (two per stage), 4 interpolations (those ``forward_is_big``
    names through the lane-a-point kernel, fp0 and fp1 at every bucket; the
    coarse widths are 128, 256, 512, 1024), for MM 4 CrossMask calls, and one
    boundary kNN over the subcloud's points."""
    want = {"fps_b1": 0, "fps_pruned": 0, "ball_query": 0,
            "three_interpolation": 0, "three_interpolation_big": 0,
            "knn": 0, **{k: 0 for k in SORT_LAUNCHES}}
    if kind == "mm":
        want["refine_cross"] = 0
    for cloud in clouds:
        for n, nb in zip(cloud["subclouds"], cloud["buckets"]):
            sizes = [nb // 4 ** s for s in range(5)]
            pruned = sum(ops.fps_is_pruned(1, ns, ns // 4)
                         for ns in sizes[:4])
            want["fps_pruned"] += pruned
            want["fps_b1"] += 4 - pruned
            want["ball_query"] += 8
            for k, v in SORT_LAUNCHES.items():
                want[k] += v * (1 + pruned)
            for k, v in interp_split(ops, 1, nb).items():
                want[k] += v
            want["knn"] += 1
            if kind == "mm":
                want["refine_cross"] += 4
    return {k: v for k, v in want.items() if v}


def scene_path(ops, kind: str, dev, tag: str, workdir: str, cfg_path: str,
               n_points: int, rooms: int, buckets: tuple,
               extra: tuple = ()) -> dict:
    """The whole-scene test of ``kind`` through ``main_cli`` on ``rooms``
    Synthetic rooms of ``n_points`` raw points whose subclouds all lie in
    ``buckets`` (each bucket met by some room); returns the kernels'
    launches in it."""
    from amcontrast3d_tpu_torch.data.data_util import bucket_size
    from amcontrast3d_tpu_torch.engine import Runner, evaluate
    from amcontrast3d_tpu_torch.engine.cli import load_cfg, main_cli, parse_args
    from amcontrast3d_tpu_torch.models import init_weights_
    from amcontrast3d_tpu_torch.tools.profile_eval import plain_ops
    from amcontrast3d_tpu_torch.transforms import build_transforms_from_cfg
    from amcontrast3d_tpu_torch.utils import EasyConfig, save_checkpoint

    recipe = os.path.basename(os.path.dirname(cfg_path))
    path = f"{kind} scene" if recipe == "s3dis" else \
        f"{recipe} {kind} scene {'/'.join(map(str, buckets))}"
    argv = ["--kind", kind, "--cfg", cfg_path, "mode=test",
            "dataset.common.NAME=Synthetic",
            f"dataset.common.num_rooms={rooms}",
            f"dataset.common.n_points={n_points}",
            "ambiguity_args.miou_B_I=True", f"root_dir={workdir}",
            f"seed={SEED}", "distributed=False", *extra]
    cfg = load_cfg(*parse_args(argv))
    # seeded random weights, handed to the CLI as a checkpoint
    runner = Runner(cfg, kind=kind, device=dev)
    init_weights_(runner.model, torch.Generator().manual_seed(SEED))
    ck = EasyConfig()
    ck.update({"run_name": f"smoke_{path.replace(' ', '_').replace('/', '_')}",
               "ckpt_dir": workdir})
    ckpt = save_checkpoint(ck, {"model": runner.model.state_dict()}, 0)

    counted = reset_counts(ops)
    torch.cuda.reset_peak_memory_stats()
    results = main_cli(None, argv + [f"pretrained_path={ckpt}"])
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counted.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30

    clouds = results["clouds"]
    seen = sorted({nb for c in clouds for nb in c["buckets"]})
    sizes = [n for c in clouds for n in c["subclouds"]]
    if len(clouds) != rooms or seen != sorted(buckets):
        raise AssertionError(f"{path}: {len(clouds)} rooms, buckets {seen}")
    if not all(bucket_size(n, cfg.get("eval_bucket", 8192)) == nb
               for c in clouds for n, nb in zip(c["subclouds"], c["buckets"])):
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
    want = scene_launches(ops, clouds, kind)
    if {k: v for k, v in launches.items() if v} != want:
        raise AssertionError(f"{path}: launches {launches}, expected {want}")
    rows = open(results["csv_path"]).read().splitlines()
    if len(rows) != 2 or not rows[0].startswith("method,Area,OA,mACC,mIoU"):
        raise AssertionError(f"{path}: results CSV {rows}")
    per_forward = {k: v / len(sizes) for k, v in want.items()}
    print(f"{path} main path: main_cli mode=test with {os.path.relpath(cfg_path, REPO)} "
          f"on {len(clouds)} Synthetic rooms, {len(sizes)} subcloud forwards, "
          f"launches {want} ({per_forward} a subcloud); mIoU "
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
    split = "test" if cfg.datatransforms.get("test") else "val"
    part = evaluate.prepare_parts(
        coord, feat, idx_points[:1], cfg,
        build_transforms_from_cfg(split, cfg.datatransforms))[0]
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


def val_forward_launches(ops, kind: str, n: int) -> dict:
    """The launches of one validation forward of a whole cloud (B = 1) of
    ``n`` points (its padded size): the interpolation's split by the
    gates."""
    want = {"fps_b1": 4, "ball_query": 8, **SORT_LAUNCHES,
            **interp_split(ops, 1, n)}
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
            results = cli.main_cli(kind, argv + ["distributed=False"])
    finally:
        faulthandler.cancel_dump_traceback_later()
    torch.cuda.synchronize()
    total = {k: fn.launches for k, fn in counted.items()}
    train = {k: v - val_counts.get(k, 0) for k, v in total.items()}
    return results, made[0], train, val_counts, val_sizes, total


def check_train_cli(ops, path, results, train, val_counts, val_sizes,
                    per_step, epochs, steps, batch_points, lrs, kind):
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
        for k, v in val_forward_launches(ops, kind, n).items():
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
    timing = check_train_cli(ops, path, results, train, val, sizes, SCANNET_LAUNCHES,
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
    check_train_cli(ops, f"{path} resumed", results3, train3, val3, sizes3,
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


def s3dis_cli_path(ops, kind: str, dev, tag: str, workdir: str,
                   amp: bool = False) -> dict:
    """The S3DIS recipe through the train CLI for two short epochs (the
    first starts the workers and warms the card up, the second is the one
    reported) with its full train transform list; ``amp``: with
    ``use_amp=True`` (a bfloat16 model); returns the kernels' launches in
    it."""
    path, steps = f"s3dis {kind} train cli" + (" bf16" if amp else ""), 3
    argv = ["--cfg", CFGS[kind], "dataset.common.NAME=Synthetic",
            "dataset.common.num_rooms=4", "dataset.common.n_points=100000",
            "dataset.train.loop=3", "dataset.val.num_rooms=1",
            "dataset.val.presample=False", f"batch_size={B}", "epochs=2",
            f"root_dir={workdir}", f"seed={SEED}"] + (["use_amp=True"] if amp
                                                      else [])
    torch.cuda.reset_peak_memory_stats()
    results, runner, train, val, sizes, total = run_train_cli(ops, argv, kind)
    cfg = runner.cfg
    dtypes = {m.compute_dtype for m in runner.model.modules()
              if hasattr(m, "compute_dtype")}
    if dtypes != {torch.bfloat16 if amp else torch.float32}:
        raise AssertionError(f"{path}: the model computes in {dtypes}")
    names = list(cfg.datatransforms.train)
    if len(names) != 8 or "PointCloudRotation" not in names:
        raise AssertionError(f"{path}: train transforms {names}")
    per_step = dict(LAUNCHES[f"{kind} train"])
    timing = check_train_cli(ops, path, results, train, val, sizes, per_step,
                             (1, 2), steps, B * N,
                             (runner.lr_fn(1), runner.lr_fn(2)), kind)
    peak = torch.cuda.max_memory_allocated() / 2**30
    note = f", refine rate {results['refine_rate']} %" if kind == "mm" else ""
    print(f"{path} main path: main_cli mode=train, 2 epochs of {steps} steps at "
          f"B={B}x{N} with the train transforms {names}, launches per train "
          f"step {per_step} (the per-row-lists interpolation VJP: "
          f"{train['three_interpolation_backward_big']}); losses "
          f"{[t['loss'] for t in timing]}, val mIoU {results['val_miou']:.3f}{note}")
    report_train_cli(path, timing, runner, loader_batch(runner, SEED + 6), peak,
                     cfg.dataloader.num_workers, tag)
    return total


def check_bf16_close(name: str, got, want, tol: float) -> float:
    """bfloat16 ``got`` within one bfloat16 ulp (of the larger of the two)
    of ``want`` plus tol·(1+max|want|), the tolerance of the float32 sums
    both are roundings of; returns the largest difference."""
    g, w = got.float(), want.float()
    big = torch.maximum(g.abs(), w.abs())
    ulp = torch.where(big > 0, torch.exp2(torch.floor(torch.log2(big)) - 7),
                      torch.zeros_like(big))
    over = ((g - w).abs() - ulp - tol * (1 + w.abs().max())).max().item()
    if not over <= 0:
        raise AssertionError(f"{name}: beyond one bfloat16 ulp by {over}")
    return (g - w).abs().max().item()


def bf16_aggregation_phase(ops, dev, rng, tag: str) -> dict:
    """The bfloat16 forms of kernels 20 and 21 (a bfloat16 ``u``, the fused
    tail under ``use_amp``) at PointNeXt-XL's 19 separable aggregations of
    the S3DIS AA step (B=4x24000, uniform, stages from FPS, the queries in
    their stage layout's order, K = 32, mixed ``sgn``), against their twins
    on the card: ext and the tie count identical, su and sq within
    1e-5·(1+max) (train form), ext identical (eval form); the VJP's float32
    accumulator within 1e-5·(1+max|du|) of the twin's, du exactly its
    rounding to bfloat16 and within one bfloat16 ulp of the twin's du.
    Each timed (wrapper, CUDA events) beside the float32 form on the same
    values in this call; the bound counts ``u`` at 2 bytes a value read and
    du at 2 bytes written; the VJP's library yardstick is ``index_add_`` of
    its (B·M·K, C) rows into a bfloat16 tensor."""
    from amcontrast3d_tpu_torch.models.pointnext import to_full_list
    from amcontrast3d_tpu_torch.ops import spatial

    results, timed, note = tally(BF16_KERNELS)
    stages = [torch.from_numpy(clouds(rng)["uniform"]).to(dev)]
    for _ in range(4):
        prev = stages[-1]
        idx = ops.furthest_point_sample(prev, prev.shape[1] // 4)
        stages.append(ops.gather_points(prev, idx).contiguous())
    layouts = spatial.sort_stages(stages)
    radii = to_full_list(0.1, [1, 4, 7, 4, 4], [1, 4, 4, 4, 4], 2)
    gen = torch.Generator(dev).manual_seed(SEED + 17)

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    f32 = {"aggregate_forward": 0.0, "aggregate_backward": 0.0}
    for s in range(1, 5):
        sup, q, c = stages[s - 1], stages[s], XL_WIDTHS[s - 1]
        m = q.shape[1]
        order = spatial.index_bits(layouts[s])
        groups = [(sup, ops.ball_query(sup, q, radii[s][0], AGG_K, layouts[s - 1],
                                       layouts[s]))]
        groups += [(q, ops.ball_query(q, q, radii[s][1], AGG_K, layouts[s]))] \
            * XL_BLOCKS[s - 1]
        gamma = randn(B * m * AGG_K, c).bfloat16()
        for j, (support, idx) in enumerate(groups):
            ns = support.shape[1]
            u = randn(B, ns, c).bfloat16()
            u32 = u.float()
            qp = randn(B, m, c)
            sgn = torch.where(randn(c) < 0, -1.0, 1.0)
            g3 = [randn(B, m, c) for _ in range(3)]
            name = f"bf16 aggregation stage {s} #{j} ({m}, {ns}, {AGG_K}, {c})"
            ext, su, sq, ties = ops.aggregate_forward(u, idx, sgn, qp, order=order,
                                                      keep_ties=True)
            want = ops.aggregate_forward_plain(u, idx, sgn, qp, keep_ties=True)
            err = check_equal(f"{name} ext", ext, want[0])
            check_equal(f"{name} ties", ties, want[3])
            err = max(err, check_close(f"{name} su", su, want[1], 1e-5),
                      check_close(f"{name} sq", sq, want[2], 1e-5))
            check_equal(f"{name} eval ext", ops.aggregate_forward(
                u, idx, sgn, need_stats=False, order=order)[0], want[0])
            note("aggregate_forward_bf16", err)
            acc, acc_want = (torch.empty(u.shape, device=dev) for _ in range(2))
            du = ops.aggregate_backward(u, idx, qp, ext, ties, *g3, order=order,
                                        accumulator=acc)
            du_want = ops.aggregate_backward_plain(u, idx, qp, ext, ties, *g3,
                                                   accumulator=acc_want)
            err = check_close(f"{name} du accumulator", acc, acc_want, 1e-5)
            check_equal(f"{name} du, the accumulator rounded", du, acc.bfloat16())
            check_bf16_close(f"{name} du", du, du_want, 1e-5)
            note("aggregate_backward_bf16", err)
            # u at 2 bytes; the forward's qp, ext, su, sq (4 B) and ties
            # (1 B) a query and channel; the VJP's qp, ext, g_ext, g_sum,
            # g_sq and ties, and du at 2 bytes
            io = B * (ns * c * 2 + m * AGG_K * 4 + c * 4)
            slots = B * m * AGG_K * c
            rows = (idx.long() + ns * torch.arange(B, device=dev)[:, None, None]
                    ).reshape(-1)
            work = {
                "aggregate_forward_bf16": (
                    io + B * m * c * 17, slots * 6,
                    lambda: ops.aggregate_forward(u, idx, sgn, qp, order=order,
                                                  keep_ties=True),
                    lambda: ops.aggregate_forward_plain(u, idx, sgn, qp,
                                                        keep_ties=True), None),
                "aggregate_backward_bf16": (
                    io + B * m * c * 21 + B * ns * c * 2, slots * 12,
                    lambda: ops.aggregate_backward(u, idx, qp, ext, ties, *g3,
                                                   order=order),
                    lambda: ops.aggregate_backward_plain(u, idx, qp, ext, ties,
                                                         *g3),
                    lambda: torch.zeros(B * ns, c, dtype=torch.bfloat16,
                                        device=dev).index_add_(0, rows, gamma))}
            for k, (nbytes, nops, kernel, plain, library) in work.items():
                timed(k, "uniform", kernel, plain, nbytes, nops, library)
            f32["aggregate_forward"] += cuda_ms(lambda: ops.aggregate_forward(
                u32, idx, sgn, qp, order=order, keep_ties=True))
            f32["aggregate_backward"] += cuda_ms(lambda: ops.aggregate_backward(
                u32, idx, qp, ext, ties, *g3, order=order))
        del gamma
    for k, ms in f32.items():
        r = results[k + "_bf16"]
        print(f"{k}_bf16 S3DIS step uniform: 19 aggregations, the queries in "
              f"their layouts' order: {r['ms']:.4f} ms a step (wrapper, median "
              f"of {TIMING_RUNS}); the float32 form on the same values "
              f"{ms:.4f} ms in this call; ext and ties identical to the twin, "
              f"su, sq and the VJP's float32 sums within 1e-5·(1+max), du their "
              f"rounding, within a bfloat16 ulp of the twin's  [{tag}]")
    return finish_kernels(results, "uniform", tag)


def bf16_model(cfg, dev):
    """``cfg``'s model with ``use_amp``'s compute type, the seeded weights
    the float32 phases take."""
    from amcontrast3d_tpu_torch.models import build_model_from_cfg, init_weights_

    model = build_model_from_cfg(cfg.model, dtype=torch.bfloat16)
    init_weights_(model, torch.Generator().manual_seed(SEED))
    return model.to(dev)


def remat_phase(ops, dev, rng, tag: str) -> dict:
    """The AA train step with ``encoder_args.remat`` and
    ``ambiguity_args.remat`` at B = 4 and 8 clouds of 24000 points (the
    S3DIS recipe at full width, seeded weights): one step from one state
    without remat, again without, and with: the losses and every BatchNorm
    statistic after the step identical, the kernels' launches identical
    (the recompute runs no FPS, ball query, sort, kNN or contrast kernel),
    and the gradients as close to the step without as two steps without
    are to each other (the VJP kernels' float atomics; identical where
    those two are).  Then 3 timed steps after 1 with and without, with
    the peak device memory.  Returns the launches of the timed remat
    steps."""
    from amcontrast3d_tpu_torch.models import build_model_from_cfg, init_weights_
    from amcontrast3d_tpu_torch.optim import build_optimizer_from_cfg
    from amcontrast3d_tpu_torch.utils.config import EasyConfig

    total = {}
    for b in REMAT_BATCHES:
        batches = [train_batch(rng, dev, b) for _ in range(N_TRAIN + 1)]
        cfgs, models = {}, {}
        for remat in (False, True):
            cfg = EasyConfig()
            cfg.load(CFGS["aa"], recursive=True)
            cfg.model.encoder_args.remat = remat
            cfg.ambiguity_args.remat = remat
            model = build_model_from_cfg(cfg.model)
            init_weights_(model, torch.Generator().manual_seed(SEED))
            cfgs[remat], models[remat] = cfg, model.to(dev)
        runs = []
        for remat in (False, False, True):
            m = copy.deepcopy(models[remat])
            opt = build_optimizer_from_cfg(cfgs[remat].optimizer, m,
                                           lr=cfgs[remat].lr)
            step = make_step(cfgs[remat], m, opt, dev, SEED + 1, "aa")
            counted = reset_counts(ops)
            out = step(batches[0])
            torch.cuda.synchronize()
            runs.append({"loss": out["loss"].item(),
                         "grads": [p.grad.detach().clone() for p in m.parameters()],
                         "buffers": [t.clone() for t in m.buffers()],
                         "launches": {k: fn.launches for k, fn in counted.items()}})
            del m, opt, step
        base, again, rem = runs

        def rel(a, b):
            num = sum((x - y).double().norm().item() ** 2 for x, y in zip(a, b))
            den = sum(y.double().norm().item() ** 2 for y in b)
            return (num / den) ** 0.5

        spread, diff = rel(again["grads"], base["grads"]), rel(rem["grads"], base["grads"])
        if not (rem["loss"] == base["loss"] == again["loss"]):
            raise AssertionError(f"remat B={b}: losses {base['loss']}, "
                                 f"{again['loss']}, remat {rem['loss']}")
        if not all(torch.equal(x, y) for x, y in zip(rem["buffers"], base["buffers"])):
            raise AssertionError(f"remat B={b}: BatchNorm statistics differ")
        if rem["launches"] != base["launches"]:
            raise AssertionError(f"remat B={b}: launches {rem['launches']} vs "
                                 f"{base['launches']}")
        if not (diff <= 2 * spread if spread > 0 else diff == 0):
            raise AssertionError(f"remat B={b}: gradients relative L2 {diff} "
                                 f"from the step without, two steps without "
                                 f"{spread} apart")
        print(f"aa train remat B={b}x{N} vs without, one step from one state "
              f"on the card: loss {rem['loss']} identical, BatchNorm statistics "
              f"identical, launches identical {dict((k, v) for k, v in rem['launches'].items() if v)}, "
              f"gradients relative L2 {diff:.3e} (two steps without: "
              f"{spread:.3e})  [{tag}]")
        for remat in (False, True):
            model = models[remat]
            opt = build_optimizer_from_cfg(cfgs[remat].optimizer, model,
                                           lr=cfgs[remat].lr)
            step = make_step(cfgs[remat], model, opt, dev, SEED, "aa")
            counted = reset_counts(ops)
            ms = []
            for i, batch in enumerate(batches):
                if i == 1:
                    torch.cuda.reset_peak_memory_stats()
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = step(batch)
                torch.cuda.synchronize()
                if i:
                    ms.append((time.perf_counter() - t) * 1e3)
                if not np.isfinite(out["loss"].item()):
                    raise AssertionError(f"remat B={b}: loss {out['loss']}")
            launches = check_launches("aa train", counted, len(batches))
            if remat:
                for k, v in launches.items():
                    total[k] = total.get(k, 0) + v
            peak = torch.cuda.max_memory_allocated() / 2**30
            path = f"aa train B={b}x{N}" + (" remat" if remat else "")
            STEP_TIMES[path] = (statistics.median(ms), peak)
            print(f"{path}: per-step ms {ms}; median {statistics.median(ms):.3f} "
                  f"ms = {b * N / statistics.median(ms) * 1e3:.1f} train "
                  f"points/s; peak {peak:.3f} GiB  [{tag}]")
            del opt, step
        del models, batches
        torch.cuda.empty_cache()
    print("remat steps in this call, median ms (peak GiB): " + ", ".join(
        f"{p} {ms:.3f} ({peak:.3f})" for p, (ms, peak) in STEP_TIMES.items()
        if p.startswith("aa train B=")) + f"  [{tag}]")
    return total



# ---- data parallelism: ranks spawned as child processes ------------------

def dp_path(kind: str, knn_backend: str, agg_fused: str, amp: bool) -> str:
    """The launch table's name of a train configuration."""
    path = f"{kind} train" + (" bf16" if amp else "")
    if knn_backend == "approx":
        path += " approx" + (" fused" if agg_fused == "on" else "")
    return path


def train_launches(ops, b: int) -> dict:
    """The AA train step's launch table for ``b`` clouds of N points: one
    cloud's FPS is ``fps_b1``, and the interpolation and its VJP split by
    the port's gates at that batch."""
    sizes = [N // 4 ** s for s in range(len(FP_CHANNELS) + 1)]
    big = {gate: sum(gate(b, sizes[s], sizes[s + 1], c)
                     for s, c in enumerate(FP_CHANNELS))
           for gate in (ops.forward_is_big, ops.backward_is_big)}
    want = dict(TRAIN_LAUNCHES, **({"fps_b1": TRAIN_LAUNCHES["fps"]}
                                   if b == 1 else {}))
    if b == 1:
        del want["fps"]
    fwd, bwd = big[ops.forward_is_big], big[ops.backward_is_big]
    want.update(three_interpolation=len(FP_CHANNELS) - fwd,
                three_interpolation_big=fwd,
                three_interpolation_backward=len(FP_CHANNELS) - bwd,
                three_interpolation_backward_big=bwd)
    return {k: v for k, v in want.items() if v}


def dp_fresh_model(kind: str, dev, amp: bool = False):
    """The cfg of ``kind`` and its model at full width (``amp``: at
    ``use_amp``'s bfloat16) with the seeded random weights every process
    draws alike; dropout off, as in the JAX package's multi-device checks
    (a rank draws masks of its own)."""
    from amcontrast3d_tpu_torch.models import build_model_from_cfg, init_weights_
    from amcontrast3d_tpu_torch.utils.config import EasyConfig

    cfg = EasyConfig()
    cfg.load(CFGS[kind], recursive=True)
    cfg.model.cls_args.dropout = 0
    model = build_model_from_cfg(cfg.model,
                                 dtype=torch.bfloat16 if amp else None)
    if kind not in DP_WEIGHTS:      # drawn once a process, then copied
        init_weights_(model, torch.Generator().manual_seed(SEED))
        DP_WEIGHTS[kind] = copy.deepcopy(model.state_dict())
    model.load_state_dict(DP_WEIGHTS[kind])
    return cfg, model.to(dev)


def dp_steps(ops, kind: str, dev, batch, path: str, mode: str, solo=None,
             timed: int = DP_TIMED, amp: bool = False) -> dict:
    """One step from the seeded state (its loss, the gradients AdamW sees
    and the BatchNorm statistics after it, the kernels' launches and the
    collectives in it), then ``timed`` steps on the host clock around
    synchronised steps (the ranks meet at a barrier before each).
    ``mode``: ``dist`` the data-parallel step; ``solo`` one process whose
    BatchNorms sync over ``solo``, a group of this rank alone (the same
    arithmetic on one copy); ``plain`` the one-process step."""
    from amcontrast3d_tpu_torch import parallel
    from amcontrast3d_tpu_torch.optim import build_optimizer_from_cfg

    cfg, model = dp_fresh_model(kind, dev, amp)
    if mode != "plain":
        parallel.sync_batchnorm_(model, solo if mode == "solo" else None)
    optimizer = build_optimizer_from_cfg(cfg.optimizer, model, lr=cfg.lr)
    step = make_step(cfg, model, optimizer, dev, SEED, kind, mode == "dist")
    names = {id(p): n for n, p in model.named_parameters()}
    grads = []
    optimizer.register_step_pre_hook(lambda opt, *_: grads.append(
        {names[id(p)]: p.grad.detach().clone() for g in opt.param_groups
         for p in g["params"] if p.grad is not None}) if not grads else None)
    counted = reset_counts(ops)
    parallel.reset_counts()
    out = step(batch)
    torch.cuda.synchronize()
    launches = check_launches(path, counted, 1)
    collectives = dict(parallel.COUNTS)
    stats = {n: b.detach().clone() for n, b in model.named_buffers()
             if n.endswith(("running_mean", "running_var"))}
    first = {"loss": out["loss"].item(), "grads": grads[0], "stats": stats}
    ms = []
    for _ in range(timed):
        torch.cuda.synchronize()
        if mode == "dist":
            parallel.barrier()
        t = time.perf_counter()
        loss = step(batch)["loss"].item()
        ms.append((time.perf_counter() - t) * 1e3)
        if not np.isfinite(loss):
            raise AssertionError(f"{path}: loss {loss}")
    del model, optimizer, step
    torch.cuda.empty_cache()
    return {"first": first, "launches": launches, "collectives": collectives,
            "ms": ms}


def dp_errors(got: dict, want: dict) -> dict:
    """A step against another: the loss (relative), the gradients over all
    parameters (relative L2) and the worst tensor's, every BatchNorm
    statistic (max abs over 1 + max)."""
    num = den = 0.0
    worst, worst_name = 0.0, None
    for n, g in want["grads"].items():
        d = (got["grads"][n] - g).double().norm().item()
        r = g.double().norm().item()
        num, den = num + d * d, den + r * r
        if r > 1e-3 and d / r > worst:
            worst, worst_name = d / r, n
    if set(got["grads"]) != set(want["grads"]):
        raise AssertionError("the steps have gradients of other parameters")
    return {"loss": abs(got["loss"] - want["loss"]) / abs(want["loss"]),
            "grads": (num / den) ** 0.5, "worst": worst, "worst_name": worst_name,
            "stats": max((got["stats"][n] - s).abs().max().item()
                         / (1 + s.abs().max().item())
                         for n, s in want["stats"].items())}


def dp_check(name: str, dist: dict, solo: dict, plain: dict,
             amp: bool = False) -> str:
    """The data-parallel step against one process on one copy with the same
    synced arithmetic (``solo``): loss, gradients and BatchNorm statistics
    within DP_TOL (at bfloat16, the gradients within DP_BF16_GRAD_TOL);
    against the plain one-process step: loss and statistics within DP_TOL,
    the gradients within DP_PLAIN_GRAD_TOL (float32 only; at bfloat16 the
    errors are printed)."""
    same, plain_err = dp_errors(dist, solo), dp_errors(dist, plain)
    bad = [k for k in ("loss", "stats") if not same[k] <= DP_TOL]
    if not same["grads"] <= (DP_BF16_GRAD_TOL if amp else DP_TOL):
        bad.append("grads")
    bounds = {} if amp else {"loss": DP_TOL, "stats": DP_TOL,
                             "grads": DP_PLAIN_GRAD_TOL}
    bad += [f"plain {k}" for k, b in bounds.items() if not plain_err[k] <= b]
    if bad:
        raise AssertionError(f"{name}: {bad} past their bounds: against one "
                             f"copy {same}, against the plain step "
                             f"{plain_err} (bounds {bounds})")
    return (f"against one process on one copy with the synced arithmetic: "
            f"loss rel err {same['loss']:.3e}, gradients rel L2 "
            f"{same['grads']:.3e} (worst tensor {same['worst']:.3e}), "
            f"BatchNorm statistics {same['stats']:.3e}; against the plain "
            f"one-process step{' (no bound at bfloat16)' if amp else ''}: "
            f"loss {plain_err['loss']:.3e}, statistics "
            f"{plain_err['stats']:.3e}, gradients rel L2 "
            f"{plain_err['grads']:.3e} (worst tensor {plain_err['worst']:.3e}, "
            f"{plain_err['worst_name']})")


def dp_bn_check(dev, label: str) -> None:
    """The synced BatchNorm over this launch's ranks against the plain
    training-mode BatchNorm of one process on the global rows, with no
    step around it (an independent reference that max-pool near-ties do not
    blur): each rank holds its rows of a seeded (world·B·N, 64) input, and
    its output, input gradient and running statistics, and the weight and
    bias gradients summed over the ranks, are held against the plain
    module's within DP_TOL (max abs over 1 + max; each rank's rows offset
    by 2·rank); at a bfloat16 input, the
    input gradient (bfloat16, both rounded from float32 sums) within
    DP_BN_BF16_TOL."""
    import torch.distributed as tdist
    from amcontrast3d_tpu_torch import parallel
    from amcontrast3d_tpu_torch.models.layers import batch_norm

    world, rank = parallel.get_world_size(), parallel.get_rank()
    rows, c = B * N, 64
    gen = torch.Generator().manual_seed(SEED + 19)
    x = torch.randn(world * rows, c, generator=gen) * 3.0 + 1.0
    # each rank's rows about a mean of their own, so the spread of the
    # ranks' means (the variance's cross-rank term) is not ~0
    x += 2.0 * torch.arange(world).repeat_interleave(rows)[:, None]
    g = torch.randn(world * rows, c, generator=gen).to(dev)
    weight = 1.0 + 0.1 * torch.randn(c, generator=gen)
    bias = torch.randn(c, generator=gen)
    mine = slice(rank * rows, (rank + 1) * rows)
    notes = []
    for dtype in (torch.float32, torch.bfloat16):
        got = {}
        for synced in (True, False):
            bn = batch_norm(c).to(dev).train()
            with torch.no_grad():
                bn.weight.copy_(weight)
                bn.bias.copy_(bias)
            if synced:
                parallel.sync_batchnorm_(bn)
            xs = x[mine] if synced else x
            xs = xs.to(dev, dtype).clone().requires_grad_()
            y = bn(xs)
            y.backward(g[mine] if synced else g)
            wb = torch.stack([bn.weight.grad, bn.bias.grad])
            if synced:
                tdist.all_reduce(wb)
            got[synced] = {
                "out": y.detach().float(), "dx": xs.grad.float(), "wb": wb,
                "stats": torch.stack([bn.running_mean, bn.running_var])}
        errs = {}
        for k, want in got[False].items():
            if k in ("out", "dx"):
                want = want[mine]
            errs[k] = ((got[True][k] - want).abs().max()
                       / (1 + want.abs().max())).item()
        bounds = {k: DP_TOL for k in errs}
        if dtype == torch.bfloat16:
            bounds["dx"] = DP_BN_BF16_TOL
        bad = {k: e for k, e in errs.items() if not e <= bounds[k]}
        if bad:
            raise AssertionError(f"dp BatchNorm {label} rank {rank} "
                                 f"{dtype}: {bad} past {bounds}")
        notes.append(f"{str(dtype).split('.')[-1]} "
                     + ", ".join(f"{k} {e:.3e}" for k, e in errs.items()))
    if rank == 0:
        print(f"dp BatchNorm {label}: the synced BatchNorm of {world} "
              f"rank(s), each ({rows}, {c}), against the plain one on the "
              f"global rows (max abs over 1 + max; weight and bias gradients "
              f"summed over the ranks): " + "; ".join(notes), flush=True)


def dp_batch(rows: int, dev, nudge: bool = False) -> dict:
    """The first ``rows`` clouds of the phase's batch (B x N, Voronoi
    labels), on ``dev``; ``nudge``: the features one float32 ulp up."""
    batch = train_batch(np.random.RandomState(SEED + 18), "cpu")
    batch = {k: v[:rows].to(dev) for k, v in batch.items()}
    if nudge:
        batch["x"] = torch.nextafter(batch["x"], torch.full_like(batch["x"], 9.0))
    return batch


def dp_solo_group():
    """A process group of rank 0 alone (every rank takes part in making
    it), over gloo: with a NCCL one, rank 0's reference steps hung four
    ranks on four cards while the others waited in a barrier."""
    import torch.distributed as dist
    return dist.new_group([0], backend="gloo")


def dp_nccl_rank(rank: int, dev, out_dir: str, tag: str) -> None:
    """A rank of (a): the AA train step over NCCL at the world size of the
    card count, each rank's rows the same B/world clouds, held on rank 0
    against one process on those clouds (the synced arithmetic, and the
    plain step), beside the spread of two plain steps whose features differ
    by one ulp; the plain step and the NCCL step timed in one process."""
    from amcontrast3d_tpu_torch import ops, parallel
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    world = parallel.get_world_size()
    rows = B // world if B % world == 0 else 1
    batch = dp_batch(rows, dev)
    path = f"aa train B={rows}"
    LAUNCHES[path] = train_launches(ops, rows)
    solo = dp_solo_group()
    dp_bn_check(dev, f"nccl x{world}")
    ref = {}
    if rank == 0:
        ref["plain"] = dp_steps(ops, "aa", dev, batch, path, "plain")
        ref["nudged"] = dp_steps(ops, "aa", dev, dp_batch(rows, dev, True),
                                 path, "plain", timed=0)
        ref["solo"] = dp_steps(ops, "aa", dev, batch, path, "solo", solo,
                               timed=0)
    print(f"dp nccl rank {rank}: at the barrier", flush=True)
    parallel.barrier()
    nccl = dp_steps(ops, "aa", dev, batch, path, "dist")
    print(f"dp nccl rank {rank}: the distributed steps done", flush=True)
    if rank == 0:
        name = f"dp aa train nccl x{world}"
        note = dp_check(name, nccl["first"], ref["solo"]["first"],
                        ref["plain"]["first"])
        spread = dp_errors(ref["nudged"]["first"], ref["plain"]["first"])
        print(f"{name} main path: {world} NCCL rank(s), each B={rows}x{N} (the "
              f"global batch {world * rows}x{N}), one step from the seeded "
              f"state (dropout off): {note}; two plain steps whose features "
              f"differ by one ulp: gradients rel L2 {spread['grads']:.3e} "
              f"(worst tensor {spread['worst']:.3e}), loss {spread['loss']:.3e}; "
              f"launches per step on rank 0 {LAUNCHES[path]}; collectives a "
              f"step {nccl['collectives']}", flush=True)
        print(f"{name} step B={rows}x{N} a rank: per-step ms {nccl['ms']}, "
              f"median {statistics.median(nccl['ms']):.3f}; the plain "
              f"one-process step in the same process {ref['plain']['ms']}, "
              f"median {statistics.median(ref['plain']['ms']):.3f}  [{tag}]",
              flush=True)
        with open(os.path.join(out_dir, "dp_nccl.json"), "w") as f:
            json.dump({name: nccl["launches"]}, f)


def dp_pair_rank(rank: int, dev, out_dir: str, tag: str, label: str,
                 scene: dict = None) -> None:
    """A rank of (b): two ranks (gloo on one card, or NCCL on two) on the
    AA and MM train steps, default tail and approx + fused, the global
    batch the phase's B clouds tiled twice, held on rank 0 against one
    process on one copy; then, with ``scene``, a rank of (c): the
    whole-scene test of one room, the subclouds shared by the two ranks."""
    from amcontrast3d_tpu_torch import ops, parallel
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    batch = dp_batch(B, dev)          # this rank's row of the tiled batch
    solo = dp_solo_group()
    dp_bn_check(dev, label)
    launches = {}
    for kind, knn_backend, agg_fused, amp in DP_PATHS:
        path = dp_path(kind, knn_backend, agg_fused, amp)
        name = f"dp {path} {label}"
        with configuration(knn_backend, agg_fused):
            if rank == 0:
                ref = {mode: dp_steps(ops, kind, dev, batch, path, mode, solo,
                                      timed=0, amp=amp)
                       for mode in ("solo", "plain")}
            parallel.barrier()
            timed = (DP_TIMED if (kind, knn_backend, agg_fused, amp)
                     == DP_TIMED_PATH else 0)
            got = dp_steps(ops, kind, dev, batch, path, "dist", timed=timed,
                           amp=amp)
        launches[name] = got["launches"]
        if rank == 0:
            note = dp_check(name, got["first"], ref["solo"]["first"],
                            ref["plain"]["first"], amp)
            print(f"{name} main path: 2 ranks ({label}), each B={B}x{N} (the "
                  f"global batch {2 * B}x{N}: one batch tiled twice), one step "
                  f"from the seeded state (dropout off): {note}; launches per "
                  f"step on each rank {LAUNCHES[path]}; collectives a step "
                  f"{got['collectives']}", flush=True)
            if got["ms"]:
                print(f"{name} step: per-step ms {got['ms']}, median "
                      f"{statistics.median(got['ms']):.3f}  [{tag}]",
                      flush=True)
    if scene is not None:
        launches[f"dp aa scene {label}"] = dp_scene(ops, dev, scene)
    with open(os.path.join(out_dir, f"dp_{label}_rank{rank}.json"), "w") as f:
        json.dump(launches, f)


def dp_scene(ops, dev, scene: dict, distributed: bool = True) -> dict:
    """The whole-scene test of ``scene``'s room from its checkpoint, the
    voted labels written to ``scene['run_dir']`` (rank 0); returns the
    kernels' launches on this rank, with the counts set to 0 just before
    and read just after."""
    from amcontrast3d_tpu_torch import parallel
    from amcontrast3d_tpu_torch.engine import Runner, evaluate
    from amcontrast3d_tpu_torch.engine.cli import load_cfg, parse_args

    cfg = load_cfg(*parse_args(scene["argv"]))
    cfg.run_dir = scene["run_dir"]
    runner = Runner(cfg, kind="aa", device=dev)
    if runner.distributed != distributed:
        raise AssertionError(f"dp aa scene: distributed {runner.distributed}")
    runner.load_pretrained(scene["ckpt"])
    counted = reset_counts(ops)
    parallel.reset_counts()
    t = time.perf_counter()
    results = evaluate.test_whole_scenes(runner, evaluate.generate_data_list(cfg),
                                         cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = {k: fn.launches for k, fn in counted.items()}
    if results:
        results["wall_s"] = wall
        results["collectives"] = dict(parallel.COUNTS)
        with open(os.path.join(scene["run_dir"], "results.json"), "w") as f:
            json.dump({k: results[k] for k in ("miou", "clouds", "wall_s",
                                                "collectives")}, f)
    return launches


def dp_phase(ops, dev, tag: str, workdir: str) -> dict:
    """Data parallelism (``amcontrast3d_tpu_torch.parallel``), the ranks
    spawned as child processes (``parallel.launch``; a rank that fails, or
    ranks that hang past DP_LIMIT_S, fail the run): (a) the AA train step
    over NCCL at the card count; (b) two gloo ranks on ``cuda:0`` and, on a
    host of two cards or more, two NCCL ranks on two cards: the AA and MM
    train steps, default tail and approx + fused; (c) the whole-scene test
    of one S3DIS room on the two gloo ranks, its voted labels identical to
    one process's.  Returns the kernels' launches by path (rank 0's)."""
    from amcontrast3d_tpu_torch import parallel
    from amcontrast3d_tpu_torch.engine import Runner
    from amcontrast3d_tpu_torch.engine.cli import load_cfg, parse_args
    from amcontrast3d_tpu_torch.models import init_weights_
    from amcontrast3d_tpu_torch.utils import EasyConfig, save_checkpoint

    t0 = time.perf_counter()
    out_dir = os.path.join(workdir, "dp")
    os.makedirs(out_dir)
    torch.cuda.empty_cache()
    cards = torch.cuda.device_count()
    by_path = {}
    parallel.launch(dp_nccl_rank, cards, (out_dir, tag), device_type="cuda",
                    backend="nccl", timeout=DP_LIMIT_S)
    by_path.update(json.load(open(os.path.join(out_dir, "dp_nccl.json"))))

    # (c)'s room: seeded random weights in a checkpoint, one process first
    argv = ["--kind", "aa", "--cfg", CFGS["aa"], "mode=test",
            "dataset.common.NAME=Synthetic", "dataset.common.num_rooms=1",
            f"dataset.common.n_points={SCENE_POINTS}",
            "ambiguity_args.miou_B_I=True", f"root_dir={workdir}",
            f"seed={SEED}", "save_pred=True"]
    holder = Runner(load_cfg(*parse_args(argv)), kind="aa", device=dev)
    init_weights_(holder.model, torch.Generator().manual_seed(SEED))
    ck = EasyConfig()
    ck.update({"run_name": "smoke_dp_scene", "ckpt_dir": workdir})
    ckpt = save_checkpoint(ck, {"model": holder.model.state_dict()}, 0)
    del holder
    scenes = {}
    for ranks in (1, 2):
        scenes[ranks] = {"argv": argv, "ckpt": ckpt,
                         "run_dir": os.path.join(workdir, f"dp_scene_{ranks}")}
        os.makedirs(scenes[ranks]["run_dir"])
    by_path["dp aa scene one process"] = dp_scene(ops, dev, scenes[1],
                                                  distributed=False)
    torch.cuda.empty_cache()

    pairs = [("gloo", 1, scenes[2])] + ([("nccl", 2, None)] if cards >= 2 else [])
    for backend, devices, scene in pairs:
        label = f"{backend} x2 on {devices} card" + ("s" if devices > 1 else "")
        parallel.launch(dp_pair_rank, 2, (out_dir, tag, label, scene),
                        device_type="cuda", backend=backend, devices=devices,
                        timeout=DP_LIMIT_S)
        for rank in (0, 1):
            got = json.load(open(os.path.join(
                out_dir, f"dp_{label}_rank{rank}.json")))
            for name, counts in got.items():
                if "scene" in name:
                    by_path[f"{name} rank {rank}"] = counts
                elif rank == 0:
                    by_path[name] = counts

    one, two = (np.loadtxt(os.path.join(scenes[r]["run_dir"], "predictions",
                                        "cloud_0.txt"), dtype=np.int64)
                for r in (1, 2))
    if one.shape != two.shape or not np.array_equal(one, two):
        raise AssertionError(f"dp aa scene: the two ranks' voted labels differ "
                             f"from one process's at {int((one != two).sum())} "
                             f"of {one.size} points")
    res = {r: json.load(open(os.path.join(scenes[r]["run_dir"], "results.json")))
           for r in (1, 2)}
    room = res[1]["clouds"][0]
    per = {r: {k: v for k, v in
               by_path[f"dp aa scene gloo x2 on 1 card rank {r}"].items() if v}
           for r in (0, 1)}
    print(f"dp aa scene main path: test_whole_scenes of one Synthetic room of "
          f"{room['points']} raw points ({len(room['subclouds'])} subclouds in "
          f"buckets {sorted(set(room['buckets']))}) on 2 gloo ranks on cuda:0: "
          f"voted labels identical to one process's at all {one.size} points, "
          f"mIoU {res[2]['miou']:.3f} / {res[1]['miou']:.3f}; launches rank 0 "
          f"{per[0]}, rank 1 {per[1]}; collectives {res[2]['collectives']}; "
          f"wall {res[2]['wall_s']:.3f} s against one process's "
          f"{res[1]['wall_s']:.3f} s  [{tag}]")
    print(f"dp phase: {time.perf_counter() - t0:.1f} s (spawning the ranks "
          f"included)")
    return by_path


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
    # the one-block handover kernel (a measurement tool the room FPS phase
    # holds beside the path's kernels) builds beside the library
    from amcontrast3d_tpu_torch.tools import fps_handover
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        tool = pool.submit(fps_handover.library, "handover")
        _build.load_library()
        tool.result()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.2f} s: "
          f"{_build.library_path()}")
    print(_build.library_path().with_suffix(".log").read_text().strip())

    rng = np.random.RandomState(SEED)
    kernels = kernel_phases(ops, dev, rng, tag)
    kernels.update(scene_kernel_phases(ops, dev, rng, tag))
    scannet_kernel_phases(ops, dev, rng, tag)
    kernels.update(rung_kernel_phases(ops, dev, rng, tag))
    gate_phase(ops, dev, tag)
    kernels.update(approx_kernel_phases(ops, dev, rng, tag))
    kernels.update(bf16_aggregation_phase(ops, dev, rng, tag))
    agg_gate_phase(dev, tag)
    kernels.update(layout_kernel_phases(ops, dev, tag))

    by_path = {}
    for kind in ("aa", "mm"):
        cfg = EasyConfig()
        cfg.load(CFGS[kind], recursive=True)
        model = build_model_from_cfg(cfg.model)
        init_weights_(model, torch.Generator().manual_seed(SEED))
        model = model.to(dev)
        by_path[f"{kind} eval"] = eval_path(ops, cfg, model, dev, rng, tag, kind)
        by_path[f"{kind} train"] = train_path(ops, cfg, model, dev, rng, tag, kind)
        # the approx configuration, then (AA) with the fused aggregation
        with configuration(knn_backend="approx"):
            path = f"{kind} train approx"
            by_path[path] = train_path(ops, cfg, model, dev, rng, tag, kind, path)
        if kind == "aa":
            with configuration(knn_backend="approx", agg_fused="on"):
                path = "aa train approx fused"
                by_path[path] = train_path(ops, cfg, model, dev, rng, tag, kind, path)
            with configuration(agg_fused="on"):
                by_path["aa eval fused"] = eval_path(ops, cfg, model, dev, rng,
                                                     tag, kind, "aa eval fused")
        if kind == "aa":
            by_path["scannet aa train approx fused"] = scannet_fused_path(
                ops, dev, rng, tag)
        # use_amp: the same paths with a bfloat16 model of the same weights
        del model
        torch.cuda.empty_cache()
        model = bf16_model(cfg, dev)
        path = f"{kind} eval bf16"
        by_path[path] = eval_path(ops, cfg, model, dev, rng, tag, kind, path,
                                  BF16_LOGIT_TOL)
        path = f"{kind} train bf16"
        by_path[path] = train_path(ops, cfg, model, dev, rng, tag, kind, path,
                                   bf16=True)
        if kind == "aa":
            with configuration(knn_backend="approx", agg_fused="on"):
                path = "aa train bf16 approx fused"
                by_path[path] = train_path(ops, cfg, model, dev, rng, tag, kind,
                                           path, bf16=True)
        print(f"{kind} steps in this call, median ms (peak GiB): " + ", ".join(
            f"{p} {ms:.3f}" + (f" ({peak:.3f})" if peak is not None else "")
            for p, (ms, peak) in STEP_TIMES.items()
            if p.startswith((kind, f"scannet {kind}")))
            + f"  [{tag}]")
        del model
        torch.cuda.empty_cache()
    by_path["aa train remat"] = remat_phase(ops, dev, rng, tag)
    by_path["base eval"] = base_path(ops, dev, rng, tag)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as workdir:
        for kind in ("aa", "mm"):
            by_path[f"{kind} scene"] = scene_path(
                ops, kind, dev, tag, workdir, CFGS[kind], SCENE_POINTS,
                SCENE_ROOMS[kind], SCENE_BUCKETS[:SCENE_ROOMS[kind]])
            torch.cuda.empty_cache()
        # the rungs from 221184 up: the ScanNet recipe, one room a bucket
        for kind, cfg_path, bucket in (("aa", SCANNET_CFG, 221184),
                                       ("aa", SCANNET_CFG, 311296),
                                       ("mm", SCANNET_MM_CFG, 221184)):
            by_path[f"scannet {kind} scene {bucket}"] = scene_path(
                ops, kind, dev, tag, workdir, cfg_path, RUNG_ROOMS[bucket], 1,
                (bucket,), (f"dataset.common.num_classes={SCANNET_CLASSES}",))
            torch.cuda.empty_cache()
        by_path["scannet aa train cli"] = scannet_cli_path(ops, dev, tag, workdir)
        torch.cuda.empty_cache()
        for kind in ("aa", "mm"):
            by_path[f"s3dis {kind} train cli"] = s3dis_cli_path(
                ops, kind, dev, tag, workdir)
            torch.cuda.empty_cache()
        by_path["s3dis aa train cli bf16"] = s3dis_cli_path(
            ops, "aa", dev, tag, workdir, amp=True)
        torch.cuda.empty_cache()
        by_path.update(dp_phase(ops, dev, tag, workdir))

    rows = [{"name": k, "route": "cuda", "source": src, "replaces": tpu,
             "launches": sum(counts[k] for counts in by_path.values()),
             "launches_by_path": {path: counts[k]
                                  for path, counts in by_path.items()},
             "max_abs_err": kernels[k]["err"], "ms": kernels[k]["ms"],
             "plain_ms": kernels[k]["plain_ms"],
             "bound_ms": kernels[k]["bound_ms"],
             "bound_by": kernels[k]["bound_by"],
             "library_ms": kernels[k]["library_ms"],
             **({"dense_bound_ms": kernels[k]["dense_bound_ms"]}
                if "dense_bound_ms" in kernels[k] else {})}
            for k, src, tpu in KERNELS]
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s in all, the build "
          f"included; the fused aggregation's ScanNet and gate phases "
          f"{sum(FUSED_PHASE_S.values()):.1f} s ("
          + ", ".join(f"{k} {v:.1f}" for k, v in FUSED_PHASE_S.items()) + ")")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
