"""Time the fused grouped aggregation on one NVIDIA GPU: its two kernels
(``csrc/aggregate.cu``, the TPU kernels 20 and 21) at the train steps'
shapes, and the table its dispatch rule is read from.

    python3 -m amcontrast3d_tpu_torch.tools.profile_aggregation [--runs R]
        [--bf16]
    python3 -m amcontrast3d_tpu_torch.tools.profile_aggregation --gates

Without ``--gates``: the kernels' own device time (``torch.profiler``, R
runs) at PointNeXt-XL's 19 separable aggregations (per stage a set
abstraction, support stage s − 1 and queries stage s, and its InvResMLP
blocks, which share one grouping of stage s; C = 128, 256, 512, 1024;
ball query, K = 32, radii from the cfg) of the S3DIS step (B = 4 × 24000,
on a uniform cloud in [0, 4]³ and on a clustered one, 64 blobs of σ 0.05,
as ``chip_smoke.py`` makes them) and of the ScanNet step (B = 2 × 64000,
rooms on a 0.04 m grid): the train forward (moments and tie count), the
VJP (its memset of du, or a parent's zero fill, counted) and the eval
forward, each summed over a step with the stage lines beside it.  Where
the package's wrappers take the query order (``order=``), the queries go
in their stage layout's order (one ``sort_stages`` a step, as the encoder
makes them); a parent's package runs its own wrappers' arguments, so
``profile_ab.sh`` can put the two side by side (``AB_BOTH_PACKAGES``).
``--bf16``: each step's lines again with a bfloat16 ``u`` (``use_amp``'s
fused tail), through the kernels' bfloat16 forms (the VJP's closing
rounding pass counted), beside the float32 form in the same call.

``--gates``: the fused tail (``GroupStatsBN.pool`` through
``grouped_slot_reduce``) against the gather tail (``_grouped_tail``), each
as ``models/pointnext.py::_separable_tail`` runs it in a
``SetAbstraction`` or ``LocalAggregation`` of the width, at every
separable aggregation shape of the S3DIS and ScanNet steps (train mode:
forward and backward), of the S3DIS step's eval forward and of one room
subcloud at 106496, 155648, 221184 and 311296 points (B = 1, eval mode:
the forward).  Two times a call, each the
median of two reads taken gather, fused, fused, gather (R runs a read):
the kernels' device time (``torch.profiler``, every kernel the call
launches), which decides, and the wall time by CUDA events (the tails'
host work included where the card waits on it); a gather tail that runs
out of memory loses.  Each line holds the two outputs against each other
(within 1e-3·(1+max): the fused tail's one-pass variance) and the
dispatch's choice.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from amcontrast3d_tpu_torch import ops
from amcontrast3d_tpu_torch.ops import spatial
from amcontrast3d_tpu_torch.tools.profile_big_kernels import card, cuda_ms, gate_stages
from amcontrast3d_tpu_torch.tools.profile_scans import fps_stages, kernel_ms, takes

AB_BOTH_PACKAGES = True

# PointNeXt-XL (cfgs/*/AMContrast3D-AA.yaml): the widths of encoder stages
# 1-4, each stage's InvResMLP blocks, the slots of a ball
WIDTHS, BLOCKS, K = (128, 256, 512, 1024), (3, 6, 3, 3), 32
ENC_BLOCKS, ENC_STRIDES = [1, 4, 7, 4, 4], [1, 4, 4, 4, 4]
FWD_KERNEL = ("aggregate_forward_kernel",)
BWD_KERNELS = ("aggregate_backward_kernel", "Memset", "FillFunctor",
               "round_to_bf16_kernel")
# (name, B, points a cloud, voxel of a room-like cloud or None, the cfg's
# radius, train): the clouds the dispatch rule is read on
GATE_CLOUDS = (("S3DIS step", 4, 24000, None, 0.1, True),
               ("S3DIS step", 4, 24000, None, 0.1, False),
               ("ScanNet step", 2, 64000, 0.02, 0.05, True),
               ("subcloud", 1, 106496, 0.04, 0.1, False),
               ("subcloud", 1, 155648, 0.04, 0.1, False),
               ("subcloud", 1, 221184, 0.02, 0.05, False),
               ("subcloud", 1, 311296, 0.02, 0.05, False))


def clustered_cloud(rng, b: int, n: int) -> np.ndarray:
    """64 Gaussian blobs of σ 0.05 in [0, 4]³ a cloud (``chip_smoke.py``'s
    clustered cloud): balls are full."""
    centres = rng.rand(b, 64, 3) * 4
    pick = rng.randint(0, 64, (b, n))
    return (np.take_along_axis(centres, pick[..., None], 1)
            + 0.05 * rng.randn(b, n, 3)).astype(np.float32)


def groupings(stages, layouts, radius: float):
    """Per encoder stage s = 1 … 4: (support, queries, C, [(kind, idx,
    count)]): the set abstraction's grouping (stage s − 1 onto s) and the
    blocks' shared one (stage s onto itself), with the queries' layout."""
    from amcontrast3d_tpu_torch.models.pointnext import to_full_list

    radii = to_full_list(radius, ENC_BLOCKS, ENC_STRIDES, 2)
    out = []
    for s in range(1, 5):
        sup, q = stages[s - 1], stages[s]
        sa = ops.ball_query(sup, q, radii[s][0], K, layouts[s - 1], layouts[s])
        blk = ops.ball_query(q, q, radii[s][1], K, layouts[s])
        out.append((s, sup, q, WIDTHS[s - 1],
                    [("set abstraction", sup, sa, 1),
                     ("block", q, blk, BLOCKS[s - 1])]))
    return out


def kernel_lines(name: str, stages, radius: float, runs: int,
                 dtype=torch.float32) -> dict:
    """The two kernels at a step's 19 aggregations, ``u`` in ``dtype``;
    returns the step's kernel device ms {train forward, VJP, eval
    forward}."""
    new_api = takes(ops.aggregate_forward, "order")
    layouts = spatial.sort_stages(stages)
    b = stages[0].shape[0]
    gen = torch.Generator(stages[0].device).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, device=stages[0].device, generator=gen)

    totals = {"train forward": 0.0, "VJP": 0.0, "eval forward": 0.0}
    for s, _, q, c, groups in groupings(stages, layouts, radius):
        for kind, support, idx, count in groups:
            m, ns = q.shape[1], support.shape[1]
            u, qp = randn(b, ns, c).to(dtype), randn(b, m, c)
            sgn = torch.where(randn(c) < 0, -1.0, 1.0)
            g3 = [randn(b, m, c) for _ in range(3)]
            if new_api:
                order = spatial.index_bits(layouts[s])
                ext, _, _, ties = ops.aggregate_forward(u, idx, sgn, qp, order=order,
                                                        keep_ties=True)
                calls = {
                    "train forward": lambda: ops.aggregate_forward(
                        u, idx, sgn, qp, order=order, keep_ties=True),
                    "VJP": lambda: ops.aggregate_backward(
                        u, idx, qp, ext, ties, *g3, order=order),
                    "eval forward": lambda: ops.aggregate_forward(
                        u, idx, sgn, need_stats=False, order=order)}
            else:
                ext = ops.aggregate_forward(u, idx, sgn, qp)[0]
                calls = {
                    "train forward": lambda: ops.aggregate_forward(u, idx, sgn, qp),
                    "VJP": lambda: ops.aggregate_backward(u, idx, sgn, qp, ext, *g3),
                    "eval forward": lambda: ops.aggregate_forward(
                        u, idx, sgn, need_stats=False)}
            ms = {what: kernel_ms(fn, runs, BWD_KERNELS if what == "VJP"
                                  else FWD_KERNEL)
                  for what, fn in calls.items()}
            for what in totals:
                totals[what] += count * ms[what]
            print(f"  {name} stage {s} {kind} (B={b}, M={m}, N={ns}, C={c}, "
                  f"K={K}) x{count}: " + ", ".join(
                      f"{what} {v:.4f}" for what, v in ms.items()) + " ms a call")
    print(f"{name} u {str(dtype).rsplit('.', 1)[-1]}: kernel device ms a "
          f"step (19 aggregations): " + ", ".join(
        f"{what} {v:.4f}" for what, v in totals.items()))
    return totals


def _module(kind: str, c: int, radius: float):
    from amcontrast3d_tpu_torch.models import pointnext

    common = dict(norm_args={"norm": "bn"}, act_args={"act": "relu"},
                  conv_args={"order": "conv-norm-act"},
                  group_args={"NAME": "ballquery", "radius": radius,
                              "nsample": K, "normalize_dp": True})
    if kind == "block":
        return pointnext.LocalAggregation([c, c], **common)
    return pointnext.SetAbstraction(in_channels=c // 2, out_channels=c,
                                    stride=4, **common)


def gate_table(dev, rng, tag: str, runs: int = 5, clouds=GATE_CLOUDS) -> list:
    """The fused and the gather tail at every separable aggregation shape
    of ``clouds`` (see the module's docstring); prints a line a shape and a
    cloud's sums, and returns the rows (name, stage, kind, B, M, N, C,
    train, fused device ms, gather device ms, fused wall ms, gather wall
    ms, count a forward)."""
    from amcontrast3d_tpu_torch.models import pointnext
    from amcontrast3d_tpu_torch.models.pointnext import to_full_list
    from amcontrast3d_tpu_torch.ops.aggregate import set_agg_fused

    rows = []
    set_agg_fused("on")
    try:
        for name, b, n, voxel, radius, train in clouds:
            stages = gate_stages(dev, rng, b, n, voxel)
            layouts = spatial.sort_stages(stages)
            radii = to_full_list(radius, ENC_BLOCKS, ENC_STRIDES, 2)
            sums = [0.0] * 4   # fused device, wall; gather device, wall
            for s, _, q, c, groups in groupings(stages, layouts, radius):
                for kind, support, idx, count in groups:
                    r = radii[s][0] if kind == "set abstraction" else radii[s][1]
                    mod = _module(kind, c, r).to(dev).train(train)
                    cin = c // 2 if kind == "set abstraction" else c
                    f = torch.randn(b, support.shape[1], cin, device=dev,
                                    requires_grad=train)
                    dp = (None if kind == "set abstraction" else
                          ops.group_points(q, idx) - q[:, :, None, :])
                    pool = (mod.pool if kind == "block"
                            else lambda t: torch.amax(t, dim=-2))
                    gout = torch.randn(b, q.shape[1], c, device=dev)

                    def tail(fused, mod=mod, f=f, support=support, idx=idx,
                             dp=dp, pool=pool, gout=gout, s=s):
                        with torch.set_grad_enabled(train):
                            out = pointnext._separable_tail(
                                mod, fused, idx, f, support, q, mod.act, pool,
                                dp, layouts[s])
                            if train:
                                out.backward(gout)
                        return out.detach()

                    got = tail(True)
                    try:
                        want = tail(False)
                    except torch.cuda.OutOfMemoryError:
                        want = None
                        torch.cuda.empty_cache()
                    err = (float("nan") if want is None
                           else (got - want).abs().max().item())
                    if want is not None and not err <= 1e-3 * (
                            1 + want.abs().max().item()):
                        raise AssertionError(f"{name} stage {s} {kind}: fused "
                                             f"vs gather tail {err}")
                    del got, want
                    reads = {(fused, what): [] for fused in (True, False)
                             for what in ("device", "wall")}
                    for fused in (False, True, True, False):
                        def call(fused=fused):
                            return tail(fused)
                        try:
                            reads[fused, "device"].append(
                                kernel_ms(call, runs, ("",)))
                            reads[fused, "wall"].append(cuda_ms(call, runs))
                        except torch.cuda.OutOfMemoryError:
                            reads[fused, "device"].append(float("inf"))
                            reads[fused, "wall"].append(float("inf"))
                            torch.cuda.empty_cache()
                    ms = {key: sum(v) / 2 for key, v in reads.items()}
                    takes_fused = pointnext._fused("relu")
                    m = q.shape[1]
                    rows.append((name, s, kind, b, m, support.shape[1], c, train,
                                 ms[True, "device"], ms[False, "device"],
                                 ms[True, "wall"], ms[False, "wall"], count))
                    for i, what in enumerate(("device", "wall")):
                        sums[i] += count * ms[True, what]
                        sums[2 + i] += count * ms[False, what]
                    wins = ms[True, "device"] < ms[False, "device"]
                    print(f"gate {name} {b}x{n} stage {s} {kind} (B={b}, M={m}, "
                          f"N={support.shape[1]}, C={c}, K={K}) "
                          f"{'train' if train else 'eval'}: device fused "
                          f"{ms[True, 'device']:.4f} ms, gather "
                          f"{ms[False, 'device']:.4f} ms; wall fused "
                          f"{ms[True, 'wall']:.4f} ms, gather "
                          f"{ms[False, 'wall']:.4f} ms; x{count} a forward; fused "
                          f"vs gather output max abs err {err:.3e}; "
                          f"{'fused' if wins else 'gather'} wins; the dispatch "
                          f"takes {'fused' if takes_fused else 'gather'}  [{tag}]")
                    del mod, f, dp, gout
            print(f"gate {name} {b}x{n} {'train' if train else 'eval'}: the "
                  f"19 aggregations, device fused {sums[0]:.4f} ms, gather "
                  f"{sums[2]:.4f} ms; wall fused {sums[1]:.4f} ms, gather "
                  f"{sums[3]:.4f} ms  [{tag}]")
            del stages, layouts
            torch.cuda.empty_cache()
    finally:
        set_agg_fused("off")
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--gates", action="store_true",
                    help="the fused tail against the gather tail, per shape")
    ap.add_argument("--runs", type=int, default=11)
    ap.add_argument("--bf16", action="store_true",
                    help="each step also with a bfloat16 u")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_aggregation needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    tag = card()
    print(f"{tag}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    rng = np.random.RandomState(0)
    if args.gates:
        gate_table(dev, rng, tag, args.runs)
        return
    dtypes = (torch.float32, torch.bfloat16) if args.bf16 else (torch.float32,)
    steps = [(name, fps_stages(torch.from_numpy(pts).to(dev), 5), 0.1)
             for name, pts in (
                 ("S3DIS step uniform",
                  rng.rand(4, 24000, 3).astype(np.float32) * 4),
                 ("S3DIS step clustered", clustered_cloud(rng, 4, 24000)))]
    steps.append(("ScanNet step", gate_stages(dev, rng, 2, 64000, 0.02), 0.05))
    for name, stages, radius in steps:
        for dtype in dtypes:
            kernel_lines(name, stages, radius, args.runs, dtype)


if __name__ == "__main__":
    main()
