"""Synthetic convergence gate of the port: multi-epoch AA and MM training
through the port's CLI, held to the JAX tool's bars.

↔ ``tools/convergence_check.py`` of the JAX package: the same flags, legs,
overrides, bars and summary keys, so that a summary of the port and one of
the JAX package read side by side.  The procedural rooms
(``data/synthetic.py``) are separable, so a correct train path (encoder and
decoder, the adaptive-margin contrast, for MM the APM and the masked
refinement, AdamW and the cosine schedule, whole-cloud validation) solves
them in a few dozen epochs; a silent numerical regression anywhere in it
shows up here as a miss.  The primary criterion is the final val overall
accuracy (bar 97); the best val mIoU (bar 60) is a lower-bar canary, as the
small val set caps it.  Each trained checkpoint then goes through
``mode=test`` whole-scene voting with the boundary / inner split and the
ambiguity buckets (bars: OA ≥ ``--oa-bar`` − 2, mIoU ≥ 90).

    python -m amcontrast3d_tpu_torch.tools.convergence_check \\
        [--epochs 40] [--kinds aa,mm] [--ab] [--amp] [--agg-fused] \\
        [--deltas N [--deltas-variants ce,aa,mm]] [--device cpu] \\
        [--override key=value ...] [--out summary.json]
    python -m amcontrast3d_tpu_torch.tools.convergence_check \\
        --merge SUMMARY.json ... [--out summary.json]

Each leg runs ``main_cli`` of the port in a fresh process (the backend
switches are read at import).  The run is on the card unless ``--device
cpu`` is given; without a card it stops.  ``--override``s go to the test
legs too, so that the model a test leg builds is the one its train leg
trained; one written ``aa:key=value`` or ``mm:key=value`` goes to the legs
of that model kind only (the CE-only variant is an AA leg), for the keys
one cfg has and the other lacks (``model.APM_args``).  The summary is
written to ``--out`` after every leg, so a run cut short keeps what it
finished.  Exit code 1 when a bar or an assert is missed.  The legs
inherit the environment, so a switch set there reaches every leg.

``--merge SUMMARY ...`` trains nothing: it joins summaries that ``--out``
wrote, from runs split to fit a card call's time (the default legs in
one, each delta variant in another), keeps each leg's verdict, applies
the delta asserts to the delta scores joined variant by variant in the
order given, and writes the union as one run's summary would read.

Where the port differs from the JAX package, the flags say so: its default
kNN backend is the exact one, so ``--ab`` trains AA with
``AMC3D_KNN_BACKEND=approx`` (the selection mode of kernel 14 and the label
vote, kernel 17) and reports approx − exact; its ``AMC3D_AGG_FUSED=auto``
means off, so ``--agg-fused`` sets ``on``; it has no recall budget to sweep,
so ``--recall-sweep`` is refused.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

# the environment of the legs that switch a backend
AB_ENV = {"AMC3D_KNN_BACKEND": "approx"}
AGG_FUSED_ENV = {"AMC3D_AGG_FUSED": "on"}
RECALL_REFUSAL = (
    "--recall-sweep has no counterpart in the port: it sweeps "
    "AMC3D_KNN_RECALL, the recall budget of the JAX package's approximate "
    "top-k on the TPU, and the port's approx threshold is the k-th distinct "
    "d² × (1 + 1e-6), with no budget to sweep")

_PHASE_SNIPPET = """
import json, sys
sys.path.insert(0, {repo!r})
from amcontrast3d_tpu_torch.engine.cli import main_cli
results = main_cli({kind!r}, argv={argv!r})
results = {{k: v for k, v in results.items()
           if isinstance(v, (int, float, str, list, tuple, dict))}}
with open({out!r}, "w") as f:
    json.dump(results, f)
"""


def run_phase(kind: str, argv: list, tag: str, workdir: str,
              extra_env: dict = None) -> dict:
    """``main_cli(kind, argv)`` in a fresh process; its results, with the
    leg's wall seconds as ``leg_seconds``."""
    out = os.path.join(workdir, f"{tag}.json")
    code = _PHASE_SNIPPET.format(repo=REPO, kind=kind, argv=argv, out=out)
    env = {**os.environ, **(extra_env or {})}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env)
    if proc.returncode != 0 or not os.path.exists(out):
        raise RuntimeError(f"phase {tag} failed (exit {proc.returncode})")
    with open(out) as f:
        res = json.load(f)
    res["leg_seconds"] = round(time.perf_counter() - t0, 3)
    return res


def find_best_ckpt(root: str) -> str:
    for dirpath, _, files in os.walk(root):
        for fn in files:
            if fn.endswith("_ckpt_best.ckpt"):
                return os.path.join(dirpath, fn)
    raise FileNotFoundError(f"no best checkpoint under {root}")


def train_bars_met(kind: str, res: dict, bar: float, oa_bar: float) -> bool:
    """The train leg's bars: best val mIoU ≥ ``bar``, final val OA ≥
    ``oa_bar``; for MM the final refine rate within 0.05-90 % (0: the
    refinement never fires; about 100: the self-mask is degenerate)."""
    ok = (float(res.get("best_val", 0.0)) >= bar
          and float(res.get("val_oa", 0.0)) >= oa_bar)
    if kind == "mm":
        rr = res.get("refine_rate")
        ok = ok and rr is not None and 0.05 <= float(rr) <= 90.0
    return ok


def test_bars_met(tres: dict, oa_bar: float) -> bool:
    """The test leg's bars: whole-scene voting scores every raw point, so
    mIoU is meaningful again (≥ 90) and OA ≥ ``oa_bar`` − 2."""
    return (float(tres.get("oa") or 0.0) >= oa_bar - 2.0
            and float(tres.get("miou") or 0.0) >= 90.0)


def delta_asserts(scores: dict) -> tuple:
    """The delta gate's asserts over best-val mIoU by variant (``ce``,
    ``aa``, ``mm``, one score a seed): AA within 1 mIoU of CE or better (a
    broken contrast path collapses AA, which spends 0.9 of its loss on it),
    MM within 1 of AA, AA's seed spread ≤ 2.5, every score above 40.
    Returns (pass, the summary entry with means, spreads and deltas)."""
    mean = {v: statistics.mean(xs) for v, xs in scores.items()}
    spread = {v: (max(xs) - min(xs) if len(xs) > 1 else 0.0)
              for v, xs in scores.items()}
    d_aa = mean["aa"] - mean["ce"]
    d_mm = mean["mm"] - mean["aa"]
    order_ct = sum(1 for c, a in zip(scores["ce"], scores["aa"]) if a > c)
    ok = (d_aa > -1.0 and d_mm > -1.0 and spread["aa"] <= 2.5
          and all(x > 40.0 for xs in scores.values() for x in xs))
    return ok, {"scores": scores, "mean": mean, "seed_spread": spread,
                "aa_minus_ce": round(d_aa, 3), "mm_minus_aa": round(d_mm, 3),
                "aa_beats_ce_seeds": f"{order_ct}/{len(scores['ce'])}",
                "pass": ok}


def deltas_entry(scores: dict, seconds: dict, force_asserts=None) -> tuple:
    """(the asserts' verdict, or None where they were not applied; the
    summary's ``deltas`` entry).  The asserts need all three variants
    unless ``force_asserts``; a subset gets its scores, means and
    spreads."""
    if set(scores) != {"ce", "aa", "mm"} and not force_asserts:
        return None, {
            "scores": scores,
            "mean": {v: statistics.mean(xs) for v, xs in scores.items()},
            "seed_spread": {v: max(xs) - min(xs) for v, xs in scores.items()},
            "variants": sorted(scores), "leg_seconds": seconds}
    ok, entry = delta_asserts(scores)
    m, sp = entry["mean"], entry["seed_spread"]
    print(f"[deltas] mean ce={m['ce']:.2f} aa={m['aa']:.2f} "
          f"mm={m['mm']:.2f}  aa-ce={entry['aa_minus_ce']:+.2f} "
          f"mm-aa={entry['mm_minus_aa']:+.2f} (spreads "
          f"ce={sp['ce']:.2f} aa={sp['aa']:.2f} mm={sp['mm']:.2f}) "
          f"-> {'PASS' if ok else 'FAIL'}", flush=True)
    return ok, {**entry, "leg_seconds": seconds}


def merge(summaries: list, force_asserts=None) -> tuple:
    """(failed, the union of ``summaries``): every leg's entry with its own
    verdict, the delta scores and leg seconds joined variant by variant,
    and the delta asserts applied to them.  A leg in two summaries
    raises."""
    out, scores, seconds, failed = {}, {}, {}, False
    for summary in summaries:
        for key, entry in summary.items():
            if key == "pass":
                continue
            if key == "deltas":
                for v, xs in entry["scores"].items():
                    scores.setdefault(v, []).extend(xs)
                    seconds.setdefault(v, []).extend(
                        entry.get("leg_seconds", {}).get(v, []))
                continue
            if key in out:
                raise ValueError(f"--merge: {key} is in two summaries")
            out[key] = entry
            failed |= isinstance(entry, dict) and entry.get("pass") is False
    if scores:
        ok, out["deltas"] = deltas_entry(scores, seconds, force_asserts)
        failed |= ok is False
    return failed, out


def overrides_of(kind: str, overrides: list) -> list:
    """The ``--override``s that go to a leg of model ``kind``: the plain
    ones and those written ``kind:key=value``."""
    out = []
    for o in overrides:
        head, sep, rest = o.partition(":")
        if not sep or "=" in head:
            out.append(o)
        elif head == kind:
            out.append(rest)
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        "amcontrast3d_tpu_torch.tools.convergence_check")
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--bar", type=float, default=60.0,
                    help="min best val mIoU (a regression canary; mIoU on "
                         "the procedural rooms is capped by rare box "
                         "classes in the small val set)")
    ap.add_argument("--oa-bar", type=float, default=97.0,
                    help="min final val overall accuracy, the primary "
                         "convergence criterion (the rooms are separable)")
    ap.add_argument("--override", action="append", default=[],
                    help="extra cfg key=value overrides for every leg; "
                         "aa:key=value or mm:key=value for the legs of that "
                         "model kind only")
    ap.add_argument("--kinds", default="aa,mm")
    ap.add_argument("--out", default=None)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default=None,
                    help="cuda (default; the run stops without a card) or "
                         "cpu")
    ap.add_argument("--ab", action="store_true",
                    help="also train AA with AMC3D_KNN_BACKEND=approx (the "
                         "threshold selection and the label vote) and report "
                         "the best-val mIoU delta approx - exact against the "
                         "exact default.  The JAX tool's AMC3D_FUSED_CONTRAST "
                         "switch has no counterpart: the port's contrast "
                         "always takes the reduction form")
    ap.add_argument("--amp", action="store_true",
                    help="also train AA with use_amp=True (a bfloat16 model) "
                         "and report the best-val delta against float32")
    ap.add_argument("--deltas", type=int, default=0, metavar="N_SEEDS",
                    help="discriminative delta gate: train CE-only / AA / MM "
                         "on the hard synthetic rooms for N seeds each "
                         "(seed + 100 s) and assert AA within 1 of CE, MM "
                         "within 1 of AA, AA's spread <= 2.5, every score "
                         "> 40.  CE-only is the AA model and optimizer with "
                         "ambiguity_args.w1=1, w2=0")
    ap.add_argument("--recall-sweep", action="store_true",
                    help="refused: " + RECALL_REFUSAL)
    ap.add_argument("--deltas-variants", default="ce,aa,mm",
                    help="subset of delta variants to run")
    ap.add_argument("--deltas-asserts", action="store_true", default=None,
                    help="force the delta asserts on a variant subset "
                         "(default: asserts only when all three ran)")
    ap.add_argument("--merge", nargs="+", default=None, metavar="SUMMARY",
                    help="join summaries written by --out (a run split "
                         "across card calls), keep each leg's verdict and "
                         "apply the delta asserts to the joined scores; "
                         "trains nothing")
    ap.add_argument("--agg-fused", action="store_true",
                    help="also train AA with AMC3D_AGG_FUSED=on (the fused "
                         "grouped aggregation, kernels 20 and 21; the port's "
                         "'auto' is off) and report the best-val delta "
                         "against the gather tail")
    args = ap.parse_args(argv)
    if args.recall_sweep:
        ap.error(RECALL_REFUSAL)
    return args


class Summary(dict):
    """The summary, written to ``path`` (when given) after every leg."""

    def __init__(self, path):
        super().__init__()
        self.path = path

    def save(self, failed: bool) -> None:
        self["pass"] = not failed
        if self.path:
            with open(self.path, "w") as f:
                json.dump(self, f, indent=2)


def main(argv=None):
    args = parse_args(argv)
    if args.merge:
        failed, merged = merge([json.load(open(p)) for p in args.merge],
                               args.deltas_asserts)
        summary = Summary(args.out)
        summary.update(merged)
        summary.save(failed)
        print(json.dumps(summary))
        sys.exit(1 if failed else 0)
    if args.device != "cpu" and not torch.cuda.is_available():
        raise SystemExit("convergence_check: no CUDA device (--device cpu "
                         "runs on the CPU)")
    device = ["--device", args.device] if args.device else []
    cfg_of = lambda kind: os.path.join(REPO, "cfgs", "synthetic",
                                       f"AMContrast3D-{kind.upper()}.yaml")
    # loop=8 gives 16 steps an epoch; colour drop off keeps the colour →
    # class mapping observable (the gate tests the implementation's
    # convergence, not augmentation robustness)
    common = ["val_freq=1", "dataset.train.loop=8",
              "datatransforms.kwargs.color_drop=0.0"]

    def train_argv(kind, root, seed=args.seed, extra=()):
        return [*device, "--cfg", cfg_of(kind), f"epochs={args.epochs}",
                f"seed={seed}", f"root_dir={root}", *common, *extra,
                *overrides_of(kind, args.override)]

    summary = Summary(args.out)
    failed = False
    with tempfile.TemporaryDirectory(prefix="amc3d_torch_convergence_") as tmp:
        for kind in args.kinds.split(","):
            kind = kind.strip()
            if not kind:  # --kinds "" → deltas-only run
                continue
            root = os.path.join(tmp, kind)
            res = run_phase(kind, train_argv(kind, root), f"{kind}_train", tmp)
            ok = train_bars_met(kind, res, args.bar, args.oa_bar)
            if kind == "mm":
                print(f"[mm] final refine_rate={res.get('refine_rate')}% "
                      f"(band 0.05..90)")
            summary[f"{kind}_train"] = {**res, "bar": args.bar,
                                        "oa_bar": args.oa_bar, "pass": ok}
            print(f"[{kind}] train: best_val={float(res.get('best_val', 0)):.2f} "
                  f"val_oa={float(res.get('val_oa', 0)):.2f} (bars {args.bar}/"
                  f"{args.oa_bar}) -> {'PASS' if ok else 'FAIL'}", flush=True)
            failed |= not ok
            summary.save(failed)

            test_argv = [*device, "--cfg", cfg_of(kind), "mode=test",
                         f"seed={args.seed}", f"root_dir={root}",
                         f"pretrained_path={find_best_ckpt(root)}",
                         "ambiguity_args.miou_B_I=True",
                         "ambiguity_args.action=True",
                         *overrides_of(kind, args.override)]
            tres = run_phase(kind, test_argv, f"{kind}_test", tmp)
            t_ok = test_bars_met(tres, args.oa_bar)
            summary[f"{kind}_test"] = {
                "miou": tres.get("miou"), "macc": tres.get("macc"),
                "oa": tres.get("oa"), "boundary": tres.get("boundary"),
                "inner": tres.get("inner"),
                "ambiguity": tres.get("ambiguity_summary"),
                "leg_seconds": tres["leg_seconds"], "pass": t_ok}
            print(f"[{kind}] test: miou={float(tres.get('miou') or 0):.2f} "
                  f"boundary={tres.get('boundary')} inner={tres.get('inner')} "
                  f"-> {'PASS' if t_ok else 'FAIL'}", flush=True)
            failed |= not t_ok
            summary.save(failed)

        default_best = lambda: float(summary.get("aa_train", {}).get(
            "best_val", 0.0))
        if args.ab:
            res = run_phase("aa", train_argv("aa", os.path.join(tmp, "aa_approx")),
                            "aa_approx_train", tmp, extra_env=AB_ENV)
            approx_best = float(res.get("best_val", 0.0))
            summary["ab_approx_vs_exact"] = {
                "approx_best_val": approx_best,
                "approx_val_oa": res.get("val_oa"),
                "exact_best_val": default_best(),
                "delta": round(approx_best - default_best(), 3),
                "timing": res.get("timing"),
                "leg_seconds": res["leg_seconds"]}
            print(f"[ab] approx best_val={approx_best:.2f} vs exact "
                  f"{default_best():.2f} (delta "
                  f"{approx_best - default_best():+.2f})", flush=True)
            summary.save(failed)

        if args.amp:
            res = run_phase("aa", train_argv("aa", os.path.join(tmp, "aa_amp"),
                                             extra=["use_amp=True"]),
                            "aa_amp_train", tmp)
            amp_best = float(res.get("best_val", 0.0))
            amp_oa = float(res.get("val_oa", 0.0))
            amp_ok = train_bars_met("aa", res, args.bar, args.oa_bar)
            summary["amp_bf16_vs_fp32"] = {
                "amp_best_val": amp_best, "amp_val_oa": amp_oa,
                "fp32_best_val": default_best(),
                "delta": round(amp_best - default_best(), 3),
                "timing": res.get("timing"),
                "leg_seconds": res["leg_seconds"], "pass": amp_ok}
            print(f"[amp] bf16 best_val={amp_best:.2f} val_oa={amp_oa:.2f} vs "
                  f"fp32 {default_best():.2f} -> "
                  f"{'PASS' if amp_ok else 'FAIL'}", flush=True)
            failed |= not amp_ok
            summary.save(failed)

        if args.agg_fused:
            res = run_phase("aa", train_argv("aa", os.path.join(tmp, "aa_aggf")),
                            "aa_aggf_train", tmp, extra_env=AGG_FUSED_ENV)
            aggf_best = float(res.get("best_val", 0.0))
            aggf_oa = float(res.get("val_oa", 0.0))
            aggf_ok = train_bars_met("aa", res, args.bar, args.oa_bar)
            summary["agg_fused_vs_gather"] = {
                "agg_fused_best_val": aggf_best, "agg_fused_val_oa": aggf_oa,
                "gather_best_val": default_best(),
                "delta": round(aggf_best - default_best(), 3),
                "timing": res.get("timing"),
                "leg_seconds": res["leg_seconds"], "pass": aggf_ok}
            print(f"[agg] fused best_val={aggf_best:.2f} val_oa={aggf_oa:.2f} "
                  f"vs gather {default_best():.2f} -> "
                  f"{'PASS' if aggf_ok else 'FAIL'}", flush=True)
            failed |= not aggf_ok
            summary.save(failed)

        if args.deltas:
            variants = {
                "ce": ("aa", ["ambiguity_args.w1=1.0", "ambiguity_args.w2=0.0",
                              "ambiguity_args.w3=0.0"]),
                "aa": ("aa", []),
                "mm": ("mm", []),
            }
            wanted = [v.strip() for v in args.deltas_variants.split(",")
                      if v.strip()]
            variants = {k: v for k, v in variants.items() if k in wanted}
            scores = {v: [] for v in variants}
            seconds = {v: [] for v in variants}
            for s in range(args.deltas):
                seed = args.seed + 100 * s
                for vname, (kind, extra) in variants.items():
                    root = os.path.join(tmp, f"delta_{vname}_{s}")
                    res = run_phase(
                        kind, train_argv(kind, root, seed,
                                         ["dataset.common.hard=True", *extra]),
                        f"delta_{vname}_{s}", tmp)
                    scores[vname].append(float(res.get("best_val", 0.0)))
                    seconds[vname].append(res["leg_seconds"])
                    print(f"[deltas] {vname} seed={seed} "
                          f"best_val={scores[vname][-1]:.2f}", flush=True)
                    summary["deltas"] = {"scores": scores,
                                         "leg_seconds": seconds}
                    summary.save(failed)
            ok, summary["deltas"] = deltas_entry(scores, seconds,
                                                 args.deltas_asserts)
            failed |= ok is False

    summary.save(failed)
    print(json.dumps(summary))
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
