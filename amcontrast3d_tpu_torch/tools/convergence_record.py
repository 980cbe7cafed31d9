"""The port's convergence record: a summary of
``amcontrast3d_tpu_torch.tools.convergence_check`` beside the JAX package's
figures on the same rooms and seeds.

    python -m amcontrast3d_tpu_torch.tools.convergence_record SUMMARY.json \\
        --card "$(nvidia-smi --query-gpu=name,power.limit --format=csv,noheader)" \\
        --command "python -m amcontrast3d_tpu_torch.tools.convergence_check ..." \\
        --out docs/CONVERGENCE_torch_r1.json

From the summary's ``--deltas`` scores (seeds 42, 142, …): each variant's
mean, sd (with its 95 % interval) and spread; the 95 % interval of MM −
AA over paired seeds, as
``tools/merge_convergence_stats.py`` computes ``mm_minus_aa_ci95`` in
``docs/CONVERGENCE_r5.json``; and the port against JAX, paired by seed
(the synthetic rooms of a seed are the same in both packages): MM against
``CONVERGENCE_r5.json``'s 5 seeds, AA (the port's default, the exact kNN)
against JAX's exact leg (its recall sweep's 3 seeds) and against JAX's
default (approx, 5 seeds), CE-only against ``CONVERGENCE_r4.json``'s 3
seeds.  Seconds an epoch: each leg's train seconds (the loop over the
loader and the steps, without validation) and its wall seconds, start-up
and validation included, over its epochs.  The critical values are
scipy's, rounded to 3 decimals as the JAX package's merge tool tabulates
them, so that its intervals come out the same.
"""
from __future__ import annotations

import argparse
import json
import math
import os

from scipy import stats as _dist

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def t95(df: int) -> float:
    """The two-sided 95 % point of Student's t."""
    return round(float(_dist.t.ppf(0.975, df)), 3)


def chi2_95(df: int) -> tuple:
    """The 2.5 % and 97.5 % points of chi-square (an sd's 95 % interval)."""
    return (round(float(_dist.chi2.ppf(0.025, df)), 6),
            round(float(_dist.chi2.ppf(0.975, df)), 3))


def f975(df1: int, df2: int) -> float:
    """The 97.5 % point of F (the two-sided 95 % test of equal variances)."""
    return round(float(_dist.f.ppf(0.975, df1, df2)), 3)


def mean(xs):
    return sum(xs) / len(xs)


def sd(xs):
    m = mean(xs)
    return math.sqrt(sum((x - m) ** 2 for x in xs) / (len(xs) - 1))


def paired_ci(a, b):
    """(mean of b − a, its 95 % interval) over paired entries."""
    d = [y - x for x, y in zip(a, b)]
    half = t95(len(d) - 1) * sd(d) / math.sqrt(len(d))
    m = mean(d)
    return round(m, 3), [round(m - half, 3), round(m + half, 3)]


def stats(xs):
    out = {"scores": xs, "mean": round(mean(xs), 3),
           "sd": round(sd(xs), 3) if len(xs) > 1 else None,
           "spread": round(max(xs) - min(xs), 3)}
    if len(xs) > 1:
        lo, hi = chi2_95(len(xs) - 1)
        scale = sd(xs) * math.sqrt(len(xs) - 1)
        out["sd_ci95"] = [round(scale / math.sqrt(hi), 3),
                          round(scale / math.sqrt(lo), 3)]
    return out


def versus(port, jax_scores, seeds):
    """The port against JAX over the seeds both have."""
    n = min(len(port), len(jax_scores))
    m, ci = paired_ci(jax_scores[:n], port[:n])
    return {"seeds": seeds[:n], "jax": stats(jax_scores[:n]),
            "port_minus_jax_mean": m, "port_minus_jax_ci95": ci,
            "gap_below_2_with_ci_below_0": m < -2.0 and ci[1] < 0.0}


def epoch_seconds(entry):
    timing = entry.get("timing") or []
    if not timing:
        return None
    train = [t["train_seconds"] for t in timing]
    return {"epochs": len(timing), "first_train_s": round(train[0], 3),
            "median_train_s": round(sorted(train)[len(train) // 2], 3),
            "wall_s_an_epoch": round(entry["leg_seconds"] / len(timing), 3)}


def record(summary: dict, r4: dict, r5: dict) -> dict:
    out = {"summary": summary,
           "seconds_an_epoch": {k: epoch_seconds(v)
                                for k, v in summary.items()
                                if isinstance(v, dict) and "timing" in v}}
    deltas = summary.get("deltas")
    if deltas and {"aa", "mm"} <= set(deltas["scores"]):
        scores = deltas["scores"]
        seeds = [42 + 100 * s for s in range(len(scores["aa"]))]
        port = {v: stats(xs) for v, xs in scores.items()}
        m, ci = paired_ci(scores["aa"], scores["mm"])
        port["mm_minus_aa_mean"], port["mm_minus_aa_ci95"] = m, ci
        jax5, rec3 = r5["deltas_5seed"], r5["recall_3seed"]
        against = {
            "mm_vs_jax_mm_r5": versus(scores["mm"], jax5["mm"]["scores"],
                                      jax5["seeds"]),
            "aa_exact_vs_jax_exact_r5": versus(scores["aa"],
                                               rec3["exact"]["scores"],
                                               rec3["seeds"]),
            "aa_exact_vs_jax_default_approx_r5": versus(
                scores["aa"], jax5["aa"]["scores"], jax5["seeds"])}
        if "ce" in scores:
            against["ce_vs_jax_ce_r4"] = versus(
                scores["ce"], r4["deltas"]["scores"]["ce"], seeds)
        out["deltas_port"] = {"seeds": seeds, **port}
        out["port_vs_jax"] = against
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(
        "amcontrast3d_tpu_torch.tools.convergence_record")
    ap.add_argument("summary")
    ap.add_argument("--card", required=True,
                    help="nvidia-smi's name and power limit of the card")
    ap.add_argument("--command", action="append", default=[],
                    help="a command that made the summary")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    load = lambda path: json.load(open(path))
    docs = os.path.join(REPO, "docs")
    out = {"card": args.card, "commands": args.command,
           **record(load(args.summary),
                    load(os.path.join(docs, "CONVERGENCE_r4.json")),
                    load(os.path.join(docs, "CONVERGENCE_r5.json")))}
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
