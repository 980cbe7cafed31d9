"""Comparisons of the port's convergence record with more runs: further
seeds of the port, its legs with one setting changed, and the JAX
package's exact AA leg run on the CPU for the port's seeds.

    python tools/convergence_study.py RECORD.json \\
        [--more MORE_SEEDS.json ...] [--jax-cpu docs/CONVERGENCE_jax_cpu_r1.json] \\
        [--variant NAME PORT.json [JAX_KEY]] [--approx APPROX.json] \\
        [--earlier EARLIER_RECORD.json --earlier-note TEXT] \\
        [--command "..."] --out docs/CONVERGENCE_torch_r1.json

``RECORD.json`` is what ``amcontrast3d_tpu_torch.tools.convergence_record``
wrote; the keys below are added to it.  ``--more``: summaries of the
port's ``--deltas`` runs of further seeds (``--kinds ""``), kept under
``more_seeds``, with each variant's mean, sd and spread over every seed
under ``deltas_every_seed``; the gate's asserts stay those of the
record's own run.  ``--jax-cpu``: the JAX package's summaries on the CPU,
one file of lists by key (its ``tools/convergence_check.py --recall-sweep
--recall-legs exact --recall-seeds S``, one or more seeds each); the
list ``aa_exact`` is held against the port's exact AA over every seed
(``aa_exact_vs_jax_exact_cpu``): paired by seed, with the two variances'
ratio beside the two-sided 95 % point of F.  ``--variant NAME``, once a
variant: an AA ``--deltas`` run of the port over the same seeds with one
setting changed, against the port's default AA by seed and, given
``JAX_KEY``, against that list of the ``--jax-cpu`` file (the JAX leg run
with the same setting).  ``--approx``: a ``--deltas`` run of the same
seeds with ``AMC3D_KNN_BACKEND=approx`` (the configuration of JAX's r5
default legs), each variant held against JAX's default by seed.
``--earlier``: an earlier record kept whole under ``earlier_runs`` with
``--earlier-note`` saying what changed since.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from amcontrast3d_tpu_torch.tools.convergence_record import (  # noqa: E402
    f975, paired_ci, sd, stats, versus)


def by_seed(port: list, other: dict) -> tuple:
    """The seeds that ``port`` (seeds 42 + 100 i) and ``other`` (a score by
    seed) both have, and each one's scores on them."""
    seeds = [42 + 100 * i for i in range(len(port)) if 42 + 100 * i in other]
    return (seeds, [port[(s - 42) // 100] for s in seeds],
            [other[s] for s in seeds])


def paired_record(port: list, other: dict) -> dict:
    """``port`` minus ``other`` on the seeds both have, paired by seed."""
    seeds, mine, theirs = by_seed(port, other)
    m, ci = paired_ci(theirs, mine)
    return {"seeds": seeds, "minus_mean": m, "minus_ci95": ci}


def jax_exact_record(port_aa: list, summaries: list) -> dict:
    """The port's exact AA (seeds 42 + 100 i) against the JAX package's
    exact leg on the seeds its summaries hold, paired by seed, with the
    ratio of the two variances."""
    scores = {}
    for summary in summaries:
        leg = summary["recall_sweep"]["exact"]
        scores.update(zip(leg["seeds"], leg["best_vals"]))
    seeds, port, jax = by_seed(port_aa, scores)
    pair = paired_record(port_aa, scores)
    return {"seeds": seeds, "jax": stats(jax), "port": stats(port),
            "port_minus_jax_mean": pair["minus_mean"],
            "port_minus_jax_ci95": pair["minus_ci95"],
            "variance_ratio_port_over_jax": round(sd(port) ** 2 / sd(jax) ** 2, 3),
            "variance_ratio_f975": f975(len(seeds) - 1, len(seeds) - 1)}


def variant_record(aa: list, default_aa: list, jax: list) -> dict:
    """A variant's AA scores (seeds 42 + 100 i) against the port's default
    and, given the JAX package's exact summaries, against those."""
    out = {**stats(aa), "vs_port_default": paired_record(
        aa, {42 + 100 * i: x for i, x in enumerate(default_aa)})}
    if jax:
        out["vs_jax"] = jax_exact_record(aa, jax)
    return out


def approx_record(summary: dict, r5: dict) -> dict:
    """The approx configuration's delta scores against JAX's default."""
    scores, jax5 = summary["deltas"]["scores"], r5["deltas_5seed"]
    return {v: {**stats(xs),
                "vs_jax_default_r5": versus(xs, jax5[v]["scores"],
                                            jax5["seeds"])}
            for v, xs in scores.items() if v in ("aa", "mm")}


def more_seeds_record(record: dict, more: list) -> dict:
    """Each variant's scores over the record's seeds and then ``more``'s."""
    every = {v: list(xs) for v, xs in record["summary"]["deltas"]["scores"].items()}
    for extra in more:
        for v, xs in extra["deltas"]["scores"].items():
            every.setdefault(v, []).extend(xs)
    return {"more_seeds": list(more),
            "deltas_every_seed": {v: stats(xs) for v, xs in every.items()}}


def study(record: dict, more=(), jax_cpu=None, variants=(), approx=None,
          r5=None) -> dict:
    """``record`` with the comparisons above added."""
    out = dict(record)
    if more:
        out.update(more_seeds_record(record, more))
    default = (out.get("deltas_every_seed") or out["deltas_port"])["aa"]
    if jax_cpu is not None:
        out["aa_exact_vs_jax_exact_cpu"] = jax_exact_record(
            default["scores"], jax_cpu["aa_exact"])
    for name, summary, jax_key in variants:
        out.setdefault("variants", {})[name] = {
            "summary": summary,
            "aa": variant_record(summary["deltas"]["scores"]["aa"],
                                 default["scores"],
                                 jax_cpu[jax_key] if jax_key else [])}
    if approx is not None:
        out["approx_summary"] = approx
        out["deltas_approx"] = approx_record(approx, r5)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser("tools/convergence_study.py")
    ap.add_argument("record")
    ap.add_argument("--more", nargs="+", default=[])
    ap.add_argument("--jax-cpu", default=None)
    ap.add_argument("--variant", nargs="+", action="append", default=[],
                    metavar="NAME PORT.json [JAX_KEY]")
    ap.add_argument("--approx", default=None)
    ap.add_argument("--earlier", default=None)
    ap.add_argument("--earlier-note", default=None)
    ap.add_argument("--command", action="append", default=[],
                    help="a command that made a summary given here")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    load = lambda path: json.load(open(path))
    jax_cpu = load(args.jax_cpu) if args.jax_cpu else None
    variants = []
    for name, path, *key in args.variant:
        variants.append((name, load(path), key[0] if key else None))
    out = study(load(args.record), [load(p) for p in args.more], jax_cpu,
                variants, load(args.approx) if args.approx else None,
                load(os.path.join(REPO, "docs", "CONVERGENCE_r5.json")))
    out["commands"] = list(out.get("commands", [])) + args.command
    if args.earlier:
        out["earlier_runs"] = {"note": args.earlier_note,
                               **load(args.earlier)}
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
