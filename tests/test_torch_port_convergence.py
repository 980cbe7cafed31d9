"""The port's convergence gate (``amcontrast3d_tpu_torch/tools/
convergence_check.py``) on the CPU.

* End to end at a tiny size (``--device cpu --epochs 1 --kinds aa,mm``,
  rooms of 3000 points, width 8, ``script/realdata_smoke.sh``'s
  ``SMOKE_CI`` shrink): the summary has the JAX tool's keys and a ``pass``
  field.  One epoch trains nothing to the bars; the keys, not the scores,
  are held here (the card's runs are in ``docs/CONVERGENCE_torch_r1.json``).
* The delta asserts on ``docs/CONVERGENCE_r4.json``'s scores pass, as the
  JAX run did; a collapsed AA (every AA score 5 below CE's) fails.
* ``--merge`` joins split runs and applies the asserts to the union.
* ``--recall-sweep`` is refused by name; ``--ab`` and ``--agg-fused`` set
  their switches in the leg's environment; ``--deltas`` runs the seeds
  seed + 100 s on the hard rooms.
* ``convergence_record``'s paired interval gives
  ``docs/CONVERGENCE_r5.json``'s ``mm_minus_aa_ci95`` from its scores, its
  critical values are the JAX merge tool's tables at any seed count, and
  a record of JAX's own scores reads no gap against JAX; in
  ``tools/convergence_study.py`` the JAX package's exact legs and the
  port's variants are paired with the port by seed.
* The tools' modules import no JAX and nothing of the JAX package.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from amcontrast3d_tpu_torch.tools import convergence_check as cc
from amcontrast3d_tpu_torch.tools import convergence_record as cr
from tools import convergence_study as cs

REPO = Path(__file__).resolve().parent.parent

# script/realdata_smoke.sh's SMOKE_CI list, rooms of 3000 points, a few
# steps at a constant rate (one epoch of the cosine schedule runs at its
# minimum), and MM's APM towers at the two encoder widths left
TINY = ["dataset.common.num_rooms=2", "dataset.common.n_points=3000",
        "batch_size=2", "val_batch_size=1", "eval_bucket=512",
        "dataset.train.voxel_max=256", "dataset.train.loop=4",
        "dataset.val.voxel_max=512", "dataset.val.presample=False",
        "model.encoder_args.width=8", "model.encoder_args.blocks=[1,1,1]",
        "model.encoder_args.strides=[1,4,4]", "model.encoder_args.nsample=8",
        "model.decoder_args.decoder_stages=2", "ambiguity_args.stages_num=2",
        "ambiguity_args.nsample=8", "min_lr=0.01",
        "mm:model.APM_args.feature_dim=[8,16]"]

TRAIN_KEYS = {"best_val", "best_epoch", "val_miou", "val_macc", "val_oa",
              "bar", "oa_bar", "pass"}
TEST_KEYS = {"miou", "macc", "oa", "boundary", "inner", "ambiguity", "pass"}


def test_tool_end_to_end_on_the_cpu(tmp_path):
    out = tmp_path / "summary.json"
    argv = [sys.executable, "-m", "amcontrast3d_tpu_torch.tools.convergence_check",
            "--device", "cpu", "--epochs", "1", "--kinds", "aa,mm",
            "--out", str(out)]
    for o in TINY:
        argv += ["--override", o]
    # one thread a leg: the suite's workers share the cores
    proc = subprocess.run(argv, cwd=REPO, capture_output=True, text=True,
                          timeout=900, env={**os.environ, "OMP_NUM_THREADS": "1",
                                            "CUDA_VISIBLE_DEVICES": ""})
    # one epoch misses the bars: exit 1, with the summary written
    assert proc.returncode in (0, 1), proc.stderr[-3000:]
    summary = json.loads(out.read_text())
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == summary
    assert set(summary) == {"aa_train", "aa_test", "mm_train", "mm_test", "pass"}
    assert summary["pass"] is (proc.returncode == 0)
    for kind in ("aa", "mm"):
        train, test = summary[f"{kind}_train"], summary[f"{kind}_test"]
        assert TRAIN_KEYS <= set(train) and TEST_KEYS <= set(test)
        assert isinstance(train["pass"], bool) and isinstance(test["pass"], bool)
        assert train["timing"][0]["steps"] == 4
        assert len(test["boundary"]) == len(test["inner"]) == 3
        assert set(test["ambiguity"]) == {"miou", "macc", "oa", "count_pct"}
    assert 0 <= summary["mm_train"]["refine_rate"] <= 100
    assert "refine_rate" not in summary["aa_train"]


def test_delta_asserts_pass_on_the_jax_scores_and_fail_on_a_collapse():
    r4 = json.loads((REPO / "docs" / "CONVERGENCE_r4.json").read_text())
    scores = r4["deltas"]["scores"]
    ok, entry = cc.delta_asserts(scores)
    assert ok and entry["pass"]
    assert entry["aa_minus_ce"] == pytest.approx(r4["deltas"]["aa_minus_ce"],
                                                 abs=1e-3)
    assert entry["mm_minus_aa"] == pytest.approx(r4["deltas"]["mm_minus_aa"],
                                                 abs=1e-3)
    collapsed = {**scores, "aa": [c - 5.0 for c in scores["ce"]]}
    ok, entry = cc.delta_asserts(collapsed)
    assert not ok and not entry["pass"]


def test_merge_joins_split_runs_and_applies_the_asserts(tmp_path, capsys):
    """``--merge``: the default legs' summary and one summary a delta
    variant read as one run's: the legs' verdicts kept, the scores joined
    and the asserts applied to them; a collapsed AA or a failed leg fails
    the union, and a leg in two summaries raises."""
    scores = json.loads((REPO / "docs" / "CONVERGENCE_r4.json").read_text()
                        )["deltas"]["scores"]
    legs = {"aa_train": {"best_val": 68.0, "pass": True},
            "ab_approx_vs_exact": {"delta": 0.5}, "pass": True}
    parts = [legs] + [{"deltas": {"scores": {v: xs},
                                  "leg_seconds": {v: [60.0] * len(xs)}},
                       "pass": True} for v, xs in scores.items()]
    failed, merged = cc.merge(parts)
    assert not failed and merged["deltas"]["pass"]
    assert merged["deltas"]["scores"] == scores
    assert merged["deltas"]["leg_seconds"]["ce"] == [60.0] * len(scores["ce"])
    assert merged["aa_train"] == legs["aa_train"]
    assert cc.merge(parts[:1] + parts[2:])[1]["deltas"]["variants"] == ["aa", "mm"]
    collapsed = {"deltas": {"scores": {"aa": [c - 5.0 for c in scores["ce"]]}}}
    assert cc.merge([parts[1], collapsed, parts[3]])[0]
    assert cc.merge([{"mm_train": {"pass": False}}, *parts[1:]])[0]
    with pytest.raises(ValueError, match="aa_train"):
        cc.merge([legs, legs])
    paths = []
    for i, part in enumerate(parts):
        paths.append(str(tmp_path / f"part{i}.json"))
        with open(paths[-1], "w") as f:
            json.dump(part, f)
    with pytest.raises(SystemExit) as exc:
        cc.main(["--merge", *paths, "--out", str(tmp_path / "all.json")])
    assert exc.value.code == 0
    written = json.loads((tmp_path / "all.json").read_text())
    assert written["pass"] and written["deltas"]["pass"]


def test_recall_sweep_is_refused_by_name(capsys):
    with pytest.raises(SystemExit) as exc:
        cc.parse_args(["--recall-sweep"])
    assert exc.value.code == 2
    assert "--recall-sweep has no counterpart in the port" in \
        capsys.readouterr().err


def _fake_legs(monkeypatch):
    calls = []

    def run_phase(kind, argv, tag, workdir, extra_env=None):
        calls.append((kind, tag, argv, dict(extra_env or {})))
        return {"best_val": 70.0, "val_oa": 99.0, "leg_seconds": 0.0,
                "timing": []}
    monkeypatch.setattr(cc, "run_phase", run_phase)
    return calls


def test_legs_set_the_port_switches(monkeypatch):
    calls = _fake_legs(monkeypatch)
    with pytest.raises(SystemExit) as exc:
        cc.main(["--device", "cpu", "--kinds", "", "--ab", "--agg-fused",
                 "--amp", "--override", "aa:lr=0.02", "--override",
                 "mm:model.APM_args.gamma=1", "--override", "epochs=3"])
    assert exc.value.code == 0
    envs = {tag: env for _, tag, _, env in calls}
    assert envs == {"aa_approx_train": {"AMC3D_KNN_BACKEND": "approx"},
                    "aa_amp_train": {},
                    "aa_aggf_train": {"AMC3D_AGG_FUSED": "on"}}
    for kind, tag, argv, _ in calls:
        assert argv[:2] == ["--device", "cpu"]
        assert "lr=0.02" in argv and "epochs=3" in argv
        assert not any("APM_args" in a for a in argv)
        assert ("use_amp=True" in argv) == (tag == "aa_amp_train")


def test_deltas_run_their_seeds_on_the_hard_rooms(monkeypatch, tmp_path):
    calls = _fake_legs(monkeypatch)
    out = tmp_path / "summary.json"
    with pytest.raises(SystemExit) as exc:
        cc.main(["--device", "cpu", "--kinds", "", "--deltas", "5",
                 "--out", str(out)])
    assert exc.value.code == 0
    for variant in ("ce", "aa", "mm"):
        seeds = [a for _, tag, argv, _ in calls
                 if tag.startswith(f"delta_{variant}")
                 for a in argv if a.startswith("seed=")]
        assert seeds == [f"seed={s}" for s in (42, 142, 242, 342, 442)]
    assert all("dataset.common.hard=True" in argv for *_, argv, _ in calls)
    assert [kind for kind, tag, *_ in calls if tag == "delta_ce_0"] == ["aa"]
    summary = json.loads(out.read_text())
    assert summary["pass"] and summary["deltas"]["pass"]
    assert {v: len(xs) for v, xs in summary["deltas"]["scores"].items()} == \
        {"ce": 5, "aa": 5, "mm": 5}
    ce_argv = next(argv for _, tag, argv, _ in calls if tag == "delta_ce_0")
    assert {"ambiguity_args.w1=1.0", "ambiguity_args.w2=0.0"} <= set(ce_argv)


def test_record_reproduces_the_jax_interval_and_reads_no_gap_on_jax():
    r4 = json.loads((REPO / "docs" / "CONVERGENCE_r4.json").read_text())
    r5 = json.loads((REPO / "docs" / "CONVERGENCE_r5.json").read_text())
    five = r5["deltas_5seed"]
    m, ci = cr.paired_ci(five["aa"]["scores"], five["mm"]["scores"])
    assert (m, ci) == (five["mm_minus_aa_mean"], five["mm_minus_aa_ci95"])
    summary = {"deltas": {"scores": {"ce": r4["deltas"]["scores"]["ce"],
                                     "aa": five["aa"]["scores"],
                                     "mm": five["mm"]["scores"]}}}
    rec = cr.record(summary, r4, r5)
    assert rec["deltas_port"]["mm_minus_aa_ci95"] == five["mm_minus_aa_ci95"]
    assert rec["deltas_port"]["aa"]["sd"] == five["aa"]["sd"]
    for key in ("mm_vs_jax_mm_r5", "aa_exact_vs_jax_default_approx_r5",
                "ce_vs_jax_ce_r4"):
        entry = rec["port_vs_jax"][key]
        assert entry["port_minus_jax_mean"] == 0
        assert entry["port_minus_jax_ci95"] == [0, 0]
    assert rec["port_vs_jax"]["aa_exact_vs_jax_exact_r5"]["seeds"] == [42, 142, 242]
    assert "deltas_every_seed" not in rec
    more = {"deltas": {"scores": {"aa": [50.0, 52.0], "mm": [51.0, 53.0]}}}
    rec = cs.study(rec, [more])
    every = rec["deltas_every_seed"]
    assert every["aa"]["scores"] == five["aa"]["scores"] + [50.0, 52.0]
    assert every["ce"]["scores"] == r4["deltas"]["scores"]["ce"]
    assert rec["deltas_port"]["aa"]["sd"] == five["aa"]["sd"]
    approx = cs.approx_record({"deltas": {"scores": {"aa": five["aa"]["scores"]}}},
                              r5)
    assert set(approx) == {"aa"}
    assert approx["aa"]["vs_jax_default_r5"]["port_minus_jax_ci95"] == [0, 0]


def test_record_critical_values_hold_at_any_seed_count():
    """The t, chi-square and F points are the tables' to 3 decimals (the
    JAX merge tool's t table, df 1-6), and a twenty-seed comparison takes
    them at 19 degrees of freedom."""
    assert [cr.t95(df) for df in range(1, 10)] == [
        12.706, 4.303, 3.182, 2.776, 2.571, 2.447, 2.365, 2.306, 2.262]
    assert [round(cr.chi2_95(df)[0], 3) for df in (2, 4, 9, 19)] == [
        0.051, 0.484, 2.7, 8.907]
    assert [cr.chi2_95(df)[1] for df in (2, 4, 9, 19)] == [
        7.378, 11.143, 19.023, 32.852]
    assert (cr.f975(4, 4), cr.f975(9, 9), cr.f975(19, 19)) == (9.605, 4.026,
                                                               2.526)
    scores = [50.0 + (7 * i) % 5 for i in range(20)]
    leg = {"recall_sweep": {"exact": {"seeds": [42 + 100 * i for i in range(20)],
                                      "best_vals": scores}}}
    rec = cs.jax_exact_record([x + 1 for x in scores], [leg])
    assert rec["variance_ratio_f975"] == 2.526
    assert rec["port_minus_jax_ci95"] == [1.0, 1.0]
    assert len(rec["jax"]["sd_ci95"]) == 2


def test_record_pairs_the_jax_exact_legs_by_seed():
    r5 = json.loads((REPO / "docs" / "CONVERGENCE_r5.json").read_text())
    five = r5["deltas_5seed"]["aa"]["scores"]

    def leg(seeds, vals):
        return {"recall_sweep": {"exact": {"seeds": seeds, "best_vals": vals}}}
    # the JAX tool's summaries in any order, one or more seeds each
    jax = [leg([342, 442], five[3:]), leg([42, 142, 242], five[:3])]
    rec = cs.jax_exact_record(five, jax)
    assert rec["seeds"] == [42, 142, 242, 342, 442]
    assert rec["port_minus_jax_mean"] == 0
    assert rec["port_minus_jax_ci95"] == [0, 0]
    assert rec["variance_ratio_port_over_jax"] == 1.0
    assert rec["variance_ratio_f975"] == 9.605
    # a port twice as spread about the same mean: four times the variance
    m = sum(five) / 5
    wide = [m + 2 * (x - m) for x in five]
    rec = cs.jax_exact_record(wide, jax)
    assert rec["variance_ratio_port_over_jax"] == pytest.approx(4.0, abs=1e-3)
    assert rec["port"]["sd"] == pytest.approx(2 * rec["jax"]["sd"], abs=2e-3)
    # a seed one side lacks is left out of the pairs
    pair = cs.paired_record([x + 1 for x in five],
                            {42: five[0], 242: five[2], 442: five[4], 542: 0.0})
    assert pair == {"seeds": [42, 242, 442], "minus_mean": 1.0,
                    "minus_ci95": [1.0, 1.0]}


def test_record_main_writes_every_comparison(tmp_path):
    r4 = json.loads((REPO / "docs" / "CONVERGENCE_r4.json").read_text())
    r5 = json.loads((REPO / "docs" / "CONVERGENCE_r5.json").read_text())
    five = r5["deltas_5seed"]
    files = {
        "summary": {"deltas": {"scores": {"ce": r4["deltas"]["scores"]["ce"],
                                          "aa": five["aa"]["scores"],
                                          "mm": five["mm"]["scores"]}}},
        "jax": {"recall_sweep": {"exact": {"seeds": five["seeds"],
                                           "best_vals": five["aa"]["scores"]}}},
        "flax": {"deltas": {"scores": {"aa": [x + 0.5 for x in
                                              five["aa"]["scores"]]}}}}
    for name, content in files.items():
        (tmp_path / f"{name}.json").write_text(json.dumps(content))
    (tmp_path / "jax_cpu.json").write_text(json.dumps(
        {"aa_exact": [files["jax"]], "same": [files["jax"]]}))
    out = tmp_path / "record.json"
    cr.main([str(tmp_path / "summary.json"), "--card", "card, 1 W",
             "--command", "port", "--out", str(out)])
    rec = json.loads(out.read_text())
    assert rec["card"] == "card, 1 W" and rec["commands"] == ["port"]
    assert rec["deltas_port"]["mm_minus_aa_ci95"] == five["mm_minus_aa_ci95"]
    (tmp_path / "earlier.json").write_text(json.dumps({"card": "old"}))
    cs.main([str(out), "--jax-cpu", str(tmp_path / "jax_cpu.json"),
             "--variant", "flax_variance", str(tmp_path / "flax.json"), "same",
             "--variant", "alone", str(tmp_path / "flax.json"),
             "--earlier", str(tmp_path / "earlier.json"),
             "--earlier-note", "before", "--command", "jax",
             "--out", str(out)])
    rec = json.loads(out.read_text())
    assert rec["card"] == "card, 1 W" and rec["commands"] == ["port", "jax"]
    assert rec["earlier_runs"] == {"note": "before", "card": "old"}
    assert rec["aa_exact_vs_jax_exact_cpu"]["port_minus_jax_ci95"] == [0, 0]
    flax = rec["variants"]["flax_variance"]["aa"]
    assert flax["vs_port_default"]["minus_mean"] == 0.5
    assert flax["vs_jax"]["port_minus_jax_mean"] == 0.5
    assert flax["vs_jax"]["seeds"] == five["seeds"]
    assert flax["vs_jax"]["variance_ratio_port_over_jax"] == 1.0
    assert "vs_jax" not in rec["variants"]["alone"]["aa"]
    assert rec["variants"]["alone"]["summary"] == files["flax"]


def test_tool_imports_no_jax():
    code = ("import sys, amcontrast3d_tpu_torch.tools.convergence_check, "
            "amcontrast3d_tpu_torch.tools.convergence_record; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'amcontrast3d_tpu')]; "
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_tool_stops_without_a_card():
    proc = subprocess.run(
        [sys.executable, "-m", "amcontrast3d_tpu_torch.tools.convergence_check",
         "--epochs", "1"], cwd=REPO, capture_output=True, text=True,
        timeout=120, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert not proc.stdout
