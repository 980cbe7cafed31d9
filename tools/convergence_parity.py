"""A convergence leg in both packages on the CPU, from the same weights.

    JAX_PLATFORMS=cpu python tools/convergence_parity.py --kind aa \\
        [--epochs 2] [--seed 42] [--hard] [--flax-variance] [--out parity.json]

Runs the first ``--epochs`` epochs of a leg of the port's convergence gate
(``amcontrast3d_tpu_torch/tools/convergence_check.py``: the synthetic
cfg of ``--kind`` cut to those epochs, ``dataset.train.loop=8``, colour
drop off, validation every epoch, ``--hard`` for the delta legs' rooms)
through the JAX package's ``Runner.train`` and then through the port's on
the CPU, the port started from the JAX trainer's initial weights
(``utils/convert.py::checkpoint_from_jax``, ``mode=finetune``) and each
of its steps handed the batch the JAX trainer's step took.  The head's
dropout is off (``model.cls_args.dropout=0``): the two packages draw their
masks from different generators.  Prints, and writes to ``--out``, each step's loss in both
(the first from the same weights on the same batch; the rest free-running,
so max-pool near-ties let them drift apart) and MM's loss terms and refine
rate, each epoch's val mIoU / OA / refine rate in both, and their
differences.  A gap that grows from the
first steps is a fault of the train path on the CPU already; a leg that
agrees here and misses a bar only on the card points at the kernels.
``--flax-variance``: the port's train-mode BatchNorm normalises with
flax's batch variance E[x²] − E[x]² (clipped at 0) in place of its
two-pass one, the one formula the two packages compute apart: a patch of
``ChannelsLastBatchNorm.forward`` in this process only
(:func:`use_flax_variance`).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from amcontrast3d_tpu.engine.runner import Runner as JaxRunner  # noqa: E402
from amcontrast3d_tpu.utils import EasyConfig as JaxConfig  # noqa: E402
from amcontrast3d_tpu_torch.engine import runner as prunner  # noqa: E402
from amcontrast3d_tpu_torch.models import layers  # noqa: E402
from amcontrast3d_tpu_torch.utils import EasyConfig  # noqa: E402
from amcontrast3d_tpu_torch.utils.convert import checkpoint_from_jax  # noqa: E402


# the step metrics kept beside the loss (MM's terms and refine rate)
EXTRAS = ("loss_reg", "loss_contrast", "refine_rate")


def use_flax_variance() -> None:
    """Patches the port's unsynced train-mode BatchNorm to flax's
    normalisation, ``(x − mean) · (rsqrt(var + eps) · scale) + bias`` with
    ``var = max(E[x²] − E[x]², 0)``, its running statistics moved with that
    variance; evaluation and the synced BatchNorm are left as they are."""
    plain = layers.ChannelsLastBatchNorm.forward

    def forward(self, x):
        if not self.training or self.synced:
            return plain(self, x)
        x2 = x.reshape(-1, x.shape[-1]).float()
        mean = x2.mean(0)
        var = torch.clamp_min((x2 * x2).mean(0) - mean * mean, 0.0)
        self.move_statistics(mean, var)
        y = (x2 - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.view(x.shape)

    layers.ChannelsLastBatchNorm.forward = forward


def _tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


class JaxRecorder(JaxRunner):
    """Keeps the initial variables, every batch and every step's loss."""

    def build_state(self, example_batch):
        state = super().build_state(example_batch)
        self.initial = _tree({"params": state.params,
                              "batch_stats": state.batch_stats})
        self.batches, self.losses, self.extras = [], [], []
        return state

    def train_step_fn(self):
        fn = super().train_step_fn()

        def step(state, batch, rng):
            self.batches.append(_tree(batch))
            state, metrics = fn(state, batch, rng)
            self.losses.append(float(metrics["loss"]))
            self.extras.append({k: float(metrics[k]) for k in EXTRAS
                                if k in metrics})
            return state, metrics
        return step


class PortRecorder(prunner.Runner):
    """Steps on ``batches`` (the JAX trainer's, in order) in place of its
    loader's; keeps every step's loss."""

    def train_step_fn(self):
        fn = super().train_step_fn()
        if not hasattr(self, "losses"):
            self.losses, self.extras = [], []

        def step(batch):
            theirs = self.batches[len(self.losses)]
            out = fn({k: torch.from_numpy(np.array(theirs[k])).to(v.dtype)
                      for k, v in batch.items()})
            self.losses.append(out["loss"].item())
            self.extras.append({k: float(out[k]) for k in EXTRAS if k in out})
            return out
        step.state = fn.state
        return step


def _cfg(cls, kind, opts):
    cfg = cls()
    cfg.load(os.path.join(REPO, "cfgs", "synthetic",
                          f"AMContrast3D-{kind.upper()}.yaml"), recursive=True)
    cfg.update(list(opts))
    cfg.cfg_basename = f"parity-{kind}"
    return cfg


def _epochs(run_dir):
    rows = {}
    with open(os.path.join(run_dir, "scalars.jsonl")) as f:
        for line in f:
            row = json.loads(line)
            rows.setdefault(row["tag"], {})[int(row["step"])] = row["value"]
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--kind", default="aa", choices=("aa", "mm"))
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--hard", action="store_true")
    ap.add_argument("--flax-variance", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if args.flax_variance:
        use_flax_variance()
    torch.manual_seed(args.seed)
    with tempfile.TemporaryDirectory(prefix="amc3d_parity_") as tmp:
        opts = [f"epochs={args.epochs}", f"seed={args.seed}", "val_freq=1",
                "dataset.train.loop=8", "datatransforms.kwargs.color_drop=0.0",
                "model.cls_args.dropout=0"]
        if args.hard:
            opts.append("dataset.common.hard=True")
        jcfg = _cfg(JaxConfig, args.kind, opts)
        jcfg.run_dir = os.path.join(tmp, "jax")
        os.makedirs(jcfg.run_dir)
        theirs = JaxRecorder(jcfg, kind=args.kind)
        _, jres = theirs.train()

        donor = prunner.Runner(_cfg(EasyConfig, args.kind, opts),
                               kind=args.kind, device="cpu")
        start = os.path.join(tmp, "start.ckpt")
        torch.save(checkpoint_from_jax(donor.model, None, theirs.initial), start)
        pcfg = _cfg(EasyConfig, args.kind,
                    opts + ["mode=finetune", f"pretrained_path={start}"])
        pcfg.run_dir = os.path.join(tmp, "port")
        os.makedirs(pcfg.run_dir)
        ours = PortRecorder(pcfg, kind=args.kind, device="cpu")
        ours.batches = theirs.batches
        res = ours.train()
        jrows, prows = _epochs(jcfg.run_dir), _epochs(pcfg.run_dir)

    steps = len(theirs.losses) // args.epochs
    rel = [abs(p - j) / abs(j) for p, j in zip(ours.losses, theirs.losses)]
    epochs = []
    for e in range(1, args.epochs + 1):
        row = {"epoch": e}
        for tag in ("train_loss", "val_miou", "refine_rate"):
            if e in jrows.get(tag, {}):
                row[tag] = {"jax": jrows[tag][e], "port": prows[tag][e]}
        row["max_step_loss_rel_diff"] = max(rel[(e - 1) * steps:e * steps])
        epochs.append(row)
    out = {"kind": args.kind, "hard": args.hard, "seed": args.seed,
           "flax_variance": args.flax_variance,
           "steps_an_epoch": steps,
           "first_step_loss": {"jax": theirs.losses[0], "port": ours.losses[0],
                               "rel_diff": rel[0]},
           "step_losses": {"jax": theirs.losses, "port": ours.losses},
           "step_metrics": {"jax": theirs.extras, "port": ours.extras},
           "epochs": epochs,
           "last_val_oa": {"jax": jres.get("val_oa"), "port": res["val_oa"]},
           "best_val": {"jax": jres.get("best_val"), "port": res["best_val"]},
           "refine_rate": {"jax": jres.get("refine_rate"),
                           "port": res.get("refine_rate")}}
    for row in epochs:
        print(json.dumps(row))
    print(json.dumps({k: v for k, v in out.items()
                      if k not in ("step_losses", "step_metrics")}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
