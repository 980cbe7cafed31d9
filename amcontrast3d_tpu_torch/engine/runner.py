"""Validation and whole-scene testing runner.

↔ ``amcontrast3d_tpu/engine/runner.py``: the host-side orchestration
around the steps of :mod:`engine.predict` for the kinds 'base' (↔ main.py),
'aa' (↔ main_AA.py) and 'mm' (↔ main_MM.py).  Ported: the constructor
(model, criterion, kind → criterion key), ``predict_fn``, ``validate`` and
``validate_boundary_inner``; they share bucket padding and
``posmask_searching`` with the whole-scene test and take any iterable of
batches.  The model holds the weights that JAX carries in ``TrainState``,
so no method takes a state.  ``train``, ``validate_sphere``, parameter
freezing and the plateau scheduler are not ported yet (ROADMAP.md §1).

The runner works on one device: the card unless the caller names the CPU.
"""
from __future__ import annotations

import logging
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from ..data.data_util import bucket_size, get_features_by_keys, pad_cloud
from ..loss import build_criterion_from_cfg
from ..models import build_model_from_cfg
from ..utils import ConfusionMatrix, set_random_seed
from .predict import make_predict_step

KIND_TO_CRITERION_KEY = {"base": "criterion_args",
                         "aa": "criterion_args_Ace",
                         "mm": "criterion_args_AcePre"}


def _prep_batch(data: Dict[str, np.ndarray], cfg) -> Dict[str, np.ndarray]:
    return {
        "pos": np.asarray(data["pos"], np.float32),
        "x": np.asarray(get_features_by_keys(data, cfg.feature_keys), np.float32),
        "y": np.asarray(data["y"], np.int64),
    }


def resolve_device(device=None) -> torch.device:
    """The card by default; the CPU only when the caller asks for it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: this package runs on the GPU unless the "
                "caller asks for the CPU (device='cpu', --device cpu)")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


class Runner:
    def __init__(self, cfg, kind: str = "aa", device=None):
        self.cfg = cfg
        self.kind = kind
        self.device = resolve_device(device)
        self.rng = set_random_seed(cfg.get("seed") or 0)

        if cfg.get("use_amp", False):
            raise NotImplementedError("use_amp (bf16) is not ported yet "
                                      "(ROADMAP.md §1)")
        self.model = build_model_from_cfg(dict(cfg.model)).to(self.device)
        crit_cfg = cfg.get(KIND_TO_CRITERION_KEY[kind]) or {"NAME": "CrossEntropy"}
        self.criterion = build_criterion_from_cfg(crit_cfg)

        self.num_classes = int(cfg.num_classes)
        self.ignore_index = cfg.get("ignore_index", None)
        self.ambiguity_args = dict(cfg.get("ambiguity_args", {}) or {})
        self._predict = None

    # ------------------------------------------------------------------
    def predict_fn(self):
        """Logits-only forward in eval mode: ``predict(batch)`` for a batch
        of device tensors ``pos`` (B, N, 3) and ``x`` (B, N, C_in)."""
        if self._predict is None:
            self._predict = make_predict_step(self.model)
        return self._predict

    def put_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in batch.items()}

    def load_pretrained(self, path: str, module: Optional[str] = None):
        """Weights from one of this package's checkpoints; returns its epoch."""
        from ..utils.ckpt import load_checkpoint
        epoch, _ = load_checkpoint(self.model, path, module=module)
        return epoch

    # ------------------------------------------------------------------
    def train(self):
        raise NotImplementedError(
            "Runner.train (epoch loop, loaders, checkpointing, freezing, the "
            "plateau scheduler) is not ported yet: ROADMAP.md §1")

    def validate_sphere(self, val_loader):
        raise NotImplementedError(
            "Runner.validate_sphere is not ported yet: ROADMAP.md §1")

    # ------------------------------------------------------------------
    def _padded_logits(self, batch):
        """Bucket-pad a host batch, run it and cut the padding off:
        → (logits (b, n, classes) numpy, the batch as padded)."""
        cfg = self.cfg
        b, n = batch["y"].shape
        nb = bucket_size(n, cfg.get("eval_bucket", 8192))
        if nb != n:
            padded = [pad_cloud({k: v[i] for k, v in batch.items()}, nb)
                      for i in range(b)]
            batch = {k: np.stack([p[k] for p in padded])
                     for k in ("pos", "x", "y")}
        dev = self.put_batch({"pos": batch["pos"], "x": batch["x"]})
        return self.predict_fn()(dev)[:, :n].cpu().numpy(), batch

    def validate(self, val_loader: Iterable):
        """Whole-cloud validation with bucket padding (↔ validate,
        main_AA.py:431-513) over an iterable of host batches (``pos``,
        ``y`` and the feature keys, each with a leading batch axis).
        Padded duplicate points are sliced off on the host before the
        confusion-matrix update."""
        cm = ConfusionMatrix(self.num_classes, self.ignore_index)
        for data in val_loader:
            batch = _prep_batch(data, self.cfg)
            n = batch["y"].shape[1]
            logits, batch = self._padded_logits(batch)
            cm.update(logits.argmax(-1), batch["y"][:, :n])
        return cm.all_metrics()

    def validate_boundary_inner(self, val_loader: Iterable):
        """Validation with boundary/inner mIoU split (↔
        validate_boundary_inner, main_AA.py:431-513): boundary points are
        those whose kNN label neighborhood is mixed (posmask quirk included:
        ``0 < Σ posmask < nsample`` with Σ ≤ nsample−1)."""
        from .evaluate import posmask_searching

        nsample = int(self.ambiguity_args.get("nsample", 24))
        cm = ConfusionMatrix(self.num_classes, self.ignore_index)
        cm_b = ConfusionMatrix(self.num_classes, self.ignore_index)
        cm_i = ConfusionMatrix(self.num_classes, self.ignore_index)
        for data in val_loader:
            batch = _prep_batch(data, self.cfg)
            b, n = batch["y"].shape
            logits, batch = self._padded_logits(batch)
            pred = logits.argmax(-1)
            y = batch["y"][:, :n]
            cm.update(pred, y)
            for i in range(b):
                posmask, _ = posmask_searching(
                    batch["pos"][i, :n], y[i], nsample, self.num_classes,
                    self.ignore_index, self.device)
                s = posmask.sum(-1)
                boundary = np.logical_and(0 < s, s < nsample)
                cm_b.update(pred[i][boundary], y[i][boundary])
                cm_i.update(pred[i][~boundary], y[i][~boundary])
        miou, macc, oa, ious, accs = cm.all_metrics()
        b_metrics = cm_b.all_metrics()[:3]
        i_metrics = cm_i.all_metrics()[:3]
        logging.info("val boundary mIoU/mACC/OA: %.2f/%.2f/%.2f  "
                     "inner: %.2f/%.2f/%.2f", *b_metrics, *i_metrics)
        return miou, macc, oa, ious, accs
