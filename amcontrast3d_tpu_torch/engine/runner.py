"""End-to-end training, validation and testing runner.

↔ ``amcontrast3d_tpu/engine/runner.py``: the host-side orchestration
around the steps of :mod:`engine.train` and :mod:`engine.predict` for the
kinds 'base' (↔ main.py), 'aa' (↔ main_AA.py) and 'mm' (↔ main_MM.py):
the epoch loop with latest/best checkpoints, resume and the finetune
family (↔ main_AA.py:119-316), ``validate``, ``validate_boundary_inner``
and ``validate_sphere``, which share bucket padding and
``posmask_searching`` with the whole-scene test and take any iterable of
batches.  The model and the optimizer hold the weights and moments that
JAX carries in ``TrainState``, so no method takes a state.

``use_amp`` builds the model with ``dtype=torch.bfloat16``, as the JAX
runner builds it with ``jnp.bfloat16`` (float32 parameters, bfloat16
Linears, float32 BatchNorms; the logits come out in bfloat16 and are
taken to float32 on the host only where numpy needs them, an exact cast).

Not ported (each raises ``NotImplementedError`` by name): ``layer_decay``
and the optimizers other than AdamW.

The runner works on one device: the card unless the caller names the CPU.
Data parallelism (↔ the JAX runner's ``distributed``, ``runner.py:52-55``):
a runner built inside a process group of N > 1 ranks
(:mod:`amcontrast3d_tpu_torch.parallel`; ``engine.cli`` launches them) is
rank r of N, unless ``distributed: False``: the weights are broadcast from
rank 0 once and its BatchNorms synced, its train loader yields its rows of
each global batch (``batch_size`` stays global), the train step is the
sharded one, and only rank 0 validates (single-device, as in JAX; the
others wait for its result, which every rank then holds), writes
checkpoints and scalars.  A cfg that asks for N > 1 ranks (``distributed:
True``, or ``world_size`` N on the CPU) in a process that is not one of
them raises.
"""
from __future__ import annotations

import logging
import time
from collections import deque
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from .. import parallel
from ..data import build_dataloader_from_cfg
from ..data.data_util import bucket_size, get_features_by_keys, pad_cloud
from ..loss import build_criterion_from_cfg
from ..models import build_model_from_cfg, init_train_weights_
from ..optim import (build_optimizer_from_cfg, freeze_parameters_,
                     freeze_pattern)
from ..scheduler import as_step_schedule, build_scheduler_from_cfg
from ..utils import (AverageMeter, ConfusionMatrix, SummaryWriter,
                     load_checkpoint, resume_checkpoint, save_checkpoint,
                     set_random_seed)
from .predict import make_predict_step
from .train import make_train_step

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
        # a cfg that names N > 1 ranks (distributed=True, the CPU's
        # world_size, torchrun's) runs only as one of N processes; on the
        # card the default leaves it to the launcher
        wanted = parallel.requested_world_size(cfg, self.device.type)
        named = (cfg.get("distributed", None) is True
                 or self.device.type == "cpu"
                 or parallel.from_environment() is not None)
        self.world_size = parallel.get_world_size()
        if named and wanted > 1 and self.world_size != wanted:
            raise RuntimeError(
                f"distributed: the cfg asks for {wanted} ranks and this "
                f"process is one of {self.world_size}; launch them with "
                "engine.cli (or torchrun), or set distributed=False")
        self.distributed = (self.world_size > 1
                            and cfg.get("distributed", None) is not False)
        self.rank = parallel.get_rank() if self.distributed else 0
        seed = cfg.get("seed") or 0
        # each rank's host streams (augmentation) of its own, as the
        # reference seeds seed + rank; the weights come from ``seed`` alone
        self.rng = set_random_seed(seed + self.rank)

        dtype = torch.bfloat16 if cfg.get("use_amp", False) else torch.float32
        self.model = init_train_weights_(
            build_model_from_cfg(dict(cfg.model), dtype=dtype),
            torch.Generator().manual_seed(seed)).to(self.device)
        if self.distributed:
            parallel.replicate(self.model)
            parallel.sync_batchnorm_(self.model)
        crit_cfg = cfg.get(KIND_TO_CRITERION_KEY[kind]) or {"NAME": "CrossEntropy"}
        self.criterion = build_criterion_from_cfg(crit_cfg)

        self.num_classes = int(cfg.num_classes)
        self.ignore_index = cfg.get("ignore_index", None)
        self.ambiguity_args = dict(cfg.get("ambiguity_args", {}) or {})
        self._predict = None

        self.lr_fn, self.epochs = build_scheduler_from_cfg(cfg)
        self.plateau = None
        self.optimizer = None
        self.frozen = []
        self._schedule = None
        self._train_step = None

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
        epoch, _ = load_checkpoint(self.model, path, module=module)
        return epoch

    # ------------------------------------------------------------------
    def build_state(self):
        """The optimizer and the per-step schedule (↔ ``build_state``: the
        model already holds its weights).  ``cfg.steps_per_epoch`` turns
        the per-epoch schedule into a per-step one; parameters named by
        ``cfg.freeze_re`` (or ``freeze_blocks`` in the mode) are frozen
        before the optimizer is built."""
        cfg = self.cfg
        self._schedule = as_step_schedule(
            self.lr_fn, cfg.get("steps_per_epoch", 1),
            start_epoch=cfg.get("start_epoch", 1))
        opt_cfg = dict(cfg.get("optimizer", {"NAME": "adamw"}) or {})
        if opt_cfg.get("layer_decay"):
            raise NotImplementedError("layer_decay is not ported yet "
                                      "(ROADMAP.md §1)")
        self.plateau = getattr(self.lr_fn, "plateau", None)
        self.frozen = freeze_parameters_(self.model, freeze_pattern(cfg))
        if self.frozen:
            logging.info("Frozen parameters: %d tensors", len(self.frozen))
        self.optimizer = build_optimizer_from_cfg(opt_cfg, self.model,
                                                  lr=float(cfg.get("lr", 1e-3)))
        self._train_step = None
        return self.optimizer

    def train_step_fn(self):
        """``step(batch) → metrics`` of :func:`engine.train.make_train_step`
        over this runner's model, criterion, optimizer and schedule; the
        dropout masks come from a generator seeded with ``seed + 1``."""
        if self._train_step is None:
            generator = torch.Generator(self.device).manual_seed(
                (self.cfg.get("seed") or 0) + 1)
            self._train_step = make_train_step(
                self.model, self.criterion, self.optimizer, self._schedule,
                self.kind, self.num_classes, self.ignore_index,
                self.ambiguity_args, self.cfg.get("grad_norm_clip"),
                generator, distributed=self.distributed)
        return self._train_step

    def _restore(self, mode: str) -> Dict:
        """``cfg.pretrained_path`` into the model: everything a run needs to
        carry on (mode ``resume``), or the weights only, all of them or the
        encoder's (the finetune family, ↔ main_AA.py:229-236).  Returns the
        checkpoint's extras for a resumed run, else nothing."""
        cfg = self.cfg
        step = self.train_step_fn()
        if mode == "resume":
            extras = resume_checkpoint(cfg, self.model, self.optimizer)
            # the schedule and the dropout seeds follow the step count
            step.state["step"] = int(
                extras.get("step", (cfg.start_epoch - 1) * cfg.steps_per_epoch))
            if self.plateau is not None and extras.get("plateau"):
                self.plateau.load_state_dict(extras["plateau"])
                step.state["lr_scale"] = self.plateau.scale
            return extras
        module = "encoder" if "encoder" in mode else cfg.get("pretrained_module")
        logging.info("Finetuning from %s (module=%s)", cfg.pretrained_path,
                     module)
        load_checkpoint(self.model, cfg.pretrained_path, module=module)
        return {}

    def train(self):
        """The epoch loop (↔ ``Runner.train``): returns the ``results``
        dict.  The metrics of a step are read two steps later, so the host
        does not wait for the device every step; a non-finite loss stops the
        run when it is read."""
        cfg = self.cfg
        seed = cfg.get("seed") or 0
        # each rank loads its rows of the global batch; rank 0 alone
        # validates
        loaders = [build_dataloader_from_cfg(
            cfg.batch_size, cfg.dataset, cfg.get("dataloader"),
            cfg.get("datatransforms"), split="train",
            distributed=self.distributed, seed=seed)]
        loaders.append(build_dataloader_from_cfg(
            cfg.get("val_batch_size", 1), cfg.dataset, cfg.get("dataloader"),
            cfg.get("datatransforms"), split="val", seed=seed)
            if self.rank == 0 else None)
        try:
            return self._train(*loaders)
        finally:
            for loader in loaders:
                if loader is not None:
                    loader.close()

    def _train(self, train_loader, val_loader):
        cfg = self.cfg
        cfg.steps_per_epoch = max(len(train_loader), 1)
        self.build_state()
        n_params = sum(p.numel() for p in self.model.parameters())
        logging.info("Number of params: %.4f M", n_params / 1e6)

        start_epoch = cfg.get("start_epoch", 1)
        mode = str(cfg.get("mode", "train"))
        best_val, best_epoch = 0.0, 0
        if cfg.get("pretrained_path"):
            extras = self._restore(mode)
            if mode == "resume":
                start_epoch = cfg.start_epoch
                best_val = float(extras.get("best_val", 0.0))
                best_epoch = int(extras.get("best_epoch", 0))
        else:
            logging.info("Training from scratch")
        step = self.train_step_fn()

        lead = self.rank == 0
        writer = SummaryWriter(
            cfg.get("run_dir") if lead else None,
            use_wandb=bool((cfg.get("wandb") or {}).get("use_wandb")),
            wandb_cfg=cfg.get("wandb"))
        val_miou = val_macc = val_oa = 0.0
        last_refine_rate = None
        timing = []
        for epoch in range(start_epoch, self.epochs + 1):
            train_loader.set_epoch(epoch)
            t0 = time.time()
            loss_meter = AverageMeter()
            cm = ConfusionMatrix(self.num_classes, self.ignore_index)
            extra_meters: Dict[str, AverageMeter] = {}

            def drain(m):
                loss = float(m["loss"])
                if not np.isfinite(loss):
                    raise FloatingPointError(
                        f"non-finite train loss {loss} in epoch {epoch}")
                loss_meter.update(loss)
                cm.update_matrix(m["cm"])
                for k, v in m.items():
                    if k.startswith("loss_") or k == "refine_rate":
                        extra_meters.setdefault(k, AverageMeter()).update(
                            float(v))

            pending = deque()
            waited, steps, t_wait = 0.0, 0, time.time()
            for data in train_loader:
                waited += time.time() - t_wait
                pending.append(step(self.put_batch(_prep_batch(data, cfg))))
                steps += 1
                if len(pending) > 2:
                    drain(pending.popleft())
                t_wait = time.time()
            while pending:
                drain(pending.popleft())
            train_seconds = time.time() - t0
            miou, macc, oa, _, _ = cm.all_metrics()
            lr = float(self.lr_fn(epoch)) * step.state["lr_scale"]
            extras = " ".join(f"{k} {m.avg:.4f}" for k, m in extra_meters.items())
            logging.info(
                "Epoch %d LR %.6f loss %.4f train_miou %.2f train_oa %.2f "
                "(%.1fs) %s", epoch, lr, loss_meter.avg, miou, oa,
                train_seconds, extras)
            timing.append({"epoch": epoch, "steps": steps,
                           "train_seconds": train_seconds,
                           "loader_wait_seconds": waited, "lr": lr,
                           "loss": loss_meter.avg,
                           "cm_total": int(cm.value.sum())})

            is_best = False
            if epoch % cfg.get("val_freq", 1) == 0:
                if lead:
                    val_miou, val_macc, val_oa = self._validate(val_loader)
                if self.distributed:
                    # the other ranks wait here for rank 0's validation
                    val_miou, val_macc, val_oa = parallel.broadcast_floats(
                        [val_miou, val_macc, val_oa], device=self.device)
                if val_miou > best_val:
                    is_best, best_val, best_epoch = True, val_miou, epoch
                logging.info("Epoch %d val_miou %.2f (best %.2f @E%d)",
                             epoch, val_miou, best_val, best_epoch)
            if self.plateau is not None and epoch > cfg.get("warmup_epochs", 0):
                # the metric-driven rate (↔ scheduler.step(epoch, val_miou)):
                # a factor on every group's rate from the next step on
                step.state["lr_scale"] = self.plateau.step(val_miou)
            # per-epoch scalars (↔ main_AA.py:298-308 / main_MM.py:303-311)
            writer.add_scalar("train_loss", loss_meter.avg, epoch)
            writer.add_scalar("train_miou", miou, epoch)
            writer.add_scalar("train_macc", macc, epoch)
            writer.add_scalar("val_miou", val_miou, epoch)
            writer.add_scalar("best_val", best_val, epoch)
            writer.add_scalar("lr", lr, epoch)
            for k, m in extra_meters.items():
                writer.add_scalar(k, m.avg, epoch)
            if "refine_rate" in extra_meters:
                last_refine_rate = extra_meters["refine_rate"].avg
            if cfg.get("ckpt_dir") and lead:
                extra = {"best_val": best_val, "best_epoch": best_epoch,
                         "step": step.state["step"]}
                if self.plateau is not None:
                    extra["plateau"] = self.plateau.state_dict()
                save_checkpoint(cfg, {"model": self.model.state_dict(),
                                      "optimizer": self.optimizer.state_dict()},
                                epoch, additioanl_dict=extra, is_best=is_best)
        writer.close()
        results = {"best_val": best_val, "best_epoch": best_epoch,
                   "val_miou": val_miou, "val_macc": val_macc,
                   "val_oa": val_oa, "timing": timing}
        if last_refine_rate is not None:
            # the last epoch's mean refine rate in percent (MM only)
            results["refine_rate"] = round(float(last_refine_rate), 3)
        return results

    def _validate(self, val_loader):
        """(mIoU, mACC, OA) by the cfg's validation: the sphere protocol,
        the boundary/inner split or the plain one."""
        if self.cfg.get("val_fn") == "validate_sphere":
            validate_fn = self.validate_sphere
        elif self.ambiguity_args.get("miou_B_I"):
            validate_fn = self.validate_boundary_inner
        else:
            validate_fn = self.validate
        return validate_fn(val_loader)[:3]

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
        # numpy holds no bfloat16: float32 is its exact value
        return self.predict_fn()(dev)[:, :n].float().cpu().numpy(), batch

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

    def validate_sphere(self, val_loader):
        """Sphere-protocol validation (↔ validate_sphere, main.py:437-508):
        the logits of all sampled spheres are summed per subsampled point of
        each cloud, then EVERY original point is scored through its nearest
        subsampled point (main.py:474-482).  Subsampled points no sphere
        reached keep zero logits and go to class 0, as in the reference."""
        ds = val_loader.dataset
        sizes = np.asarray([len(c[0]) for c in ds.clouds], np.int64)
        offsets = np.concatenate([[0], np.cumsum(sizes)])
        vote = np.zeros((int(offsets[-1]), self.num_classes), np.float32)
        predict = self.predict_fn()
        for data in val_loader:
            batch = _prep_batch(data, self.cfg)
            dev = self.put_batch({"pos": batch["pos"], "x": batch["x"]})
            logits = predict(dev).float().cpu().numpy()
            cloud_idx = np.asarray(data["cloud_idx"]).reshape(-1)
            point_idx = np.asarray(data["point_idx"])
            flat_idx = (point_idx + offsets[cloud_idx][:, None]).ravel()
            flat_logits = logits.reshape(-1, self.num_classes)
            for c in range(self.num_classes):
                vote[:, c] += np.bincount(flat_idx, weights=flat_logits[:, c],
                                          minlength=len(vote))
        cm = ConfusionMatrix(self.num_classes, self.ignore_index)
        for ci, c in enumerate(ds.clouds):
            pred = vote[offsets[ci]:offsets[ci + 1]].argmax(-1)
            if getattr(ds, "projections", None) is not None:
                cm.update(pred[ds.projections[ci]], ds.raw_labels[ci])
            else:
                cm.update(pred, c[2])
        return cm.all_metrics()
