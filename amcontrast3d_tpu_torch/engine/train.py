"""The train step.

↔ ``amcontrast3d_tpu/engine/train.py::make_train_step`` for the kinds
``base`` (BaseSeg, ``criterion(logits, y)``), ``aa``
(BaseSeg_AMContrast3D with ``CrossEntropyAce``) and ``mm``
(BaseSeg_M_AMContrast3D with ``CrossEntropyAcePre``: loss = seg + reg, and
the metrics ``loss_seg``, ``loss_ce``, ``loss_contrast``, ``loss_reg`` and
``refine_rate``).  One call is one step:
the forward in training mode, the loss, the backward, the global-norm
clip, the step's learning rate, AdamW, and the confusion matrix of the
train logits.  The model and the optimizer hold the state that JAX
carries in ``TrainState``; ``step.state`` holds the step counter (the
schedule and the dropout seeds follow it, and a resumed run restores it)
and ``lr_scale``, the plateau scheduler's factor on every group's rate.
Frozen parameters are those with ``requires_grad`` off when the optimizer
was built (``optim.freeze_parameters_``).  Not ported yet: adahessian.

``distributed`` is the sharded step (↔ ``make_train_step(axis_name='dp')``
under ``make_sharded_train_step``), one process a rank: the batch holds
this rank's rows, the model's BatchNorms are synced
(``parallel.sync_batchnorm_``), the gradients are averaged over the ranks
in one all_reduce before the clip and AdamW, the loss and the aux metrics
are averaged and the confusion matrix summed, and the dropout masks are
drawn from (seed, step, rank) (↔ ``fold_in(rng, axis_index)``).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Union

import torch
from torch import nn

from .. import parallel
from ..optim import clip_by_global_norm_
from ..utils.metrics import confusion_matrix_update


def make_train_step(model: nn.Module, criterion: Callable,
                    optimizer: torch.optim.Optimizer,
                    lr_schedule: Union[Callable[[int], float], float],
                    kind: str, num_classes: int,
                    ignore_index: Optional[int] = None,
                    ambiguity_args: Optional[Dict] = None,
                    grad_norm_clip: Optional[float] = None,
                    generator: Optional[torch.Generator] = None,
                    distributed: bool = False
                    ) -> Callable[[Dict], Dict[str, torch.Tensor]]:
    """Returns ``step(batch) → {"loss", "cm", …}`` for a batch of device
    tensors ``pos`` (B, N, 3), ``x`` (B, N, C_in), ``y`` (B, N).

    ``generator`` (on the model's device) draws the dropout masks; step s
    reseeds it with its initial seed + s, so a step's masks depend only
    on the seed and the step (as JAX folds the step into its key); with
    ``distributed``, on the rank too (rank r adds r·0x9E3779B9 modulo 2³²,
    far from any step count).  Nothing is read back to the host."""
    if kind not in ("base", "aa", "mm"):
        raise NotImplementedError(f"train step kind {kind} is not ported")
    ambiguity_args = dict(ambiguity_args or {})
    params = [p for g in optimizer.param_groups for p in g["params"]]
    seed = generator.initial_seed() if generator is not None else None
    if seed is not None and distributed:
        # the CPU generator keeps 32 bits of a seed
        seed = (seed + parallel.get_rank() * 0x9E3779B9) % 2 ** 32
    state = {"step": 0, "lr_scale": 1.0}

    def step(batch: Dict) -> Dict[str, torch.Tensor]:
        s = state["step"]
        model.train()
        if generator is not None:
            generator.manual_seed(seed + s)
        target = batch["y"]
        key = "f_up" if ambiguity_args.get("stages", "up") == "up" \
            else "f_down"
        aux = {}
        if kind == "base":
            logits = model(batch["pos"], batch["x"], generator=generator)
            loss = criterion(logits, target)
        elif kind == "aa":
            logits, stages = model(batch["pos"], batch["x"],
                                   generator=generator)
            up = list(zip(stages["p"], stages[key]))
            loss = criterion(logits, target, up, num_classes, ignore_index,
                             ambiguity_args, clouds=stages["clouds"])
        else:
            # ground-truth-driven refinement needs the labels in the forward
            kwargs = ({"target": target}
                      if ambiguity_args.get("source") == "AEF" else {})
            logits, stages, rate = model(batch["pos"], batch["x"],
                                         generator=generator, **kwargs)
            up = list(zip(stages["p"], stages[key]))
            seg, ce, con, reg = criterion(
                logits, target, up, stages["ambiguity"], num_classes,
                ignore_index, ambiguity_args, clouds=stages["clouds"])
            loss = seg + reg
            aux = {"loss_seg": seg.detach(), "loss_ce": ce.detach(),
                   "loss_contrast": con.detach(), "loss_reg": reg.detach(),
                   "refine_rate": rate.detach()}
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if distributed:
            parallel.all_reduce_gradients_(params)
        if grad_norm_clip is not None and grad_norm_clip > 0:
            clip_by_global_norm_(params, grad_norm_clip)
        lr = lr_schedule(s) if callable(lr_schedule) else lr_schedule
        lr *= state["lr_scale"]
        for group in optimizer.param_groups:
            group["lr"] = lr
        optimizer.step()
        with torch.no_grad():
            cm = confusion_matrix_update(logits.argmax(-1), target,
                                         num_classes, ignore_index)
        loss = loss.detach()
        if distributed:
            loss, aux, cm = parallel.reduce_metrics(loss, aux, cm)
        state["step"] = s + 1
        return {"loss": loss, "cm": cm, **aux}

    step.state = state
    return step
