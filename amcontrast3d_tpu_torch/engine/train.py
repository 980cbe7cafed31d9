"""The train step.

↔ ``amcontrast3d_tpu/engine/train.py::make_train_step`` for the kinds
``base`` (BaseSeg, ``criterion(logits, y)``), ``aa``
(BaseSeg_AMContrast3D with ``CrossEntropyAce``) and ``mm``
(BaseSeg_M_AMContrast3D with ``CrossEntropyAcePre``: loss = seg + reg, and
the metrics ``loss_seg``, ``loss_ce``, ``loss_contrast``, ``loss_reg`` and
``refine_rate``).  One call is one step:
the forward in training mode, the loss, the backward, the global-norm
clip, the step's learning rate, the optimizer (AdamW or any of
``optim``'s chains), and the confusion matrix of the train logits.  The
model and the optimizer hold the state that JAX carries in
``TrainState``; ``step.state`` holds the step counter (the
schedule and the dropout seeds follow it, and a resumed run restores it)
and ``lr_scale``, the plateau scheduler's factor on every group's rate.
Frozen parameters are those with ``requires_grad`` off when the optimizer
was built (``optim.freeze_parameters_``).

``needs_hessian`` (the optimizer ``adahessian`` or ``lookahead_adahessian``,
↔ ``make_train_step(needs_hessian=True)``, ``engine/train.py:134-142`` of
the JAX package): the gradients are taken with ``create_graph=True`` and
the Hutchinson diagonal ``z ⊙ (H z)`` by a second ``autograd.grad`` along
±1 probes (``optim.hutchinson_diag``), drawn from the step's generator
reseeded from (seed, step) alone, so every rank would draw the same ones
(JAX folds the key before the replica index); a caller may hand the
probes in (``step(batch, probes=...)``, numpy arrays or tensors in the
optimizer's parameter order).  The clip takes the gradients only; the
diagonal reaches the update unclipped (JAX's clip chain forwards
``hess``).  Not ported with it, each raising ``NotImplementedError`` by
name: ``distributed`` (the synced BatchNorm has no second-order rule),
a bfloat16 model (``use_amp``) and remat.

``distributed`` is the sharded step (↔ ``make_train_step(axis_name='dp')``
under ``make_sharded_train_step``), one process a rank: the batch holds
this rank's rows, the model's BatchNorms are synced
(``parallel.sync_batchnorm_``), the gradients are averaged over the ranks
in one all_reduce before the clip and AdamW, the loss and the aux metrics
are averaged and the confusion matrix summed, and the dropout masks are
drawn from (seed, step, rank) (↔ ``fold_in(rng, axis_index)``).
Every seed of a step comes from ``utils.random.fold_in``, so that the
streams of two seeds share no run of masks.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Union

import torch
from torch import nn

from .. import parallel
from ..optim import clip_by_global_norm_, hutchinson_diag, rademacher_like
from ..utils.metrics import confusion_matrix_update
from ..utils.random import fold_in


# the probes' stream is that of the dropout seed plus this
PROBE_SEED_OFFSET = 0x2545F491


def apply_gradients(optimizer: torch.optim.Optimizer, params,
                    lr: float, lr_scale: float = 1.0,
                    grad_norm_clip: Optional[float] = None,
                    hess=None) -> None:
    """The update of a step from the gradients in ``.grad`` (↔ JAX's
    ``build_tx`` chain): the global-norm clip, then the optimizer at the
    step's rate ``lr`` of the schedule, its update scaled by the plateau
    factor ``lr_scale``.  Every group's ``lr`` is ``lr · lr_scale`` (what
    ``torch.optim.AdamW`` reads; the factor commutes with its update) and
    its ``lr_scale`` the factor, which ``optim.extras.Chain`` applies to
    the final update, where the JAX chain's ``scale_by_plateau`` sits.
    ``hess``: the Hutchinson diagonal of each parameter, unclipped, for
    adahessian's rule (``optim.extras.Chain.step(hess=...)``)."""
    if grad_norm_clip is not None and grad_norm_clip > 0:
        clip_by_global_norm_(params, grad_norm_clip)
    for group in optimizer.param_groups:
        group["lr"] = lr * lr_scale
        group["lr_scale"] = lr_scale
    if hess is None:
        optimizer.step()
    else:
        optimizer.step(hess=hess)


def forward_loss(model: nn.Module, criterion: Callable, kind: str,
                 batch: Dict, num_classes: int,
                 ignore_index: Optional[int] = None,
                 ambiguity_args: Optional[Dict] = None,
                 generator: Optional[torch.Generator] = None):
    """(loss, logits, aux metrics) of one train-mode forward and the loss
    of ``kind`` (↔ ``_forward_loss``)."""
    ambiguity_args = dict(ambiguity_args or {})
    target = batch["y"]
    key = "f_up" if ambiguity_args.get("stages", "up") == "up" else "f_down"
    aux = {}
    if kind == "base":
        logits = model(batch["pos"], batch["x"], generator=generator)
        loss = criterion(logits, target)
    elif kind == "aa":
        logits, stages = model(batch["pos"], batch["x"], generator=generator)
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
    return loss, logits, aux


def _check_second_order(model: nn.Module, ambiguity_args: Dict,
                        distributed: bool) -> None:
    """Raises ``NotImplementedError`` naming each part of a step whose
    second order is not ported."""
    if distributed:
        raise NotImplementedError(
            "adahessian with distributed=True is not ported: the synced "
            "BatchNorm (models.layers._SyncedBatchNorm) has no second-order "
            "rule")
    if any(getattr(m, "compute_dtype", torch.float32) != torch.float32
           for m in model.modules()):
        raise NotImplementedError(
            "adahessian with use_amp (a bfloat16 model) is not ported: the "
            "bfloat16 forms have no second-order rule")
    if ambiguity_args.get("remat", False) or any(
            getattr(m, "remat", False) is True for m in model.modules()):
        raise NotImplementedError(
            "adahessian with remat (encoder_args.remat or "
            "ambiguity_args.remat) is not ported")


def make_train_step(model: nn.Module, criterion: Callable,
                    optimizer: torch.optim.Optimizer,
                    lr_schedule: Union[Callable[[int], float], float],
                    kind: str, num_classes: int,
                    ignore_index: Optional[int] = None,
                    ambiguity_args: Optional[Dict] = None,
                    grad_norm_clip: Optional[float] = None,
                    generator: Optional[torch.Generator] = None,
                    distributed: bool = False, needs_hessian: bool = False
                    ) -> Callable[[Dict], Dict[str, torch.Tensor]]:
    """Returns ``step(batch) → {"loss", "cm", …}`` for a batch of device
    tensors ``pos`` (B, N, 3), ``x`` (B, N, C_in), ``y`` (B, N).

    ``generator`` (on the model's device) draws the dropout masks; step s
    reseeds it with ``fold_in(seed, s)`` of its initial seed, so a step's
    masks depend only on the seed and the step (as JAX folds the step into
    its key ``PRNGKey(seed)``); with ``distributed``, rank r > 0 first
    folds r into the seed (rank 0's masks are the one-process step's).
    ``needs_hessian``: the adahessian step (see the module's note); its
    probes come from ``generator`` reseeded with ``fold_in(seed +
    PROBE_SEED_OFFSET, s)`` (without a generator, one on the parameters'
    device, from a seed of 0).
    Nothing is read back to the host."""
    if kind not in ("base", "aa", "mm"):
        raise NotImplementedError(f"train step kind {kind} is not ported")
    ambiguity_args = dict(ambiguity_args or {})
    params = [p for g in optimizer.param_groups for p in g["params"]]
    if needs_hessian:
        _check_second_order(model, ambiguity_args, distributed)
    seed = generator.initial_seed() if generator is not None else None
    probe_seed = (seed or 0) + PROBE_SEED_OFFSET
    if seed is not None and distributed and parallel.get_rank():
        seed = fold_in(seed, parallel.get_rank())
    state = {"step": 0, "lr_scale": 1.0}

    def hessian(loss, s: int, probes):
        """Sets ``.grad`` and returns the Hutchinson diagonal."""
        grads = torch.autograd.grad(loss, params, create_graph=True,
                                    allow_unused=True)
        if probes is None:
            gen = generator
            if gen is None:
                gen = torch.Generator(params[0].device)
            gen.manual_seed(fold_in(probe_seed, s))
            probes = rademacher_like(params, gen)
        else:
            if len(probes) != len(params):
                raise ValueError(f"{len(probes)} probes for {len(params)} "
                                 "parameters")
            probes = [torch.as_tensor(z).to(p.device, p.dtype)
                      for z, p in zip(probes, params)]
        hess = hutchinson_diag(grads, params, [probes])
        for p, g in zip(params, grads):
            p.grad = torch.zeros_like(p) if g is None else g.detach()
        return hess

    def step(batch: Dict, probes=None) -> Dict[str, torch.Tensor]:
        s = state["step"]
        model.train()
        if generator is not None:
            generator.manual_seed(fold_in(seed, s))
        target = batch["y"]
        loss, logits, aux = forward_loss(model, criterion, kind, batch,
                                         num_classes, ignore_index,
                                         ambiguity_args, generator)
        optimizer.zero_grad(set_to_none=True)
        hess = None
        if needs_hessian:
            hess = hessian(loss, s, probes)
        else:
            loss.backward()
        if distributed:
            parallel.all_reduce_gradients_(params)
        apply_gradients(optimizer, params,
                        lr_schedule(s) if callable(lr_schedule) else lr_schedule,
                        state["lr_scale"], grad_norm_clip, hess)
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
