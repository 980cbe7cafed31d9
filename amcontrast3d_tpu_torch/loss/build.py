"""LOSS registry and the criteria of the AA and MM train steps.

↔ ``amcontrast3d_tpu/loss/build.py`` (``cross_entropy``,
``CrossEntropy``, ``CrossEntropyAce``, ``CrossEntropyAcePre``,
``build_criterion_from_cfg``).  Criteria take channels-last logits
(B, N, ncls).  As there, ``CrossEntropyAce`` and ``CrossEntropyAcePre``
ignore the configured ``label_smoothing`` (the reference builds a plain
``CrossEntropyLoss()``, ignore index −100).  The CE runs at the logits'
dtype (bfloat16 under ``use_amp``: its log-softmax, its mean and its
weight), as the JAX package's does; the contrast and regression terms
are float32, so a weighted sum of them is float32.  The rest of the registry is
not ported yet.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..models.layers import rounded
from ..utils.registry import Registry
from .contrast import contrast_head

LOSS = Registry("loss")

_TORCH_CE_IGNORE = -100  # torch.nn.CrossEntropyLoss default


def cross_entropy(logits: torch.Tensor, target: torch.Tensor, weight=None,
                  ignore_index: Optional[int] = _TORCH_CE_IGNORE,
                  label_smoothing: float = 0.0) -> torch.Tensor:
    """Mean over the non-ignored elements (weighted mean with class
    weights); 0 when every element is ignored."""
    ncls = logits.shape[-1]
    logits = logits.reshape(-1, ncls)
    target = target.reshape(-1).long()
    valid = torch.ones_like(target, dtype=logits.dtype)
    if ignore_index is not None:
        valid = (target != ignore_index).to(logits.dtype)
        target = torch.where(target == ignore_index, 0, target)
    logp = torch.log_softmax(logits, -1)
    nll = -logp.gather(-1, target[:, None])[:, 0]
    if label_smoothing > 0:
        nll = (1.0 - label_smoothing) * nll - label_smoothing * logp.mean(-1)
    if weight is not None:
        w = torch.as_tensor(weight, dtype=logits.dtype,
                            device=logits.device)[target] * valid
        return (nll * w).sum() / torch.clamp_min(w.sum(), 1e-12)
    return (nll * valid).sum() / torch.clamp_min(valid.sum(), 1.0)


def _weighted(w: float, term: torch.Tensor) -> torch.Tensor:
    """``w · term`` with ``w`` in the term's dtype, as JAX's weakly typed
    scalar takes it: the CE at bfloat16 under ``use_amp`` (its logits'
    dtype), the contrast and regression terms in float32."""
    return term * rounded(w, term.dtype)


@LOSS.register_module(name=["CrossEntropy", "CrossEntropyLoss"])
class CrossEntropy:
    def __init__(self, label_smoothing: float = 0.0, weight=None,
                 ignore_index: Optional[int] = _TORCH_CE_IGNORE, **kwargs):
        self.label_smoothing = label_smoothing
        self.weight = weight
        self.ignore_index = (ignore_index if ignore_index is not None
                             else _TORCH_CE_IGNORE)

    def __call__(self, logits, target, *args, **kwargs):
        return cross_entropy(logits, target, weight=self.weight,
                             ignore_index=self.ignore_index,
                             label_smoothing=self.label_smoothing)


@LOSS.register_module()
class CrossEntropyAce:
    """AMContrast3D objective: w1·CE + w2·AdaptiveMarginContrast."""

    def __init__(self, **kwargs):
        self.ce = CrossEntropy()  # plain CE, smoothing deliberately ignored

    def __call__(self, logits, target, up_stages, num_classes: int,
                 ignore_index: Optional[int], ambiguity_args: Dict,
                 clouds=None):
        """``clouds``: the layouts of the stages' positions, as the model's
        forward sorted them (``stages["clouds"]``)."""
        ce = self.ce(logits, target)
        contrast, _ = contrast_head(up_stages, target, num_classes,
                                    ignore_index, ambiguity_args, clouds)
        return (_weighted(ambiguity_args["w1"], ce)
                + _weighted(ambiguity_args["w2"], contrast))


@LOSS.register_module()
class CrossEntropyAcePre:
    """AMContrast3D++ objective: Seg = w1·CE + w2·Contrast and
    Reg = w3·MAE(predicted ambiguity, target ambiguity), the target without
    gradient.  Returns ``(seg, ce, contrast, reg)``, each weighted."""

    def __init__(self, **kwargs):
        self.ce = CrossEntropy()

    def __call__(self, logits, target, up_stages, pred_ai_list,
                 num_classes: int, ignore_index: Optional[int],
                 ambiguity_args: Dict, clouds=None):
        ce = self.ce(logits, target)
        contrast, target_ai_list = contrast_head(
            up_stages, target, num_classes, ignore_index, ambiguity_args,
            clouds)
        pred = torch.cat([a.reshape(-1) for a in pred_ai_list])
        tgt = torch.cat([a.reshape(-1) for a in target_ai_list])
        reg = (pred - tgt.detach()).abs().mean()
        ce = _weighted(ambiguity_args["w1"], ce)
        contrast = _weighted(ambiguity_args["w2"], contrast)
        reg = _weighted(ambiguity_args["w3"], reg)
        return ce + contrast, ce, contrast, reg


def build_criterion_from_cfg(cfg, **kwargs):
    return LOSS.build(cfg, **kwargs)
