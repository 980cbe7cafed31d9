"""LOSS registry and the criteria of the AA train step.

↔ ``amcontrast3d_tpu/loss/build.py`` (``cross_entropy``,
``CrossEntropy``, ``CrossEntropyAce``, ``build_criterion_from_cfg``).
Criteria take channels-last logits (B, N, ncls).  As there,
``CrossEntropyAce`` ignores the configured ``label_smoothing`` (the
reference builds a plain ``CrossEntropyLoss()``, ignore index −100).  The
rest of the registry is not ported yet.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

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
                 ignore_index: Optional[int], ambiguity_args: Dict):
        ce = self.ce(logits, target)
        contrast, _ = contrast_head(up_stages, target, num_classes,
                                    ignore_index, ambiguity_args)
        return ambiguity_args["w1"] * ce + ambiguity_args["w2"] * contrast


def build_criterion_from_cfg(cfg, **kwargs):
    return LOSS.build(cfg, **kwargs)
