"""Inference steps: logits-only predict and logits plus confusion matrix.

↔ ``amcontrast3d_tpu/engine/train.py::make_predict_step`` and
``::make_eval_step``.  The model holds its own weights, so a step takes
only the batch, a dict of device tensors: ``pos`` (B, N, 3), ``x``
(B, N, C_in) and, for the eval step, ``y`` (B, N) labels.  Both put the
model in eval mode and run under ``torch.inference_mode()``.  On a
data-parallel rank the predict step is the sharded one as it stands (↔
``make_sharded_predict_step``: the logits of the rank's rows; eval-mode
BatchNorms read their running statistics, so no rank waits on another).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch import nn

from .. import parallel
from ..utils.metrics import confusion_matrix_update


def make_predict_step(model: nn.Module) -> Callable[[Dict], torch.Tensor]:
    def step(batch: Dict) -> torch.Tensor:
        model.eval()
        with torch.inference_mode():
            out = model(batch["pos"], batch["x"])
        return out[0] if isinstance(out, tuple) else out

    return step


def make_eval_step(model: nn.Module, num_classes: int,
                   ignore_index: Optional[int] = None,
                   distributed: bool = False
                   ) -> Callable[[Dict], Dict[str, torch.Tensor]]:
    """``distributed`` (↔ ``make_sharded_eval_step``): the logits of this
    rank's rows and the confusion matrix summed over the ranks."""
    predict = make_predict_step(model)

    def step(batch: Dict) -> Dict[str, torch.Tensor]:
        logits = predict(batch)
        with torch.inference_mode():
            cm = confusion_matrix_update(logits.argmax(-1), batch["y"],
                                         num_classes, ignore_index)
            if distributed:
                parallel.collective("all_reduce", cm)
        return {"logits": logits, "cm": cm}

    return step
