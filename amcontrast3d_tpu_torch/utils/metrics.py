"""Segmentation metrics.

↔ ``amcontrast3d_tpu/utils/metrics.py``: the per-batch confusion matrix
as a tensor function (it runs on the model's device, inside the eval
step), and the host-side numpy accumulator and IoU helpers.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def confusion_matrix_update(pred: torch.Tensor, true: torch.Tensor,
                            num_classes: int,
                            ignore_index: Optional[int] = None) -> torch.Tensor:
    """One batch's ``(num_classes, num_classes)`` int64 confusion matrix
    (rows = true, cols = pred); ``ignore_index`` labels go to a virtual
    class that is cut off."""
    virtual = num_classes + 1 if ignore_index is not None else num_classes
    true = true.reshape(-1).long()
    pred = pred.reshape(-1).long()
    if ignore_index is not None:
        ignore = true == ignore_index
        pred = torch.where(ignore, virtual - 1, pred)
        true = torch.where(ignore, virtual - 1, true)
    bins = torch.bincount(true * virtual + pred, minlength=virtual * virtual)
    return bins.view(virtual, virtual)[:num_classes, :num_classes]


class ConfusionMatrix:
    """Host-side accumulator: of per-batch matrices (``update_matrix``) and
    of predictions and labels as numpy arrays (``update``)."""

    def __init__(self, num_classes: int, ignore_index: Optional[int] = None):
        self.num_classes = num_classes
        self.ignore_index = ignore_index
        self.virtual_num_classes = (num_classes + 1 if ignore_index is not None
                                    else num_classes)
        self.value = np.zeros((num_classes, num_classes), dtype=np.int64)

    def update(self, pred, true) -> None:
        pred = np.asarray(pred).reshape(-1).astype(np.int64)
        true = np.asarray(true).reshape(-1).astype(np.int64)
        v = self.virtual_num_classes
        if self.ignore_index is not None:
            ignore = true == self.ignore_index
            pred = np.where(ignore, v - 1, pred)
            true = np.where(ignore, v - 1, true)
        bins = np.bincount(true * v + pred, minlength=v * v)
        self.value += bins.reshape(v, v)[:self.num_classes, :self.num_classes]

    def update_matrix(self, matrix) -> None:
        if isinstance(matrix, torch.Tensor):
            matrix = matrix.cpu().numpy()
        self.value += np.asarray(matrix, dtype=np.int64)

    def reset(self) -> None:
        self.value = np.zeros((self.num_classes, self.num_classes), dtype=np.int64)

    @property
    def tp(self):
        return np.diag(self.value)

    @property
    def count(self):
        return self.value.sum(axis=1)

    @property
    def total(self):
        return self.value.sum()

    @property
    def union(self):
        return self.value.sum(axis=0) + self.value.sum(axis=1) - np.diag(self.value)

    def all_metrics(self) -> Tuple[float, float, float, np.ndarray, np.ndarray]:
        """(mIoU, mAcc, OA, IoU per class, Acc per class), in percent."""
        tp = self.tp
        fp = self.value.sum(axis=0) - tp
        fn = self.count - tp
        iou_per_cls = tp / np.maximum(tp + fp + fn, 1) * 100
        acc_per_cls = tp / np.maximum(self.count, 1) * 100
        overall = tp.sum() / max(self.total, 1) * 100
        return (float(np.mean(iou_per_cls)), float(np.mean(acc_per_cls)),
                float(overall), iou_per_cls, acc_per_cls)


def get_mious(tp, union, count):
    """Reference ``get_mious`` (metrics.py:176-183) on numpy arrays."""
    tp = np.asarray(tp, dtype=np.float64)
    union = np.asarray(union, dtype=np.float64)
    count = np.asarray(count, dtype=np.float64)
    iou_per_cls = (tp + 1e-10) / (union + 1e-10) * 100
    acc_per_cls = (tp + 1e-10) / (count + 1e-10) * 100
    over_all_acc = tp.sum() / max(count.sum(), 1e-10) * 100
    return (float(np.mean(iou_per_cls)), float(np.mean(acc_per_cls)),
            float(over_all_acc), iou_per_cls, acc_per_cls)


def IoU_from_confusions(confusions: np.ndarray) -> np.ndarray:
    """Per-class IoU from stacked confusion matrices; absent classes get
    the present-class mean, so a later flat mean is over present classes."""
    confusions = np.asarray(confusions, dtype=np.float64)
    tp = np.diagonal(confusions, axis1=-2, axis2=-1)
    tp_fn = confusions.sum(axis=-1)
    tp_fp = confusions.sum(axis=-2)
    iou = tp / (tp_fp + tp_fn - tp + 1e-6)
    absent = tp_fn < 1e-3
    present = np.sum(~absent, axis=-1, keepdims=True)
    miou = iou.sum(axis=-1, keepdims=True) / (present + 1e-6)
    return iou + absent * miou


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)
