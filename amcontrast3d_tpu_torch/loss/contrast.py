"""Adaptive-margin contrastive loss (ContrastHead).

↔ ``amcontrast3d_tpu/loss/contrast.py`` in the reduction form of
``point_contrast_margin_fused``'s exact branch (``contrast.py:174-273``):
the exact kNN supplies only each point's k-th-nearest d² threshold; the
neighbourhood sums come from :func:`ops.contrast_reductions`, whose kernels
never gather (B, N, K, C) neighbour features.  The loss is taken over the
boundary points ``0 < a ≤ 1`` as a masked mean.

Ported variants: ``contrast_softnn_margin`` with ``supervisedCL``
Method1, ``dist_cos`` or ``dist_dot``, margin constant / adaptive /
learned, ``db`` −m / +m / none, cctype Method1-3.  The others (the
gather-based forms of ``contrast.py:276-318``) and ``remat`` raise
``NotImplementedError``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..ops import ambiguity_from_stats, contrast_reductions, knn
from .aef import one_hot_labels, subscene_labels

_EPS = 1e-12


def _check_ported(args: Dict, dist_func: str, contrast_func: str) -> None:
    ported = (contrast_func == "contrast_softnn_margin"
              and args.get("supervisedCL", "Method1") == "Method1"
              and dist_func in ("dist_cos", "dist_dot")
              and args.get("margin", "adaptive") in
              ("constant", "adaptive", "learned")
              and args.get("db", "-m") in ("-m", "+m", "none"))
    if not ported:
        raise NotImplementedError(
            f"contrast variant {contrast_func}/{dist_func} with "
            f"supervisedCL={args.get('supervisedCL', 'Method1')}, "
            f"margin={args.get('margin', 'adaptive')}, db={args.get('db', '-m')} "
            "is not ported")


def point_contrast_margin(p: torch.Tensor, f: torch.Tensor,
                          labels_stage: torch.Tensor, args: Dict,
                          dist_func: str = "dist_cos",
                          contrast_func: str = "contrast_softnn_margin"
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-stage adaptive-margin contrast.  p (B, N, 3), f (B, N, C),
    labels_stage (B, N, ncls) soft one-hot or (B, N) class ids → (scalar
    loss, ambiguity a (B, N), no gradient)."""
    _check_ported(args, dist_func, contrast_func)
    nsample = args["nsample"]
    if labels_stage.dim() == 2:
        lab = labels_stage.float()
    else:
        lab = labels_stage.argmax(-1).float()
    temperature = args.get("temperature", None)
    tinv = 1.0 / float(temperature) if temperature else 1.0
    cctype = args.get("cctype", "Method2")
    margin_mode = args.get("margin", "adaptive")

    if dist_func == "dist_cos":
        # per-vector normalisation; the reference clamps the norm product
        # at 1e-8 (torch cosine_similarity): they differ only for
        # near-zero features
        norm = torch.sqrt((f * f).sum(-1, keepdim=True))
        fsim = f / torch.clamp_min(norm, 1e-8)
    else:  # dist_dot: the reference's +1e-12 shift cancels in the ratio
        fsim = f

    with torch.no_grad():
        # the k-th-nearest d² (direct form, as the kernels compute it) with
        # the JAX package's relative cushion
        _, d2 = knn(p, p, nsample)
        kth = d2[..., -1] * (1.0 + 1e-5)
    red = contrast_reductions(p.contiguous(), fsim.contiguous(), lab, kth,
                              tinv, cctype == "Method3",
                              margin_mode == "learned", cctype != "Method1")
    P, Q, s_pos, s_neg = red[..., 0], red[..., 1], red[..., 2], red[..., 3]
    stats = red.detach()
    a = ambiguity_from_stats(stats[..., 4], stats[..., 5], stats[..., 6],
                             stats[..., 7], args.get("ccbeta", 0.04),
                             method1=cctype == "Method1",
                             k_cap=float(nsample - 1))

    if margin_mode == "constant":
        margin = torch.full_like(a, args["nu"])
    elif margin_mode == "adaptive":
        margin = args["mu"] * a + args["nu"]
    else:  # learned: u, v are means over the K neighbour slots
        K = float(nsample - 1)
        margin = (s_neg / K - 1.0) * a + s_pos / K

    db = args.get("db", "-m")
    pos, neg = P, Q
    if db == "-m":
        pos = P * torch.exp(-margin * tinv)
    elif db == "+m":
        neg = Q * torch.exp(margin * tinv)

    per_point = -torch.log(pos / (pos + neg) + _EPS)
    valid = ((a > 0) & (a <= 1)).to(per_point.dtype)
    loss = (per_point * valid).sum() / torch.clamp_min(valid.sum(), 1.0)
    return loss, a


def contrast_head(up_stages: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                  target: torch.Tensor, num_classes: int,
                  ignore_index: Optional[int], args: Dict
                  ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Sum of the per-stage losses over ``stages_num`` decoder stages.

    up_stages: [(p_s (B, N_s, 3), f_s (B, N_s, C))], stage 0 at full
    resolution first; its positions are the label-propagation source."""
    if args.get("remat", False):
        raise NotImplementedError("ambiguity_args.remat is not ported")
    labels0 = one_hot_labels(target, num_classes, ignore_index)
    p0 = up_stages[0][0]
    loss_sum = 0.0
    target_ai_list: List[torch.Tensor] = []
    for i in range(int(args.get("stages_num", 4))):
        p, f = up_stages[i]
        labels = labels0 if i == 0 else subscene_labels(labels0, p0, p, i)
        loss, a = point_contrast_margin(p, f, labels, args)
        loss_sum = loss_sum + loss
        target_ai_list.append(a)
    return loss_sum, target_ai_list
