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
gather-based forms of ``contrast.py:276-318``) raise
``NotImplementedError``.

``ambiguity_args.remat`` (the JAX head's ``jax.checkpoint`` of each
stage's ``point_contrast_margin``, saving only what it names
``contrast_knn``) checkpoints each stage's margin loss
(``torch.utils.checkpoint``, not reentrant) and keeps the threshold (kNN
or selection) and the (B, N, 9) reductions: the backward recomputes the
normalisation and the loss's elementwise terms, and no kernel runs twice.

The stage clouds are sorted once a forward, all in one sort
(``ops.spatial.sort_stages``), by the model's encoder, which hands the
layouts on (``clouds=``); each goes to the kernels that read it: the
stage's self-kNN (or, in the approx configuration, its threshold
selection), its contrast forward and both halves of the VJP, and, for stage
0, the label propagation (or the vote) to the coarser stages, whose own
layouts order the vote's queries.  Given no
layouts, the heads sort the stages themselves, the same way; a layout made
for another tensor than the stage's positions is refused.  The
ground-truth ambiguity (``ambiguity_head``) takes its stages' layouts the
same way.

In the approx configuration (``ops.knn.set_knn_backend('approx')``, unless
``ambiguity_args.fused`` is False, as the JAX package's fused branches
read it) no kNN runs for the loss: each point's threshold is the TPU's own
selection (``contrast_reductions_selfk``) and the stage labels come from
the majority vote (``label_vote``) instead of ``subscene_labels``
(``contrast.py:212-218, 345-370, 389-422``).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..ops import (ambiguity_from_stats, contrast_reductions,
                   contrast_reductions_selfk, knn, label_vote)
from ..ops.knn import use_approx
from ..ops.spatial import SortedCloud, check_layout, sort_stages, sort_support
from .aef import NSTRIDE, one_hot_labels, stage_ambiguity, subscene_labels

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


def _selection(args: Dict) -> bool:
    """Whether the approx configuration's threshold selection and label
    vote replace the exact kNN (↔ ``_use_fused(...) and _use_approx()``)."""
    return use_approx() and args.get("fused", True)


def _vote_k(stage_i: int) -> int:
    """kr = Π NSTRIDE[:i], the stage-0 points a stage point stands for."""
    return math.prod(NSTRIDE[:stage_i])


def point_contrast_margin(p: torch.Tensor, f: torch.Tensor,
                          labels_stage: torch.Tensor, args: Dict,
                          dist_func: str = "dist_cos",
                          contrast_func: str = "contrast_softnn_margin",
                          cloud: Optional[SortedCloud] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-stage adaptive-margin contrast.  p (B, N, 3), f (B, N, C),
    labels_stage (B, N, ncls) soft one-hot or (B, N) class ids → (scalar
    loss, ambiguity a (B, N), no gradient).  ``cloud``: p's sorted layout,
    sorted here when not given and the exact kNN runs (in the approx
    configuration the contrast kernels sort when it is not given).  With
    ``args["remat"]`` and gradients on, the loss is checkpointed, the
    threshold and the reductions kept."""
    _check_ported(args, dist_func, contrast_func)
    if labels_stage.dim() == 2:
        lab = labels_stage.float()
    else:
        lab = labels_stage.argmax(-1).float()
    p, kth = p.contiguous(), None
    if not _selection(args):
        with torch.no_grad():
            if cloud is None:
                cloud = sort_support(p)
            # the k-th-nearest d² (direct form, as the kernels compute it)
            # with the JAX package's relative cushion
            _, d2 = knn(p, p, args["nsample"], cloud)
            kth = d2[..., -1] * (1.0 + 1e-5)

    def margin(f, keep=None):
        return _margin(p, f, lab, kth, args, dist_func, cloud, keep)

    if not (args.get("remat", False) and torch.is_grad_enabled()):
        return margin(f)
    return checkpoint(margin, f, {}, use_reentrant=False,
                      preserve_rng_state=False)


def _margin(p, f, lab, kth, args: Dict, dist_func: str,
            cloud: Optional[SortedCloud], keep: Optional[dict]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The loss of :func:`point_contrast_margin` from the threshold ``kth``
    (None: the selection's); ``keep``: the dict a checkpoint holds for the
    reductions across its recompute."""
    nsample = args["nsample"]
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

    flags = (tinv, cctype == "Method3", margin_mode == "learned",
             cctype != "Method1")
    kept = {} if keep is None else {"keep": keep}
    if kth is None:
        red = contrast_reductions_selfk(p, fsim.contiguous(), lab, nsample,
                                        *flags, cloud=cloud, **kept)
    else:
        red = contrast_reductions(p, fsim.contiguous(), lab, kth, *flags,
                                  cloud=cloud, **kept)
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


def _stage_clouds(ps: List[torch.Tensor],
                  clouds: Optional[Sequence[SortedCloud]]) -> List[SortedCloud]:
    """The layout of each stage's positions: ``clouds`` as the forward
    handed them on (each checked against its stage), or one sort of all."""
    if clouds is None:
        return sort_stages(ps)
    clouds = list(clouds[:len(ps)])
    if len(clouds) != len(ps):
        raise ValueError(f"{len(clouds)} layouts for {len(ps)} stages")
    for cloud, p in zip(clouds, ps):
        check_layout(cloud, p)
    return clouds


def contrast_head(up_stages: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                  target: torch.Tensor, num_classes: int,
                  ignore_index: Optional[int], args: Dict,
                  clouds: Optional[Sequence[SortedCloud]] = None
                  ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Sum of the per-stage losses over ``stages_num`` decoder stages.

    up_stages: [(p_s (B, N_s, 3), f_s (B, N_s, C))], stage 0 at full
    resolution first; its positions are the label-propagation source.
    ``clouds``: the layouts of the p_s, as the model's forward sorted them
    (sorted here when not given)."""
    labels0 = one_hot_labels(target, num_classes, ignore_index)
    vote = _selection(args)
    if vote:
        lab0 = labels0.argmax(-1).to(torch.int32)
    stages = int(args.get("stages_num", 4))
    # the positions every kernel of a stage reads, and their layouts
    ps = [p.contiguous() for p, _ in up_stages[:stages]]
    p0 = ps[0]
    with torch.no_grad():
        clouds = _stage_clouds(ps, clouds)
    loss_sum = 0.0
    target_ai_list: List[torch.Tensor] = []
    for i in range(stages):
        p, f = ps[i], up_stages[i][1]
        if i == 0:
            labels = labels0
        elif vote:
            labels = label_vote(p0, lab0, p, _vote_k(i), labels0.shape[-1],
                                clouds[0], clouds[i])
        else:
            labels = subscene_labels(labels0, p0, p, i, clouds[0])
        loss, a = point_contrast_margin(p, f, labels, args, cloud=clouds[i])
        loss_sum = loss_sum + loss
        target_ai_list.append(a)
    return loss_sum, target_ai_list


def ambiguity_head(up_stages: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                   target: torch.Tensor, num_classes: int,
                   ignore_index: Optional[int], args: Dict,
                   clouds: Optional[Sequence[SortedCloud]] = None
                   ) -> List[torch.Tensor]:
    """Ground-truth ambiguity (B, N_s) per stage, no loss: the propagated
    stage labels and the K-slot neighbourhood statistics of the exact kNN
    (the JAX package's exact branch, ``contrast.py:423-427``), or in the
    approx configuration the voted labels and the counts and distances of
    the selection's reductions over a zero 1-wide feature
    (``contrast.py:400-422``).  ``clouds``: as :func:`contrast_head`
    takes them."""
    labels0 = one_hot_labels(target, num_classes, ignore_index)
    cctype = args.get("cctype", "Method2")
    fused = _selection(args)
    out = []
    with torch.no_grad():
        stages = int(args.get("stages_num", 4))
        ps = [s[0].contiguous() for s in up_stages[:stages]]
        p0 = ps[0]
        # every stage's layout, from the forward or by one sort: its kNN or
        # its contrast kernels, the labels from stage 0
        clouds = _stage_clouds(ps, clouds)
        if fused:
            lab0 = labels0.argmax(-1).to(torch.int32)
        for i in range(stages):
            p = ps[i]
            if not fused:
                labels = subscene_labels(labels0, p0, p, i, clouds[0])
                out.append(stage_ambiguity(p, labels, args["nsample"], cctype,
                                           args.get("ccbeta", 0.04),
                                           clouds[i])[0])
                continue
            lab = lab0 if i == 0 else label_vote(
                p0, lab0, p, _vote_k(i), labels0.shape[-1], clouds[0],
                clouds[i])
            red = contrast_reductions_selfk(
                p, p.new_zeros(*p.shape[:2], 1), lab.float(), args["nsample"],
                1.0, cctype == "Method3", False, cctype != "Method1",
                cloud=clouds[i])
            out.append(ambiguity_from_stats(
                red[..., 4], red[..., 5], red[..., 6], red[..., 7],
                args.get("ccbeta", 0.04), method1=cctype == "Method1",
                k_cap=float(args["nsample"] - 1)))
    return out
