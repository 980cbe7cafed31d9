"""The adaptive-margin contrast reductions over threshold neighbourhoods.

↔ ``amcontrast3d_tpu/ops/contrast_pallas.py::contrast_reductions`` (the
exact backend's entry, with an external threshold ``kth``) and its TPU
kernels ``_fwd_kernel`` (forward), ``_bwd_rows_kernel`` and
``_bwd_sup_kernel`` (VJP), ported as ``csrc/contrast.cu``.  For every point
i, over its neighbours ``{j ≠ i : d²_ij ≤ kth_i}`` of the same cloud, with
``s_ij = f_i·f_j``, ``e_ij = exp(s_ij·tinv)`` and ``pm_ij`` = same label:

    P    = Σ pm·e        Q    = Σ (1−pm)·e
    Spos = Σ pm·s        Sneg = Σ (1−pm)·s          (zero unless need_s)
    npos = Σ pm          nneg = Σ (1−pm)
    dpos = Σ pm·d̃        dneg = Σ (1−pm)·d̃          (zero unless need_d)

with ``d̃ = √(|d²| + 1e-12)`` when ``cctype_root`` else d², and column 8 is
``kth``: (B, N, 9).  d² is in the direct form ``(dx·dx + dy·dy) + dz·dz``,
so membership is bit-identical between the kernels and the plain twins.
Similarities are full float32 (the TPU kernels' default bf16 MXU passes
are a TPU choice).  Differentiable in ``f`` only; with
``w_ij = nb·[pm·gP_i + (1−pm)·gQ_i]·e_ij·tinv (+ nb·[pm·gSpos_i +
(1−pm)·gSneg_i] when need_s)``:

    df_i = Σ_j w_ij f_j   (rows)      df_j += Σ_i w_ij f_i   (support)

Gradients into columns 4-8 are ignored, as in the TPU VJP.  All three
kernels read the cloud's Morton-sorted layout (``spatial.SortedCloud``, ↔
the Morton / kd sort of ``contrast_reductions``,
``contrast_pallas.py:644-695``) and its sorted (label, threshold) columns
(:func:`support_layout`), and skip the chunks whose box lies beyond the
threshold from a block's points (↔ the TPU kernels' threshold bounds,
``:237``, ``:326-329``, ``:405-411``).  Each wrapper takes the layout of
``p`` (``cloud=``) or sorts for itself; :func:`contrast_reductions` gathers
the columns once, in the forward, and keeps layout and columns for both
halves of the VJP.  The plain twins accept a layout and ignore it.

The approx configuration (``ops.knn.set_knn_backend('approx')``) takes the
TPU's own threshold instead of the exact kNN's: ↔
``contrast_pallas.py::contrast_reductions_selfk`` (``_fwd_kernel`` with
``has_kth=False``) and ``::label_vote`` (``_vote_kernel``).  That threshold
is each point's k-th smallest *distinct* d² (the TPU's extraction rounds
remove every copy of each minimum) times float32(1 + 1e-6), or 3e38 times
the same with fewer than k distinct values: ``contrast_select`` (kernel
``csrc/contrast_select.cu``) finds it over a point's own cloud, self
included, and ``label_vote`` (``csrc/vote.cu``) over the stage-0 support,
then takes the majority class of the points within it, ties to the lowest
class.  Both kernels are listed scans (``csrc/listed_select.cuh``) over the
Morton-sorted layouts the forward made: the selection over its cloud's
(``cloud=``), the vote over the support's (``cloud=``) with the queries in
the order of their own (``query_cloud=``); each wrapper sorts what it is
not given, and the plain twins accept the layouts and ignore them.  Both
are exact where the TPU tournament may overflow above 4096 points.  The
port always uses the reduction form of the contrast, so it needs no
counterpart of the JAX package's ``set_fused_contrast``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import spatial
from ._build import launch
from .knn import pairwise_d2

_NOUT = 9
# query rows per (B, tile, N) block of the plain twins
_TILE = 512
# the selection's slack, float32(1 + 1e-6), and its value for fewer than k
# distinct distances (the TPU kernels' fill value)
_SLACK = float(np.float32(1.0 + 1e-6))
_NONE = float(np.float32(3e38))
# (B, tile, N) elements a sorted block of the plain selection may hold
_SELECT_ELEMENTS = 2 ** 24
# the vote kernel's per-warp histograms (8 warps) must fit the 227 KB of
# shared memory a block may use beside 16 KB kept for the rest (its list of
# chunks: 4 KB)
VOTE_MAX_CLASSES = (232448 - 16384) // 32


def _check(p, f, lab, kth, cuda: bool) -> None:
    B, N, C = f.shape
    shapes = {"p": (p, (B, N, 3)), "lab": (lab, (B, N)), "kth": (kth, (B, N))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    for t in (p, f, lab, kth):
        if t.dtype != torch.float32:
            raise TypeError(f"contrast reductions take float32, got {t.dtype}")
        if cuda and (t.device.type != "cuda" or t.device != f.device
                     or not t.is_contiguous()):
            raise ValueError("contrast kernels need contiguous tensors on one "
                             f"CUDA device, got {t.device} "
                             f"contiguous={t.is_contiguous()}")
    if cuda and not 1 <= C <= 512:
        raise ValueError(f"contrast kernels take 1 ≤ C ≤ 512, got {C}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _tile_terms(p, f, lab, kth, s: int, e: int, tinv: float):
    """d², membership, same-label mask, similarities and exp for the query
    rows s:e against every support point: (B, e−s, N) each."""
    N = p.shape[1]
    d2 = pairwise_d2(p[:, s:e], p)
    col = torch.arange(N, device=p.device)
    row = torch.arange(s, e, device=p.device)
    nb = (d2 <= kth[:, s:e, None]) & (col != row[:, None])
    pm = lab[:, None, :] == lab[:, s:e, None]
    sim = torch.matmul(f[:, s:e], f.transpose(1, 2))
    ex = torch.exp(torch.where(nb, sim, 0.0) * tinv)
    return d2, nb, pm, sim, ex


def contrast_forward_plain(p, f, lab, kth, tinv: float = 1.0,
                           cctype_root: bool = False, need_s: bool = True,
                           need_d: bool = True,
                           cloud: Optional[spatial.SortedCloud] = None
                           ) -> torch.Tensor:
    """Plain PyTorch reductions (B, N, 9), in (B, tile, N) blocks (a
    layout, ``cloud``, changes nothing here).

    Each point's sums run over its members one at a time, in float32, in
    the order the forward kernel visits them: along the cloud's own Morton
    curve (:func:`spatial.sort_support`, the layout every stage cloud has).
    A float32 sum over thousands of members (a point with fewer than k
    distinct d² takes every other point) then rounds as the kernel's does,
    where a sum in index order would differ from it by some 1e-5."""
    _check(p, f, lab, kth, cuda=False)
    B, N, C = f.shape
    perm = spatial.sort_support(p).perm                     # (B, N)
    # the support columns in the kernel's visit order
    ps = torch.gather(p, 1, perm[..., None].expand(B, N, 3))
    fs = torch.gather(f, 1, perm[..., None].expand(B, N, C))
    ls = torch.gather(lab, 1, perm)
    out = f.new_zeros(B, N, _NOUT)
    for s in range(0, N, _TILE):
        e = min(s + _TILE, N)
        d2 = pairwise_d2(p[:, s:e], ps)
        row = torch.arange(s, e, device=p.device)
        nb = (d2 <= kth[:, s:e, None]) & (perm[:, None, :] != row[:, None])
        pm = ls[:, None, :] == lab[:, s:e, None]
        sim = torch.matmul(f[:, s:e], fs.transpose(1, 2))
        ex = torch.exp(torch.where(nb, sim, 0.0) * tinv)
        pos, neg = nb & pm, nb & ~pm
        o = out[:, s:e]
        o[..., 4] = pos.sum(-1)
        o[..., 5] = neg.sum(-1)
        dt = torch.sqrt(d2.abs() + 1e-12) if cctype_root else d2
        terms = [(0, ex, True), (2, sim, need_s), (6, dt, need_d)]
        # each row's members first, in visit order (a stable sort of the
        # non-members behind them), then the sums one member at a time
        front = torch.sort((~nb).to(torch.uint8), dim=-1, stable=True).indices
        width = int(nb.sum(-1).max()) if nb.numel() else 0
        front = front[..., :width]
        is_pos = pos.gather(-1, front)
        is_neg = neg.gather(-1, front)
        for col, value, needed in terms:
            if not needed:
                continue
            v = value.gather(-1, front)
            vp = torch.where(is_pos, v, 0.0)
            vn = torch.where(is_neg, v, 0.0)
            acc_p = torch.zeros_like(vp[..., 0])
            acc_n = torch.zeros_like(vn[..., 0])
            for t in range(width):
                acc_p = acc_p + vp[..., t]
                acc_n = acc_n + vn[..., t]
            o[..., col] = acc_p
            o[..., col + 1] = acc_n
    out[..., 8] = kth
    return out


def _layout(p, lab, kth, cloud):
    """(cloud, aux, cmax) the kernels read: the layout of ``p`` (sorted
    here when not given) and :func:`support_layout`'s columns."""
    if cloud is None:
        cloud = spatial.sort_support(p)
    return (cloud,) + support_layout(cloud, lab, kth)


def _forward_kernel(cloud, aux, f, tinv, cctype_root, need_s, need_d):
    B, N, C = f.shape
    out = torch.empty(B, N, _NOUT, dtype=torch.float32, device=f.device)
    launch("amc3d_contrast_forward", cloud.packed.data_ptr(), aux.data_ptr(),
           cloud.boxes.data_ptr(), f.data_ptr(), out.data_ptr(), B, N, C,
           float(tinv), int(cctype_root), int(need_s), int(need_d), _stream(f))
    contrast_forward.launches += 1
    return out


def contrast_forward(p, f, lab, kth, tinv: float = 1.0,
                     cctype_root: bool = False, need_s: bool = True,
                     need_d: bool = True,
                     cloud: Optional[spatial.SortedCloud] = None
                     ) -> torch.Tensor:
    """p (B,N,3), f (B,N,C), lab (B,N), kth (B,N), all f32 → (B, N, 9).

    A CUDA tensor goes through the chunk-pruned forward kernel of
    ``csrc/contrast.cu`` over ``cloud`` (the layout of ``p``; sorted here
    when not given); a CPU tensor through :func:`contrast_forward_plain`.
    No gradient: :func:`contrast_reductions` is the differentiable entry."""
    if cloud is not None:
        spatial.check_layout(cloud, p)
    if all(t.device.type == "cpu" for t in (p, f, lab, kth)):
        return contrast_forward_plain(p, f, lab, kth, tinv, cctype_root,
                                      need_s, need_d)
    _check(p, f, lab, kth, cuda=True)
    cloud, aux, _ = _layout(p, lab, kth, cloud)
    return _forward_kernel(cloud, aux, f, tinv, cctype_root, need_s, need_d)


def _grad_plain(p, f, lab, kth, g4, tinv, need_s, rows: bool, support: bool):
    """(df_rows, df_support) of the plain VJP; g4 (B, N, 4) holds the
    incoming gradients of P, Q, Spos, Sneg."""
    _check(p, f, lab, kth, cuda=False)
    B, N, C = f.shape
    df_rows = f.new_zeros(B, N, C) if rows else None
    df_sup = f.new_zeros(B, N, C) if support else None
    for s in range(0, N, _TILE):
        e = min(s + _TILE, N)
        _, nb, pm, _, ex = _tile_terms(p, f, lab, kth, s, e, tinv)
        g = g4[:, s:e, None, :]
        w = torch.where(pm, g[..., 0], g[..., 1]) * ex * tinv
        if need_s:
            w = w + torch.where(pm, g[..., 2], g[..., 3])
        w = torch.where(nb, w, 0.0)                                # (B, T, N)
        if rows:
            df_rows[:, s:e] = torch.matmul(w, f)
        if support:
            df_sup += torch.matmul(w.transpose(1, 2), f[:, s:e])
    return df_rows, df_sup


def contrast_grad_rows_plain(p, f, lab, kth, g4, tinv: float = 1.0,
                             need_s: bool = True,
                             cloud: Optional[spatial.SortedCloud] = None
                             ) -> torch.Tensor:
    """Plain query-side VJP: df_i = Σ_j w_ij f_j, (B, N, C) (a layout,
    ``cloud``, changes nothing here)."""
    return _grad_plain(p, f, lab, kth, g4, tinv, need_s, True, False)[0]


def contrast_grad_support_plain(p, f, lab, kth, g4, tinv: float = 1.0,
                                need_s: bool = True,
                                cloud: Optional[spatial.SortedCloud] = None
                                ) -> torch.Tensor:
    """Plain support-side VJP: df_j = Σ_i w_ij f_i, (B, N, C) (a layout,
    ``cloud``, changes nothing here)."""
    return _grad_plain(p, f, lab, kth, g4, tinv, need_s, False, True)[1]


def _check_g4(f, g4) -> None:
    B, N, _ = f.shape
    if (g4.shape != (B, N, 4) or g4.dtype != torch.float32
            or g4.device != f.device or not g4.is_contiguous()
            or g4.data_ptr() % 16):
        raise ValueError("g4 must be a contiguous, 16-byte aligned "
                         "(B, N, 4) float32 tensor "
                         f"on {f.device}, got {tuple(g4.shape)} {g4.dtype} "
                         f"on {g4.device}")


def support_layout_plain(cloud: spatial.SortedCloud, lab: torch.Tensor,
                         kth: torch.Tensor):
    """What the contrast kernels read beside ``cloud``: (aux (B, N, 2) f32,
    each sorted point's label and threshold; cmax (B, ceil(N/64)) f32, the
    largest threshold of each chunk, the support kernel's chunk limit)."""
    B, N = lab.shape
    aux = torch.gather(torch.stack([lab, kth], -1), 1,
                       cloud.perm[..., None].expand(B, N, 2))
    return aux, spatial.chunk_max(aux[..., 1])


def support_layout(cloud: spatial.SortedCloud, lab: torch.Tensor,
                   kth: torch.Tensor):
    """:func:`support_layout_plain` by the ``csrc/layout.cu`` kernel (one
    launch, a block a chunk) for CUDA tensors, by the plain twin for CPU
    tensors."""
    if lab.device.type == "cpu" and kth.device.type == "cpu":
        return support_layout_plain(cloud, lab, kth)
    B, N = lab.shape
    for name, t, dtype in (("the layout's perm", cloud.perm, torch.int64),
                           ("lab", lab, torch.float32),
                           ("kth", kth, torch.float32)):
        if (t.shape != (B, N) or t.dtype != dtype or not t.is_contiguous()
                or t.device.type != "cuda" or t.device != lab.device):
            raise ValueError(f"{name} must be a contiguous ({B}, {N}) {dtype} "
                             f"CUDA tensor, got {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}")
    perm = cloud.perm
    aux = torch.empty(B, N, 2, dtype=torch.float32, device=lab.device)
    cmax = torch.empty(B, -(-N // spatial.CHUNK), dtype=torch.float32,
                       device=lab.device)
    launch("amc3d_support_aux", perm.data_ptr(), lab.data_ptr(),
           kth.data_ptr(), aux.data_ptr(), cmax.data_ptr(), B, N, _stream(lab))
    support_layout.launches += 1
    return aux, cmax


support_layout.launches = 0


def _rows_kernel(cloud, aux, f, g4, tinv, need_s):
    B, N, C = f.shape
    df = torch.empty(B, N, C, dtype=torch.float32, device=f.device)
    launch("amc3d_contrast_grad_rows", cloud.packed.data_ptr(), aux.data_ptr(),
           cloud.boxes.data_ptr(), f.data_ptr(), g4.data_ptr(), df.data_ptr(),
           B, N, C, float(tinv), int(need_s), _stream(f))
    contrast_grad_rows.launches += 1
    return df


def _support_kernel(cloud, aux, cmax, f, g4, tinv, need_s):
    B, N, C = f.shape
    df = torch.empty(B, N, C, dtype=torch.float32, device=f.device)
    launch("amc3d_contrast_grad_support", cloud.packed.data_ptr(),
           aux.data_ptr(), cloud.boxes.data_ptr(), cmax.data_ptr(),
           f.data_ptr(), g4.data_ptr(), df.data_ptr(), B, N, C, float(tinv),
           int(need_s), _stream(f))
    contrast_grad_support.launches += 1
    return df


def contrast_grad_rows(p, f, lab, kth, g4, tinv: float = 1.0,
                       need_s: bool = True,
                       cloud: Optional[spatial.SortedCloud] = None
                       ) -> torch.Tensor:
    """Query-side VJP (B, N, C): each point i sums over its members j
    (``d²_ij ≤ kth_i``).  The chunk-pruned rows kernel of
    ``csrc/contrast.cu`` for a CUDA tensor, over ``cloud`` (the layout of
    ``p``; sorted here when not given); :func:`contrast_grad_rows_plain`
    for a CPU tensor."""
    if cloud is not None:
        spatial.check_layout(cloud, p)
    if all(t.device.type == "cpu" for t in (p, f, lab, kth, g4)):
        return contrast_grad_rows_plain(p, f, lab, kth, g4, tinv, need_s)
    _check(p, f, lab, kth, cuda=True)
    _check_g4(f, g4)
    cloud, aux, _ = _layout(p, lab, kth, cloud)
    return _rows_kernel(cloud, aux, f, g4, tinv, need_s)


def contrast_grad_support(p, f, lab, kth, g4, tinv: float = 1.0,
                          need_s: bool = True,
                          cloud: Optional[spatial.SortedCloud] = None
                          ) -> torch.Tensor:
    """Support-side VJP (B, N, C): each point j sums over the queries i
    whose threshold admits it (``d²_ij ≤ kth_i``).  The chunk-pruned support
    kernel of ``csrc/contrast.cu`` for a CUDA tensor, over ``cloud`` (the
    layout of ``p``; sorted here when not given); the plain twin for a CPU
    tensor."""
    if cloud is not None:
        spatial.check_layout(cloud, p)
    if all(t.device.type == "cpu" for t in (p, f, lab, kth, g4)):
        return contrast_grad_support_plain(p, f, lab, kth, g4, tinv, need_s)
    _check(p, f, lab, kth, cuda=True)
    _check_g4(f, g4)
    return _support_kernel(*_layout(p, lab, kth, cloud), f, g4, tinv, need_s)


class _ContrastReductions(torch.autograd.Function):
    """Forward and VJP by the kernels, or by the plain twins (``plain``).
    The kernels' forward gathers the sorted columns of ``cloud``, the
    layout of ``p`` (sorted here when not given), once, and keeps layout
    and columns for both halves of the VJP.  ``keep``: a dict a
    checkpointed caller holds (the loss's ``ambiguity_args.remat``); the
    forward puts its sums (and layout and columns) there, and the
    recompute takes them back instead of launching again."""

    @staticmethod
    def forward(ctx, p, f, lab, kth, tinv, cctype_root, need_s, need_d,
                plain, cloud, keep):
        ctx.tinv, ctx.need_s, ctx.plain = tinv, need_s, plain
        if keep is not None and "out" in keep:
            if plain:
                ctx.save_for_backward(p, f, lab, kth)
            else:
                ctx.cloud, aux, cmax = keep["layout"]
                ctx.save_for_backward(f, aux, cmax)
            return keep["out"].clone()
        if plain:
            ctx.save_for_backward(p, f, lab, kth)
            out = contrast_forward_plain(p, f, lab, kth, tinv, cctype_root,
                                         need_s, need_d)
        else:
            _check(p, f, lab, kth, cuda=True)
            ctx.cloud, aux, cmax = _layout(p, lab, kth, cloud)
            ctx.save_for_backward(f, aux, cmax)
            out = _forward_kernel(ctx.cloud, aux, f, tinv, cctype_root,
                                  need_s, need_d)
            if keep is not None:
                keep["layout"] = (ctx.cloud, aux, cmax)
        if keep is not None:
            keep["out"] = out.detach()
        return out

    @staticmethod
    def backward(ctx, gout):
        g4 = gout[..., :4].contiguous()
        if ctx.plain:
            df_rows, df_sup = _grad_plain(*ctx.saved_tensors, g4, ctx.tinv,
                                          ctx.need_s, rows=True, support=True)
        else:
            f, aux, cmax = ctx.saved_tensors
            _check_g4(f, g4)
            df_rows = _rows_kernel(ctx.cloud, aux, f, g4, ctx.tinv, ctx.need_s)
            df_sup = _support_kernel(ctx.cloud, aux, cmax, f, g4, ctx.tinv,
                                     ctx.need_s)
        return (None, df_rows + df_sup) + (None,) * 9


def contrast_reductions(p, f, lab, kth, tinv: float = 1.0,
                        cctype_root: bool = False, need_s: bool = True,
                        need_d: bool = True,
                        cloud: Optional[spatial.SortedCloud] = None,
                        keep: Optional[dict] = None) -> torch.Tensor:
    """p (B,N,3), f (B,N,C), lab (B,N) argmax labels, kth (B,N) d²
    threshold, all f32 → (B, N, 9) [P,Q,Spos,Sneg,npos,nneg,dpos,dneg,thr],
    differentiable in ``f``.  CUDA tensors run the three kernels over
    ``cloud``, the layout of ``p`` (sorted in the forward when not given),
    CPU tensors the plain twins.  ``keep``: a dict that a checkpointed
    caller holds across its recompute, which then reuses the forward's
    sums (no kernel runs twice)."""
    if cloud is not None:
        spatial.check_layout(cloud, p)
    plain = all(t.device.type == "cpu" for t in (p, f, lab, kth))
    return _ContrastReductions.apply(p, f, lab, kth, float(tinv),
                                     bool(cctype_root), bool(need_s),
                                     bool(need_d), plain, cloud, keep)


def contrast_reductions_plain(p, f, lab, kth, tinv: float = 1.0,
                              cctype_root: bool = False, need_s: bool = True,
                              need_d: bool = True,
                              cloud: Optional[spatial.SortedCloud] = None,
                              keep: Optional[dict] = None) -> torch.Tensor:
    """:func:`contrast_reductions` by the plain twins on any device (a
    layout, ``cloud``, changes nothing here)."""
    return _ContrastReductions.apply(p, f, lab, kth, float(tinv),
                                     bool(cctype_root), bool(need_s),
                                     bool(need_d), True, None, keep)


def kth_distinct_plain(support: torch.Tensor, query: torch.Tensor,
                       k: int) -> torch.Tensor:
    """support (B, N, 3), query (B, M, 3) f32 → (B, M) f32: the k-th
    smallest distinct d² from each query to the support (3e38 with fewer
    than k distinct values) times float32(1 + 1e-6), by sorting blocks of
    query rows."""
    B, N, _ = support.shape
    out = []
    tile = max(1, _SELECT_ELEMENTS // max(B * N, 1))
    for s in range(0, query.shape[1], tile):
        d2 = pairwise_d2(query[:, s:s + tile], support).sort(-1).values
        new = torch.ones_like(d2, dtype=torch.bool)
        new[..., 1:] = d2[..., 1:] != d2[..., :-1]
        hit = new & (new.cumsum(-1) == k)
        del new
        kth = d2.gather(-1, hit.int().argmax(-1, keepdim=True))[..., 0]
        out.append(torch.where(hit.any(-1), kth, _NONE) * _SLACK)
    return torch.cat(out, 1)


def _check_points(name: str, t: torch.Tensor, B: int, n: int) -> None:
    if tuple(t.shape) != (B, n, 3) or t.dtype != torch.float32:
        raise ValueError(f"{name} must be ({B}, {n}, 3) float32, got "
                         f"{tuple(t.shape)} {t.dtype}")


def _check_select_cuda(name: str, tensors, device, k: int) -> None:
    for t in tensors:
        if t.device.type != "cuda" or t.device != device or not t.is_contiguous():
            raise ValueError(f"{name} kernel needs contiguous tensors on one "
                             f"CUDA device, got {t.device} "
                             f"contiguous={t.is_contiguous()}")
    if k < 1:
        raise ValueError(f"k must be positive, got {k}")


def contrast_select_plain(p: torch.Tensor, k: int,
                          cloud: Optional[spatial.SortedCloud] = None
                          ) -> torch.Tensor:
    """Plain PyTorch :func:`contrast_select` (a layout, ``cloud``, changes
    nothing here)."""
    return kth_distinct_plain(p, p, k)


def contrast_select(p: torch.Tensor, k: int,
                    cloud: Optional[spatial.SortedCloud] = None
                    ) -> torch.Tensor:
    """p (B, N, 3) f32 → (B, N) f32: each point's contrast threshold, its
    k-th smallest distinct d² over its own cloud (self included, so k
    counts it) times float32(1 + 1e-6).  A CUDA tensor goes through the
    listed scan of ``csrc/contrast_select.cu`` over ``cloud`` (the layout
    of ``p``, refused for another tensor; sorted here when not given), a
    CPU tensor through :func:`contrast_select_plain`."""
    if cloud is not None:
        spatial.check_layout(cloud, p)
    if p.device.type == "cpu":
        return contrast_select_plain(p, k)
    B, N = p.shape[:2]
    _check_points("p", p, B, N)
    _check_select_cuda("contrast selection", (p,), p.device, k)
    if cloud is None:
        cloud = spatial.sort_support(p)
    out = torch.empty(B, N, dtype=torch.float32, device=p.device)
    launch("amc3d_contrast_select", cloud.packed.data_ptr(),
           cloud.boxes.data_ptr(), out.data_ptr(), B, N, int(k), _stream(p))
    contrast_select.launches += 1
    return out


def contrast_reductions_selfk(p, f, lab, k: int, tinv: float = 1.0,
                              cctype_root: bool = False, need_s: bool = True,
                              need_d: bool = True,
                              cloud: Optional[spatial.SortedCloud] = None,
                              keep: Optional[dict] = None) -> torch.Tensor:
    """:func:`contrast_reductions` over each point's own threshold (↔
    ``contrast_pallas.py::contrast_reductions_selfk``): no kNN runs.  The
    forward and the VJP are the same kernels with that threshold, which
    column 8 holds; the selection and the contrast kernels read ``cloud``
    when given.  ``k`` counts the self point.  ``keep``: as
    :func:`contrast_reductions` takes it, the thresholds kept too."""
    with torch.no_grad():
        if keep is not None and "thr" in keep:
            thr = keep["thr"]
        else:
            thr = contrast_select(p, k, cloud)
            if keep is not None:
                keep["thr"] = thr
    return contrast_reductions(p, f, lab, thr, tinv, cctype_root, need_s,
                               need_d, cloud, keep)


def contrast_reductions_selfk_plain(p, f, lab, k: int, tinv: float = 1.0,
                                    cctype_root: bool = False,
                                    need_s: bool = True,
                                    need_d: bool = True,
                                    cloud: Optional[spatial.SortedCloud] = None,
                                    keep: Optional[dict] = None
                                    ) -> torch.Tensor:
    """:func:`contrast_reductions_selfk` by the plain twins on any device (a
    layout, ``cloud``, changes nothing here)."""
    with torch.no_grad():
        if keep is not None and "thr" in keep:
            thr = keep["thr"]
        else:
            thr = contrast_select_plain(p, k)
            if keep is not None:
                keep["thr"] = thr
    return contrast_reductions_plain(p, f, lab, thr, tinv, cctype_root,
                                     need_s, need_d, keep=keep)


def label_vote_plain(p_sup: torch.Tensor, lab_sup: torch.Tensor,
                     p_q: torch.Tensor, k: int, num_classes: int,
                     cloud: Optional[spatial.SortedCloud] = None,
                     query_cloud: Optional[spatial.SortedCloud] = None
                     ) -> torch.Tensor:
    """Plain PyTorch :func:`label_vote`: class counts of the members by a
    matmul against the support's one-hot labels, then ``argmax`` (the
    layouts, ``cloud`` and ``query_cloud``, change nothing here)."""
    thr = kth_distinct_plain(p_sup, p_q, k)
    onehot = F.one_hot(lab_sup.long(), num_classes).float()
    B, N, _ = p_sup.shape
    votes = []
    tile = max(1, _SELECT_ELEMENTS // max(B * N, 1))
    for s in range(0, p_q.shape[1], tile):
        member = pairwise_d2(p_q[:, s:s + tile], p_sup) <= thr[:, s:s + tile, None]
        votes.append(torch.matmul(member.float(), onehot).argmax(-1))
    return torch.cat(votes, 1).to(torch.int32)


def label_vote(p_sup: torch.Tensor, lab_sup: torch.Tensor, p_q: torch.Tensor,
               k: int, num_classes: int,
               cloud: Optional[spatial.SortedCloud] = None,
               query_cloud: Optional[spatial.SortedCloud] = None
               ) -> torch.Tensor:
    """Majority-vote class of each query among the support points within its
    k-th smallest distinct d² (times float32(1 + 1e-6)), ties to the lowest
    class (↔ ``contrast_pallas.py::label_vote``).

    p_sup (B, N, 3) f32, lab_sup (B, N) class ids (int32 on the card),
    p_q (B, M, 3) f32 → (B, M) int32.  A CUDA tensor goes through the
    listed scans of ``csrc/vote.cu`` (1 ≤ num_classes ≤
    ``VOTE_MAX_CLASSES``) over ``cloud`` (the layout of ``p_sup``), the
    queries in the order of ``query_cloud`` (the layout of ``p_q``); each
    is refused for another tensor and sorted here when not given.  A CPU
    tensor goes through :func:`label_vote_plain`."""
    if cloud is not None:
        spatial.check_layout(cloud, p_sup)
    if query_cloud is not None:
        spatial.check_layout(query_cloud, p_q)
    if all(t.device.type == "cpu" for t in (p_sup, lab_sup, p_q)):
        return label_vote_plain(p_sup, lab_sup, p_q, k, num_classes)
    B, N = p_sup.shape[:2]
    M = p_q.shape[1]
    _check_points("p_sup", p_sup, B, N)
    _check_points("p_q", p_q, B, M)
    if tuple(lab_sup.shape) != (B, N) or lab_sup.dtype != torch.int32:
        raise ValueError(f"lab_sup must be ({B}, {N}) int32, got "
                         f"{tuple(lab_sup.shape)} {lab_sup.dtype}")
    _check_select_cuda("label vote", (p_sup, lab_sup, p_q), p_sup.device, k)
    if not 1 <= num_classes <= VOTE_MAX_CLASSES:
        raise ValueError(f"the vote kernel takes 1 ≤ num_classes ≤ "
                         f"{VOTE_MAX_CLASSES}, got {num_classes}")
    if cloud is None:
        cloud = spatial.sort_support(p_sup)
    if query_cloud is None:
        query_cloud = cloud if spatial.is_self(p_sup, p_q) else \
            spatial.sort_support(p_q)
    # the frame's rows are views (a sort_stages frame holds lo and scale in
    # one row of 4), so the kernel takes their strides
    lo, scale = cloud.lo, cloud.scale
    out = torch.empty(B, M, dtype=torch.int32, device=p_q.device)
    launch("amc3d_label_vote", cloud.packed.data_ptr(), cloud.boxes.data_ptr(),
           cloud.codes.data_ptr(), lo.data_ptr(), lo.stride(0),
           scale.data_ptr(), scale.stride(0), lab_sup.data_ptr(),
           query_cloud.packed.data_ptr(), out.data_ptr(), B, N, M, int(k),
           int(num_classes), _stream(p_q))
    label_vote.launches += 1
    return out


contrast_forward.launches = 0
contrast_grad_rows.launches = 0
contrast_grad_support.launches = 0
contrast_select.launches = 0
label_vote.launches = 0
