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

Gradients into columns 4-8 are ignored, as in the TPU VJP.  The Morton /
kd sort of the TPU path only serves its chunk pruning and is not ported.
"""
from __future__ import annotations

import torch

from ._build import launch
from .knn import pairwise_d2

_NOUT = 9
# query rows per (B, tile, N) block of the plain twins
_TILE = 512


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
                           need_d: bool = True) -> torch.Tensor:
    """Plain PyTorch reductions (B, N, 9), in (B, tile, N) blocks."""
    _check(p, f, lab, kth, cuda=False)
    B, N, _ = f.shape
    out = f.new_zeros(B, N, _NOUT)
    for s in range(0, N, _TILE):
        e = min(s + _TILE, N)
        d2, nb, pm, sim, ex = _tile_terms(p, f, lab, kth, s, e, tinv)
        pos, neg = nb & pm, nb & ~pm
        o = out[:, s:e]
        o[..., 0] = torch.where(pos, ex, 0.0).sum(-1)
        o[..., 1] = torch.where(neg, ex, 0.0).sum(-1)
        if need_s:
            o[..., 2] = torch.where(pos, sim, 0.0).sum(-1)
            o[..., 3] = torch.where(neg, sim, 0.0).sum(-1)
        o[..., 4] = pos.sum(-1)
        o[..., 5] = neg.sum(-1)
        if need_d:
            dt = torch.sqrt(d2.abs() + 1e-12) if cctype_root else d2
            o[..., 6] = torch.where(pos, dt, 0.0).sum(-1)
            o[..., 7] = torch.where(neg, dt, 0.0).sum(-1)
    out[..., 8] = kth
    return out


def contrast_forward(p, f, lab, kth, tinv: float = 1.0,
                     cctype_root: bool = False, need_s: bool = True,
                     need_d: bool = True) -> torch.Tensor:
    """p (B,N,3), f (B,N,C), lab (B,N), kth (B,N), all f32 → (B, N, 9).

    A CUDA tensor goes through the forward kernel of ``csrc/contrast.cu``;
    a CPU tensor through :func:`contrast_forward_plain`.  No gradient:
    :func:`contrast_reductions` is the differentiable entry."""
    if all(t.device.type == "cpu" for t in (p, f, lab, kth)):
        return contrast_forward_plain(p, f, lab, kth, tinv, cctype_root,
                                      need_s, need_d)
    _check(p, f, lab, kth, cuda=True)
    B, N, C = f.shape
    out = torch.empty(B, N, _NOUT, dtype=torch.float32, device=f.device)
    launch("amc3d_contrast_forward", p.data_ptr(), f.data_ptr(),
           lab.data_ptr(), kth.data_ptr(), out.data_ptr(), B, N, C,
           float(tinv), int(cctype_root), int(need_s), int(need_d), _stream(f))
    contrast_forward.launches += 1
    return out


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
                             need_s: bool = True) -> torch.Tensor:
    """Plain query-side VJP: df_i = Σ_j w_ij f_j, (B, N, C)."""
    return _grad_plain(p, f, lab, kth, g4, tinv, need_s, True, False)[0]


def contrast_grad_support_plain(p, f, lab, kth, g4, tinv: float = 1.0,
                                need_s: bool = True) -> torch.Tensor:
    """Plain support-side VJP: df_j = Σ_i w_ij f_i, (B, N, C)."""
    return _grad_plain(p, f, lab, kth, g4, tinv, need_s, False, True)[1]


def _grad_kernel(name: str, p, f, lab, kth, g4, tinv, need_s):
    _check(p, f, lab, kth, cuda=True)
    B, N, C = f.shape
    if (g4.shape != (B, N, 4) or g4.dtype != torch.float32
            or g4.device != f.device or not g4.is_contiguous()
            or g4.data_ptr() % 16):
        raise ValueError("g4 must be a contiguous, 16-byte aligned "
                         "(B, N, 4) float32 tensor "
                         f"on {f.device}, got {tuple(g4.shape)} {g4.dtype} "
                         f"on {g4.device}")
    df = torch.empty(B, N, C, dtype=torch.float32, device=f.device)
    launch(name, p.data_ptr(), f.data_ptr(), lab.data_ptr(), kth.data_ptr(),
           g4.data_ptr(), df.data_ptr(), B, N, C, float(tinv), int(need_s),
           _stream(f))
    return df


def contrast_grad_rows(p, f, lab, kth, g4, tinv: float = 1.0,
                       need_s: bool = True) -> torch.Tensor:
    """Query-side VJP (B, N, C): the rows kernel of ``csrc/contrast.cu`` for
    a CUDA tensor, :func:`contrast_grad_rows_plain` for a CPU tensor."""
    if all(t.device.type == "cpu" for t in (p, f, lab, kth, g4)):
        return contrast_grad_rows_plain(p, f, lab, kth, g4, tinv, need_s)
    df = _grad_kernel("amc3d_contrast_grad_rows", p, f, lab, kth, g4, tinv,
                      need_s)
    contrast_grad_rows.launches += 1
    return df


def contrast_grad_support(p, f, lab, kth, g4, tinv: float = 1.0,
                          need_s: bool = True) -> torch.Tensor:
    """Support-side VJP (B, N, C): each point j sums over the queries i
    whose threshold admits it (``d²_ij ≤ kth_i``).  The support kernel of
    ``csrc/contrast.cu`` for a CUDA tensor, the plain twin for a CPU one."""
    if all(t.device.type == "cpu" for t in (p, f, lab, kth, g4)):
        return contrast_grad_support_plain(p, f, lab, kth, g4, tinv, need_s)
    df = _grad_kernel("amc3d_contrast_grad_support", p, f, lab, kth, g4,
                      tinv, need_s)
    contrast_grad_support.launches += 1
    return df


class _ContrastReductions(torch.autograd.Function):
    """Forward and VJP by the kernels, or by the plain twins (``plain``)."""

    @staticmethod
    def forward(ctx, p, f, lab, kth, tinv, cctype_root, need_s, need_d,
                plain):
        fwd = contrast_forward_plain if plain else contrast_forward
        ctx.save_for_backward(p, f, lab, kth)
        ctx.tinv, ctx.need_s, ctx.plain = tinv, need_s, plain
        return fwd(p, f, lab, kth, tinv, cctype_root, need_s, need_d)

    @staticmethod
    def backward(ctx, gout):
        p, f, lab, kth = ctx.saved_tensors
        g4 = gout[..., :4].contiguous()
        args = (p, f, lab, kth, g4, ctx.tinv, ctx.need_s)
        if ctx.plain:
            df_rows, df_sup = _grad_plain(*args, rows=True, support=True)
        else:
            df_rows = contrast_grad_rows(*args)
            df_sup = contrast_grad_support(*args)
        return (None, df_rows + df_sup) + (None,) * 7


def contrast_reductions(p, f, lab, kth, tinv: float = 1.0,
                        cctype_root: bool = False, need_s: bool = True,
                        need_d: bool = True) -> torch.Tensor:
    """p (B,N,3), f (B,N,C), lab (B,N) argmax labels, kth (B,N) d²
    threshold, all f32 → (B, N, 9) [P,Q,Spos,Sneg,npos,nneg,dpos,dneg,thr],
    differentiable in ``f``.  CUDA tensors run the three kernels, CPU
    tensors the plain twins."""
    plain = all(t.device.type == "cpu" for t in (p, f, lab, kth))
    return _ContrastReductions.apply(p, f, lab, kth, float(tinv),
                                     bool(cctype_root), bool(need_s),
                                     bool(need_d), plain)


def contrast_reductions_plain(p, f, lab, kth, tinv: float = 1.0,
                              cctype_root: bool = False, need_s: bool = True,
                              need_d: bool = True) -> torch.Tensor:
    """:func:`contrast_reductions` by the plain twins on any device."""
    return _ContrastReductions.apply(p, f, lab, kth, float(tinv),
                                     bool(cctype_root), bool(need_s),
                                     bool(need_d), True)


contrast_forward.launches = 0
contrast_grad_rows.launches = 0
contrast_grad_support.launches = 0
