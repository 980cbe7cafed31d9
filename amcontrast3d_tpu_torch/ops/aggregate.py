"""Fused grouped aggregation: reductions over the K slots of a grouped
tensor that is never materialised, and their VJP.

↔ ``amcontrast3d_tpu/ops/aggregate_pallas.py``.  With the separable first
conv of a PointNeXt aggregation every grouped value is a per-support vector
minus a per-query one, ``h[i, k] = u[idx[i, k]] − qp[i]``; BatchNorm, a
monotone activation and the max-pool over K then need only, per query and
channel,

    ext = sgn · max_k (sgn · u[idx[i, k]])     (sgn = ±1, in u-space)
    su  = Σ_k h[i, k],    sq = Σ_k h[i, k]²     (skipped in eval mode)

:func:`grouped_slot_reduce` returns them, differentiable in ``u`` and
``qp``.  Its backward gives ``du[idx[i, k]] += γ_k`` with
``γ_k = g_sum + 2·(u_k − qp)·g_sq + eq_k / Σ_k eq_k · g_ext`` (``eq_k``:
slot k attains the extremum; the even tie split of ``jnp.max`` and
``torch.amax``) and ``dqp = −(K·g_sum + 2·g_sq·su)``.  The kernels are
``csrc/aggregate.cu`` (TPU kernels ``_fwd_kernel`` and ``_bwd_kernel``);
the plain twins gather the (B, M, K, C) tensor.  The JAX entry's support
and query positions and ``radius`` only feed its chunk pruning, and
``splits`` its bf16 matmul gather: the port takes neither.

The switch (``set_agg_fused``, default from ``AMC3D_AGG_FUSED``) is
process-wide, as in the JAX package; ``auto`` means ``off`` here (JAX: on
a TPU only).  ``agg_fused_fits`` is the JAX package's dispatch rule (its
VMEM residency bound), kept as the rule here.
"""
from __future__ import annotations

import os

import torch

from ._build import launch

_MODES = ("auto", "on", "off")
_AGG_FUSED = "off"
# the JAX kernels' query tile and support chunk, for agg_fused_fits
_TQ, _CS = 256, 512


def set_agg_fused(mode: str) -> None:
    """'auto' | 'on' | 'off' (↔ ``aggregate_pallas.py:87``)."""
    global _AGG_FUSED
    if mode not in _MODES:
        raise ValueError(f"fused aggregation mode must be one of {_MODES}, "
                         f"got {mode!r}")
    _AGG_FUSED = mode


def agg_fused_enabled() -> bool:
    """Whether the separable aggregations take the fused tail ('on')."""
    return _AGG_FUSED == "on"


set_agg_fused(os.environ.get("AMC3D_AGG_FUSED", "off"))


def agg_fused_fits(n: int, c: int, k: int) -> bool:
    """The JAX package's gate (``aggregate_pallas.py:99``): the TPU kernel's
    support buffer, gradient block and slot scratch within 64 MiB of VMEM,
    for n support points, c channels and k slots."""
    cp = -(-c // 128) * 128
    cs = min(_CS, -(-n // 8) * 8)
    n_pad = -(-n // cs) * cs
    return n_pad * (2 * cp + 128) * 4 + k * _TQ * cp * 4 <= 64 * 1024 * 1024


def _shapes(u, idx):
    B, N, C = u.shape
    return B, N, C, idx.shape[1], idx.shape[2]


def _check_cuda(name: str, u, idx, sgn, rows: dict) -> None:
    """Shapes, dtypes, device and contiguity the kernels take; ``rows`` maps
    the names of the (B, M, C) float32 operands to their tensors (or None)."""
    B, N, C, M, K = _shapes(u, idx)
    want = {"u": (u, (B, N, C), torch.float32),
            "idx": (idx, (B, M, K), torch.int32),
            "sgn": (sgn, (C,), torch.float32)}
    want.update({k: (v, (B, M, C), torch.float32) for k, v in rows.items()
                 if v is not None})
    for key, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: {key} must be {shape} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device.type != "cuda" or t.device != u.device or not t.is_contiguous():
            raise ValueError(f"{name} kernel needs contiguous tensors on one "
                             f"CUDA device, got {key} on {t.device} "
                             f"contiguous={t.is_contiguous()}")
    if K < 1:
        raise ValueError(f"{name}: idx needs at least one slot")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _slots(u, idx) -> torch.Tensor:
    """The grouped tensor (B, M, K, C), gathered."""
    B, N, C, M, K = _shapes(u, idx)
    rows = idx.reshape(B, M * K, 1).long().expand(-1, -1, C)
    return torch.gather(u, 1, rows).view(B, M, K, C)


def aggregate_forward_plain(u, idx, sgn, qp=None, need_stats: bool = True):
    """Plain PyTorch :func:`aggregate_forward`.  The moments add the slots
    one by one in order, as the kernel does, so that both round alike: a
    train step through either then runs the same forward, and max-pool
    near-ties downstream do not flip between them."""
    g = _slots(u, idx)
    ext = torch.amax(g * sgn, dim=2) * sgn
    if not need_stats:
        return ext, None, None
    su = sq = torch.zeros_like(ext)
    for k in range(g.shape[2]):
        h = g[:, :, k] if qp is None else g[:, :, k] - qp
        su = su + h
        sq = sq + h * h
    return ext, su, sq


def aggregate_forward(u, idx, sgn, qp=None, need_stats: bool = True):
    """u (B, N, C) f32, idx (B, M, K) int32 in [0, N), sgn (C,) ±1, qp
    (B, M, C) or None (zeros) → (ext, su, sq), each (B, M, C) f32; su and
    sq are None unless ``need_stats``.  No gradient:
    :func:`grouped_slot_reduce` is the differentiable entry.  A CUDA
    tensor goes through the forward kernel of ``csrc/aggregate.cu``, a CPU
    tensor through :func:`aggregate_forward_plain`."""
    if all(t.device.type == "cpu" for t in (u, idx, sgn)):
        return aggregate_forward_plain(u, idx, sgn, qp, need_stats)
    B, N, C, M, K = _shapes(u, idx)
    if need_stats and qp is None:
        qp = u.new_zeros(B, M, C)
    _check_cuda("aggregate_forward", u, idx, sgn,
                {"qp": qp if need_stats else None})
    ext = torch.empty(B, M, C, dtype=torch.float32, device=u.device)
    su = torch.empty_like(ext) if need_stats else None
    sq = torch.empty_like(ext) if need_stats else None
    ptr = lambda t: None if t is None else t.data_ptr()
    launch("amc3d_aggregate_forward", u.data_ptr(), idx.data_ptr(),
           sgn.data_ptr(), ptr(qp if need_stats else None), ext.data_ptr(),
           ptr(su), ptr(sq), B, N, M, K, C, int(need_stats), _stream(u))
    aggregate_forward.launches += 1
    return ext, su, sq


def aggregate_backward_plain(u, idx, sgn, qp, ext, g_ext, g_sum=None,
                             g_sq=None) -> torch.Tensor:
    """Plain PyTorch :func:`aggregate_backward`: γ over the gathered slots,
    scattered by ``index_add_``."""
    B, N, C, M, K = _shapes(u, idx)
    g = _slots(u, idx)
    eq = (g * sgn == (ext * sgn)[:, :, None]).float()
    gamma = eq * (g_ext / eq.sum(2).clamp_min(1.0))[:, :, None]
    if g_sum is not None:
        h = g if qp is None else g - qp[:, :, None]
        gamma = (g_sum[:, :, None] + 2.0 * h * g_sq[:, :, None]) + gamma
    rows = (idx.long() + N * torch.arange(B, device=u.device)[:, None, None])
    return u.new_zeros(B * N, C).index_add_(
        0, rows.reshape(-1), gamma.reshape(-1, C)).view(B, N, C)


def aggregate_backward(u, idx, sgn, qp, ext, g_ext, g_sum=None,
                       g_sq=None) -> torch.Tensor:
    """du (B, N, C) of :func:`aggregate_forward` for the incoming gradients
    of ext, su and sq (``g_sum``, ``g_sq`` None: eval mode, no moments).  A
    CUDA tensor goes through the backward kernel of ``csrc/aggregate.cu``
    (float atomics: not bit-deterministic), a CPU tensor through
    :func:`aggregate_backward_plain`."""
    if all(t.device.type == "cpu" for t in (u, idx, sgn, ext, g_ext)):
        return aggregate_backward_plain(u, idx, sgn, qp, ext, g_ext, g_sum,
                                        g_sq)
    B, N, C, M, K = _shapes(u, idx)
    stats = g_sum is not None
    if stats and qp is None:
        qp = u.new_zeros(B, M, C)
    _check_cuda("aggregate_backward", u, idx, sgn,
                {"ext": ext, "g_ext": g_ext, "qp": qp if stats else None,
                 "g_sum": g_sum, "g_sq": g_sq})
    if stats != (g_sq is not None):
        raise ValueError("aggregate_backward takes g_sum and g_sq together")
    du = torch.zeros(B, N, C, dtype=torch.float32, device=u.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    launch("amc3d_aggregate_backward", u.data_ptr(), idx.data_ptr(),
           sgn.data_ptr(), ptr(qp if stats else None), ext.data_ptr(),
           g_ext.data_ptr(), ptr(g_sum), ptr(g_sq), du.data_ptr(), B, N, M, K,
           C, int(stats), _stream(u))
    aggregate_backward.launches += 1
    return du


class _SlotReduce(torch.autograd.Function):
    """Forward and VJP by the kernels, or by the plain twins (``plain``);
    returns (ext, su, sq) with the moments, else (ext,)."""

    @staticmethod
    def forward(ctx, u, qp, idx, sgn, need_stats, plain):
        fwd = aggregate_forward_plain if plain else aggregate_forward
        ext, su, sq = fwd(u, idx, sgn, qp, need_stats)
        ctx.save_for_backward(u, qp, idx, sgn, ext, su)
        ctx.need_stats, ctx.plain = need_stats, plain
        return (ext, su, sq) if need_stats else (ext,)

    @staticmethod
    def backward(ctx, g_ext, g_sum=None, g_sq=None):
        u, qp, idx, sgn, ext, su = ctx.saved_tensors
        bwd = aggregate_backward_plain if ctx.plain else aggregate_backward
        args = (g_ext.contiguous(),)
        dqp = None
        if ctx.need_stats:
            args += (g_sum.contiguous(), g_sq.contiguous())
            # qp enters every slot of the moments: d su/dqp = −K,
            # d sq/dqp = −2·Σ_k h = −2·su
            dqp = -(idx.shape[-1] * g_sum + 2.0 * g_sq * su)
        du = bwd(u, idx, sgn, qp, ext, *args)
        return du, dqp, None, None, None, None


def _slot_reduce(u, idx, sgn, qp, need_stats: bool, plain: bool):
    if need_stats and qp is None:
        qp = u.new_zeros(u.shape[0], idx.shape[1], u.shape[2])
    out = _SlotReduce.apply(u.contiguous(),
                            qp.contiguous() if need_stats else None,
                            idx.contiguous(), sgn.contiguous(),
                            bool(need_stats), plain)
    return tuple(out) if need_stats else (out[0], None, None)


def grouped_slot_reduce(u, idx, sgn, qp=None, need_stats: bool = True):
    """u (B, N, C) f32 per-support values, idx (B, M, K) int32 slot indices
    (ball query or kNN output, repeats allowed), sgn (C,) ±1, qp (B, M, C)
    per-query offsets (None: zeros) → (ext, su, sq), each (B, M, C); su and
    sq are None unless ``need_stats`` (eval-mode BatchNorm).
    Differentiable in ``u`` and ``qp``.  CUDA tensors run the two kernels,
    CPU tensors the plain twins."""
    plain = all(t.device.type == "cpu" for t in (u, idx, sgn))
    return _slot_reduce(u, idx, sgn, qp, need_stats, plain)


def grouped_slot_reduce_plain(u, idx, sgn, qp=None, need_stats: bool = True):
    """:func:`grouped_slot_reduce` by the plain twins on any device."""
    return _slot_reduce(u, idx, sgn, qp, need_stats, True)


aggregate_forward.launches = 0
aggregate_backward.launches = 0
