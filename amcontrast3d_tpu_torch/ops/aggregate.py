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
``γ_k = g_sum + 2·(u_k − qp)·g_sq + eq_k / ties · g_ext`` (``eq_k``: slot
k attains the extremum; ``ties = max(Σ_k eq_k, 1)``, the even tie split of
``jnp.max`` and ``torch.amax``, counted by the forward) and
``dqp = −(K·g_sum + 2·g_sq·su)``.  The kernels are ``csrc/aggregate.cu``
(TPU kernels ``_fwd_kernel`` and ``_bwd_kernel``): both take the queries
in runs along the query cloud's Morton curve, the order of its layout
(``query_cloud``), which changes no value; the plain twins gather the
(B, M, K, C) tensor.  The JAX entry's support and query positions and
``radius`` only feed its chunk pruning, and ``splits`` its bf16 matmul
gather: the port takes neither.

``u`` is float32 or bfloat16 (the fused tail's ``u = w_f(f) + w_dp(p)/r``
under ``use_amp``), ``qp`` and every other operand float32, and ext, su,
sq float32 either way (ext the exact float32 of a value of ``u``), as the
JAX entry returns them.  A bfloat16 ``u`` on the card takes the kernels'
bfloat16 forms (``aggregate_forward_bf16``, ``aggregate_backward_bf16``:
the slot values loaded as bfloat16, everything after in float32; the VJP
sums du in float32 and rounds it once to bfloat16, as JAX's
``du.astype(u.dtype)`` after its float32 kernel); no other dtype is taken
and nothing is upcast on the way in.  The plain twins gather bfloat16 and
compute in float32.

The switch (``set_agg_fused``, default from ``AMC3D_AGG_FUSED``) is
process-wide, as in the JAX package; ``auto`` means ``off`` here (JAX: on
a TPU only).  Where it is on, every separable aggregation with a monotone
activation takes the fused tail (``models/pointnext.py::_fused``): the
port's rule, read from the card's table of the fused tail against the
gather tail (``tools/profile_aggregation.py --gates``, PERF.md §6), in
place of the JAX package's VMEM rule ``agg_fused_fits``.
"""
from __future__ import annotations

import os

import torch

from . import spatial
from ._build import launch

_MODES = ("auto", "on", "off")
_AGG_FUSED = "off"
# csrc/aggregate.cu::kMaxSlots: the forward counts a channel's tied slots
# in a byte
MAX_SLOTS = 255


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


def _shapes(u, idx):
    B, N, C = u.shape
    return B, N, C, idx.shape[1], idx.shape[2]


def _check_cuda(name: str, u, idx, rows: dict, order, u_dtype) -> None:
    """Shapes, dtypes, device and contiguity the kernels take; ``rows`` maps
    the names of the (B, M, C) operands to (tensor or None, dtype)."""
    B, N, C, M, K = _shapes(u, idx)
    want = {"u": (u, (B, N, C), u_dtype),
            "idx": (idx, (B, M, K), torch.int32)}
    want.update({k: (v, (B, M, C), dtype) for k, (v, dtype) in rows.items()
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
    spatial.check_order(order, B, M, u.device, f"{name}: order")


def _check_slots(name: str, k: int) -> None:
    if k > MAX_SLOTS:
        raise ValueError(f"{name}: the tie count is a byte, so at most "
                         f"{MAX_SLOTS} slots, got {k}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _ptr(t):
    return None if t is None else t.data_ptr()


def _order_args(order):
    """The C interface's (pointer, stride within a row) of ``order``."""
    return (None, 1) if order is None else (order.data_ptr(), order.stride(1))


def _slots(u, idx) -> torch.Tensor:
    """The grouped tensor (B, M, K, C), gathered at u's dtype and taken to
    float32 (exact for bfloat16)."""
    B, N, C, M, K = _shapes(u, idx)
    rows = idx.reshape(B, M * K, 1).long().expand(-1, -1, C)
    return torch.gather(u, 1, rows).view(B, M, K, C).float()



def aggregate_forward_plain(u, idx, sgn, qp=None, need_stats: bool = True,
                            order=None, keep_ties: bool = False):
    """Plain PyTorch :func:`aggregate_forward` (``order`` changes nothing
    here).  The moments add the slots one by one in order, as the kernel
    does, so that both round alike: a train step through either then runs
    the same forward, and max-pool near-ties downstream do not flip between
    them."""
    g = _slots(u, idx)
    ext = torch.amax(g * sgn, dim=2) * sgn
    ties = None
    if keep_ties:
        _check_slots("aggregate_forward", idx.shape[2])
        ties = (g * sgn == (ext * sgn)[:, :, None]).sum(2).to(torch.uint8)
    if not need_stats:
        return ext, None, None, ties
    su = sq = torch.zeros_like(ext)
    for k in range(g.shape[2]):
        h = g[:, :, k] if qp is None else g[:, :, k] - qp
        su = su + h
        sq = sq + h * h
    return ext, su, sq, ties


def aggregate_forward(u, idx, sgn, qp=None, need_stats: bool = True,
                      order=None, keep_ties: bool = False):
    """u (B, N, C) f32 or bf16, idx (B, M, K) int32 in [0, N), sgn (C,)
    ±1, qp (B, M, C) f32 or None (zeros) → (ext, su, sq, ties), each
    (B, M, C): ext,
    su and sq f32 (su and sq None unless ``need_stats``), ties uint8, the
    slots that reach the extremum, for :func:`aggregate_backward` (None
    unless ``keep_ties``; then K ≤ MAX_SLOTS).  ``order`` (B, M) int32:
    each cloud's queries in the order the kernel's runs take them (a
    layout's :func:`spatial.index_bits`; a stride within a row allowed), or
    None (index order); it changes no value.  No gradient:
    :func:`grouped_slot_reduce` is the differentiable entry.  A CUDA
    tensor goes through the forward kernel of ``csrc/aggregate.cu`` (its
    bfloat16 form for a bfloat16 ``u``: :func:`aggregate_forward_bf16`), a
    CPU tensor through :func:`aggregate_forward_plain`."""
    if all(t.device.type == "cpu" for t in (u, idx, sgn)):
        return aggregate_forward_plain(u, idx, sgn, qp, need_stats, order,
                                       keep_ties)
    if u.dtype == torch.bfloat16:
        return aggregate_forward_bf16(u, idx, sgn, qp, need_stats, order,
                                      keep_ties)
    return _forward_kernel(u, idx, sgn, qp, need_stats, order, keep_ties,
                           False)


def aggregate_forward_bf16(u, idx, sgn, qp=None, need_stats: bool = True,
                           order=None, keep_ties: bool = False):
    """The bfloat16 form of :func:`aggregate_forward`'s kernel: ``u`` a
    bfloat16 CUDA tensor (anything else raises), the outputs as there."""
    return _forward_kernel(u, idx, sgn, qp, need_stats, order, keep_ties,
                           True)


def _forward_kernel(u, idx, sgn, qp, need_stats, order, keep_ties,
                    bf16: bool):
    name = "aggregate_forward_bf16" if bf16 else "aggregate_forward"
    B, N, C, M, K = _shapes(u, idx)
    if need_stats and qp is None:
        qp = torch.zeros(B, M, C, dtype=torch.float32, device=u.device)
    if keep_ties:
        _check_slots(name, K)
    _check_cuda(name, u, idx,
                {"qp": (qp if need_stats else None, torch.float32)}, order,
                torch.bfloat16 if bf16 else torch.float32)
    if sgn.shape != (C,) or sgn.dtype != torch.float32 \
            or sgn.device != u.device or not sgn.is_contiguous():
        raise ValueError(f"{name}: sgn must be a contiguous ({C},) "
                         f"float32 tensor on {u.device}")
    ext = torch.empty(B, M, C, dtype=torch.float32, device=u.device)
    su = torch.empty_like(ext) if need_stats else None
    sq = torch.empty_like(ext) if need_stats else None
    ties = (torch.empty(B, M, C, dtype=torch.uint8, device=u.device)
            if keep_ties else None)
    launch("amc3d_" + name, u.data_ptr(), idx.data_ptr(),
           sgn.data_ptr(), _ptr(qp if need_stats else None), *_order_args(order),
           ext.data_ptr(), _ptr(su), _ptr(sq), _ptr(ties), B, N, M, K, C,
           int(need_stats), _stream(u))
    (aggregate_forward_bf16 if bf16 else aggregate_forward).launches += 1
    return ext, su, sq, ties


def aggregate_backward_plain(u, idx, qp, ext, ties, g_ext, g_sum=None,
                             g_sq=None, order=None,
                             accumulator=None) -> torch.Tensor:
    """Plain PyTorch :func:`aggregate_backward`: γ over the gathered slots
    in float32, scattered by ``index_add_`` into float32 and rounded once
    to u's dtype (``order`` changes nothing here)."""
    B, N, C, M, K = _shapes(u, idx)
    g = _slots(u, idx)
    eq = (g == ext[:, :, None]).float()
    gamma = eq * (g_ext / ties.float().clamp_min(1.0))[:, :, None]
    if g_sum is not None:
        h = g if qp is None else g - qp[:, :, None]
        gamma = (g_sum[:, :, None] + 2.0 * h * g_sq[:, :, None]) + gamma
    rows = (idx.long() + N * torch.arange(B, device=u.device)[:, None, None])
    du = (torch.zeros(B * N, C, dtype=torch.float32, device=u.device)
          if accumulator is None else accumulator.view(B * N, C).zero_())
    du.index_add_(0, rows.reshape(-1), gamma.reshape(-1, C))
    return du.view(B, N, C).to(u.dtype)


def aggregate_backward(u, idx, qp, ext, ties, g_ext, g_sum=None, g_sq=None,
                       order=None, accumulator=None) -> torch.Tensor:
    """du (B, N, C) of :func:`aggregate_forward` for the incoming gradients
    of ext, su and sq (``g_sum``, ``g_sq`` None: eval mode, no moments),
    given its ext and ties: du in u's dtype (float32 or bfloat16).  A slot
    attains the extremum where its value equals ext (``sgn`` = ±1 does not
    enter).  ``order`` as the forward's.  ``accumulator``: for a bfloat16
    ``u``, a float32 (B, N, C) tensor that receives du's float32 sums before
    their rounding.  A CUDA tensor goes through the backward kernel of
    ``csrc/aggregate.cu`` (each run's rows summed once, then float atomics
    across runs: not bit-deterministic; its bfloat16 form for a bfloat16
    ``u``: :func:`aggregate_backward_bf16`), a CPU tensor through
    :func:`aggregate_backward_plain`."""
    if all(t.device.type == "cpu" for t in (u, idx, ext, ties, g_ext)):
        return aggregate_backward_plain(u, idx, qp, ext, ties, g_ext, g_sum,
                                        g_sq, order, accumulator)
    if u.dtype == torch.bfloat16:
        return aggregate_backward_bf16(u, idx, qp, ext, ties, g_ext, g_sum,
                                       g_sq, order, accumulator)
    if accumulator is not None:
        raise ValueError("aggregate_backward: a float32 u's kernel sums in du "
                         "itself; the accumulator is a bfloat16 u's")
    return _backward_kernel(u, idx, qp, ext, ties, g_ext, g_sum, g_sq, order,
                            None)


def aggregate_backward_bf16(u, idx, qp, ext, ties, g_ext, g_sum=None,
                            g_sq=None, order=None,
                            accumulator=None) -> torch.Tensor:
    """The bfloat16 form of :func:`aggregate_backward`'s kernel: ``u`` a
    bfloat16 CUDA tensor (anything else raises); du summed in float32
    (``accumulator``, or a scratch tensor) and rounded once to bfloat16 in
    a closing pass."""
    if accumulator is None:
        accumulator = torch.empty(u.shape, dtype=torch.float32, device=u.device)
    elif (accumulator.shape != u.shape or accumulator.dtype != torch.float32
          or accumulator.device != u.device or not accumulator.is_contiguous()):
        raise ValueError("aggregate_backward_bf16: the accumulator must be a "
                         f"contiguous float32 {tuple(u.shape)} tensor on "
                         f"{u.device}")
    return _backward_kernel(u, idx, qp, ext, ties, g_ext, g_sum, g_sq, order,
                            accumulator)


def _backward_kernel(u, idx, qp, ext, ties, g_ext, g_sum, g_sq, order, acc):
    """The float32 form (``acc`` None: du is the sums) or the bfloat16 one
    (the sums in ``acc``, du their rounding)."""
    bf16 = acc is not None
    name = "aggregate_backward_bf16" if bf16 else "aggregate_backward"
    B, N, C, M, K = _shapes(u, idx)
    stats = g_sum is not None
    if stats != (g_sq is not None):
        raise ValueError(f"{name} takes g_sum and g_sq together")
    f32 = torch.float32
    if stats and qp is None:
        qp = torch.zeros(B, M, C, dtype=f32, device=u.device)
    _check_slots(name, K)
    _check_cuda(name, u, idx,
                {"ext": (ext, f32), "ties": (ties, torch.uint8),
                 "g_ext": (g_ext, f32), "qp": (qp if stats else None, f32),
                 "g_sum": (g_sum, f32), "g_sq": (g_sq, f32)}, order,
                torch.bfloat16 if bf16 else f32)
    du = torch.empty(B, N, C, dtype=u.dtype, device=u.device)
    launch("amc3d_" + name, u.data_ptr(), idx.data_ptr(),
           _ptr(qp if stats else None), ext.data_ptr(), ties.data_ptr(),
           g_ext.data_ptr(), _ptr(g_sum), _ptr(g_sq), *_order_args(order),
           *((acc.data_ptr(),) if bf16 else ()), du.data_ptr(), B, N, M, K, C,
           int(stats), _stream(u))
    (aggregate_backward_bf16 if bf16 else aggregate_backward).launches += 1
    return du


class _SlotReduce(torch.autograd.Function):
    """Forward and VJP by the kernels, or by the plain twins (``plain``);
    returns (ext, su, sq) with the moments, else (ext,).  The forward
    counts the ties only when ``u`` needs its gradient.  du comes back in
    u's dtype, dqp in float32 (the caller's cast takes it to qp's)."""

    @staticmethod
    def forward(ctx, u, qp, idx, sgn, need_stats, plain, order):
        fwd = aggregate_forward_plain if plain else aggregate_forward
        ext, su, sq, ties = fwd(u, idx, sgn, qp, need_stats, order,
                                keep_ties=ctx.needs_input_grad[0])
        ctx.save_for_backward(u, qp, idx, ext, su, ties, order)
        ctx.need_stats, ctx.plain = need_stats, plain
        return (ext, su, sq) if need_stats else (ext,)

    @staticmethod
    def backward(ctx, g_ext, g_sum=None, g_sq=None):
        u, qp, idx, ext, su, ties, order = ctx.saved_tensors
        args = (g_ext.contiguous(),)
        dqp = None
        if ctx.need_stats:
            args += (g_sum.contiguous(), g_sq.contiguous())
            # qp enters every slot of the moments: d su/dqp = −K,
            # d sq/dqp = −2·Σ_k h = −2·su
            dqp = torch.addcmul(g_sum * -idx.shape[-1], g_sq, su, value=-2.0)
        du = None
        if ctx.needs_input_grad[0]:
            bwd = aggregate_backward_plain if ctx.plain else aggregate_backward
            du = bwd(u, idx, qp, ext, ties, *args, order=order)
        return du, dqp, None, None, None, None, None


def _slot_reduce(u, idx, sgn, qp, need_stats: bool, plain: bool, query_cloud):
    B, M = idx.shape[:2]
    order = None
    if query_cloud is not None:
        order = spatial.index_bits(query_cloud)
        spatial.check_order(order, B, M, u.device, "query_cloud's order")
    if need_stats and qp is None:
        qp = torch.zeros(u.shape[0], idx.shape[1], u.shape[2],
                         dtype=torch.float32, device=u.device)
    out = _SlotReduce.apply(u.contiguous(),
                            qp.float().contiguous() if need_stats else None,
                            idx.contiguous(), sgn.contiguous(),
                            bool(need_stats), plain, order)
    return tuple(out) if need_stats else (out[0], None, None)


def grouped_slot_reduce(u, idx, sgn, qp=None, need_stats: bool = True,
                        query_cloud=None):
    """u (B, N, C) f32 or bf16 per-support values, idx (B, M, K) int32 slot
    indices (ball query or kNN output, repeats allowed), sgn (C,) ±1, qp
    (B, M, C) per-query offsets, taken in f32 (None: zeros) → (ext, su,
    sq), each (B, M, C) f32; su and
    sq are None unless ``need_stats`` (eval-mode BatchNorm).
    ``query_cloud``: the layout of the M queries (a
    :class:`spatial.SortedCloud` of (B, M) points), whose order the kernels'
    runs take; without it, index order.  It changes no value.
    Differentiable in ``u`` and ``qp``, the gradients in their dtypes.
    CUDA tensors run the two kernels (their bfloat16 forms for a bfloat16
    ``u``), CPU tensors the plain twins."""
    plain = all(t.device.type == "cpu" for t in (u, idx, sgn))
    return _slot_reduce(u, idx, sgn, qp, need_stats, plain, query_cloud)


def grouped_slot_reduce_plain(u, idx, sgn, qp=None, need_stats: bool = True,
                              query_cloud=None):
    """:func:`grouped_slot_reduce` by the plain twins on any device."""
    return _slot_reduce(u, idx, sgn, qp, need_stats, True, query_cloud)


aggregate_forward.launches = 0
aggregate_backward.launches = 0
aggregate_forward_bf16.launches = 0
aggregate_backward_bf16.launches = 0
