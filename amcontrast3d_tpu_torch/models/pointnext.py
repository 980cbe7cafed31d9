"""PointNeXt encoder / decoder / segmentation head (PyTorch, channels-last).

↔ ``amcontrast3d_tpu/models/pointnext.py``.  Positions are (B, N, 3),
features (B, N, C), grouped neighbourhoods (B, M, K, C); per-stage point
counts are ``N_i = N_{i-1} // stride``.  Submodules keep the flax names
(``enc{i}_sa``, ``enc{i}_block{j}``, ``LocalAggregation_0``, ``w_f``,
``w_dp``, ``ConvBlock_{n}``, ``BatchNorm_0``, ``fp{k}``).

Ported: LocalAggregation (the separable ``dp_fj`` form and the generic
grouped MLP), SetAbstraction (head, separable and generic paths; FPS or
the random sampler), the fused GroupStatsBN tail of the separable forms
(on with ``ops.aggregate.set_agg_fused('on')``), FeaturePropagation with
upsampling and the global one, InvResMLP and ResBlock, the encoder with
its per-stage shared ball query, the decoder with the masked refinement,
and SegHead.  Not yet: the masked ``n_valid`` path.

``dtype`` (the runner's ``use_amp``: bfloat16) is the compute type of every
Linear, as the JAX modules' field: the BatchNorms return float32, so the
features between blocks stay float32, and what stays bfloat16 is what
stays so in JAX: ``w_f(f)`` and ``w_dp(p)`` (the latter exact on its
bfloat16 operands, ``Precision.HIGHEST``), the gather tail's grouped
tensor, the fused tail's ``u = w_f(f) + w_dp(p)/r`` (its kernels take it
in bfloat16 and ``qp`` in float32), the stem's output and the logits.

``remat`` (the JAX encoder's ``nn.remat`` of each set abstraction and
block) checkpoints each of them (``torch.utils.checkpoint``, not
reentrant): the stage clouds, their layouts and the grouping indices come
in from outside, so the backward recomputes only the Linears, the gathers,
the BatchNorms and the pool, never FPS, a ball query or a sort; the
recompute moves no running statistic (``layers.recomputing``).

The encoder takes its positions first (:meth:`PointNextEncoder.sample`):
FPS reads positions only, so the whole chain p_0 → … → p_S runs before any
feature, and one :func:`ops.spatial.sort_stages` then sorts every stage
cloud.  Each layout goes to the kernels that read that cloud: the encoder's
ball queries, the decoder's CrossMask and, through the models of
``base_seg.py``, the loss.
"""
from __future__ import annotations

import contextlib
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops import spatial
from ..ops.aggregate import agg_fused_enabled, grouped_slot_reduce
from ..ops.fps import furthest_point_sample, random_sample
from ..ops.group import (CHANNEL_MAP, create_grouper, gather_points,
                         get_aggregation_features, group_points)
from ..ops.interpolate import three_interpolation
from ..ops.knn import ball_query, knn
from ..parallel import all_reduce_mean
from .apm import Attention
from .layers import (ChannelsLastBatchNorm, ConvBlock, Dense, Dropout,
                     MLPBlocks, _act_name, _norm_name, create_act,
                     recomputing, rounded)
from .refine import dual_masks, map_sum


def to_full_list(param, blocks: Sequence[int], strides: Sequence[int],
                 param_scaling: float = 1) -> List[List]:
    """Expand a scalar/partial radius or nsample spec into per-block lists."""
    param_list: List[List] = []
    if isinstance(param, (list, tuple)):
        for i, value in enumerate(param):
            value = [value] if not isinstance(value, (list, tuple)) else list(value)
            if len(value) != blocks[i]:
                value += [value[-1]] * (blocks[i] - len(value))
            param_list.append(value)
    else:
        for i, stride in enumerate(strides):
            if stride == 1:
                param_list.append([param] * blocks[i])
            else:
                param_list.append([param] + [param * param_scaling] * (blocks[i] - 1))
                param *= param_scaling
    return param_list


# eval-time cap on the materialised (B, M, K, C) grouped tensor: above it
# the separable tail runs in query chunks (inference BN is an affine map,
# so chunking is exact)
_EVAL_GATHER_BUDGET = 256 * 1024 * 1024


def _grouped_tail(idx, hf, sup, q, dp_dense, bn, act, dp_scale, pool,
                  chunkable: bool, dp_pre=None):
    """gather(hf) + dp projection + norm + act + pool over K, the memory
    peak of the separable aggregation.  ``dp_pre``: precomputed raw
    (B, M, K, 3) relative positions shared by the blocks of a stage."""
    B, M, K = idx.shape
    nbytes = B * M * K * hf.shape[-1] * 4

    def tail(idx_c, q_c, dp_c):
        hj = group_points(hf, idx_c)
        dp = (group_points(sup, idx_c) - q_c[:, :, None, :]
              if dp_c is None else dp_c)
        if dp_scale is not None:
            dp = dp / dp_scale
        h = bn(hj + dp_dense(dp))
        if act is not None:
            h = act(h)
        return pool(h)

    if not chunkable or nbytes <= _EVAL_GATHER_BUDGET:
        return tail(idx, q, dp_pre)
    mc = -(-M // -(-nbytes // _EVAL_GATHER_BUDGET))
    return torch.cat([tail(idx[:, s:s + mc], q[:, s:s + mc],
                           None if dp_pre is None else dp_pre[:, s:s + mc])
                      for s in range(0, M, mc)], 1)


def _recompute_context():
    return contextlib.nullcontext(), recomputing()


def _remat(fn, f):
    """``fn(f)`` checkpointed: its activations are recomputed from ``f`` in
    the backward, with the running statistics left alone (the tensors
    ``fn`` closes over are kept as they are)."""
    return checkpoint(fn, f, use_reentrant=False, preserve_rng_state=False,
                      context_fn=_recompute_context)


def _pool(reduction: str):
    reduction = "mean" if reduction.lower() == "avg" else reduction.lower()
    if reduction == "max":
        return lambda x: torch.amax(x, dim=-2)
    if reduction == "mean":
        return lambda x: torch.mean(x, dim=-2)
    if reduction == "sum":
        return lambda x: torch.sum(x, dim=-2)
    raise ValueError(reduction)


# activations that commute with a per-channel max through a monotone
# (sign-adjusted) affine: nondecreasing everywhere
_MONOTONE_ACTS = {None, "relu", "relu6", "leakyrelu", "elu", "sigmoid",
                  "tanh"}


class GroupStatsBN(ChannelsLastBatchNorm):
    """The BatchNorm of a separable aggregation (↔ the JAX package's
    ``GroupStatsBN``, ``models/pointnext.py:108``, which takes the flax
    name ``BatchNorm_0`` of the ``nn.BatchNorm`` it replaces; the
    parameters and buffers are those of :class:`ChannelsLastBatchNorm`).

    Called on a tensor it is that BatchNorm (the gather tail).
    :meth:`pool` is the fused tail: BatchNorm + activation + max-pool over
    the virtual grouped tensor ``h[b, i, k] = u[idx[b, i, k]] − qp[b, i]``,
    from :func:`ops.aggregate.grouped_slot_reduce`'s signed extremum and
    slot moments.  The pooled output ``act(affine(ext − qp))`` is exact
    because the affine is monotone per channel in the direction of
    ``sign(scale)``.  Train mode takes flax's one-pass variance
    ``max(E[h²] − E[h]², 0)`` of the grouped tensor and moves the running
    statistics as flax does (momentum 0.9, biased variance); ``synced``,
    the moments of the global batch (the JAX tail's single ``pmean`` of
    ``[mean, mean²]``)."""

    def pool(self, u, qp, idx, act=None, query_cloud=None):
        """u (B, N, C) per-support values (float32 or bfloat16), qp (B, M,
        C) per-query offsets (taken in float32, as the JAX tail's ``qp32``),
        idx (B, M, K) int32 → (B, M, C) float32; ``query_cloud``: the
        layout of the M queries, whose order the kernels take them in.  In
        a remat's recompute the running statistics stay as they are."""
        sgn = torch.where(self.weight.detach() >= 0, 1.0, -1.0)
        qp = qp.float()
        if self.training:
            ext, su, sq = grouped_slot_reduce(u, idx, sgn, qp=qp,
                                              query_cloud=query_cloud)
            n = idx.numel()
            mean, mu2 = su.sum((0, 1)) / n, sq.sum((0, 1)) / n
            if self.synced:
                # one all_reduce of this rank's [E[h], E[h²]] (↔ the JAX
                # tail's pmean); its VJP hands every rank's share of the
                # cotangent to kernel 21's g_sum and g_sq
                both = all_reduce_mean(torch.cat([mean, mu2]),
                                       self.process_group)
                mean, mu2 = both.split(mean.shape[0])
            var = torch.clamp_min(mu2 - mean * mean, 0.0)
            self.move_statistics(mean, var)
        else:
            ext = grouped_slot_reduce(u, idx, sgn, need_stats=False,
                                      query_cloud=query_cloud)[0]
            mean, var = self.running_mean, self.running_var
        y = (ext - qp - mean) * (torch.rsqrt(var + self.eps) * self.weight) \
            + self.bias
        return act(y) if act is not None else y


def group_stats_bn(channels: int) -> GroupStatsBN:
    return GroupStatsBN(channels, eps=1e-5, momentum=0.1)


def _fused(act_name) -> bool:
    """Whether a separable aggregation takes the fused tail (the reduction
    is a max, checked by the caller): the switch is on and the activation
    monotone.  The port's rule, read on the card (PERF.md §6,
    ``tools/profile_aggregation.py --gates``), holds at every shape: the
    fused tail's kernels took less device time than the gather tail's at
    every separable aggregation of the S3DIS and ScanNet steps (train:
    forward and backward; S3DIS eval) and of room subclouds from 106496 to
    311296 points (eval), ScanNet's 64000-point stage 0 and the subclouds'
    first stages, which the JAX package's VMEM rule ``agg_fused_fits``
    keeps on the gather tail, included."""
    return agg_fused_enabled() and act_name in _MONOTONE_ACTS


def _separable_tail(module, fused: bool, idx, f, p, q, act, pool,
                    dp_pre=None, query_cloud=None):
    """The tail of a separable aggregation (``module``: a
    :class:`LocalAggregation` or :class:`SetAbstraction`, its ``w_f``,
    ``w_dp`` and ``BatchNorm_0``) over the grouping ``idx`` of the queries
    ``q`` in the support ``p`` (``q is p`` for a block): with ``fused``
    GroupStatsBN's fused tail, with no grouped tensor,
    ``u_j − qp_i = W_f·f_j + W_dp·(p_j − q_i)/r`` (``query_cloud``: the
    layout of ``q``); else the gather tail (``pool`` over K, ``dp_pre``:
    the stage's shared relative positions)."""
    dp_scale = _dp_scale(module.grouper)
    if not fused:
        return _grouped_tail(idx, module.w_f(f), p, q, module.w_dp,
                             module.BatchNorm_0, act, dp_scale, pool,
                             chunkable=not module.training, dp_pre=dp_pre)

    def proj(x):
        d = module.w_dp(x)
        return d if dp_scale is None else d * rounded(1.0 / dp_scale, d.dtype)

    sproj = proj(p)
    qproj = sproj if q is p else proj(q)
    return module.BatchNorm_0.pool(module.w_f(f) + sproj, qproj, idx, act,
                                   query_cloud)


def _group_idx(grouper, support, query, cloud=None, query_cloud=None):
    """The grouping indices; ``cloud`` and ``query_cloud``: the layouts of
    ``support`` and ``query``, where the caller holds them."""
    if grouper.method == "ballquery":
        return ball_query(support, query, grouper.radius, grouper.nsample,
                          cloud, query_cloud)
    return knn(support, query, grouper.nsample, cloud)[0]


def _dp_scale(grouper):
    return (grouper.radius if grouper.normalize_dp
            and grouper.method == "ballquery" else None)


class LocalAggregation(nn.Module):
    """Group → per-neighbour MLP → pool (max, mean/avg or sum).

    Under the JAX package's own condition (``use_separable``: a
    single-layer ``dp_fj`` conv in ``conv-norm-act`` order with a norm,
    grouped by a ball query or a kNN) the conv is computed as ``W·[dp; fj] = W_dp·dp +
    gather(W_f·f)``: the feature half runs once a point instead of once a
    neighbour, and its norm is a BatchNorm whatever the norm's name, as in
    the JAX package.  Otherwise (any ``feature_type``, several layers,
    another order or no norm) the generic branch groups the relative
    positions and the features, builds the ``feature_type``'s features and
    runs them through ``MLPBlocks_0``."""

    def __init__(self, channels: Sequence[int], norm_args=None, act_args=None,
                 group_args=None, conv_args=None, feature_type: str = "dp_fj",
                 reduction: str = "max", last_act: bool = True, dtype=None):
        super().__init__()
        order = (conv_args or {}).get("order", "conv-norm-act")
        self.grouper = create_grouper(group_args)
        self.pool = _pool(reduction)
        self.feature_type = feature_type
        out_channels = list(channels[1:])
        self.separable = (feature_type == "dp_fj"
                          and len(out_channels) == 1
                          and order == "conv-norm-act"
                          and _norm_name(norm_args) is not None
                          and self.grouper.method in ("ballquery", "knn"))
        self.act_name = _act_name(act_args) if last_act else None
        self.max_pool = reduction.lower() == "max"
        if not self.separable:
            self.MLPBlocks_0 = MLPBlocks(
                CHANNEL_MAP[feature_type](channels[0]), out_channels,
                norm_args=norm_args, act_args=act_args, order=order,
                last_act=last_act, dtype=dtype)
            return
        out_ch = out_channels[0]
        self.w_f = Dense(channels[0], out_ch, bias=False, dtype=dtype)
        self.w_dp = Dense(3, out_ch, bias=False, dtype=dtype, exact=True)
        self.BatchNorm_0 = group_stats_bn(out_ch)
        self.act = create_act(act_args) if last_act else None

    def forward(self, p, f, cached_idx=None, cloud=None):
        """``cached_idx``: the stage's shared grouping, an ``(idx, dp)``
        pair or a bare idx (consecutive blocks of a stage share points,
        radius and nsample, and the ball query is deterministic); ``cloud``:
        the layout of ``p`` for a grouping of its own."""
        cached_dp = None
        if isinstance(cached_idx, tuple):
            cached_idx, cached_dp = cached_idx
        idx = cached_idx if cached_idx is not None else self.group(p, cloud)
        if not self.separable:
            dp, fj = self.grouper(p, p, f, idx)
            fj = get_aggregation_features(p, dp, f, fj, self.feature_type)
            return self.pool(self.MLPBlocks_0(fj))
        return _separable_tail(self, self.takes_fused(), idx, f, p, p,
                               self.act, self.pool, cached_dp, cloud)

    def group(self, p, cloud=None):
        """The grouping indices of ``p`` onto itself (None for a group of
        every point)."""
        if self.grouper.method == "all":
            return None
        return _group_idx(self.grouper, p, p, cloud)

    def takes_fused(self) -> bool:
        """Whether this aggregation takes the fused tail."""
        return self.separable and self.max_pool and _fused(self.act_name)


class SetAbstraction(nn.Module):
    """Downsampling set abstraction with optional residual."""

    def __init__(self, in_channels: int, out_channels: int, layers: int = 1,
                 stride: int = 1, group_args=None, norm_args=None,
                 act_args=None, conv_args=None, sampler: str = "fps",
                 feature_type: str = "dp_fj", use_res: bool = False,
                 is_head: bool = False, dtype=None):
        super().__init__()
        if sampler.lower() not in ("fps", "random"):
            raise ValueError(f"sampler {sampler} not supported")
        order = (conv_args or {}).get("order", "conv-norm-act")
        self.is_head, self.stride = is_head, stride
        self.sampler = sampler.lower()
        self.all_aggr = not is_head and stride == 1
        self.use_res = use_res and not self.all_aggr and not is_head
        self.feature_type = feature_type
        mid = out_channels // 2 if stride > 1 else out_channels
        channels = [in_channels] + [mid] * (layers - 1) + [out_channels]
        n = 0   # flax numbers ConvBlocks in creation order

        def conv(cin, cout, **kw) -> str:
            nonlocal n
            name = f"ConvBlock_{n}"
            self.add_module(name, ConvBlock(cin, cout, dtype=dtype, **kw))
            n += 1
            return name

        self.identity_name, self.mlp_names = None, []
        if is_head:
            # stem MLP: no norm, no act
            self.mlp_names = [conv(cin, cout, order=order) for cin, cout
                              in zip(channels[:-1], channels[1:])]
            return
        if self.use_res and in_channels != channels[-1]:
            self.identity_name = conv(in_channels, channels[-1])
        ga = dict(group_args or {})
        if self.all_aggr:
            ga["nsample"] = None
            ga["radius"] = None
        self.grouper = create_grouper(ga)
        self.act = create_act(act_args)
        self.act_name = _act_name(act_args)
        self.use_separable = (not self.all_aggr and feature_type == "dp_fj"
                              and len(channels) == 2
                              and order == "conv-norm-act"
                              and _norm_name(norm_args) is not None
                              and self.grouper.method in ("ballquery", "knn"))
        if self.use_separable:
            self.w_f = Dense(in_channels, out_channels, bias=False, dtype=dtype)
            self.w_dp = Dense(3, out_channels, bias=False, dtype=dtype,
                              exact=True)
            self.BatchNorm_0 = group_stats_bn(out_channels)
            return
        cin = CHANNEL_MAP[feature_type](in_channels)
        for i, ch in enumerate(channels[1:]):
            last = i == len(channels) - 2
            self.mlp_names.append(conv(
                cin, ch, norm_args=norm_args,
                act_args=None if (last and self.use_res) else act_args,
                order=order))
            cin = ch

    def sample(self, p, generator: Optional[torch.Generator] = None):
        """(sampled indices or None, the query positions) of this set
        abstraction: they read positions only.  The random sampler draws
        from ``generator`` (on ``p``'s device), which it needs."""
        if self.is_head or self.all_aggr:
            return None, p
        npoint = p.shape[1] // self.stride
        if self.sampler == "fps":
            idx = furthest_point_sample(p, npoint)
        else:
            if generator is None:
                raise ValueError("the random sampler needs a generator")
            idx = random_sample(p, npoint, generator)
        return idx, gather_points(p, idx)

    def forward(self, p, f, sampled=None, cloud=None, query_cloud=None,
                remat: bool = False):
        """``sampled``: :meth:`sample`'s (indices, query positions), taken
        here when not given; ``cloud`` and ``query_cloud``: the layouts of
        ``p`` and of the query positions, where the caller holds them;
        ``remat``: checkpoint all but the sampling and the grouping."""
        if self.is_head:
            return p, _remat(self._stem, f) if remat else self._stem(f)
        idx, new_p = self.sample(p) if sampled is None else sampled
        if self.use_separable:
            gidx = _group_idx(self.grouper, p, new_p, cloud, query_cloud)
        else:
            gidx = self.grouper.indices(new_p, p)

        def body(f):
            return self._aggregate(p, f, idx, new_p, gidx, query_cloud)

        return new_p, _remat(body, f) if remat else body(f)

    def _stem(self, f):
        for name in self.mlp_names:
            f = getattr(self, name)(f)
        return f

    def _aggregate(self, p, f, idx, new_p, gidx, query_cloud):
        """The features of the queries ``new_p`` (FPS indices ``idx``) over
        the grouping ``gidx``."""
        mlp = [getattr(self, name) for name in self.mlp_names]
        fi = None
        if self.use_res or "df" in self.feature_type:
            fi = gather_points(f, idx) if idx is not None else f
        if self.use_res:
            identity = (getattr(self, self.identity_name)(fi)
                        if self.identity_name else fi)
        if self.use_separable:
            f = _separable_tail(
                self, _fused(None if self.use_res else self.act_name), gidx, f,
                p, new_p,
                None if self.use_res else self.act,
                lambda t: torch.amax(t, dim=-2), query_cloud=query_cloud)
        else:
            dp, fj = self.grouper(new_p, p, f, gidx)
            fj = get_aggregation_features(new_p, dp, fi, fj, self.feature_type)
            for block in mlp:
                fj = block(fj)
            f = torch.amax(fj, dim=-2)
        if self.use_res:
            f = self.act(f + identity)
        return f


class FeaturePropagation(nn.Module):
    """3-NN upsampling + MLP; ``mlp`` is [skip + coarse, fp, fp].  The
    global form (``upsample=False``) takes ``pf1`` alone: the mean of its
    features over the points, through ``Dense_0`` and a ReLU, broadcast to
    every point and concatenated to its features, then the ConvBlocks of
    ``mlp[2:]``."""

    def __init__(self, mlp: Sequence[int], upsample: bool = True,
                 norm_args=None, act_args=None, dtype=None):
        super().__init__()
        self.upsample = upsample
        if upsample:
            cins, couts = mlp[:-1], mlp[1:]
        else:
            self.Dense_0 = Dense(mlp[0], mlp[1], dtype=dtype)
            cins, couts = [mlp[0] + mlp[1]] + list(mlp[2:-1]), mlp[2:]
        for i, (cin, cout) in enumerate(zip(cins, couts)):
            self.add_module(f"ConvBlock_{i}", ConvBlock(
                cin, cout, norm_args=norm_args, act_args=act_args,
                dtype=dtype))

    def forward(self, pf1, pf2=None, query_cloud=None, cloud=None):
        """``query_cloud`` and ``cloud``: the layouts of ``p1`` (the fine
        stage) and ``p2`` (the coarse one), which the interpolation reads;
        it sorts for itself without them."""
        if self.upsample:
            (p1, f1), (p2, f2) = pf1, pf2
            f = three_interpolation(p1, p2, f2, cloud, query_cloud)
            if f1 is not None:
                f = torch.cat([f1, f], -1)
        else:
            f = pf1[1]
            g = torch.relu(self.Dense_0(f.mean(1)))
            g = g[:, None, :].expand(*f.shape[:2], g.shape[-1])
            f = torch.cat([f, g.to(f.dtype)], -1)
        for name, block in self.named_children():
            if name.startswith("ConvBlock_"):
                f = block(f)
        return f


class _ResidualBlock(nn.Module):
    """An encoder block: ``LocalAggregation_0``, then its ``ConvBlock_{i}``
    (none in ResBlock), the residual where the widths match, the
    activation."""

    def forward(self, p, f, cached_idx=None, cloud=None, remat: bool = False):
        """``remat``: checkpoint all but the grouping."""
        if not remat:
            return p, self._block(p, f, cached_idx, cloud)
        if cached_idx is None:
            cached_idx = self.LocalAggregation_0.group(p, cloud)
        return p, _remat(lambda f: self._block(p, f, cached_idx, cloud), f)

    def _block(self, p, f, cached_idx, cloud):
        identity = f
        f = self.LocalAggregation_0(p, f, cached_idx=cached_idx, cloud=cloud)
        for name, block in self.named_children():
            if name.startswith("ConvBlock_"):
                f = block(f)
        if f.shape[-1] == identity.shape[-1] and self.use_res:
            f = f + identity
        return self.act(f)


class InvResMLP(_ResidualBlock):
    """Inverted-residual MLP block."""

    def __init__(self, in_channels: int, norm_args=None, act_args=None,
                 aggr_args=None, group_args=None, conv_args=None,
                 expansion: int = 1, use_res: bool = True,
                 num_posconvs: int = 2, less_act: bool = False, dtype=None):
        super().__init__()
        aggr = dict(aggr_args or {"feature_type": "dp_fj", "reduction": "max"})
        self.use_res = use_res
        self.act = create_act(act_args)
        self.LocalAggregation_0 = LocalAggregation(
            [in_channels, in_channels], norm_args=norm_args,
            act_args=act_args if num_posconvs > 0 else None,
            group_args=group_args, conv_args=conv_args,
            feature_type=aggr.get("feature_type", "dp_fj"),
            reduction=aggr.get("reduction", "max"), dtype=dtype)
        mid = int(in_channels * expansion)
        channels = ([] if num_posconvs < 1 else [in_channels]
                    if num_posconvs == 1 else [mid, in_channels])
        order = (conv_args or {}).get("order", "conv-norm-act")
        cin = in_channels
        for i, ch in enumerate(channels):
            last = i == len(channels) - 1
            self.add_module(f"ConvBlock_{i}", ConvBlock(
                cin, ch, norm_args=norm_args,
                act_args=None if (last and not less_act) else act_args,
                order=order, dtype=dtype))
            cin = ch



class ResBlock(_ResidualBlock):
    """The plain residual block: a LocalAggregation of channels [C, C,
    C·expansion, C] with no activation inside (so it always takes the
    generic branch), the residual, then the activation."""

    def __init__(self, in_channels: int, norm_args=None, act_args=None,
                 aggr_args=None, group_args=None, conv_args=None,
                 expansion: int = 1, use_res: bool = True, dtype=None):
        super().__init__()
        aggr = dict(aggr_args or {"feature_type": "dp_fj", "reduction": "max"})
        self.use_res = use_res
        self.act = create_act(act_args)
        mid = in_channels * expansion
        self.LocalAggregation_0 = LocalAggregation(
            [in_channels, in_channels, mid, in_channels], norm_args=norm_args,
            act_args=None, group_args=group_args, conv_args=conv_args,
            feature_type=aggr.get("feature_type", "dp_fj"),
            reduction=aggr.get("reduction", "max"), dtype=dtype)


_BLOCKS = {"InvResMLP": InvResMLP, "ResBlock": ResBlock}


class PointNextEncoder(nn.Module):
    """PointNeXt encoder; ``forward`` returns per-stage position and
    feature lists, index 0 being the input."""

    def __init__(self, in_channels: int = 4, width: int = 32,
                 blocks: Sequence[int] = (1, 4, 7, 4, 4),
                 strides: Sequence[int] = (1, 4, 4, 4, 4),
                 block: str = "InvResMLP", nsample=32, radius=0.1,
                 aggr_args=None, group_args=None, sa_layers: int = 1,
                 sa_use_res: bool = False, norm_args=None, act_args=None,
                 conv_args=None, sampler: str = "fps", expansion: int = 4,
                 use_res: bool = True, radius_scaling: float = 2,
                 nsample_scaling: float = 1, remat: bool = False, dtype=None):
        super().__init__()
        if block not in _BLOCKS:
            raise ValueError(f"block {block} not supported")
        block_cls = _BLOCKS[block]
        self.width, self.blocks, self.strides = width, list(blocks), list(strides)
        self.remat = bool(remat)
        norm_args = norm_args or {"norm": "bn"}
        act_args = act_args or {"act": "relu"}
        aggr_args = dict(aggr_args or {"feature_type": "dp_fj", "reduction": "max"})
        self.radii = to_full_list(radius, blocks, strides, radius_scaling)
        self.nsamples = to_full_list(nsample, blocks, strides, nsample_scaling)
        self.group_name = dict(group_args or {"NAME": "ballquery"}).get(
            "NAME", "ballquery")
        channels = self.channel_list
        in_ch = in_channels
        self.shared = []
        for i in range(len(blocks)):
            is_head = i == 0 and strides[i] == 1
            ga = dict(group_args or {"NAME": "ballquery"})
            ga["radius"], ga["nsample"] = self.radii[i][0], self.nsamples[i][0]
            self.add_module(f"enc{i}_sa", SetAbstraction(
                in_channels=in_ch, out_channels=channels[i],
                layers=sa_layers if not is_head else 1, stride=strides[i],
                group_args=ga, norm_args=norm_args, act_args=act_args,
                conv_args=conv_args, sampler=sampler, use_res=sa_use_res,
                is_head=is_head,
                feature_type=aggr_args.get("feature_type", "dp_fj"),
                dtype=dtype))
            in_ch = channels[i]
            nb = blocks[i]
            # consecutive blocks of a stage share (points, radius, nsample):
            # one ball query (and one dp gather) serves them all
            self.shared.append(
                nb > 2 and block == "InvResMLP"
                and aggr_args.get("feature_type", "dp_fj") == "dp_fj"
                and all(self.radii[i][j] == self.radii[i][1]
                        and self.nsamples[i][j] == self.nsamples[i][1]
                        for j in range(1, nb)))
            for j in range(1, nb):
                gaj = dict(group_args or {"NAME": "ballquery"})
                gaj["radius"], gaj["nsample"] = self.radii[i][j], self.nsamples[i][j]
                self.add_module(f"enc{i}_block{j}", block_cls(
                    in_channels=in_ch, aggr_args=aggr_args,
                    norm_args=norm_args, act_args=act_args, group_args=gaj,
                    conv_args=conv_args, expansion=expansion,
                    use_res=use_res, dtype=dtype))

    @property
    def channel_list(self) -> List[int]:
        width, channels = self.width, []
        for stride in self.strides:
            if stride != 1:
                width *= 2
            channels.append(width)
        return channels

    @property
    def out_channels(self) -> int:
        return self.channel_list[-1]

    def sample(self, p0, generator: Optional[torch.Generator] = None
               ) -> "Stages":
        """The positions of every stage, before any feature: each set
        abstraction's FPS in turn (one batched launch a stage; the random
        sampler draws from ``generator``), then one
        :func:`ops.spatial.sort_stages` over the distinct stage clouds
        (:func:`ops.spatial.sort_each`)."""
        p = p0.contiguous()
        positions, sampled = [p], []
        for i in range(len(self.blocks)):
            sampled.append(getattr(self, f"enc{i}_sa").sample(p, generator))
            p = sampled[-1][1]
            positions.append(p)
        return Stages(positions, sampled, spatial.sort_each(positions))

    def forward(self, p0, f0, stages: Optional["Stages"] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """``stages``: :meth:`sample` of ``p0`` (from ``generator``), taken
        here when not given;
        returns the positions (its tensors, which its layouts were made
        from) and the features of every stage, index 0 the input.  With
        ``remat`` and gradients on, each set abstraction and block is
        checkpointed."""
        if stages is None:
            stages = self.sample(p0, generator)
        remat = self.remat and torch.is_grad_enabled()
        p_list, f_list = [stages.p[0]], [f0]
        p, f = stages.p[0], f0
        for i in range(len(self.blocks)):
            cloud, query_cloud = stages.clouds[i], stages.clouds[i + 1]
            p, f = getattr(self, f"enc{i}_sa")(p, f, stages.sampled[i], cloud,
                                               query_cloud, remat)
            shared = None
            if self.shared[i]:
                r, k = self.radii[i][1], self.nsamples[i][1]
                if self.group_name == "ballquery":
                    idx = ball_query(p, p, r, k, query_cloud)
                else:
                    idx = knn(p, p, k, query_cloud)[0]
                # the fused tail never forms dp: blocks that take it share
                # idx alone
                block = getattr(self, f"enc{i}_block1").LocalAggregation_0
                shared = idx if block.takes_fused() else \
                    (idx, group_points(p, idx) - p[:, :, None, :])
            for j in range(1, self.blocks[i]):
                p, f = getattr(self, f"enc{i}_block{j}")(
                    p, f, cached_idx=shared, cloud=query_cloud, remat=remat)
            p_list.append(p)
            f_list.append(f)
        return p_list, f_list


class Stages(NamedTuple):
    """:meth:`PointNextEncoder.sample` of a batch: per stage (index 0 the
    input) its positions and their layout, and per set abstraction its
    (FPS indices or None, query positions)."""
    p: List[torch.Tensor]
    sampled: List[Tuple[Optional[torch.Tensor], torch.Tensor]]
    clouds: List[spatial.SortedCloud]


class PointNextDecoder(nn.Module):
    """PointNeXt decoder.  ``forward`` returns the full-resolution
    features, the per-stage decoder features (index s ↔ encoder stage s+1)
    and the mean refine rate (0 without refinement).

    With ``refine`` and an ``a_list`` the AMContrast3D++ masked refinement
    runs after each FeaturePropagation stage: the 'up' feature is recorded
    before it (it feeds the contrastive objective) and the refined feature
    goes on to the next stage.  ``a_list`` holds the per-stage ambiguity
    (B, N_s), ``a_map_list`` the APM's lifted maps for ``refine_mapping``
    (added to the feature, or the query of a trained cross-attention with
    ``refine_attention``)."""

    def __init__(self, encoder_channel_list: Sequence[int],
                 decoder_layers: int = 2, decoder_stages: int = 4,
                 in_channels_input: int = 3, norm_args=None, act_args=None,
                 refine: bool = False, refine_mapping: bool = False,
                 refine_attention: bool = False, nsample_k: int = 12,
                 fusion: str = "MIN", threshold: float = 0.7,
                 threshold_max: float = 1.0, gamma: float = 0.5,
                 dtype=None):
        super().__init__()
        ecl = list(encoder_channel_list)
        self.decoder_stages = decoder_stages
        self._out_channels = ecl[:decoder_stages][0]
        self.refine, self.refine_mapping = refine, refine_mapping
        self.refine_attention = refine_attention
        self.nsample_k, self.fusion = nsample_k, fusion
        self.threshold, self.threshold_max = threshold, threshold_max
        self.gamma = gamma
        skip_channels = ecl[:-1]
        if len(skip_channels) < decoder_stages:
            skip_channels.insert(0, in_channels_input)
        fp_channels = ecl[:decoder_stages]
        norm_args = norm_args or {"norm": "bn"}
        act_args = act_args or {"act": "relu"}
        n, in_ch = decoder_stages, ecl[-1]
        for i in range(-1, -n - 1, -1):
            mlp = [skip_channels[i] + in_ch] + [fp_channels[i]] * decoder_layers
            self.add_module(f"fp{n + i}", FeaturePropagation(
                mlp, norm_args=norm_args, act_args=act_args, dtype=dtype))
            in_ch = fp_channels[i]
            if refine and refine_mapping and refine_attention:
                self.add_module(f"refine_att{n + i}",
                                Attention(in_ch, in_ch, in_ch, dtype=dtype))

    @property
    def out_channels(self) -> int:
        return self._out_channels

    def forward(self, p: List[torch.Tensor], f: List[torch.Tensor],
                a_list: Optional[List[torch.Tensor]] = None,
                a_map_list: Optional[List[torch.Tensor]] = None,
                clouds: Optional[List[spatial.SortedCloud]] = None):
        """``clouds``: the layouts of ``p`` (the encoder's), which each
        stage's interpolation (the fine stage's and the coarse one's) and
        the refinement's CrossMask read; sorted here, once, when not
        given."""
        n = self.decoder_stages
        f = list(f)
        if clouds is None:
            clouds = spatial.sort_each(p)
        up_features: List[Optional[torch.Tensor]] = [None] * n
        refine_rates = []
        for i in range(-1, -n - 1, -1):
            f[i - 1] = getattr(self, f"fp{n + i}")(
                [p[i - 1], f[i - 1]], [p[i], f[i]], clouds[i - 1], clouds[i])
            up_features[i] = f[i - 1]
            if not self.refine or a_list is None:
                continue
            if not self.refine_mapping:
                f[i - 1], rate = dual_masks(
                    p[i - 1], f[i - 1], a_list[i], self.nsample_k, self.fusion,
                    self.threshold, self.threshold_max, self.gamma,
                    clouds[i - 1])
                refine_rates.append(rate)
            elif self.refine_attention:
                f[i - 1] = getattr(self, f"refine_att{n + i}")(
                    a_map_list[i], f[i - 1])
            else:
                f[i - 1] = map_sum(f[i - 1], a_map_list[i])
        rate = (torch.stack(refine_rates).mean() if refine_rates
                else p[0].new_zeros(()))
        return f[-n - 1], up_features, rate


class SegHead(nn.Module):
    """Scene segmentation head."""

    def __init__(self, num_classes: int, in_channels: int, mlps=None,
                 norm_args=None, act_args=None, dropout: float = 0.5,
                 global_feat: Optional[str] = None, dtype=None):
        super().__init__()
        norm_args = norm_args or {"norm": "bn1d"}
        act_args = act_args or {"act": "relu"}
        self.global_feat = global_feat
        if global_feat is not None:
            in_channels *= 1 + len(global_feat.split(","))
        if mlps is None:
            mlps = [in_channels, in_channels, num_classes]
        else:
            m = mlps if isinstance(mlps, (list, tuple)) else [mlps]
            mlps = [in_channels] + list(m) + [num_classes]
        layers = []
        for cin, cout in zip(mlps[:-2], mlps[1:-1]):
            layers.append(ConvBlock(cin, cout, norm_args=norm_args,
                                    act_args=act_args, dtype=dtype))
            if dropout:
                layers.append(Dropout(dropout))
        # no norm: the logits come out in ``dtype``
        layers.append(ConvBlock(mlps[-2], mlps[-1], dtype=dtype))
        n = 0   # flax names only the ConvBlocks: ConvBlock_0, ConvBlock_1, …
        for layer in layers:
            if isinstance(layer, ConvBlock):
                self.add_module(f"ConvBlock_{n}", layer)
                n += 1
            else:
                self.add_module(f"Dropout_{n - 1}", layer)

    def forward(self, f, generator: Optional[torch.Generator] = None):
        """``generator`` draws the dropout masks in training mode."""
        if self.global_feat is not None:
            feats = [f]
            for ft in self.global_feat.split(","):
                if "max" in ft:
                    g = torch.amax(f, dim=1, keepdim=True)
                elif ft in ("avg", "mean"):
                    g = torch.mean(f, dim=1, keepdim=True)
                else:
                    raise ValueError(ft)
                feats.append(g.expand_as(f))
            f = torch.cat(feats, -1)
        for layer in self.children():
            f = layer(f, generator) if isinstance(layer, Dropout) else layer(f)
        return f
