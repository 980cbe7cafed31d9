"""PointNeXt encoder / decoder / segmentation head (PyTorch, channels-last).

↔ ``amcontrast3d_tpu/models/pointnext.py``.  Positions are (B, N, 3),
features (B, N, C), grouped neighbourhoods (B, M, K, C); per-stage point
counts are ``N_i = N_{i-1} // stride``.  Submodules keep the flax names
(``enc{i}_sa``, ``enc{i}_block{j}``, ``LocalAggregation_0``, ``w_f``,
``w_dp``, ``ConvBlock_{n}``, ``BatchNorm_0``, ``fp{k}``).

Ported: the separable ``dp_fj`` LocalAggregation, SetAbstraction (head,
separable and generic paths), FeaturePropagation with upsampling,
InvResMLP, the encoder with its per-stage shared ball query, the decoder
without refinement, and SegHead.  Not yet: the generic grouped-MLP
LocalAggregation, the masked ``n_valid`` path, the fused GroupStatsBN
aggregation, remat, ResBlock and random sampling.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops.fps import furthest_point_sample
from ..ops.group import (CHANNEL_MAP, create_grouper, gather_points,
                         get_aggregation_features, group_points)
from ..ops.interpolate import three_interpolation
from ..ops.knn import ball_query, knn
from .layers import ConvBlock, Dropout, _norm_name, batch_norm, create_act


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


def _pool(reduction: str):
    reduction = "mean" if reduction.lower() == "avg" else reduction.lower()
    if reduction == "max":
        return lambda x: torch.amax(x, dim=-2)
    if reduction == "mean":
        return lambda x: torch.mean(x, dim=-2)
    if reduction == "sum":
        return lambda x: torch.sum(x, dim=-2)
    raise ValueError(reduction)


def _group_idx(grouper, support, query):
    if grouper.method == "ballquery":
        return ball_query(support, query, grouper.radius, grouper.nsample)
    return knn(support, query, grouper.nsample)[0]


def _dp_scale(grouper):
    return (grouper.radius if grouper.normalize_dp
            and grouper.method == "ballquery" else None)


class LocalAggregation(nn.Module):
    """Group → per-neighbour conv → pool, in the separable form only.

    A single-layer ``dp_fj`` conv with a norm is computed as
    ``W·[dp; fj] = W_dp·dp + gather(W_f·f)``: the feature half runs once
    per point instead of once per neighbour.  Every other form (the JAX
    package's generic grouped-MLP branch) is not ported."""

    def __init__(self, channels: Sequence[int], norm_args=None, act_args=None,
                 group_args=None, conv_args=None, feature_type: str = "dp_fj",
                 reduction: str = "max", last_act: bool = True):
        super().__init__()
        order = (conv_args or {}).get("order", "conv-norm-act")
        self.grouper = create_grouper(group_args)
        self.pool = _pool(reduction)
        if not (feature_type == "dp_fj" and len(channels) == 2
                and order == "conv-norm-act"
                and _norm_name(norm_args) is not None
                and self.grouper.method in ("ballquery", "knn")):
            raise NotImplementedError(
                "only the separable single-layer dp_fj aggregation with a "
                "norm is ported")
        out_ch = channels[1]
        self.w_f = nn.Linear(channels[0], out_ch, bias=False)
        self.w_dp = nn.Linear(3, out_ch, bias=False)
        self.BatchNorm_0 = batch_norm(out_ch)
        self.act = create_act(act_args) if last_act else None

    def forward(self, p, f, cached_idx=None):
        """``cached_idx``: the stage's shared grouping, an ``(idx, dp)``
        pair or a bare idx (consecutive blocks of a stage share points,
        radius and nsample, and the ball query is deterministic)."""
        cached_dp = None
        if isinstance(cached_idx, tuple):
            cached_idx, cached_dp = cached_idx
        idx = cached_idx if cached_idx is not None else \
            _group_idx(self.grouper, p, p)
        return _grouped_tail(
            idx, self.w_f(f), p, p, self.w_dp, self.BatchNorm_0, self.act,
            _dp_scale(self.grouper), self.pool, chunkable=not self.training,
            dp_pre=cached_dp)


class SetAbstraction(nn.Module):
    """Downsampling set abstraction with optional residual."""

    def __init__(self, in_channels: int, out_channels: int, layers: int = 1,
                 stride: int = 1, group_args=None, norm_args=None,
                 act_args=None, conv_args=None, sampler: str = "fps",
                 feature_type: str = "dp_fj", use_res: bool = False,
                 is_head: bool = False):
        super().__init__()
        if sampler.lower() != "fps":
            raise NotImplementedError(f"sampler {sampler} not ported")
        order = (conv_args or {}).get("order", "conv-norm-act")
        self.is_head, self.stride = is_head, stride
        self.all_aggr = not is_head and stride == 1
        self.use_res = use_res and not self.all_aggr and not is_head
        self.feature_type = feature_type
        mid = out_channels // 2 if stride > 1 else out_channels
        channels = [in_channels] + [mid] * (layers - 1) + [out_channels]
        n = 0   # flax numbers ConvBlocks in creation order

        def conv(cin, cout, **kw) -> str:
            nonlocal n
            name = f"ConvBlock_{n}"
            self.add_module(name, ConvBlock(cin, cout, **kw))
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
        self.use_separable = (not self.all_aggr and feature_type == "dp_fj"
                              and len(channels) == 2
                              and order == "conv-norm-act"
                              and _norm_name(norm_args) is not None
                              and self.grouper.method in ("ballquery", "knn"))
        if self.use_separable:
            self.w_f = nn.Linear(in_channels, out_channels, bias=False)
            self.w_dp = nn.Linear(3, out_channels, bias=False)
            self.BatchNorm_0 = batch_norm(out_channels)
            return
        cin = CHANNEL_MAP[feature_type](in_channels)
        for i, ch in enumerate(channels[1:]):
            last = i == len(channels) - 2
            self.mlp_names.append(conv(
                cin, ch, norm_args=norm_args,
                act_args=None if (last and self.use_res) else act_args,
                order=order))
            cin = ch

    def forward(self, p, f):
        mlp = [getattr(self, name) for name in self.mlp_names]
        if self.is_head:
            for block in mlp:
                f = block(f)
            return p, f
        if not self.all_aggr:
            idx = furthest_point_sample(p, p.shape[1] // self.stride)
            new_p = gather_points(p, idx)
        else:
            idx, new_p = None, p
        fi = None
        if self.use_res or "df" in self.feature_type:
            fi = gather_points(f, idx) if idx is not None else f
        if self.use_res:
            identity = (getattr(self, self.identity_name)(fi)
                        if self.identity_name else fi)
        if self.use_separable:
            gidx = _group_idx(self.grouper, p, new_p)
            f = _grouped_tail(
                gidx, self.w_f(f), p, new_p, self.w_dp, self.BatchNorm_0,
                None if self.use_res else self.act, _dp_scale(self.grouper),
                lambda t: torch.amax(t, dim=-2), chunkable=not self.training)
        else:
            dp, fj = self.grouper(new_p, p, f)
            fj = get_aggregation_features(new_p, dp, fi, fj, self.feature_type)
            for block in mlp:
                fj = block(fj)
            f = torch.amax(fj, dim=-2)
        if self.use_res:
            f = self.act(f + identity)
        return new_p, f


class FeaturePropagation(nn.Module):
    """3-NN upsampling + MLP; ``mlp`` is [skip + coarse, fp, fp]."""

    def __init__(self, mlp: Sequence[int], upsample: bool = True,
                 norm_args=None, act_args=None):
        super().__init__()
        if not upsample:
            raise NotImplementedError("global (non-upsampling) FP not ported")
        for i, (cin, cout) in enumerate(zip(mlp[:-1], mlp[1:])):
            self.add_module(f"ConvBlock_{i}", ConvBlock(
                cin, cout, norm_args=norm_args, act_args=act_args))

    def forward(self, pf1, pf2):
        (p1, f1), (p2, f2) = pf1, pf2
        f = three_interpolation(p1, p2, f2)
        if f1 is not None:
            f = torch.cat([f1, f], -1)
        for block in self.children():
            f = block(f)
        return f


class InvResMLP(nn.Module):
    """Inverted-residual MLP block."""

    def __init__(self, in_channels: int, norm_args=None, act_args=None,
                 aggr_args=None, group_args=None, conv_args=None,
                 expansion: int = 1, use_res: bool = True,
                 num_posconvs: int = 2, less_act: bool = False):
        super().__init__()
        aggr = dict(aggr_args or {"feature_type": "dp_fj", "reduction": "max"})
        self.use_res = use_res
        self.act = create_act(act_args)
        self.LocalAggregation_0 = LocalAggregation(
            [in_channels, in_channels], norm_args=norm_args,
            act_args=act_args if num_posconvs > 0 else None,
            group_args=group_args, conv_args=conv_args,
            feature_type=aggr.get("feature_type", "dp_fj"),
            reduction=aggr.get("reduction", "max"))
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
                order=order))
            cin = ch

    def forward(self, p, f, cached_idx=None):
        identity = f
        f = self.LocalAggregation_0(p, f, cached_idx=cached_idx)
        for name, block in self.named_children():
            if name.startswith("ConvBlock_"):
                f = block(f)
        if f.shape[-1] == identity.shape[-1] and self.use_res:
            f = f + identity
        return p, self.act(f)


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
                 nsample_scaling: float = 1):
        super().__init__()
        if block != "InvResMLP":
            raise NotImplementedError(f"block {block} not ported")
        self.width, self.blocks, self.strides = width, list(blocks), list(strides)
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
                feature_type=aggr_args.get("feature_type", "dp_fj")))
            in_ch = channels[i]
            nb = blocks[i]
            # consecutive blocks of a stage share (points, radius, nsample):
            # one ball query (and one dp gather) serves them all
            self.shared.append(
                nb > 2 and aggr_args.get("feature_type", "dp_fj") == "dp_fj"
                and all(self.radii[i][j] == self.radii[i][1]
                        and self.nsamples[i][j] == self.nsamples[i][1]
                        for j in range(1, nb)))
            for j in range(1, nb):
                gaj = dict(group_args or {"NAME": "ballquery"})
                gaj["radius"], gaj["nsample"] = self.radii[i][j], self.nsamples[i][j]
                self.add_module(f"enc{i}_block{j}", InvResMLP(
                    in_channels=in_ch, aggr_args=aggr_args,
                    norm_args=norm_args, act_args=act_args, group_args=gaj,
                    conv_args=conv_args, expansion=expansion,
                    use_res=use_res))

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

    def forward(self, p0, f0) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        p_list, f_list = [p0], [f0]
        p, f = p0, f0
        for i in range(len(self.blocks)):
            p, f = getattr(self, f"enc{i}_sa")(p, f)
            shared = None
            if self.shared[i]:
                r, k = self.radii[i][1], self.nsamples[i][1]
                if self.group_name == "ballquery":
                    idx = ball_query(p, p, r, k)
                else:
                    idx = knn(p, p, k)[0]
                shared = (idx, group_points(p, idx) - p[:, :, None, :])
            for j in range(1, self.blocks[i]):
                p, f = getattr(self, f"enc{i}_block{j}")(p, f, cached_idx=shared)
            p_list.append(p)
            f_list.append(f)
        return p_list, f_list


class PointNextDecoder(nn.Module):
    """PointNeXt decoder without refinement.  ``forward`` returns the
    full-resolution features and the per-stage decoder features (index s
    ↔ encoder stage s+1)."""

    def __init__(self, encoder_channel_list: Sequence[int],
                 decoder_layers: int = 2, decoder_stages: int = 4,
                 in_channels_input: int = 3, norm_args=None, act_args=None):
        super().__init__()
        ecl = list(encoder_channel_list)
        self.decoder_stages = decoder_stages
        self._out_channels = ecl[:decoder_stages][0]
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
                mlp, norm_args=norm_args, act_args=act_args))
            in_ch = fp_channels[i]

    @property
    def out_channels(self) -> int:
        return self._out_channels

    def forward(self, p: List[torch.Tensor], f: List[torch.Tensor]):
        n = self.decoder_stages
        f = list(f)
        up_features: List[Optional[torch.Tensor]] = [None] * n
        for i in range(-1, -n - 1, -1):
            f[i - 1] = getattr(self, f"fp{n + i}")(
                [p[i - 1], f[i - 1]], [p[i], f[i]])
            up_features[i] = f[i - 1]
        return f[-n - 1], up_features


class SegHead(nn.Module):
    """Scene segmentation head."""

    def __init__(self, num_classes: int, in_channels: int, mlps=None,
                 norm_args=None, act_args=None, dropout: float = 0.5,
                 global_feat: Optional[str] = None):
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
                                    act_args=act_args))
            if dropout:
                layers.append(Dropout(dropout))
        layers.append(ConvBlock(mlps[-2], mlps[-1]))
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
