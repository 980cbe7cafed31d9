"""PointNet++ encoder and decoder (PyTorch, channels-last).

↔ ``amcontrast3d_tpu/models/pointnetv2.py`` (``PointNet2SA``,
``PointNet2Encoder``, ``PointNet2Decoder``; ``cfgs/s3dis/pointnet++.yaml``
builds them under ``BaseSeg``).  A stage samples by FPS, groups by a ball
query, runs its MLP stack over the grouped ``dp_fj`` features and max-pools;
the decoder is a stack of 3-NN FeaturePropagation modules back to the
input level.  Submodules keep the flax names (``sa{i}``, ``ConvBlock_{j}``,
``fp{k}``) so that ``utils/convert.py::from_jax_variables`` maps the JAX
weights leaf by leaf.  ``PointNet2PartDecoder`` is not ported.  ``dtype``
is the compute type of every Linear (the JAX modules' field); each block
has a BatchNorm, which returns float32.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops import spatial
from ..ops.fps import furthest_point_sample
from ..ops.group import (CHANNEL_MAP, create_grouper, gather_points,
                         get_aggregation_features)
from .build import MODELS
from .layers import ConvBlock
from .pointnext import FeaturePropagation, to_full_list


class PointNet2SA(nn.Module):
    """One set-abstraction stage: FPS → group → MLPs → max-pool (the JAX
    module samples by FPS whatever its ``sampler`` field says)."""

    def __init__(self, in_channels: int, mlp: Sequence[int], stride: int,
                 radius: float, nsample: Optional[int], group_args=None,
                 norm_args=None, act_args=None, conv_args=None,
                 feature_type: str = "dp_fj", dtype=None):
        super().__init__()
        ga = dict(group_args or {"NAME": "ballquery"})
        ga["radius"], ga["nsample"] = radius, nsample   # None: one group of all
        self.grouper = create_grouper(ga)
        self.stride, self.feature_type = stride, feature_type
        order = (conv_args or {}).get("order", "conv-norm-act")
        cin = CHANNEL_MAP[feature_type](in_channels)
        for j, cout in enumerate(mlp):
            self.add_module(f"ConvBlock_{j}", ConvBlock(
                cin, cout, norm_args=norm_args or {"norm": "bn"},
                act_args=act_args or {"act": "relu"}, order=order,
                dtype=dtype))
            cin = cout

    def forward(self, p, f):
        if self.stride > 1:
            new_p = gather_points(p, furthest_point_sample(
                p, p.shape[1] // self.stride))
        else:
            new_p = p
        dp, fj = self.grouper(new_p, p, f)
        fj = get_aggregation_features(new_p, dp, None, fj, self.feature_type)
        for block in self.children():
            fj = block(fj)
        return new_p, torch.amax(fj, dim=-2)


@MODELS.register_module()
class PointNet2Encoder(nn.Module):
    """Single-scale grouping; ``forward`` returns per-stage position and
    feature lists, index 0 being the input."""

    def __init__(self, in_channels: int = 4, radius=0.1, num_samples=32,
                 aggr_args=None, group_args=None, conv_args=None,
                 norm_args=None, act_args=None, blocks=None, mlps=None,
                 width: Optional[int] = None,
                 strides: Sequence[int] = (4, 4, 4, 4), layers: int = 3,
                 width_scaling: int = 2, radius_scaling: float = 2,
                 nsample_scaling: float = 1, sampler: str = "fps",
                 dtype=None):
        """``sampler`` is taken and not read: the JAX encoder hands it to
        stages that sample by FPS whatever it says."""
        super().__init__()
        self.mlps, self.width, self.strides = mlps, width, list(strides)
        self.layers, self.width_scaling = layers, width_scaling
        blocks = list(blocks) if blocks is not None else [1] * len(strides)
        radii = to_full_list(radius, blocks, strides, radius_scaling)
        nsamples = to_full_list(num_samples, blocks, strides, nsample_scaling)
        feature_type = dict(aggr_args or {}).get("feature_type", "dp_fj")
        in_ch = in_channels
        for i, stage_mlp in enumerate(self._stage_mlps()):
            self.add_module(f"sa{i}", PointNet2SA(
                in_ch, stage_mlp, self.strides[i], radii[i][0], nsamples[i][0],
                group_args=group_args, norm_args=norm_args, act_args=act_args,
                conv_args=conv_args, feature_type=feature_type, dtype=dtype))
            in_ch = stage_mlp[-1]

    def _stage_mlps(self) -> List[List[int]]:
        if self.mlps is not None:
            # the reference nests per-block lists; flatten per stage
            return [[c for block in stage for c in
                     (block if isinstance(block, (list, tuple)) else [block])]
                    for stage in self.mlps]
        width, out = self.width or 32, []
        for _ in self.strides:
            width *= self.width_scaling
            out.append([width] * self.layers)
        return out

    @property
    def channel_list(self) -> List[int]:
        return [m[-1] for m in self._stage_mlps()]

    @property
    def out_channels(self) -> int:
        return self.channel_list[-1]

    def forward(self, p0, f0) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        p_list, f_list = [p0], [f0]
        p, f = p0, f0
        for stage in self.children():
            p, f = stage(p, f)
            p_list.append(p)
            f_list.append(f)
        return p_list, f_list


@MODELS.register_module()
class PointNet2Decoder(nn.Module):
    """A stack of FP modules back to the input level; ``forward`` returns
    the full-resolution features, the per-stage decoder features and 0 (no
    refinement), as ``PointNextDecoder`` does."""

    def __init__(self, encoder_channel_list: Sequence[int], fp_mlps=None,
                 decoder_layers: int = 1, in_channels_input: int = 3,
                 norm_args=None, act_args=None, dtype=None):
        super().__init__()
        ecl = list(encoder_channel_list)
        self.n = n = len(ecl)
        # skip channels per level: the input features, then encoder stages;
        # fp output channels mirror the skip pyramid
        skip = [in_channels_input] + ecl[:-1]
        fp_out = [ecl[0]] + ecl[:-1]
        if fp_mlps is not None:
            fp_out = [list(m)[-1] for m in fp_mlps]
        self.out_channels = fp_out[0]
        in_ch = ecl[-1]
        for i in range(-1, -n - 1, -1):
            mlp = [skip[i] + in_ch] + [fp_out[i]] * max(decoder_layers, 1)
            self.add_module(f"fp{n + i}", FeaturePropagation(
                mlp, norm_args=norm_args or {"norm": "bn"},
                act_args=act_args or {"act": "relu"}, dtype=dtype))
            in_ch = mlp[-1]

    def forward(self, p: List[torch.Tensor], f: List[torch.Tensor]):
        """Each stage's interpolation reads the layouts of its fine and its
        coarse stage, sorted here once for all stages."""
        n, f = self.n, list(f)
        up_features = [None] * n
        clouds = spatial.sort_each(p)
        for i in range(-1, -n - 1, -1):
            f[i - 1] = getattr(self, f"fp{n + i}")(
                [p[i - 1], f[i - 1]], [p[i], f[i]], clouds[i - 1], clouds[i])
            up_features[i] = f[i - 1]
        return f[-n - 1], up_features, torch.zeros((), device=f[0].device)
