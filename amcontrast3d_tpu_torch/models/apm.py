"""Ambiguity Prediction Module (APM): per-point ambiguity a ∈ (0, 1).

↔ ``amcontrast3d_tpu/models/apm.py``.  One Linear → Dropout → BatchNorm →
sigmoid tower per encoder stage (``APM_pf_ConCate``, the default) and the
position-only and attention ablations.  The flax modules create their
layers at the first call and take the input width from the data; here the
widths are explicit: ``feature_dim[stage]`` for the per-stage modules, 3
for positions.  Submodules keep the flax names (``layer_{s}``, ``map_{s}``,
``ext_{s}``, ``att_{s}``, ``Dense_i``, ``BatchNorm_i``, ``_SigmoidTower_0``,
``Attention_0``, ``gcnconv``), so ``from_jax_variables`` maps weights leaf
by leaf.  Every ``forward`` takes ``(p, f, stage, generator)`` and returns
a (B, N, 1), or ``(a, a_map (B, N, D))`` with ``linear_mapping``.  The
refinement's settings in ``APM_args`` (``nsample_k``, ``threshold``,
``gamma``, ``fusion``, …) are read by the model, not here: ``make_module``
hands a constructor only the keys it names.  ``dtype`` is the compute
type of every Linear (the JAX modules' field): the towers' BatchNorms
return float32, so ``a`` is float32, and the lifted map, the attention and
the graph ablation's output are in ``dtype``.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from ..ops.group import group_points
from ..ops.knn import knn
from .build import MODELS
from .layers import Dense, Dropout, batch_norm, rounded


class _SigmoidTower(nn.Module):
    """Linear → Dropout → BatchNorm → sigmoid per entry of ``channels``,
    then a 1-channel Linear → BatchNorm → sigmoid head."""

    def __init__(self, in_channels: int, channels: Sequence[int],
                 dropout: Sequence[float], dtype=None):
        super().__init__()
        self.n = len(channels)
        cin = in_channels
        for i, ch in enumerate(list(channels) + [1]):
            self.add_module(f"Dense_{i}", Dense(cin, ch, dtype=dtype))
            if i < min(self.n, len(dropout)) and dropout[i]:
                self.add_module(f"Dropout_{i}", Dropout(dropout[i]))
            self.add_module(f"BatchNorm_{i}", batch_norm(ch))
            cin = ch

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for i in range(self.n + 1):
            x = getattr(self, f"Dense_{i}")(x)
            drop = getattr(self, f"Dropout_{i}", None)
            if drop is not None:
                x = drop(x, generator)
            x = torch.sigmoid(getattr(self, f"BatchNorm_{i}")(x))
        return x


@MODELS.register_module()
class APM_pf_ConCate(nn.Module):
    """Concat(p, f) → a (the default APM)."""

    def __init__(self, feature_dim: Sequence[int] = (64, 128, 256, 512),
                 linear_mapping: bool = True,
                 channel: Sequence[int] = (32, 16, 8, 4, 2),
                 dropout: Sequence[float] = (0, 0, 0, 0, 0), dtype=None):
        super().__init__()
        self.feature_dim, self.linear_mapping = list(feature_dim), linear_mapping
        for s, d in enumerate(self.feature_dim):
            self.add_module(f"layer_{s}", _SigmoidTower(3 + d, channel, dropout,
                                                        dtype))
            if linear_mapping:
                self.add_module(f"map_{s}", Dense(1, d, dtype=dtype))

    def forward(self, p, f, stage: int,
                generator: Optional[torch.Generator] = None):
        if f.shape[-1] != self.feature_dim[stage]:
            raise ValueError(f"stage {stage} feature dim {f.shape[-1]} != "
                             f"{self.feature_dim[stage]}")
        a = getattr(self, f"layer_{stage}")(torch.cat([p, f], -1), generator)
        if self.linear_mapping:
            return a, torch.sigmoid(getattr(self, f"map_{stage}")(a))
        return a


@MODELS.register_module()
class APM_p(nn.Module):
    """Position-only MLP ablation."""

    def __init__(self, channel: Sequence[int] = (32, 16, 8, 4, 2),
                 dropout: Sequence[float] = (0, 0, 0, 0, 0), dtype=None):
        super().__init__()
        self.add_module("_SigmoidTower_0", _SigmoidTower(3, channel, dropout,
                                                         dtype))

    def forward(self, p, f=None, stage: int = 0,
                generator: Optional[torch.Generator] = None):
        return getattr(self, "_SigmoidTower_0")(p, generator)


@MODELS.register_module()
class APM_p_Group(nn.Module):
    """kNN relative positions → shared Linear → ReLU → max-pool → tower."""

    def __init__(self, k: int = 12,
                 channel: Sequence[int] = (32, 16, 8, 4, 2),
                 dropout: Sequence[float] = (0, 0, 0, 0, 0), dtype=None):
        super().__init__()
        self.k = k
        self.Dense_0 = Dense(3, channel[0], dtype=dtype)
        self.add_module("_SigmoidTower_0", _SigmoidTower(
            channel[0], channel[1:], dropout[1:], dtype))

    def forward(self, p, f=None, stage: int = 0,
                generator: Optional[torch.Generator] = None):
        idx, _ = knn(p, p, self.k)
        rel = group_points(p, idx) - p[:, :, None, :]            # (B, N, k, 3)
        h = torch.amax(torch.relu(self.Dense_0(rel)), dim=-2)
        return getattr(self, "_SigmoidTower_0")(h, generator)


class Attention(nn.Module):
    """QKV cross-attention: x gives Q, y gives K and V; softmax over the
    points of y, scaled by √dim_out."""

    def __init__(self, dim_q: int, dim_kv: int, dim_out: int, dtype=None):
        super().__init__()
        self.dim_out = dim_out
        self.Dense_0 = Dense(dim_q, dim_out, dtype=dtype)
        self.Dense_1 = Dense(dim_kv, dim_out, dtype=dtype)
        self.Dense_2 = Dense(dim_kv, dim_out, dtype=dtype)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        q, k, v = self.Dense_0(x), self.Dense_1(y), self.Dense_2(y)
        attn = torch.matmul(q, k.transpose(1, 2)) / rounded(
            math.sqrt(float(self.dim_out)), q.dtype)
        return torch.matmul(torch.softmax(attn, -1), v)


@MODELS.register_module()
class APM_pf_CrossAtt(nn.Module):
    """Lifted positions cross-attend the features, then the tower."""

    def __init__(self, feature_dim: Sequence[int] = (64, 128, 256, 512),
                 channel: Sequence[int] = (32, 16, 8, 4, 2),
                 dropout: Sequence[float] = (0, 0, 0, 0, 0),
                 linear_mapping: bool = False, dtype=None):
        super().__init__()
        self.feature_dim, self.linear_mapping = list(feature_dim), linear_mapping
        for s, d in enumerate(self.feature_dim):
            self.add_module(f"ext_{s}", Dense(3, d, dtype=dtype))
            self.add_module(f"att_{s}", Attention(d, d, d, dtype))
            self.add_module(f"layer_{s}", _SigmoidTower(d, channel, dropout,
                                                        dtype))
            if linear_mapping:
                self.add_module(f"map_{s}", Dense(1, d, dtype=dtype))

    def forward(self, p, f, stage: int,
                generator: Optional[torch.Generator] = None):
        h = getattr(self, f"att_{stage}")(getattr(self, f"ext_{stage}")(p), f)
        a = getattr(self, f"layer_{stage}")(h, generator)
        if self.linear_mapping:
            return a, torch.sigmoid(getattr(self, f"map_{stage}")(a))
        return a


@MODELS.register_module()
class APM_p_Graph(nn.Module):
    """Star-graph GCN ablation in its closed form: with x₀ = pᵢ and
    x_j = |pᵢ − p_{n_j}| over the k − 1 nearest neighbours,
    ``out_i = W·[x₀·(1 + (k−1)/√2) + ½·Σ_j x_j] / k + b``; no sigmoid."""

    def __init__(self, nsample_k: int = 12, dtype=None):
        super().__init__()
        self.nsample_k = nsample_k
        self.gcnconv = Dense(3, 1, dtype=dtype)

    def forward(self, p, f=None, stage: int = 0,
                generator: Optional[torch.Generator] = None):
        k = self.nsample_k
        idx, _ = knn(p, p, k)
        rel = (group_points(p, idx[..., 1:]) - p[:, :, None, :]).abs()
        agg = (p * (1.0 + (k - 1) / math.sqrt(2.0)) + 0.5 * rel.sum(-2)) / float(k)
        return self.gcnconv(agg)


@MODELS.register_module()
class APM_pp_SelfAtt(nn.Module):
    """Self-attention over the positions, then the tower."""

    def __init__(self, att_dim: int = 16,
                 channel: Sequence[int] = (32, 16, 8, 4, 2),
                 dropout: Sequence[float] = (0, 0, 0, 0, 0), dtype=None):
        super().__init__()
        self.Attention_0 = Attention(3, 3, att_dim, dtype)
        self.add_module("_SigmoidTower_0", _SigmoidTower(att_dim, channel,
                                                         dropout, dtype))

    def forward(self, p, f=None, stage: int = 0,
                generator: Optional[torch.Generator] = None):
        return getattr(self, "_SigmoidTower_0")(self.Attention_0(p, p), generator)
