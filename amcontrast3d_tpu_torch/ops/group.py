"""Gather / group ops and the grouper front-end.

↔ ``amcontrast3d_tpu/ops/group.py``.  In JAX these are XLA gathers; here
they are ``torch.gather`` with int64 indices, at the dtype of what they
gather (bfloat16 too, the gather tail's ``w_f(f)`` under ``use_amp``), on
the card and on the CPU alike.  No kernel.  Layout is
channels-last: features (B, N, C), grouped neighbourhoods (B, M, K, C).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .knn import ball_query, knn


def gather_points(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, C), idx (B, M) → (B, M, C)."""
    idx = idx.long()[..., None].expand(-1, -1, x.shape[-1])
    return torch.gather(x, 1, idx)


def group_points(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, C), idx (B, M, K) → (B, M, K, C)."""
    B, M, K = idx.shape
    return gather_points(x, idx.reshape(B, M * K)).view(B, M, K, x.shape[-1])


def clamp_members_valid(idx: torch.Tensor,
                        n_valid: Optional[torch.Tensor]) -> torch.Tensor:
    """Replace members that index padded support rows (idx ≥ n_valid) with
    the query's first member; the identity when ``n_valid`` is None."""
    if n_valid is None:
        return idx
    return torch.where(idx < n_valid[:, None, None], idx, idx[:, :, :1])


class Grouper(NamedTuple):
    """A configured neighbourhood grouper (↔ ``create_grouper``).

    method: 'ballquery' | 'knn' | 'all'
    """
    method: str
    radius: Optional[float]
    nsample: Optional[int]
    relative_xyz: bool = True
    normalize_dp: bool = False

    def indices(self, query_xyz: torch.Tensor, support_xyz: torch.Tensor
                ) -> Optional[torch.Tensor]:
        """The (B, M, K) grouping indices (None for 'all')."""
        if self.method == "all":
            return None
        if self.method == "ballquery":
            return ball_query(support_xyz, query_xyz, self.radius, self.nsample)
        if self.method == "knn":
            return knn(support_xyz, query_xyz, self.nsample)[0]
        raise ValueError(f"unknown grouper {self.method}")

    def __call__(self, query_xyz: torch.Tensor, support_xyz: torch.Tensor,
                 features: Optional[torch.Tensor] = None,
                 idx: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Returns (dp (B, M, K, 3), fj (B, M, K, C) or None); ``idx``:
        :meth:`indices`, taken here when not given."""
        if self.method == "all":
            # one group holding every point, absolute coordinates
            fj = features[:, None] if features is not None else None
            return support_xyz[:, None], fj
        if idx is None:
            idx = self.indices(query_xyz, support_xyz)
        grouped_xyz = group_points(support_xyz, idx)
        if self.relative_xyz:
            grouped_xyz = grouped_xyz - query_xyz[:, :, None, :]
            if self.normalize_dp and self.method == "ballquery":
                grouped_xyz = grouped_xyz / self.radius
        fj = group_points(features, idx) if features is not None else None
        return grouped_xyz, fj


def create_grouper(group_args) -> Grouper:
    ga = dict(group_args) if group_args is not None else {}
    method = ga.get("NAME", "ballquery")
    nsample = ga.get("nsample", 20)
    if nsample is None:
        method = "all"
    return Grouper(method=method, radius=ga.get("radius", 0.1),
                   nsample=nsample,
                   relative_xyz=ga.get("relative_xyz", True),
                   normalize_dp=ga.get("normalize_dp", False))


def get_aggregation_features(p: torch.Tensor, dp: torch.Tensor,
                             f: Optional[torch.Tensor], fj: torch.Tensor,
                             feature_type: str = "dp_fj") -> torch.Tensor:
    """p (B, M, 3) query positions, dp (B, M, K, 3), f (B, M, C) centre
    features (only for the ``*_df`` types), fj (B, M, K, C)."""
    if feature_type == "dp_fj":
        return torch.cat([dp, fj], -1)
    if feature_type == "dp_fj_df":
        return torch.cat([dp, fj, fj - f[:, :, None, :]], -1)
    if feature_type == "pi_dp_fj_df":
        pi = p[:, :, None, :].expand_as(dp)
        return torch.cat([pi, dp, fj, fj - f[:, :, None, :]], -1)
    if feature_type == "dp_df":
        return torch.cat([dp, fj - f[:, :, None, :]], -1)
    raise ValueError(f"unknown feature_type {feature_type}")


# feature_type → input channel count of the first conv after grouping
CHANNEL_MAP = {
    "dp_fj": lambda x: 3 + x,
    "dp_fj_df": lambda x: x * 2 + 3,
    "pi_dp_fj_df": lambda x: x * 2 + 6,
    "dp_df": lambda x: x + 3,
}
