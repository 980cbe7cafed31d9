from .fps import furthest_point_sample, furthest_point_sample_plain
from .group import (CHANNEL_MAP, Grouper, clamp_members_valid, create_grouper,
                    gather_points, get_aggregation_features, group_points)
from .interpolate import (three_interpolate, three_interpolation,
                          three_interpolation_plain, three_nn)
from .knn import ball_query, ball_query_plain, knn

__all__ = [
    "furthest_point_sample", "furthest_point_sample_plain",
    "CHANNEL_MAP", "Grouper", "clamp_members_valid", "create_grouper",
    "gather_points", "get_aggregation_features", "group_points",
    "three_interpolate", "three_interpolation", "three_interpolation_plain",
    "three_nn", "ball_query", "ball_query_plain", "knn",
]
