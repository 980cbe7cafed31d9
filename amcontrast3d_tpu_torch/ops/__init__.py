from .ambiguity import ambiguity_from_stats, ambiguity_function
from .contrast import (contrast_forward, contrast_forward_plain,
                       contrast_grad_rows, contrast_grad_rows_plain,
                       contrast_grad_support, contrast_grad_support_plain,
                       contrast_reductions, contrast_reductions_plain)
from .fps import furthest_point_sample, furthest_point_sample_plain
from .group import (CHANNEL_MAP, Grouper, clamp_members_valid, create_grouper,
                    gather_points, get_aggregation_features, group_points)
from .interpolate import (three_interpolate, three_interpolation,
                          three_interpolation_backward,
                          three_interpolation_backward_plain,
                          three_interpolation_plain,
                          three_interpolation_weights, three_nn)
from .knn import ball_query, ball_query_plain, knn, knn_plain
from .refine import (dual_masks_cross, dual_masks_cross_plain, refine_cross,
                     refine_cross_backward, refine_cross_backward_plain,
                     refine_cross_plain)

__all__ = [
    "ambiguity_from_stats", "ambiguity_function",
    "contrast_forward", "contrast_forward_plain", "contrast_grad_rows",
    "contrast_grad_rows_plain", "contrast_grad_support",
    "contrast_grad_support_plain", "contrast_reductions",
    "contrast_reductions_plain",
    "furthest_point_sample", "furthest_point_sample_plain",
    "CHANNEL_MAP", "Grouper", "clamp_members_valid", "create_grouper",
    "gather_points", "get_aggregation_features", "group_points",
    "three_interpolate", "three_interpolation", "three_interpolation_backward",
    "three_interpolation_backward_plain", "three_interpolation_plain",
    "three_interpolation_weights",
    "three_nn", "ball_query", "ball_query_plain", "knn", "knn_plain",
    "dual_masks_cross", "dual_masks_cross_plain", "refine_cross",
    "refine_cross_backward", "refine_cross_backward_plain",
    "refine_cross_plain",
]
