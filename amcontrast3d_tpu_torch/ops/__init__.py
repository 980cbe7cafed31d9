from .ambiguity import ambiguity_from_stats, ambiguity_function
from .contrast import (contrast_forward, contrast_forward_plain,
                       contrast_grad_rows, contrast_grad_rows_plain,
                       contrast_grad_support, contrast_grad_support_plain,
                       contrast_reductions, contrast_reductions_plain)
from .fps import (fps_is_pruned, furthest_point_sample,
                  furthest_point_sample_b1, furthest_point_sample_plain,
                  furthest_point_sample_pruned)
from .group import (CHANNEL_MAP, Grouper, clamp_members_valid, create_grouper,
                    gather_points, get_aggregation_features, group_points)
from .interpolate import (forward_is_big, three_interpolate,
                          three_interpolation, three_interpolation_backward,
                          three_interpolation_backward_big,
                          three_interpolation_backward_plain,
                          three_interpolation_backward_small,
                          three_interpolation_big, three_interpolation_plain,
                          three_interpolation_small,
                          three_interpolation_weights, three_nn)
from .knn import (ball_query, ball_query_big, ball_query_plain,
                  ball_query_small, knn, knn_big, knn_plain, knn_small)
from .refine import (dual_masks_cross, dual_masks_cross_plain, refine_cross,
                     refine_cross_backward, refine_cross_backward_plain,
                     refine_cross_plain)

__all__ = [
    "ambiguity_from_stats", "ambiguity_function",
    "contrast_forward", "contrast_forward_plain", "contrast_grad_rows",
    "contrast_grad_rows_plain", "contrast_grad_support",
    "contrast_grad_support_plain", "contrast_reductions",
    "contrast_reductions_plain",
    "fps_is_pruned", "furthest_point_sample", "furthest_point_sample_b1",
    "furthest_point_sample_plain", "furthest_point_sample_pruned",
    "CHANNEL_MAP", "Grouper", "clamp_members_valid", "create_grouper",
    "gather_points", "get_aggregation_features", "group_points",
    "forward_is_big", "three_interpolate", "three_interpolation",
    "three_interpolation_backward",
    "three_interpolation_backward_big", "three_interpolation_backward_plain",
    "three_interpolation_backward_small", "three_interpolation_big",
    "three_interpolation_plain", "three_interpolation_small",
    "three_interpolation_weights",
    "three_nn", "ball_query", "ball_query_big", "ball_query_plain",
    "ball_query_small", "knn", "knn_big", "knn_plain", "knn_small",
    "dual_masks_cross", "dual_masks_cross_plain", "refine_cross",
    "refine_cross_backward", "refine_cross_backward_plain",
    "refine_cross_plain",
]
