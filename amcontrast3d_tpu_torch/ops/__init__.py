from .aggregate import (agg_fused_enabled, aggregate_backward,
                        aggregate_backward_plain, aggregate_forward,
                        aggregate_forward_plain, grouped_slot_reduce,
                        grouped_slot_reduce_plain, set_agg_fused)
from .ambiguity import ambiguity_from_stats, ambiguity_function
from .contrast import (contrast_forward, contrast_forward_plain,
                       contrast_grad_rows, contrast_grad_rows_plain,
                       contrast_grad_support, contrast_grad_support_plain,
                       contrast_reductions, contrast_reductions_plain,
                       contrast_reductions_selfk,
                       contrast_reductions_selfk_plain, contrast_select,
                       contrast_select_plain, label_vote, label_vote_plain)
from .fps import (fps_is_pruned, furthest_point_sample,
                  furthest_point_sample_b1, furthest_point_sample_plain,
                  furthest_point_sample_pruned)
from .group import (CHANNEL_MAP, Grouper, clamp_members_valid, create_grouper,
                    gather_points, get_aggregation_features, group_points)
from .interpolate import (backward_is_big, forward_is_big, three_interpolate,
                          three_interpolation, three_interpolation_backward,
                          three_interpolation_backward_big,
                          three_interpolation_backward_plain,
                          three_interpolation_backward_small,
                          three_interpolation_big, three_interpolation_plain,
                          three_interpolation_small,
                          three_interpolation_weights, three_nn)
from .knn import (ball_query, ball_query_plain, knn, knn_plain,
                  set_knn_backend, use_approx)
from .refine import (dual_masks_cross, dual_masks_cross_plain, refine_cross,
                     refine_cross_backward, refine_cross_backward_plain,
                     refine_cross_plain)

__all__ = [
    "agg_fused_enabled", "aggregate_backward",
    "aggregate_backward_plain", "aggregate_forward", "aggregate_forward_plain",
    "grouped_slot_reduce", "grouped_slot_reduce_plain", "set_agg_fused",
    "ambiguity_from_stats", "ambiguity_function",
    "contrast_forward", "contrast_forward_plain", "contrast_grad_rows",
    "contrast_grad_rows_plain", "contrast_grad_support",
    "contrast_grad_support_plain", "contrast_reductions",
    "contrast_reductions_plain", "contrast_reductions_selfk",
    "contrast_reductions_selfk_plain", "contrast_select",
    "contrast_select_plain", "label_vote",
    "label_vote_plain",
    "fps_is_pruned", "furthest_point_sample", "furthest_point_sample_b1",
    "furthest_point_sample_plain", "furthest_point_sample_pruned",
    "CHANNEL_MAP", "Grouper", "clamp_members_valid", "create_grouper",
    "gather_points", "get_aggregation_features", "group_points",
    "backward_is_big", "forward_is_big", "three_interpolate",
    "three_interpolation", "three_interpolation_backward",
    "three_interpolation_backward_big", "three_interpolation_backward_plain",
    "three_interpolation_backward_small", "three_interpolation_big",
    "three_interpolation_plain", "three_interpolation_small",
    "three_interpolation_weights",
    "three_nn", "ball_query", "ball_query_plain", "knn", "knn_plain",
    "set_knn_backend", "use_approx",
    "dual_masks_cross", "dual_masks_cross_plain", "refine_cross",
    "refine_cross_backward", "refine_cross_backward_plain",
    "refine_cross_plain",
]
