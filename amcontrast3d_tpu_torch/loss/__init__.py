from .aef import (NSTRIDE, gather_int, one_hot_labels, stage_ambiguity,
                  stage_neighborhood, subscene_labels)
from .build import (LOSS, CrossEntropy, CrossEntropyAce, CrossEntropyAcePre,
                    build_criterion_from_cfg, cross_entropy)
from .contrast import ambiguity_head, contrast_head, point_contrast_margin

__all__ = [
    "NSTRIDE", "gather_int", "one_hot_labels", "stage_ambiguity",
    "stage_neighborhood", "subscene_labels", "LOSS", "CrossEntropy",
    "CrossEntropyAce", "CrossEntropyAcePre", "build_criterion_from_cfg",
    "cross_entropy", "ambiguity_head", "contrast_head",
    "point_contrast_margin",
]
