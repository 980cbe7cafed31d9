from .build import (MODELS, build_model_from_cfg, filter_kwargs, init_weights_,
                    make_module)
from .layers import ConvBlock, create_act
from .pointnext import (FeaturePropagation, InvResMLP, LocalAggregation,
                        PointNextDecoder, PointNextEncoder, SegHead,
                        SetAbstraction)
from .base_seg import BaseSeg, BaseSeg_AMContrast3D

__all__ = [
    "MODELS", "build_model_from_cfg", "filter_kwargs", "init_weights_",
    "make_module", "ConvBlock", "create_act",
    "FeaturePropagation", "InvResMLP", "LocalAggregation",
    "PointNextDecoder", "PointNextEncoder", "SegHead", "SetAbstraction",
    "BaseSeg", "BaseSeg_AMContrast3D",
]
