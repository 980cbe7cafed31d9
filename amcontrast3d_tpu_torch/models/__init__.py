from .build import (MODELS, build_model_from_cfg, filter_kwargs,
                    init_train_weights_, init_weights_, make_module)
from .layers import ConvBlock, create_act
from .pointnext import (FeaturePropagation, InvResMLP, LocalAggregation,
                        PointNextDecoder, PointNextEncoder, SegHead,
                        SetAbstraction)
from .apm import (APM_p, APM_p_Graph, APM_p_Group, APM_pf_ConCate,
                  APM_pf_CrossAtt, APM_pp_SelfAtt, Attention)
from .base_seg import (BaseSeg, BaseSeg_AMContrast3D,
                       BaseSeg_M_AMContrast3D)

__all__ = [
    "MODELS", "build_model_from_cfg", "filter_kwargs", "init_train_weights_",
    "init_weights_", "make_module", "ConvBlock", "create_act",
    "FeaturePropagation", "InvResMLP", "LocalAggregation",
    "PointNextDecoder", "PointNextEncoder", "SegHead", "SetAbstraction",
    "APM_p", "APM_p_Graph", "APM_p_Group", "APM_pf_ConCate",
    "APM_pf_CrossAtt", "APM_pp_SelfAtt", "Attention",
    "BaseSeg", "BaseSeg_AMContrast3D", "BaseSeg_M_AMContrast3D",
]
