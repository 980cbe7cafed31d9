from .build import DATASETS, build_dataset_from_cfg
from .data_util import (bucket_size, crop_pc, get_class_weights,
                        get_features_by_keys, pad_cloud, voxelize)
from .synthetic import Synthetic, make_room

__all__ = ["DATASETS", "build_dataset_from_cfg", "bucket_size", "crop_pc",
           "get_class_weights", "get_features_by_keys", "pad_cloud",
           "voxelize", "Synthetic", "make_room"]
