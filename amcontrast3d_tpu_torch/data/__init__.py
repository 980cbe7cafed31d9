from .build import (DATASETS, NumpyLoader, build_dataloader_from_cfg,
                    build_dataset_from_cfg, concat_collate_fn,
                    stack_collate_fn)
from .data_util import (bucket_size, crop_pc, get_class_weights,
                        get_features_by_keys, grid_subsampling, pad_cloud,
                        voxelize)
from . import s3dis, s3dis_sphere, scannet, synthetic  # noqa: F401  (register datasets)
from .s3dis import S3DIS
from .s3dis_sphere import S3DISSphere
from .scannet import ScanNet
from .synthetic import Synthetic, make_room

__all__ = ["DATASETS", "NumpyLoader", "build_dataloader_from_cfg",
           "build_dataset_from_cfg", "concat_collate_fn", "stack_collate_fn",
           "bucket_size", "crop_pc", "get_class_weights",
           "get_features_by_keys", "grid_subsampling", "pad_cloud",
           "voxelize", "S3DIS", "S3DISSphere", "ScanNet", "Synthetic",
           "make_room"]
