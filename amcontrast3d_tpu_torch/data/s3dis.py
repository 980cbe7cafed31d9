"""S3DIS dataset (↔ openpoints/dataset/s3dis/s3dis.py:12-148).

Loads ``raw/Area_*.npy`` rooms (xyzrgb+label), voxel-downsamples at 0.04 m,
crops to ``voxel_max`` points at train time, loops the room list, optional
presample pickle cache — identical recipe and hyperparameters.
"""
from __future__ import annotations

import logging
import os
import pickle
from typing import Optional

import numpy as np

from .build import DATASETS
from .data_util import crop_pc, voxelize


@DATASETS.register_module()
class S3DIS:
    classes = ['ceiling', 'floor', 'wall', 'beam', 'column', 'window', 'door',
               'chair', 'table', 'bookcase', 'sofa', 'board', 'clutter']
    num_classes = 13
    num_per_class = np.array([3370714, 2856755, 4919229, 318158, 375640,
                              478001, 974733, 650464, 791496, 88727, 1284130,
                              229758, 2272837], dtype=np.int32)
    class2color = {'ceiling': [150, 218, 228], 'floor': [143, 223, 142],
                   'wall': [171, 198, 230], 'beam': [255, 255, 0],
                   'column': [219, 219, 146], 'window': [197, 176, 212],
                   'door': [222, 40, 47], 'chair': [189, 189, 57],
                   'table': [255, 152, 153], 'bookcase': [150, 103, 185],
                   'sofa': [144, 86, 76], 'board': [200, 156, 149],
                   'clutter': [255, 188, 126]}
    cmap = [*class2color.values()]
    gravity_dim = 2

    def __init__(self, data_root: str = 'data/S3DIS/s3disfull',
                 test_area: int = 5, voxel_size: float = 0.04,
                 voxel_max: Optional[int] = None, split: str = 'train',
                 transform=None, loop: int = 1, presample: bool = False,
                 variable: bool = False, shuffle: bool = True, **kwargs):
        self.split, self.voxel_size, self.transform = split, voxel_size, transform
        self.voxel_max, self.loop = voxel_max, loop
        self.presample = presample
        self.variable = variable
        self.shuffle = shuffle

        raw_root = os.path.join(data_root, 'raw')
        self.raw_root = raw_root
        data_list = sorted(os.listdir(raw_root))
        data_list = [item[:-4] for item in data_list if 'Area_' in item]
        if split == 'train':
            self.data_list = [i for i in data_list
                              if f'Area_{test_area}' not in i]
        else:
            self.data_list = [i for i in data_list if f'Area_{test_area}' in i]

        processed_root = os.path.join(data_root, 'processed')
        filename = os.path.join(
            processed_root,
            f's3dis_{split}_area{test_area}_{voxel_size:.3f}_{voxel_max}.pkl')
        if presample and not os.path.exists(filename):
            np.random.seed(0)
            self.data = []
            for item in self.data_list:
                cdata = np.load(os.path.join(raw_root, item + '.npy')).astype(np.float32)
                cdata[:, :3] -= np.min(cdata[:, :3], 0)
                if voxel_size:
                    coord = cdata[:, 0:3]
                    uniq_idx = voxelize(coord, voxel_size)
                    cdata = cdata[uniq_idx]
                self.data.append(cdata)
            os.makedirs(processed_root, exist_ok=True)
            with open(filename, 'wb') as f:
                pickle.dump(self.data, f)
            logging.info("presample cache saved: %s", filename)
        elif presample:
            with open(filename, 'rb') as f:
                self.data = pickle.load(f)
        self.data_idx = np.arange(len(self.data_list))
        assert len(self.data_idx) > 0

    def __getitem__(self, idx):
        data_idx = self.data_idx[idx % len(self.data_idx)]
        if self.presample:
            coord, feat, label = np.split(self.data[data_idx], [3, 6], axis=1)
        else:
            cdata = np.load(os.path.join(
                self.raw_root, self.data_list[data_idx] + '.npy')).astype(np.float32)
            cdata[:, :3] -= np.min(cdata[:, :3], 0)
            coord, feat, label = cdata[:, :3], cdata[:, 3:6], cdata[:, 6:7]
            coord, feat, label = crop_pc(
                coord, feat, label, self.split, self.voxel_size, self.voxel_max,
                downsample=not self.presample, variable=self.variable,
                shuffle=self.shuffle)
        label = label.squeeze(-1).astype(np.int64)
        data = {'pos': coord.astype(np.float32),
                'x': feat.astype(np.float32), 'y': label}
        if self.transform is not None:
            data = self.transform(data)
        if 'heights' not in data:
            g = self.gravity_dim
            data['heights'] = data['pos'][:, g:g + 1].astype(np.float32)
        return data

    def __len__(self):
        return len(self.data_idx) * self.loop
