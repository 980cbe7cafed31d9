"""ScanNet v2 dataset (↔ openpoints/dataset/scannetv2/scannet.py:63-179).

Scenes are ``.pth`` tuples (coord, feat∈[−1,1], label) loaded with torch
(cpu); color rescale ``(feat+1)·127.5``, ignore label −100, voxel 0.02 m.
"""
from __future__ import annotations

import glob
import logging
import os
import pickle
from typing import Optional

import numpy as np

from .build import DATASETS
from .data_util import crop_pc, voxelize


@DATASETS.register_module()
class ScanNet:
    classes = ['wall', 'floor', 'cabinet', 'bed', 'chair', 'sofa', 'table',
               'door', 'window', 'bookshelf', 'picture', 'counter', 'desk',
               'curtain', 'refridgerator', 'shower curtain', 'toilet', 'sink',
               'bathtub', 'otherfurniture']
    num_classes = 20
    ignore_index = -100
    gravity_dim = 2

    def __init__(self, data_root: str = 'data/ScanNet', split: str = 'train',
                 voxel_size: float = 0.02, voxel_max: Optional[int] = None,
                 transform=None, loop: int = 1, presample: bool = False,
                 variable: bool = False, shuffle: bool = True, **kwargs):
        self.split, self.voxel_size, self.transform = split, voxel_size, transform
        self.voxel_max, self.loop = voxel_max, loop
        self.presample = presample
        self.variable = variable
        self.shuffle = shuffle
        self.data_root = data_root

        self.data_list = sorted(
            glob.glob(os.path.join(data_root, split, '*.pth')))
        assert len(self.data_list) > 0, f"no .pth scenes under {data_root}/{split}"

        processed_root = os.path.join(data_root, 'processed')
        filename = os.path.join(
            processed_root,
            f'scannet_{split}_{voxel_size:.3f}_{voxel_max}.pkl')
        if presample and not os.path.exists(filename):
            np.random.seed(0)
            self.data = [self._load_voxelized(p) for p in self.data_list]
            os.makedirs(processed_root, exist_ok=True)
            with open(filename, 'wb') as f:
                pickle.dump(self.data, f)
            logging.info("presample cache saved: %s", filename)
        elif presample:
            with open(filename, 'rb') as f:
                self.data = pickle.load(f)
        self.data_idx = np.arange(len(self.data_list))

    def _load_raw(self, path):
        import torch
        data = torch.load(path, weights_only=False)
        coord, feat = np.asarray(data[0]), np.asarray(data[1])
        label = np.asarray(data[2]) if len(data) > 2 and self.split != 'test' \
            else np.zeros(len(coord))
        feat = np.clip((feat + 1) / 2.0, 0, 1).astype(np.float32)  # scannet.py:149
        return (coord.astype(np.float32), feat,
                label.astype(np.int64))

    def _load_voxelized(self, path):
        coord, feat, label = self._load_raw(path)
        coord -= coord.min(0)
        uniq_idx = voxelize(coord, self.voxel_size)
        return coord[uniq_idx], feat[uniq_idx], label[uniq_idx]

    def __getitem__(self, idx):
        data_idx = self.data_idx[idx % len(self.data_idx)]
        if self.presample:
            coord, feat, label = [a.copy() for a in self.data[data_idx]]
        else:
            coord, feat, label = self._load_raw(self.data_list[data_idx])
            coord, feat, label = crop_pc(
                coord, feat, label, self.split, self.voxel_size, self.voxel_max,
                downsample=not self.presample, variable=self.variable,
                shuffle=self.shuffle)
        data = {'pos': coord.astype(np.float32),
                'x': (feat * 255.0).astype(np.float32),
                'y': label.astype(np.int64)}
        if self.transform is not None:
            data = self.transform(data)
        if 'heights' not in data:
            g = self.gravity_dim
            data['heights'] = data['pos'][:, g:g + 1].astype(np.float32)
        return data

    def __len__(self):
        return len(self.data_idx) * self.loop
