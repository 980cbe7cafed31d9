"""S3DIS sphere-sampling dataset (↔ openpoints/dataset/s3dis/s3dis_sphere.py).

Alternative protocol to whole-room cropping: clouds are pre-subsampled with
the native C++ grid subsampler (barycenter voxels — the reference uses its
``grid_subsampling`` extension for the same), then training samples are
spheres of ``in_radius`` drawn by *potential-based* sampling: every point
carries a potential; each step picks the least-visited (min-potential) point,
returns the sphere around it, and bumps the potentials of points in the
sphere by ``(1 − d²/r²)²`` so later spheres cover other regions — the
KPConv-style scheme the reference inherits.

Host KD-trees come from scipy (cKDTree) — radius search is a host-side
preprocessing concern, not a device op.

Data layout: reads the same ``raw/Area_*.npy`` rooms as the main S3DIS
dataset (xyzrgb+label), not the Stanford Annotations folders.
"""
from __future__ import annotations

import logging
import os
import pickle

import numpy as np

from .build import DATASETS


@DATASETS.register_module()
class S3DISSphere:
    classes = ['ceiling', 'floor', 'wall', 'beam', 'column', 'window', 'door',
               'chair', 'table', 'bookcase', 'sofa', 'board', 'clutter']
    num_classes = 13
    color_mean = np.array([0.5136457, 0.49523646, 0.44921124])
    color_std = np.array([0.18308958, 0.18415008, 0.19252081])
    gravity_dim = 2

    def __init__(self, voxel_size: float = 0.04, in_radius: float = 2.0,
                 num_points: int = 15000, num_steps: int = 2000,
                 num_epochs: int = 100, data_root: str = 'data/S3DIS/s3disfull',
                 transform=None, split: str = 'train', test_area: int = 5,
                 centering: bool = False, **kwargs):
        from scipy.spatial import cKDTree

        self.voxel_size = voxel_size
        self.in_radius = in_radius
        self.num_points = num_points
        self.num_steps = num_steps
        self.transform = transform
        self.split = split
        self.centering = centering
        self.epoch = 0

        raw_root = os.path.join(data_root, 'raw')
        data_list = sorted(f[:-4] for f in os.listdir(raw_root) if 'Area_' in f)
        if split == 'train':
            rooms = [r for r in data_list if f'Area_{test_area}' not in r]
        else:
            rooms = [r for r in data_list if f'Area_{test_area}' in r]

        processed = os.path.join(data_root, 'processed')
        os.makedirs(processed, exist_ok=True)
        cache = os.path.join(processed,
                             f'sphere_{split}_{voxel_size:.3f}.pkl')
        if os.path.exists(cache):
            with open(cache, 'rb') as f:
                self.clouds = pickle.load(f)
        else:
            from .data_util import grid_subsampling
            self.clouds = []
            for room in rooms:
                cdata = np.load(os.path.join(raw_root, room + '.npy')).astype(np.float32)
                pts, colors, labels = cdata[:, :3], cdata[:, 3:6], cdata[:, 6].astype(np.int32)
                sp, sc, sl = grid_subsampling(pts, colors, labels,
                                              sampleDl=voxel_size)
                self.clouds.append((sp, sc, sl.astype(np.int64)))
            with open(cache, 'wb') as f:
                pickle.dump(self.clouds, f)
            logging.info("sphere cache saved: %s", cache)

        self.trees = [cKDTree(c[0]) for c in self.clouds]

        # validation projection inds: every ORIGINAL point maps to its nearest
        # subsampled point so the eval protocol scores all raw points
        # (↔ s3dis_sphere.py:256-275 `_proj.pkl`)
        self.projections = self.raw_labels = None
        if split != 'train':
            proj_cache = os.path.join(
                processed, f'sphere_{split}_{voxel_size:.3f}_proj.pkl')
            if os.path.exists(proj_cache):
                with open(proj_cache, 'rb') as f:
                    self.projections, self.raw_labels = pickle.load(f)
            else:
                self.projections, self.raw_labels = [], []
                for room, tree in zip(rooms, self.trees):
                    cdata = np.load(os.path.join(raw_root, room + '.npy'))
                    _, proj = tree.query(cdata[:, :3].astype(np.float32), k=1)
                    self.projections.append(np.asarray(proj, np.int32))
                    self.raw_labels.append(cdata[:, 6].astype(np.int64))
                with open(proj_cache, 'wb') as f:
                    pickle.dump((self.projections, self.raw_labels), f)
        # potential-based sampling state (one potential per subsampled point)
        rng = np.random.RandomState(42 if split != 'train' else None)
        self.potentials = [rng.rand(len(c[0])).astype(np.float64) * 1e-3
                           for c in self.clouds]
        self.argmins = [int(np.argmin(p)) for p in self.potentials]

    def __len__(self):
        return self.num_steps

    def _pick(self):
        cloud_idx = int(np.argmin([p[a] for p, a in
                                   zip(self.potentials, self.argmins)]))
        point_idx = self.argmins[cloud_idx]
        return cloud_idx, point_idx

    def __getitem__(self, idx):
        cloud_idx, point_idx = self._pick()
        points, colors, labels = self.clouds[cloud_idx]
        center = points[point_idx].copy()
        if self.split == 'train':
            center[:2] += np.random.normal(scale=self.in_radius / 10, size=2)
        neighbors = self.trees[cloud_idx].query_ball_point(center, self.in_radius)
        neighbors = np.asarray(neighbors, dtype=np.int64)
        if len(neighbors) == 0:
            neighbors = np.array([point_idx], dtype=np.int64)
        # update potentials: visited points become less likely
        d2 = np.sum((points[neighbors] - center) ** 2, axis=1)
        self.potentials[cloud_idx][neighbors] += \
            np.square(1.0 - d2 / (self.in_radius ** 2))
        self.argmins[cloud_idx] = int(np.argmin(self.potentials[cloud_idx]))

        if len(neighbors) > self.num_points:
            sel = np.random.choice(len(neighbors), self.num_points,
                                   replace=False)
            neighbors = neighbors[sel]
        elif len(neighbors) < self.num_points:
            pad = np.random.choice(len(neighbors),
                                   self.num_points - len(neighbors))
            neighbors = np.concatenate([neighbors, neighbors[pad]])

        pos = points[neighbors] - (center if self.centering else points[neighbors].min(0))
        x = colors[neighbors] / 255.0 if colors.max() > 1 else colors[neighbors]
        data = {'pos': pos.astype(np.float32),
                'x': (x * 255.0).astype(np.float32),
                'y': labels[neighbors],
                'cloud_idx': np.int64(cloud_idx),
                'point_idx': neighbors}
        if self.transform is not None:
            data = self.transform(data)
        if 'heights' not in data:
            data['heights'] = data['pos'][:, 2:3].astype(np.float32)
        return data
