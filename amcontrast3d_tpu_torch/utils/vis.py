"""Headless point-cloud writers (↔ ``amcontrast3d_tpu/utils/vis.py``:
``labels_to_colors``, ``write_obj``, ``read_obj``, copied).

Colors are produced from labels via a colormap and written to .obj for any
viewer.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np


def labels_to_colors(labels: np.ndarray, cmap=None) -> np.ndarray:
    labels = np.asarray(labels).astype(np.int64)
    if cmap is None:
        rng = np.random.RandomState(42)
        cmap = rng.randint(0, 255, (max(labels.max() + 1, 1), 3))
    cmap = np.asarray(cmap)
    return cmap[labels] / (255.0 if cmap.max() > 1 else 1.0)


def write_obj(points: np.ndarray, colors: Optional[np.ndarray], out_file: str):
    """v x y z r g b lines (↔ vis3d.py write_obj / vis.py:60-66)."""
    os.makedirs(os.path.dirname(os.path.abspath(out_file)), exist_ok=True)
    points = np.asarray(points)
    with open(out_file, "w") as f:
        for i in range(len(points)):
            if colors is not None:
                c = colors[i]
                f.write("v %.4f %.4f %.4f %f %f %f\n" % (
                    points[i, 0], points[i, 1], points[i, 2], c[0], c[1], c[2]))
            else:
                f.write("v %.4f %.4f %.4f\n" % tuple(points[i, :3]))


def read_obj(path: str):
    pts, cols = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                vals = line.split()[1:]
                pts.append([float(v) for v in vals[:3]])
                if len(vals) >= 6:
                    cols.append([float(v) for v in vals[3:6]])
    return (np.asarray(pts, np.float32),
            np.asarray(cols, np.float32) if cols else None)
