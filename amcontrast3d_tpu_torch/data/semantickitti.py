"""SemanticKITTI file helpers of the whole-scene test.

↔ ``amcontrast3d_tpu/data/semantickitti.py``: the label tables (the
standard semantic-kitti.yaml learning map; 'unlabeled' becomes −1 =
ignore), the ``.bin`` / ``.label`` readers and the sequence file list.
The ``SemanticKITTI`` dataset class waits for the train CLI (ROADMAP.md).
"""
from __future__ import annotations

import os
from os.path import join

import numpy as np

# semantic-kitti.yaml learning_map (public dataset constant)
_LEARNING_MAP = {
    0: 0, 1: 0, 10: 1, 11: 2, 13: 5, 15: 3, 16: 5, 18: 4, 20: 5, 30: 6,
    31: 7, 32: 8, 40: 9, 44: 10, 48: 11, 49: 12, 50: 13, 51: 14, 52: 0,
    60: 9, 70: 15, 71: 16, 72: 17, 80: 18, 81: 19, 99: 0, 252: 1, 253: 7,
    254: 6, 255: 8, 256: 5, 257: 5, 258: 4, 259: 5,
}
_LEARNING_MAP_INV = {
    0: 0, 1: 10, 2: 11, 3: 15, 4: 18, 5: 20, 6: 30, 7: 31, 8: 32, 9: 40,
    10: 44, 11: 48, 12: 49, 13: 50, 14: 51, 15: 70, 16: 71, 17: 72,
    18: 80, 19: 81,
}


def _make_lut(mapping, size=260):
    lut = np.zeros(size, dtype=np.int32)
    for k, v in mapping.items():
        lut[k] = v
    return lut


remap_lut_read = _make_lut(_LEARNING_MAP)
remap_lut_write = _make_lut(_LEARNING_MAP_INV, size=20)


def load_pc_kitti(pc_path: str) -> np.ndarray:
    scan = np.fromfile(pc_path, dtype=np.float32).reshape(-1, 4)
    return scan[:, 0:3]


def load_label_kitti(label_path: str, remap_lut: np.ndarray) -> np.ndarray:
    label = np.fromfile(label_path, dtype=np.uint32).reshape(-1)
    sem_label = label & 0xFFFF
    return (remap_lut[sem_label] - 1).astype(np.int32)  # unlabeled → −1


def get_semantickitti_file_list(dataset_path: str, test_seq_num: str):
    """(train, val, test) lists of [velodyne .bin, .label] path pairs."""
    seq_list = np.sort(os.listdir(dataset_path))
    train_list, val_list, test_list = [], [], []
    for seq_id in seq_list:
        seq_path = join(dataset_path, seq_id)
        pc_path = join(seq_path, 'velodyne')
        label_path = join(seq_path, 'labels')
        if not os.path.isdir(pc_path):
            continue
        pairs = [[join(pc_path, f), join(label_path, f.replace('bin', 'label'))]
                 for f in np.sort(os.listdir(pc_path))]
        if seq_id == '08':
            val_list.extend(pairs)
            if seq_id == test_seq_num:
                test_list.extend(pairs)
        elif int(seq_id) >= 11 and seq_id == test_seq_num:
            test_list.extend(pairs)
        elif seq_id in ['00', '01', '02', '03', '04', '05', '06', '07',
                        '09', '10']:
            train_list.extend(pairs)
    return train_list, val_list, test_list
