"""The port's day-one real-data drill
(``amcontrast3d_tpu_torch/tools/realdata_smoke.sh``) on the CPU: train →
resume → ``mode=test`` through ``examples/segmentation/main_AA_torch.py``
against fabricated raw S3DIS rooms with the released YAML, only the shapes
shrunk by ``SMOKE_CI``'s overrides.  The fixture rooms are those of
``tests/test_realdata_smoke.py``, made by the port's copy of
``make_room``."""
import csv
import glob
import os
import subprocess

import numpy as np
import pytest

from amcontrast3d_tpu_torch.data.synthetic import make_room

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def s3dis_root(tmp_path):
    rng = np.random.RandomState(3)
    raw = tmp_path / "s3disfull" / "raw"
    raw.mkdir(parents=True)
    for name in ["Area_1_office_1", "Area_2_office_1", "Area_5_office_1"]:
        pos, color, label = make_room(rng, 3000)
        np.save(raw / f"{name}.npy",
                np.hstack([pos, color * 255.0,
                           label[:, None].astype(np.float32)]))
    return str(tmp_path / "s3disfull")


def test_realdata_smoke_script(s3dis_root, tmp_path):
    out = str(tmp_path / "run")
    # one thread a leg: the suite's workers share the cores
    env = {**os.environ, "SMOKE_CI": "1", "SMOKE_EPOCHS": "1",
           "OMP_NUM_THREADS": "1", "CUDA_VISIBLE_DEVICES": ""}
    r = subprocess.run(
        ["bash", os.path.join(REPO, "amcontrast3d_tpu_torch", "tools",
                              "realdata_smoke.sh"), s3dis_root, out],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=1200)
    assert r.returncode == 0, (r.stdout[-3000:], r.stderr[-3000:])
    assert "drill complete" in r.stdout
    # all three legs ran and the CSV has the headline row
    assert "== [2/3] resume" in r.stdout and "== [3/3]" in r.stdout
    csvs = glob.glob(os.path.join(out, "**", "*_test.csv"), recursive=True)
    assert len(csvs) == 1
    rows = list(csv.reader(open(csvs[0])))
    assert rows[0][:5] == ["method", "Area", "OA", "mACC", "mIoU"]
    assert len(rows) == 2
    assert np.isfinite(float(rows[1][4]))
