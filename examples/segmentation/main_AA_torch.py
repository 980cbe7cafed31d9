"""AMContrast3D (AA) through the PyTorch + CUDA port — the counterpart of
``main_AA.py``:

    python examples/segmentation/main_AA_torch.py \
        --cfg cfgs/s3dis/AMContrast3D-AA.yaml mode=test [--device cpu] ...
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from amcontrast3d_tpu_torch.engine.cli import main_cli  # noqa: E402

if __name__ == "__main__":
    main_cli("aa")
