"""AMContrast3D (AA) through the PyTorch + CUDA port — the counterpart of
``main_AA.py``:

    python examples/segmentation/main_AA_torch.py \
        --cfg cfgs/s3dis/AMContrast3D-AA.yaml [--device cpu] \
        [mode=train|resume|finetune|test|val] [pretrained_path=...] ...

Without ``mode`` it trains: loaders, the recipe's train transforms,
validation every ``val_freq`` epochs, ``latest`` and ``best`` checkpoints in
the run directory under ``root_dir``; ``mode=resume pretrained_path=<latest>``
carries on, ``mode=test pretrained_path=<best>`` is the whole-scene test.
The run is on the card unless ``--device cpu`` is given.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from amcontrast3d_tpu_torch.engine.cli import main_cli  # noqa: E402

if __name__ == "__main__":
    main_cli("aa")
