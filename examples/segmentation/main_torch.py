"""The vanilla PointNeXt trainer through the PyTorch + CUDA port — the
counterpart of ``main.py`` (``--kind base``: ``BaseSeg`` with the
``criterion_args`` loss, no contrast):

    python examples/segmentation/main_torch.py \
        --cfg cfgs/s3dis/pointnext-xl.yaml [--device cpu] \
        [mode=train|resume|finetune|test|val] [pretrained_path=...] ...

Without ``mode`` it trains: loaders, the recipe's train transforms,
validation every ``val_freq`` epochs, ``latest`` and ``best`` checkpoints in
the run directory under ``root_dir``; ``mode=resume pretrained_path=<latest>``
carries on, ``mode=test pretrained_path=<best>`` is the whole-scene test.
The run is on the card unless ``--device cpu`` is given; on a host
with more than one card it is one process a card (NCCL) unless
``distributed=False``, under ``torchrun`` the rank its environment
names, and ``--device cpu world_size=N`` runs N gloo ranks on the CPU.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from amcontrast3d_tpu_torch.engine.cli import main_cli  # noqa: E402

if __name__ == "__main__":
    main_cli("base")
