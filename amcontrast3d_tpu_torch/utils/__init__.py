from .config import EasyConfig
from .registry import Registry
from .metrics import (AverageMeter, ConfusionMatrix, IoU_from_confusions,
                      confusion_matrix_update, get_mious)
from .logger import (generate_exp_directory, resume_exp_directory,
                     setup_logger_dist, write_to_csv)
from .ckpt import load_checkpoint, resume_checkpoint, save_checkpoint
from .random import set_random_seed
from .summary import SummaryWriter

__all__ = [
    "EasyConfig", "Registry", "AverageMeter", "ConfusionMatrix",
    "IoU_from_confusions", "confusion_matrix_update", "get_mious",
    "generate_exp_directory", "resume_exp_directory", "setup_logger_dist",
    "write_to_csv", "load_checkpoint", "resume_checkpoint",
    "save_checkpoint", "set_random_seed", "SummaryWriter",
]
