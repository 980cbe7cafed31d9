from .predict import make_eval_step, make_predict_step
from .runner import Runner
from .train import make_train_step

__all__ = ["Runner", "make_eval_step", "make_predict_step", "make_train_step"]
