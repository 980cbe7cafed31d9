from .predict import make_eval_step, make_predict_step
from .train import make_train_step

__all__ = ["make_eval_step", "make_predict_step", "make_train_step"]
