from .predict import make_eval_step, make_predict_step

__all__ = ["make_eval_step", "make_predict_step"]
