"""Training tier: the train step, its optimizer, and the serving entry point."""

from .loop import data_loss, l2_penalty, make_train_step, predict
from .optim import Optimizer, make_optimizer

__all__ = ["data_loss", "l2_penalty", "make_train_step", "predict",
           "Optimizer", "make_optimizer"]
