"""Training tier: the train and eval steps, ``fit()``, its optimizer,
metrics, splits, target normalizer and checkpoints, and the serving entry
point."""

from .checkpoint import CheckpointWriter, latest_step, restore_checkpoint, save_checkpoint
from .loop import (FitResult, data_loss, evaluate_splits, fit, l2_penalty, make_eval_step,
                   make_train_step, predict)
from .metrics import mae, r2_score, rmse
from .normalizer import Normalizer
from .optim import Optimizer, make_optimizer
from .splits import group_holdout_split, pair_level_split, random_split

__all__ = ["data_loss", "l2_penalty", "make_train_step", "make_eval_step", "predict",
           "FitResult", "fit", "evaluate_splits", "Optimizer", "make_optimizer",
           "mae", "r2_score", "rmse", "Normalizer", "group_holdout_split",
           "pair_level_split", "random_split", "CheckpointWriter", "latest_step",
           "restore_checkpoint", "save_checkpoint"]
