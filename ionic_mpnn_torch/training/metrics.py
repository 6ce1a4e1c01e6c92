"""Evaluation metrics, as the reference computes them in numpy.

R² uses the reference's epsilon-guarded form
``1 - SS_res / (SS_tot + 1e-6)`` (``train_viscosity.py:44-50``); MAE is
the plain mean absolute error (``train_viscosity.py:369``). The JAX
package's ``training/metrics.py``, line for line.
"""

from __future__ import annotations

import numpy as np

__all__ = ["r2_score", "mae", "rmse"]

EPS = 1e-6


def r2_score(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    y_true = np.asarray(y_true, np.float64)
    y_pred = np.asarray(y_pred, np.float64)
    ss_res = np.sum((y_true - y_pred) ** 2)
    ss_tot = np.sum((y_true - np.mean(y_true)) ** 2)
    return float(1.0 - ss_res / (ss_tot + EPS))


def mae(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    return float(np.mean(np.abs(np.asarray(y_true) - np.asarray(y_pred))))


def rmse(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    return float(np.sqrt(np.mean((np.asarray(y_true) - np.asarray(y_pred)) ** 2)))
