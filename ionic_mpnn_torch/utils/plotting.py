"""Loss-curve and parity plots (the JAX package's ``utils/plotting.py``;
reference ``train_viscosity.py:61-74, 372-413``, ``utils/mp_utils.py:47-56``;
Figure-2a/2b/2c style).

matplotlib is imported when a plot is made, never with this module: the
package imports without it. The CLIs ask :func:`can_plot` first, which
prints one line where matplotlib is not installed.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

__all__ = ["plot_loss", "plot_parity", "can_plot"]

NO_MATPLOTLIB = "plots not made: matplotlib is not installed"


def can_plot() -> bool:
    """Whether matplotlib imports here; where it does not, print
    :data:`NO_MATPLOTLIB` (a CLI then makes no plot and goes on)."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        print(NO_MATPLOTLIB)
        return False
    return True


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_loss(history: Dict[str, List[float]], out_path, title: str = "Training curve") -> Path:
    plt = _mpl()
    plt.figure(figsize=(6, 4))
    plt.plot(history["loss"], label="Train loss")
    plt.plot(history["val_loss"], label="Validation loss")
    plt.xlabel("Epoch")
    plt.ylabel("Loss")
    plt.title(title)
    plt.legend()
    plt.tight_layout()
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    plt.savefig(out_path, dpi=300)
    plt.close()
    return out_path


def plot_parity(
    y_train: np.ndarray,
    pred_train: np.ndarray,
    y_dev: Optional[np.ndarray],
    pred_dev: Optional[np.ndarray],
    out_path,
    xlabel: str = "Experimental",
    ylabel: str = "Predicted",
    title: str = "Parity plot",
) -> Path:
    plt = _mpl()
    plt.figure(figsize=(5, 5))
    plt.scatter(y_train, pred_train, s=10, alpha=0.6, color="#FF8B32", label="Train")
    lows = [np.min(y_train), np.min(pred_train)]
    highs = [np.max(y_train), np.max(pred_train)]
    if y_dev is not None and len(y_dev):
        plt.scatter(y_dev, pred_dev, s=18, alpha=0.6, color="#FFD582", label="Validation")
        lows += [np.min(y_dev), np.min(pred_dev)]
        highs += [np.max(y_dev), np.max(pred_dev)]
    low, high = min(lows), max(highs)
    plt.plot([low, high], [low, high], "k--", linewidth=1)
    plt.xlabel(xlabel)
    plt.ylabel(ylabel)
    plt.title(title)
    plt.legend(frameon=False)
    plt.tight_layout()
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    plt.savefig(out_path, dpi=300)
    plt.close()
    return out_path
