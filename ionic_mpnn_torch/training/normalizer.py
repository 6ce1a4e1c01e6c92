"""Target normalization (z-score on train-split statistics only).

The melting-point recipe normalizes with ``std or 1.0``
(``train_melting_point.py:255-258``), the transfer recipe with
``std + 1e-6`` (``train_melting_point_transfer.py:174-181``): the guards
``"or1"`` and ``"eps"``. The statistics travel with checkpoints
(:mod:`.checkpoint`) and as JSON (:meth:`Normalizer.save`), in the JAX
package's format.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np

__all__ = ["Normalizer"]


@dataclass(frozen=True)
class Normalizer:
    mean: float = 0.0
    std: float = 1.0

    @classmethod
    def fit(cls, y_train: np.ndarray, guard: str = "or1") -> "Normalizer":
        y = np.asarray(y_train, np.float64)
        mean = float(y.mean())
        std = float(y.std())
        if guard == "or1":
            std = std or 1.0
        elif guard == "eps":
            std = std + 1e-6
        else:
            raise ValueError(f"unknown guard {guard!r}")
        return cls(mean=mean, std=std)

    @classmethod
    def identity(cls) -> "Normalizer":
        return cls(0.0, 1.0)

    def transform(self, y: np.ndarray) -> np.ndarray:
        return (np.asarray(y, np.float32) - self.mean) / self.std

    def inverse(self, y: np.ndarray) -> np.ndarray:
        return np.asarray(y, np.float32) * self.std + self.mean

    def save(self, path) -> None:
        Path(path).write_text(json.dumps({"mean": self.mean, "std": self.std}))

    @classmethod
    def load(cls, path) -> "Normalizer":
        d = json.loads(Path(path).read_text())
        return cls(mean=d["mean"], std=d["std"])
