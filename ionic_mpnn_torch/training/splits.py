"""Dataset splits: the reference's seed-42 random split, the leak-free
pair-level split it leaves commented out, and a group hold-out.

The reference chains two ``sklearn.model_selection.train_test_split(
random_state=42)`` calls for 80/10/10 (``train_viscosity.py:273-274``).
:func:`train_test_split` here is that function for an array and a float
``test_size``, without scikit-learn: ``ceil(test_size · n)`` test items,
taken first from ``RandomState(seed).permutation(n)``, the rest train, in
permutation order. The indices equal the JAX package's.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np

__all__ = ["train_test_split", "random_split", "pair_level_split", "group_holdout_split"]


def train_test_split(x: np.ndarray, test_size: float, random_state: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """``(train, test)`` as scikit-learn's ``train_test_split(x,
    test_size=test_size, random_state=random_state)`` returns them for a
    float ``test_size`` in (0, 1)."""
    x = np.asarray(x)
    if not 0.0 < test_size < 1.0:
        raise ValueError(f"test_size {test_size} is not in (0, 1)")
    n_test = math.ceil(test_size * len(x))
    if not 0 < n_test < len(x):
        raise ValueError(f"test_size {test_size} of {len(x)} items leaves an empty split")
    perm = np.random.RandomState(random_state).permutation(len(x))
    return x[perm[n_test:]], x[perm[:n_test]]


def random_split(
    n: int, seed: int = 42, test_size: float = 0.20
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Reference-compatible 80/10/10 index split (seed 42)."""
    indices = np.arange(n)
    idx_train, idx_tmp = train_test_split(indices, test_size, seed)
    idx_dev, idx_test = train_test_split(idx_tmp, 0.50, seed)
    return idx_train, idx_dev, idx_test


def group_holdout_split(
    groups: Sequence[str], test_group: str, seed: int = 42,
    dev_size: float = 0.10,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Hold out every record of ``test_group`` for test (train on the other
    families, test on this one). Dev is a seeded random fraction of the
    remaining records."""
    groups = np.asarray(groups)
    test_idx = np.where(groups == test_group)[0]
    if len(test_idx) == 0:
        raise ValueError(f"test_group {test_group!r} matches no records "
                         f"(groups present: {sorted(set(groups))})")
    rest = np.where(groups != test_group)[0]
    rng = np.random.default_rng(seed)
    rest = rng.permutation(rest)
    n_dev = max(1, int(round(dev_size * len(rest))))
    return np.sort(rest[n_dev:]), np.sort(rest[:n_dev]), test_idx


def pair_level_split(
    pair_ids: Sequence[str], seed: int = 42, test_size: float = 0.30
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Leak-free split on unique pair ids (``train_viscosity.py:277-283``):
    no ion pair appears in two splits."""
    unique_pairs = np.unique(np.asarray(pair_ids))
    p_train, p_tmp = train_test_split(unique_pairs, test_size, seed)
    p_dev, p_test = train_test_split(p_tmp, 0.50, seed)
    train_set, dev_set = set(p_train), set(p_dev)
    idx_train, idx_dev, idx_test = [], [], []
    for i, p in enumerate(pair_ids):
        if p in train_set:
            idx_train.append(i)
        elif p in dev_set:
            idx_dev.append(i)
        else:
            idx_test.append(i)
    return np.asarray(idx_train), np.asarray(idx_dev), np.asarray(idx_test)
