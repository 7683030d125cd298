"""Patient-level split, the same patients in the same splits as the reference.

The reference splits SORTED patient folder names with
``train_test_split(folders, test_size=0.3, random_state=42)`` then
``train_test_split(test_val, test_size=0.6, random_state=42)``, giving
70 / 12 / 18 % train / val / test *by patient*
(reference ``src/ModelDataGenerator.py:236-247``; ``mrisr_tpu/data/split.py``
calls scikit-learn).  The port must not need scikit-learn, so
:func:`train_test_split` writes out what scikit-learn's does for a list, a
float ``test_size`` and an integer seed (``ShuffleSplit``):

    n_test = ceil(test_size * n);  n_train = n - n_test
    perm = RandomState(seed).permutation(n)
    test = perm[:n_test];  train = perm[n_test:]     (permutation order)

``n_train`` is NOT ``floor((1 - test_size) * n)``: that differs at
n = 90, 170, 180, ... and would move patients between splits.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np


def train_test_split(items: Sequence, test_size: float,
                     seed: int) -> Tuple[list, list]:
    """``(train, test)`` lists, as scikit-learn's ``train_test_split`` with
    ``random_state=seed`` returns them."""
    n = len(items)
    n_test = math.ceil(test_size * n)
    if not 0 < n_test < n:
        raise ValueError(f"test_size={test_size} leaves an empty split of "
                         f"{n} items")
    perm = np.random.RandomState(seed).permutation(n)
    return [items[i] for i in perm[n_test:]], [items[i] for i in perm[:n_test]]


def patient_level_split(
    patient_ids: Sequence[str],
    test_val_fraction: float = 0.3,
    test_within_fraction: float = 0.6,
    seed: int = 42,
) -> Tuple[List[str], List[str], List[str]]:
    """Return (train, val, test) patient id lists."""
    ids = sorted(patient_ids)
    train, test_val = train_test_split(ids, test_val_fraction, seed)
    val, test = train_test_split(test_val, test_within_fraction, seed)
    return train, val, test


def split_for(
    patient_ids: Sequence[str],
    split: str,
    test_val_fraction: float = 0.3,
    test_within_fraction: float = 0.6,
    seed: int = 42,
) -> List[str]:
    train, val, test = patient_level_split(
        patient_ids, test_val_fraction, test_within_fraction, seed
    )
    return {"train": train, "val": val, "test": test}[split]
