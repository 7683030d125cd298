"""Pure-index triplet / window math (a copy of ``mrisr_tpu/data/triplets.py``).

The reference builds a flat list of ``(patient_idx, series_idx, triplet_idx)``
from slice *counts* only, then regenerates every triplet of a volume per
__getitem__ (`reference/src/ModelDataGenerator.py:118-214`).  The
indexing contract it establishes (and that this module reproduces exactly,
including the subtle offset rule) is:

For a series with ``n`` slices, the per-volume triplet list is the
concatenation of
- distance-2 triplets ``(i, i+2) -> i+1`` for ``i in [0, n-2)``   (3 mm gap),
- distance-4 triplets ``(i, i+4) -> i+2`` for ``i in [0, n-4)``   (6 mm gap),

so triplet_idx ``t < n-2`` denotes d2 triplet ``i = t`` and ``t >= n-2``
denotes d4 triplet ``i = t - (n-2)`` — the d4 block is ALWAYS offset by
``n-2`` even when ``distance_filter == 4`` skips indexing the d2 block
(`ModelDataGenerator.py:150-162`).

Everything here is plain integer math on numpy arrays — no pixel IO — so an
epoch's sample plan is a single vectorized computation.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np


def num_triplets(n_slices: int, distance_filter: Optional[int] = None) -> int:
    """Number of indexable triplets for a series (reference __len__ semantics)."""
    if n_slices < 3:
        return 0
    d2 = max(n_slices - 2, 0)
    d4 = max(n_slices - 4, 0)
    if distance_filter == 2:
        return d2
    if distance_filter == 4:
        return d4
    return d2 + d4


def triplet_slice_ids(n_slices: int, triplet_idx: int) -> Tuple[int, int, int, int]:
    """Map a per-volume triplet index to (pre, mid, post, distance).

    Implements the d2/d4 offset rule above.
    """
    d2 = n_slices - 2
    if triplet_idx < d2:
        i = triplet_idx
        return i, i + 1, i + 2, 2
    i = triplet_idx - d2
    return i, i + 2, i + 4, 4


@dataclass
class TripletIndex:
    """Flat triplet index over a list of series, mirroring TripletSliceDataset.

    ``series_slice_counts``: number of slices per series (order defines
    series ids).  Entries are (series_id, triplet_idx) pairs; with
    ``triplet_idx`` in the *full* per-volume numbering so the offset rule is
    preserved under distance filtering.
    """

    series_slice_counts: Sequence[int]
    distance_filter: Optional[int] = None

    def __post_init__(self):
        sids: List[np.ndarray] = []
        tids: List[np.ndarray] = []
        for sid, n in enumerate(self.series_slice_counts):
            if n < 3:
                continue
            d2 = n - 2
            d4 = max(n - 4, 0)
            if self.distance_filter in (None, 2):
                sids.append(np.full(d2, sid, dtype=np.int32))
                tids.append(np.arange(d2, dtype=np.int32))
            if self.distance_filter in (None, 4) and d4 > 0:
                sids.append(np.full(d4, sid, dtype=np.int32))
                tids.append(d2 + np.arange(d4, dtype=np.int32))
        if sids:
            self.series_ids = np.concatenate(sids)
            self.triplet_ids = np.concatenate(tids)
        else:
            self.series_ids = np.zeros(0, dtype=np.int32)
            self.triplet_ids = np.zeros(0, dtype=np.int32)

    def __len__(self) -> int:
        return int(self.series_ids.shape[0])

    def slice_plan(self) -> np.ndarray:
        """(N, 5) int32 array of [series_id, pre, mid, post, distance].

        Fully vectorized: this is the whole epoch's gather plan.
        """
        n = np.asarray(self.series_slice_counts, dtype=np.int32)[self.series_ids]
        d2 = n - 2
        t = self.triplet_ids
        is_d4 = t >= d2
        i = np.where(is_d4, t - d2, t)
        dist = np.where(is_d4, 4, 2).astype(np.int32)
        pre = i
        mid = i + dist // 2
        post = i + dist
        return np.stack([self.series_ids, pre, mid, post, dist], axis=1)


@dataclass
class WindowIndex:
    """5-slice-window index for the Progressive UNet.

    Windows ``(i..i+4)`` within one series only — never spanning patients —
    with ``n_slices - 4`` windows per series
    (`reference/src/ModelDataGenerator_ProgressiveUNet.py:131-160`).
    """

    series_slice_counts: Sequence[int]
    window: int = 5

    def __post_init__(self):
        sids: List[np.ndarray] = []
        wids: List[np.ndarray] = []
        for sid, n in enumerate(self.series_slice_counts):
            nw = n - (self.window - 1)
            if nw <= 0:
                continue
            sids.append(np.full(nw, sid, dtype=np.int32))
            wids.append(np.arange(nw, dtype=np.int32))
        if sids:
            self.series_ids = np.concatenate(sids)
            self.window_ids = np.concatenate(wids)
        else:
            self.series_ids = np.zeros(0, dtype=np.int32)
            self.window_ids = np.zeros(0, dtype=np.int32)

    def __len__(self) -> int:
        return int(self.series_ids.shape[0])

    def slice_plan(self) -> np.ndarray:
        """(N, 1 + window) int32 array of [series_id, i, i+1, ..., i+window-1]."""
        offs = np.arange(self.window, dtype=np.int32)[None, :]
        slices = self.window_ids[:, None] + offs
        return np.concatenate([self.series_ids[:, None], slices], axis=1)


def eval_volume_triplets(n_slices: int) -> np.ndarray:
    """Stride-2 eval triplets: (i, i+2) -> i+1 for even i.

    Matches ``generate_volume_triplets``
    (`reference/src/VolumeVisualization.py:53-86`): every other middle
    slice of the volume gets predicted.  Returns (N, 3) [pre, mid, post].
    """
    i = np.arange(0, n_slices - 2, 2, dtype=np.int32)
    return np.stack([i, i + 1, i + 2], axis=1)


def eval_hierarchical_pairs(n_slices: int) -> np.ndarray:
    """4-gap pairs for the hierarchical cascade: rows [i, i+1, i+2, i+3, i+4].

    Matches ``generate_hierarchical_4slice_pairs``
    (`reference/src/VolumeVisualization.py:405-442`): stride 1, all
    ``n_slices - 4`` windows (later windows overwrite earlier predictions when
    the predicted volume is assembled, as in the reference's fill loop at
    `:593-600`).
    """
    i = np.arange(0, n_slices - 4, dtype=np.int32)
    return np.stack([i, i + 1, i + 2, i + 3, i + 4], axis=1)


def recursive_bisection_triplets(n_slices: int) -> np.ndarray:
    """Multi-scale triplets by recursive midpoint bisection over [0, Z-1].

    The reference prototyped (but never trained on) this generator
    (`reference/src/Dataset_Generator.ipynb:cell5`,
    ``generate_progressive_triplets``): starting from the full volume span,
    emit (left, right) -> mid and recurse into both halves while the gap
    is at least 2.  Returns (N, 3) [pre, mid, post] rows in recursion
    (pre-order) order — the "scale the gap algorithmically" idea the
    Progressive UNet productionized (SURVEY.md §5 long-context row).
    """
    rows: List[Tuple[int, int, int]] = []

    def recurse(lo: int, hi: int):
        if hi - lo < 2:
            return
        mid = (lo + hi) // 2
        rows.append((lo, mid, hi))
        recurse(lo, mid)
        recurse(mid, hi)

    recurse(0, n_slices - 1)
    if not rows:
        return np.zeros((0, 3), dtype=np.int32)
    return np.asarray(rows, dtype=np.int32)


def eval_progressive_windows(n_slices: int) -> np.ndarray:
    """All 5-slice windows, middle index i+2 (VolumeVisualization.py:89-116)."""
    i = np.arange(0, n_slices - 4, dtype=np.int32)
    offs = np.arange(5, dtype=np.int32)[None, :]
    return i[:, None] + offs
