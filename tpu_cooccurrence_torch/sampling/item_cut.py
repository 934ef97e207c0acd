"""Vectorized per-item interaction cut (copy of
``tpu_cooccurrence/sampling/item_cut.py``, numpy paths only).

Within a window fire, an interaction is tagged ``sample=true`` iff the
item's cumulative accepted count is still below ``fMax``
(``ItemInteractionCounterTwoInputStreamOperator.java:119-143``); user-level
rejections later decrement it via feedback (:94-116).
"""

from __future__ import annotations

import numpy as np


def grouped_rank(keys: np.ndarray) -> np.ndarray:
    """Rank (0-based) of each element within its key group, by position.

    ``grouped_rank([5, 3, 5, 5, 3]) == [0, 0, 1, 2, 1]``. Stable argsort
    plus a segment scan (the reference package's numpy fallback; its
    native counting pass gives the same ranks).
    """
    n = len(keys)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    order = np.argsort(keys, kind="stable")
    sorted_keys = keys[order]
    group_start = np.zeros(n, dtype=np.int64)
    new_group = np.flatnonzero(sorted_keys[1:] != sorted_keys[:-1]) + 1
    group_start[new_group] = new_group
    group_start = np.maximum.accumulate(group_start)
    ranks_sorted = np.arange(n, dtype=np.int64) - group_start
    ranks = np.empty(n, dtype=np.int64)
    ranks[order] = ranks_sorted
    return ranks


class ItemInteractionCut:
    """Cumulative per-item acceptance counter with feedback decrements."""

    def __init__(self, item_cut: int, capacity: int) -> None:
        self.item_cut = item_cut
        self.counts = np.zeros(capacity, dtype=np.int32)

    def _ensure(self, max_id: int) -> None:
        if max_id >= len(self.counts):
            new_cap = max(2 * len(self.counts), max_id + 1)
            grown = np.zeros(new_cap, dtype=np.int32)
            grown[: len(self.counts)] = self.counts
            self.counts = grown

    def fire(self, items: np.ndarray) -> np.ndarray:
        """Tag a window's interactions; updates counters. Returns bool mask."""
        if len(items) == 0:
            return np.zeros(0, dtype=bool)
        self._ensure(int(items.max()))
        ranks = grouped_rank(items)
        sampled = (self.counts[items] + ranks) < self.item_cut
        uniq, n_window = np.unique(items, return_counts=True)
        self.counts[uniq] = np.minimum(self.item_cut, self.counts[uniq] + n_window)
        return sampled

    def apply_feedback(self, items: np.ndarray, development_mode: bool = False,
                       counters=None) -> None:
        """Apply ``(item, -1)`` decrements (reference :94-116)."""
        if len(items) == 0:
            return
        if development_mode:
            if counters is not None:
                from ..metrics import ITEM_FEEDBACK_ELEMENTS

                counters.add(ITEM_FEEDBACK_ELEMENTS, len(items))
            if np.any(self.counts[items] == 0):
                bad = items[self.counts[items] == 0][0]
                raise AssertionError(
                    f"Item interactions 0 for item {bad}, but received decrement feedback.")
        np.subtract.at(self.counts, items, 1)
