"""Host-side per-window COO aggregation (copy of
``tpu_cooccurrence/ops/aggregate.py``, numpy fold only).

The reference folds a window's pair deltas per (item, other) cell before
they reach the rescorer (``ItemRowAggregator.java:26-31``); here the same
fold also leaves the device scatter with one entry per distinct cell.
:class:`AggregatedPairs` carries an already-folded window from the
pipeline's producer thread to a scorer that accepts it (``pipeline.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


def aggregate_window_coo(src: np.ndarray, dst: np.ndarray,
                         delta: np.ndarray, return_key: bool = False):
    """Fold duplicate ``(src, dst)`` pairs of one window into single entries.

    Returns ``(src, dst, delta)`` sorted by ``(src, dst)`` with one entry
    per distinct cell and the deltas summed as int64 (exact: the bincount
    accumulates in float64, far above any window's total). With
    ``return_key=True`` the packed ``src << 32 | dst`` int64 key array is
    appended (same order), for callers that index by packed key. Entries whose
    deltas cancel to zero are kept — a zero scatter-add is a no-op, and
    the reference also rescores rows for net-zero cells.
    """
    if not np.issubdtype(np.asarray(delta).dtype, np.integer):
        raise TypeError(
            f"aggregate_window_coo: delta dtype must be integer, got "
            f"{np.asarray(delta).dtype}")
    key = (src.astype(np.int64) << 32) | dst.astype(np.int64)
    uniq_key, inverse = np.unique(key, return_inverse=True)
    agg = np.bincount(inverse, weights=delta,
                      minlength=len(uniq_key)).astype(np.int64)
    out = ((uniq_key >> 32).astype(np.int32),
           (uniq_key & 0xFFFFFFFF).astype(np.int32), agg)
    return out + (uniq_key,) if return_key else out


@dataclasses.dataclass
class AggregatedPairs:
    """One window's pair deltas already folded by :func:`aggregate_window_coo`.

    The pipelined window loop (``pipeline.py``) runs the fold on its
    producer thread, so the scorer's turn starts at slot allocation;
    scorers that set ``accepts_aggregated = True`` take this in place of
    a raw ``PairDeltaBatch`` and skip their own fold. The fields are
    exactly the ``return_key=True`` output (sorted by packed key, one
    entry per distinct cell, int64 exact deltas), so a scorer consuming
    them is bit-identical to one folding the raw batch itself.
    """

    src: np.ndarray    # [M] int32, sorted (primary key)
    dst: np.ndarray    # [M] int32
    delta: np.ndarray  # [M] int64 exact folded deltas
    key: np.ndarray    # [M] int64 packed src << 32 | dst, sorted

    def __len__(self) -> int:
        return len(self.src)

    @staticmethod
    def fold(src, dst, delta) -> "AggregatedPairs":
        s, d, v, k = aggregate_window_coo(
            src, dst, delta.astype(np.int64), return_key=True)
        return AggregatedPairs(s, d, v, k)


def narrow_deltas_int32(agg: np.ndarray) -> np.ndarray:
    """Narrow exact int64 per-cell window deltas to the device's int32."""
    if len(agg) and max(-int(agg.min()), int(agg.max())) >= 2**31:
        raise ValueError("window cell delta exceeds int32 range")
    return agg.astype(np.int32)


def distinct_sorted(sorted_vals: np.ndarray) -> np.ndarray:
    """Distinct values of an already-sorted array (no re-sort)."""
    if len(sorted_vals) == 0:
        return sorted_vals
    return sorted_vals[np.flatnonzero(
        np.diff(sorted_vals, prepend=sorted_vals[0] - 1))]


def merge_sorted_insert(keys: np.ndarray, vals: np.ndarray,
                        pos: np.ndarray, new_keys: np.ndarray,
                        new_vals: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Insert sorted ``new_keys``/``new_vals`` into the sorted parallel
    arrays ``keys``/``vals`` at searchsorted positions ``pos`` (one merge
    pass; the vocab's sorted-id mode uses it)."""
    n, m = len(keys), len(new_keys)
    tgt = pos + np.arange(m)
    keep = np.ones(n + m, dtype=bool)
    keep[tgt] = False
    out_k = np.empty(n + m, dtype=keys.dtype)
    out_v = np.empty(n + m, dtype=vals.dtype)
    out_k[tgt] = new_keys
    out_k[keep] = keys
    out_v[tgt] = new_vals
    out_v[keep] = vals
    return out_k, out_v
