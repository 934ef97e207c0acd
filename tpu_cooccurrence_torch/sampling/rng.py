"""Deterministic, parallelism-independent reservoir RNG.

Copy of ``tpu_cooccurrence/sampling/rng.py``: the draws must match the
reference package bit for bit, so this stays numpy.

The reference draws reservoir indices from a single ``java.util.Random(seed)``
shared by all keys of an operator subtask
(``UserInteractionCounterOneInputStreamOperator.java:55,82,207``), which makes
results depend on element processing order and parallelism. We instead derive
each draw from ``(seed, user, draw_index)`` with a splitmix64-based stateless
hash: draws are identical regardless of processing order, vectorize over
users in NumPy, and are trivially portable to device code later. This is a
deliberate, documented deviation — the *distribution* (uniform over
``[0, total)``) is what the algorithm requires, not Java's exact stream.
"""

from __future__ import annotations

import numpy as np

_U64 = np.uint64
_MASK = np.uint64(0xFFFFFFFFFFFFFFFF)


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer (public-domain constants).

    uint64 wraparound is the point; numpy's overflow warnings are suppressed.
    """
    with np.errstate(over="ignore"):
        x = (x + _U64(0x9E3779B97F4A7C15)) & _MASK
        z = x
        z = ((z ^ (z >> _U64(30))) * _U64(0xBF58476D1CE4E5B9)) & _MASK
        z = ((z ^ (z >> _U64(27))) * _U64(0x94D049BB133111EB)) & _MASK
        return z ^ (z >> _U64(31))


def reservoir_draw(seed: int, users, draw_indices, totals):
    """Uniform draws in ``[0, totals)`` keyed by ``(seed, user, draw_index)``.

    All of ``users``, ``draw_indices``, ``totals`` broadcast; returns int64.
    Mirrors the role of ``random.nextInt(userInteractionsTotal)`` in the
    reference (``UserInteractionCounterOneInputStreamOperator.java:207``).
    """
    users = np.asarray(users, dtype=np.uint64)
    draw_indices = np.asarray(draw_indices, dtype=np.uint64)
    totals = np.asarray(totals, dtype=np.int64)
    s = _U64(seed & 0xFFFFFFFFFFFFFFFF)
    with np.errstate(over="ignore"):
        h = _splitmix64((_splitmix64((s ^ (users * _U64(0x9E3779B97F4A7C15))) & _MASK)
                         ^ draw_indices) & _MASK)
    # 64-bit modulo bias is negligible for any realistic `totals`.
    return (h % totals.astype(np.uint64)).astype(np.int64)

