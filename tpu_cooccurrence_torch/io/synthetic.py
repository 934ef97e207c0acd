"""Synthetic interaction streams (copy of ``tpu_cooccurrence/io/synthetic.py``,
trimmed to the Zipfian basket generator the bench workload uses)."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def zipfian_interactions(
    n_events: int,
    n_items: int = 1_000_000,
    n_users: int = 100_000,
    alpha: float = 1.1,
    seed: int = 0,
    events_per_ms: int = 100,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Zipfian basket stream: item popularity ~ Zipf(alpha), users uniform,
    timestamps ascending at ``events_per_ms`` events per millisecond.

    Returns (users, items, timestamps) int64 arrays, identical to the
    reference package's for the same arguments.
    """
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, n_items + 1, dtype=np.float64)
    weights = ranks ** (-alpha)
    items = sample_items(weights / weights.sum(), n_events, rng)
    users = rng.integers(0, n_users, n_events, dtype=np.int64)
    timestamps = (np.arange(n_events, dtype=np.int64) // events_per_ms)
    return users, items, timestamps


def sample_items(weights: np.ndarray, n: int,
                 rng: np.random.Generator) -> np.ndarray:
    """``n`` iid draws from a normalized weight vector via inverse-CDF."""
    cdf = np.cumsum(weights)
    cdf[-1] = 1.0
    return np.searchsorted(cdf, rng.random(n)).astype(np.int64)

