"""Vectorized per-user reservoir sampling with eviction deltas.

Copy of ``tpu_cooccurrence/sampling/reservoir.py`` on its numpy paths
(the reference package's native expansion helpers are a later port item;
they emit the same pair multiset). Replaces the reference's keyed
user-counter operator (``UserInteractionCounterOneInputStreamOperator.java:145-257``)
with a batch formulation emitting COO pair-delta blocks per window:

  1. Within a window all appends precede all draws, so every append is
     written first and each append's partners are ``history[:slot]``.
  2. The reservoir denominator counts every interaction (:158).
  3. Row-sum deltas are the per-source segment-sum of pair deltas, so the
     scorer derives them.
  4. ``observedCooccurrences`` counts only append-path emissions (:195).

Draws use the order-independent ``(seed, user, draw_index)`` hash RNG
(``sampling/rng.py``). The un-expanded basket form of the reference
(``BasketBatch``) feeds only the fused window, which is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from ..metrics import Counters, OBSERVED_COOCCURRENCES
from .item_cut import grouped_rank
from .rng import reservoir_draw


@dataclasses.dataclass
class PairDeltaBatch:
    """COO pair deltas for one window: ``C[src, dst] += delta``."""

    src: np.ndarray  # int64
    dst: np.ndarray  # int64
    delta: np.ndarray  # int32

    @staticmethod
    def concat(batches: List["PairDeltaBatch"]) -> "PairDeltaBatch":
        if not batches:
            z = np.zeros(0, dtype=np.int64)
            return PairDeltaBatch(z, z, np.zeros(0, dtype=np.int32))
        return PairDeltaBatch(
            np.concatenate([b.src for b in batches]),
            np.concatenate([b.dst for b in batches]),
            np.concatenate([b.delta for b in batches]),
        )

    def __len__(self) -> int:
        return len(self.src)


def _ragged_arange(sizes: np.ndarray) -> np.ndarray:
    """``[0..s0), [0..s1), ...`` concatenated."""
    total = int(sizes.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    ends = np.cumsum(sizes)
    starts = ends - sizes
    return np.arange(total, dtype=np.int64) - np.repeat(starts, sizes)


class UserReservoirSampler:
    """Reservoir state over dense user ids, with 2D history storage.

    In sampled mode histories are bounded by ``kMax``; in skip-cuts mode
    they are unbounded and the column dimension grows by doubling.
    History cells beyond each row's ``hist_len`` are unspecified (storage
    grows with ``np.empty``) and never read.
    """

    def __init__(self, user_cut: int, seed: int, skip_cuts: bool,
                 capacity: int = 1024, counters: Optional[Counters] = None) -> None:
        self.user_cut = user_cut
        self.seed = seed
        self.skip_cuts = skip_cuts
        self.counters = counters if counters is not None else Counters()
        init_cols = 8 if skip_cuts else user_cut
        self.hist = np.zeros((capacity, init_cols), dtype=np.int32)
        self.hist_len = np.zeros(capacity, dtype=np.int64)
        self.total = np.zeros(capacity, dtype=np.int64)
        self.draws = np.zeros(capacity, dtype=np.int64)

    def _ensure_rows(self, max_user: int) -> None:
        if max_user >= self.hist.shape[0]:
            new_rows = max(2 * self.hist.shape[0],
                           1 << int(max_user + 1).bit_length())
            for name in ("hist_len", "total", "draws"):
                old = getattr(self, name)
                grown = np.zeros(new_rows, dtype=old.dtype)
                grown[: len(old)] = old
                setattr(self, name, grown)
            grown = np.empty((new_rows, self.hist.shape[1]),
                             dtype=self.hist.dtype)
            grown[: self.hist.shape[0]] = self.hist
            self.hist = grown

    def _ensure_cols(self, max_len: int) -> None:
        if max_len > self.hist.shape[1]:
            new_cols = max(2 * self.hist.shape[1], max_len)
            grown = np.empty((self.hist.shape[0], new_cols),
                             dtype=self.hist.dtype)
            grown[:, : self.hist.shape[1]] = self.hist
            self.hist = grown

    def fire(self, users: np.ndarray, items: np.ndarray,
             sampled: np.ndarray) -> Tuple[PairDeltaBatch, np.ndarray]:
        """Process one window's tagged interactions (arrival order).

        Returns ``(pair_deltas, feedback_items)``; ``feedback_items`` are
        the rejected interactions' items (each a ``-1`` item-cut
        decrement, reference :246-248).
        """
        empty = PairDeltaBatch.concat([])
        if len(users) == 0:
            return empty, np.zeros(0, dtype=np.int64)
        self._ensure_rows(int(users.max()))

        # Reservoir denominators (fact 2): per-event totals.
        rank_all = grouped_rank(users)
        total_at_event = self.total[users] + rank_all + 1
        np.add.at(self.total, users, 1)

        if not np.any(sampled):
            return empty, np.zeros(0, dtype=np.int64)

        s_users = users[sampled]
        s_items = items[sampled]
        s_total = total_at_event[sampled]
        s_rank = grouped_rank(s_users)

        len_before = self.hist_len[s_users]
        if self.skip_cuts:
            is_append = np.ones(len(s_users), dtype=bool)
        else:
            is_append = (len_before + s_rank) < self.user_cut

        blocks: List[PairDeltaBatch] = []

        # ---- Append path (vectorized; fact 1) ----
        a_users = s_users[is_append]
        a_items = s_items[is_append]
        a_slot = (len_before + s_rank)[is_append]
        if len(a_users):
            self._ensure_cols(int(a_slot.max()) + 1)
            self.hist[a_users, a_slot] = a_items
            np.add.at(self.hist_len, a_users, 1)
            sizes = a_slot  # number of partners per append event
            total_partners = int(sizes.sum())
            if total_partners > 0:
                col = _ragged_arange(sizes)
                row_u = np.repeat(a_users, sizes)
                partners = self.hist[row_u, col].astype(np.int64)
                new_rep = np.repeat(a_items, sizes)
                ones = np.ones(len(partners), dtype=np.int32)
                # Both directions (reference :180-193).
                blocks.append(PairDeltaBatch(new_rep, partners, ones))
                blocks.append(PairDeltaBatch(partners, new_rep, ones))
                self.counters.add(OBSERVED_COOCCURRENCES, 2 * total_partners)

        # ---- Draw path ----
        d_mask = ~is_append
        if np.any(d_mask):
            d_users = s_users[d_mask]
            d_items = s_items[d_mask]
            d_total = s_total[d_mask]
            d_rank = grouped_rank(d_users)
            d_idx = self.draws[d_users] + d_rank
            np.add.at(self.draws, d_users, 1)
            k = reservoir_draw(self.seed, d_users, d_idx, d_total)
            replace = k < self.user_cut
            feedback_items = d_items[~replace]

            # Replacements mutate slots sequentially (the same slot can be
            # hit twice in one window), so they run per event.
            kc = self.user_cut
            for u, item, slot in zip(d_users[replace].tolist(),
                                     d_items[replace].tolist(),
                                     k[replace].tolist()):
                hist_row = self.hist[u, :kc]
                previous = int(hist_row[slot])
                others = np.delete(hist_row, slot).astype(np.int64)
                new_rep = np.full(kc - 1, item, dtype=np.int64)
                prev_rep = np.full(kc - 1, previous, dtype=np.int64)
                plus = np.ones(kc - 1, dtype=np.int32)
                minus = -plus
                # (item -> others, +1), (previous -> others, -1),
                # (others -> item, +1), (others -> previous, -1)
                # (reference :215-243).
                blocks.append(PairDeltaBatch(new_rep, others, plus))
                blocks.append(PairDeltaBatch(prev_rep, others.copy(), minus))
                blocks.append(PairDeltaBatch(others.copy(), new_rep, plus))
                blocks.append(PairDeltaBatch(others.copy(), prev_rep, minus))
                self.hist[u, slot] = item
        else:
            feedback_items = np.zeros(0, dtype=np.int64)

        return PairDeltaBatch.concat(blocks), feedback_items
