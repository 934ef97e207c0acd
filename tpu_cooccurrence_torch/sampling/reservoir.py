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
(``sampling/rng.py``). With ``emit_baskets`` set (the dense fused window,
``--fused-window``) the sampler emits the un-expanded star-op form,
:class:`BasketBatch`, instead: every sampling decision is the same, only
the output encoding differs.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

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


@dataclasses.dataclass
class BasketBatch:
    """One window's pair deltas in un-expanded *star-op* form.

    The dense fused window's uplink (``--fused-window``,
    ``ops/device_scorer``): each row is one op, a new (star) item against
    a basket of partner items, and the card expands it into the count
    scatter (``ops/expand.apply_baskets``). One append event is one op
    (basket = the user's history prefix, ``skip = -1``); one replacement
    is two ops over the same pre-write reservoir row (``(+1, new item)``
    and ``(-1, previous item)``, both with ``skip = slot``). The logical
    pair stream equals the expanded :class:`PairDeltaBatch`: ``len(self)``
    counts logical pairs and :meth:`to_pairs` materializes them on the
    host (the chained path).

    ``baskets`` cells at ``j >= lens[i]`` are UNSPECIFIED (they come
    straight from the reservoir storage, which grows with ``np.empty``)
    and every consumer masks them.
    """

    new_items: np.ndarray  # [N] int32 star item per op
    baskets: np.ndarray    # [N, W] int32 partner rows
    lens: np.ndarray       # [N] int32 valid cells per row
    skips: np.ndarray      # [N] int32 excluded column (-1 = none)
    signs: np.ndarray      # [N] int32 delta sign (+1 / -1)

    @property
    def n_ops(self) -> int:
        return len(self.new_items)

    def _valid(self) -> np.ndarray:
        # Cached: len(), the scorer's routing and the host expansion all
        # need the same mask (an instance is built and consumed once).
        if not hasattr(self, "_valid_mask"):
            w = self.baskets.shape[1] if self.baskets.ndim == 2 else 0
            j = np.arange(w, dtype=np.int64)[None, :]
            self._valid_mask = ((j < self.lens[:, None])
                                & (j != self.skips[:, None]))
        return self._valid_mask

    def pairs_per_op(self) -> np.ndarray:
        """Directed pairs each op emits per direction (= valid cells)."""
        if not hasattr(self, "_per_op"):
            self._per_op = self._valid().sum(axis=1)
        return self._per_op

    def __len__(self) -> int:
        # Both directions, as the equivalent PairDeltaBatch's len.
        return int(2 * self.pairs_per_op().sum())

    def to_pairs(self) -> PairDeltaBatch:
        """Host-side expansion to COO: the same multiset of ``(src, dst,
        delta)`` entries the expanded sampler emits (entry order differs;
        every consumer folds, so order is immaterial)."""
        valid = self._valid()
        per_op = valid.sum(axis=1)
        partners = self.baskets[valid].astype(np.int64)
        news = np.repeat(self.new_items.astype(np.int64), per_op)
        deltas = np.repeat(self.signs.astype(np.int32), per_op)
        return PairDeltaBatch(
            np.concatenate([news, partners]),
            np.concatenate([partners, news]),
            np.concatenate([deltas, deltas]),
        )

    @staticmethod
    def empty() -> "BasketBatch":
        z = np.zeros(0, dtype=np.int32)
        return BasketBatch(z, np.zeros((0, 0), dtype=np.int32), z.copy(),
                           z.copy(), z.copy())


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
        # Fused-window mode: emit star ops (BasketBatch) instead of
        # host-expanded COO. Set by the job when the scorer wants them.
        self.emit_baskets = False

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
             sampled: np.ndarray):
        """Process one window's tagged interactions (arrival order).

        Returns ``(pair_deltas, feedback_items)``: a
        :class:`PairDeltaBatch`, or a :class:`BasketBatch` when
        ``emit_baskets`` is set; ``feedback_items`` are the rejected
        interactions' items (each a ``-1`` item-cut decrement, reference
        :246-248).
        """
        empty = (BasketBatch.empty() if self.emit_baskets
                 else PairDeltaBatch.concat([]))
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
        ap_baskets: Optional[np.ndarray] = None

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
            if self.emit_baskets:
                # Capture the partner prefixes now: the draw path below
                # mutates the rows of users that cross kMax in this same
                # window. Advanced indexing copies; cells at j >= slot are
                # the storage's unspecified tail, masked by consumers.
                wa = int(a_slot.max())
                ap_baskets = (self.hist[a_users, :wa] if wa else
                              np.zeros((len(a_users), 0), dtype=np.int32))
            elif total_partners > 0:
                col = _ragged_arange(sizes)
                row_u = np.repeat(a_users, sizes)
                partners = self.hist[row_u, col].astype(np.int64)
                new_rep = np.repeat(a_items, sizes)
                ones = np.ones(len(partners), dtype=np.int32)
                # Both directions (reference :180-193).
                blocks.append(PairDeltaBatch(new_rep, partners, ones))
                blocks.append(PairDeltaBatch(partners, new_rep, ones))
            if total_partners > 0:
                self.counters.add(OBSERVED_COOCCURRENCES, 2 * total_partners)

        # ---- Draw path ----
        d_mask = ~is_append
        rep_ops = None
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

            kc = self.user_cut
            r_users = d_users[replace]
            r_items = d_items[replace]
            r_slots = k[replace]
            if self.emit_baskets:
                rep_ops = self._replacement_ops(r_users, r_items, r_slots,
                                                kc)
            else:
                # Replacements mutate slots sequentially (the same slot
                # can be hit twice in one window), so they run per event.
                for u, item, slot in zip(r_users.tolist(), r_items.tolist(),
                                         r_slots.tolist()):
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
                    blocks.append(PairDeltaBatch(prev_rep, others.copy(),
                                                 minus))
                    blocks.append(PairDeltaBatch(others.copy(), new_rep,
                                                 plus))
                    blocks.append(PairDeltaBatch(others.copy(), prev_rep,
                                                 minus))
                    self.hist[u, slot] = item
        else:
            feedback_items = np.zeros(0, dtype=np.int64)

        if self.emit_baskets:
            return (self._assemble_baskets(a_items, a_slot, ap_baskets,
                                           rep_ops), feedback_items)
        return PairDeltaBatch.concat(blocks), feedback_items

    def _replacement_ops(self, r_users, r_items, r_slots, kc: int):
        """Replacement events as star ops: per event, two ops over the
        PRE-write reservoir row, ``(+1, new item)`` and ``(-1, previous
        occupant)``, both excluding ``slot``; then the slot write.

        A user's row may be hit twice in one window, and each op must see
        the row as it was at its own event, so the events run in order;
        when every replacing user is distinct (the common window) one
        gather of the pre-write rows and one scatter of the writes do it.
        """
        m = len(r_users)
        new = np.empty(2 * m, dtype=np.int32)
        skips = np.empty(2 * m, dtype=np.int32)
        signs = np.empty(2 * m, dtype=np.int32)
        if m:
            skips[0::2] = skips[1::2] = r_slots
        signs[0::2] = 1
        signs[1::2] = -1
        if m and len(np.unique(r_users)) == m:
            rows = self.hist[r_users, :kc]            # copies (advanced)
            baskets = np.repeat(rows, 2, axis=0)
            new[0::2] = r_items
            new[1::2] = self.hist[r_users, r_slots]   # previous occupants
            self.hist[r_users, r_slots] = r_items
            return new, baskets, skips, signs
        baskets = np.empty((2 * m, kc if m else 0), dtype=np.int32)
        for e, (u, item, slot) in enumerate(zip(
                r_users.tolist(), r_items.tolist(), r_slots.tolist())):
            row = self.hist[u, :kc]
            baskets[2 * e] = row
            baskets[2 * e + 1] = row
            new[2 * e] = item
            new[2 * e + 1] = row[slot]  # previous occupant
            self.hist[u, slot] = item
        return new, baskets, skips, signs

    @staticmethod
    def _assemble_baskets(a_items, a_slot, ap_baskets,
                          rep_ops) -> BasketBatch:
        """Stack the window's append and replacement ops into one
        :class:`BasketBatch` (basket width = the window's widest op)."""
        n_app = len(a_items)
        wa = ap_baskets.shape[1] if ap_baskets is not None else 0
        if rep_ops is not None:
            r_new, r_baskets, r_skips, r_signs = rep_ops
        else:
            r_new = np.zeros(0, dtype=np.int32)
            r_baskets = np.zeros((0, 0), dtype=np.int32)
            r_skips = r_signs = np.zeros(0, dtype=np.int32)
        n_rep = len(r_new)
        n = n_app + n_rep
        if n == 0:
            return BasketBatch.empty()
        w = max(wa, r_baskets.shape[1])
        baskets = np.zeros((n, w), dtype=np.int32)
        new_items = np.empty(n, dtype=np.int32)
        lens = np.empty(n, dtype=np.int32)
        skips = np.full(n, -1, dtype=np.int32)
        signs = np.ones(n, dtype=np.int32)
        if n_app:
            baskets[:n_app, :wa] = ap_baskets
            new_items[:n_app] = a_items
            lens[:n_app] = a_slot
        if n_rep:
            baskets[n_app:, :r_baskets.shape[1]] = r_baskets
            new_items[n_app:] = r_new
            lens[n_app:] = r_baskets.shape[1]
            skips[n_app:] = r_skips
            signs[n_app:] = r_signs
        return BasketBatch(new_items, baskets, lens, skips, signs)

    # -- checkpoint -------------------------------------------------------

    def clean_hist(self, n_users: int) -> np.ndarray:
        """``hist[:n_users]`` with the unspecified cells beyond each row's
        ``hist_len`` zeroed: storage grows with ``np.empty``, and stale
        heap bytes must not reach a checkpoint (it has to be
        byte-reproducible, and compressible)."""
        h = self.hist[:n_users].copy()
        cols = np.arange(h.shape[1], dtype=np.int64)[None, :]
        h[cols >= self.hist_len[:n_users, None]] = 0
        return h

    def checkpoint_state(self, n_users: int) -> dict:
        """Reservoir state of the first ``n_users`` dense users, in the
        reference package's keys and layout.

        The vocab can be ahead of the sampler (users whose events are
        still buffered in unfired windows, or late-dropped): the arrays
        are sized up before slicing, or the slice would come up short."""
        self._ensure_rows(max(n_users - 1, 0))
        return {
            "hist": self.clean_hist(n_users),
            "hist_len": self.hist_len[:n_users],
            "total": self.total[:n_users],
            "draws": self.draws[:n_users],
        }

    def restore_state(self, st: dict, n_users: int) -> None:
        self._ensure_rows(max(n_users - 1, 0))
        self._ensure_cols(st["hist"].shape[1])
        self.hist[:n_users, : st["hist"].shape[1]] = st["hist"]
        self.hist_len[:n_users] = st["hist_len"]
        self.total[:n_users] = st["total"]
        self.draws[:n_users] = st["draws"]
