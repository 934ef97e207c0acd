"""External-id <-> dense-index mapping (copy of ``tpu_cooccurrence/state/vocab.py``).

The reference keys operators by raw integer ids via hash partitioning; the
TPU path needs *dense* indices to address device arrays (the co-occurrence
matrix row/col space). Ids are assigned in first-appearance order, which is
deterministic for a fixed stream — this also makes the dense index a stable
RNG key for the reservoir sampler.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..ops.aggregate import merge_sorted_insert


class IdMap:
    """Grow-only external->dense id mapping with batch lookup.

    Two regimes, switched automatically:

    * **table** (fast path): while every external id is a small
      non-negative int (true of every benchmark dataset — MovieLens /
      Instacart ids and the synthetic streams are bounded), lookups are a
      single fancy-index into a dense ``ext -> dense+1`` table — O(n),
      no sort. The table grows to the max id seen, capped at
      ``_TABLE_CAP`` entries (128 MB).
    * **sorted** (general path): first batch with a negative or
      too-large id permanently switches to a sorted (external, dense)
      array pair — fully vectorized ``searchsorted``. The per-batch
      ``np.unique`` sort this pays was the vocab-mapping hot spot at the
      25M-event shape, which is why the table path exists.

    A lazy dict mirror serves the scalar :meth:`to_dense` API.
    """

    _TABLE_CAP = 1 << 24

    def __init__(self) -> None:
        self._keys = np.zeros(0, dtype=np.int64)   # sorted external ids
        self._vals = np.zeros(0, dtype=np.int64)   # dense id per key
        self._rev: list = []
        self._rev_arr: np.ndarray = np.zeros(0, dtype=np.int64)  # cache
        self._fwd: Dict[int, int] = {}  # lazy mirror for to_dense()
        self._fwd_n = 0  # how many dense ids the mirror covers
        self._table: Optional[np.ndarray] = np.zeros(1024, dtype=np.int64)

    def __len__(self) -> int:
        return len(self._rev)

    def map_batch(self, ids: np.ndarray) -> np.ndarray:
        """Map a batch of external ids, assigning new dense ids as needed.

        Dense ids are assigned in first-appearance order (deterministic for
        a fixed stream). No per-id Python loop in either regime.
        """
        ids = np.asarray(ids, dtype=np.int64)
        if self._table is not None and len(ids):
            mx = int(ids.max())
            if int(ids.min()) >= 0 and mx < self._TABLE_CAP:
                return self._map_table(ids, mx)
            self._leave_table_mode()
        return self._map_sorted(ids)

    def _map_table(self, ids: np.ndarray, mx: int) -> np.ndarray:
        table = self._table
        if mx >= len(table):
            grown = np.zeros(max(2 * len(table), mx + 1), dtype=np.int64)
            grown[: len(table)] = table
            self._table = table = grown
        dense1 = table[ids]  # dense id + 1; 0 = unseen
        miss = dense1 == 0
        if miss.any():
            miss_ids = ids[miss]
            # First-appearance dedup WITHOUT sorting (np.unique sorts —
            # measured as the mapping's dominant cost on vocab-heavy
            # streams): scatter descending markers over the reversed
            # array (last write wins => the first occurrence's marker
            # survives), then keep exactly the positions whose marker
            # reads back as their own. The temp markers only touch miss
            # slots, every one of which is finalized just below.
            n = len(miss_ids)
            table[miss_ids[::-1]] = np.arange(n, 0, -1, dtype=np.int64)
            is_first = table[miss_ids] == np.arange(1, n + 1)
            new_ext = miss_ids[is_first]  # in first-appearance order
            base = len(self._rev)
            table[new_ext] = base + 1 + np.arange(len(new_ext),
                                                  dtype=np.int64)
            self._rev.extend(new_ext.tolist())
            dense1 = table[ids]
        return dense1 - 1

    def _leave_table_mode(self) -> None:
        """Materialize the sorted arrays from ``_rev`` and switch for good
        (an id outside the table regime was seen)."""
        rev = np.asarray(self._rev, dtype=np.int64)
        order = np.argsort(rev, kind="stable")
        self._keys = rev[order]
        self._vals = order.astype(np.int64)
        self._table = None

    def _map_sorted(self, ids: np.ndarray) -> np.ndarray:
        uniq, inverse = np.unique(ids, return_inverse=True)
        dense_uniq = np.empty(len(uniq), dtype=np.int64)
        if len(self._keys):
            pos = np.searchsorted(self._keys, uniq)
            safe = np.minimum(pos, len(self._keys) - 1)
            hit = self._keys[safe] == uniq
        else:
            pos = np.zeros(len(uniq), dtype=np.int64)
            hit = np.zeros(len(uniq), dtype=bool)
        dense_uniq[hit] = self._vals[pos[hit]]
        miss = np.flatnonzero(~hit)
        if len(miss):
            # np.unique sorts, but first-appearance order must win for
            # determinism: assign new ids by first position in the batch.
            first_pos = np.full(len(uniq), np.iinfo(np.int64).max,
                                dtype=np.int64)
            np.minimum.at(first_pos, inverse,
                          np.arange(len(inverse), dtype=np.int64))
            order = miss[np.argsort(first_pos[miss], kind="stable")]
            new_ext = uniq[order]
            new_dense = len(self._rev) + np.arange(len(order), dtype=np.int64)
            dense_uniq[order] = new_dense
            self._rev.extend(new_ext.tolist())
            # Merge the (sorted) new keys into the sorted lookup arrays.
            ins = pos[miss]  # miss is sorted, so uniq[miss] is sorted too
            self._keys, self._vals = merge_sorted_insert(
                self._keys, self._vals, ins, uniq[miss], dense_uniq[miss])
        return dense_uniq[inverse]

    def to_external(self, dense: int) -> int:
        return self._rev[dense]

    def to_dense(self, ext):
        """Dense id for an external id, or ``None`` if never seen.

        Safe under concurrent growth (serving query threads call this
        while the ingest thread appends): the catch-up bound is captured
        ONCE — re-reading ``len(self._rev)`` after the fill loop could
        mark ids mapped mid-loop as covered without ever filling them,
        silently resolving those users/items to ``None`` forever.
        """
        n = len(self._rev)
        if self._fwd_n != n:
            for dense in range(self._fwd_n, n):
                self._fwd[self._rev[dense]] = dense
            self._fwd_n = n
        return self._fwd.get(ext)

    def external_array(self) -> np.ndarray:
        """The dense -> external id array, refreshed if the vocab grew.

        The returned object is never mutated (growth *replaces* the
        cache), so a caller may hold it across its own reads — the
        serving snapshot captures it at publish and reads it lock-free.
        """
        # Rebuilt only when the vocab has grown since the last call (result
        # materialization calls this per row — it must not be O(vocab)).
        if len(self._rev_arr) != len(self._rev):
            self._rev_arr = np.asarray(self._rev, dtype=np.int64)
        return self._rev_arr

    def to_external_batch(self, dense: np.ndarray) -> np.ndarray:
        return self.external_array()[dense]

    # -- checkpoint ------------------------------------------------------

    def checkpoint_state(self) -> np.ndarray:
        """The dense -> external id array (the reference package's layout)."""
        return np.asarray(self._rev, dtype=np.int64)

    def restore_state(self, rev: np.ndarray) -> None:
        self._rev = [int(x) for x in rev]
        rev = np.asarray(rev, dtype=np.int64)
        if len(rev) == 0 or (rev.min() >= 0 and rev.max() < self._TABLE_CAP):
            # Rebuild the fast-path table (the mode is restored state too).
            n = max(1024, int(rev.max(initial=0)) + 1)
            self._table = np.zeros(n, dtype=np.int64)
            self._table[rev] = 1 + np.arange(len(rev), dtype=np.int64)
            self._keys = np.zeros(0, dtype=np.int64)
            self._vals = np.zeros(0, dtype=np.int64)
        else:
            self._leave_table_mode()
        self._fwd = {}
        self._fwd_n = 0
        # A same-length restore must drop the cache too (its length check
        # alone would keep the old ids).
        self._rev_arr = np.zeros(0, dtype=np.int64)
