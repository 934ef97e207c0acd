"""Array-native top-K result store with lazy materialization.

Copy of ``tpu_cooccurrence/state/results.py``, trimmed. The scorers hand
back whole windows as packed ``[S, K]`` arrays (:class:`TopKBatch`);
:class:`LatestResults` absorbs them with O(S) numpy scatters into a dense
pointer table, and the per-item ``[(other, score), ...]`` lists are built
only for items read. A checkpoint restore lands its rows one at a time
(:meth:`LatestResults.set_row`, the list-row adapter). All stored ids are
dense vocab indices; external ids appear only at the materialization
boundary.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Iterator, List, Mapping, Tuple

import numpy as np


@dataclasses.dataclass
class TopKBatch:
    """One window's top-K results in packed array form (dense-id space).

    ``vals`` may contain ``-inf`` for rows with fewer than K co-occurring
    items; the matching ``idx`` entries are unspecified and are filtered
    at materialization time.
    """

    rows: np.ndarray  # [S] int32 dense item ids
    idx: np.ndarray   # [S, K] int32 dense other-item ids
    vals: np.ndarray  # [S, K] float32 scores (descending)

    def __len__(self) -> int:
        return len(self.rows)

    @staticmethod
    def empty(top_k: int) -> "TopKBatch":
        return TopKBatch(np.zeros(0, np.int32),
                         np.zeros((0, top_k), np.int32),
                         np.zeros((0, top_k), np.float32))

    @staticmethod
    def concatenate(rows_l, idx_l, vals_l, top_k: int) -> "TopKBatch":
        """Assemble per-chunk host arrays into one batch ([] -> empty)."""
        if not rows_l:
            return TopKBatch.empty(top_k)
        return TopKBatch(np.concatenate(rows_l), np.concatenate(idx_l),
                         np.concatenate(vals_l))


class _ListBatch:
    """Rows set one by one as ``[(dense other, score), ...]`` lists."""

    def __init__(self) -> None:
        self.rows: List[List[Tuple[int, float]]] = []

    def append(self, top: List[Tuple[int, float]]) -> int:
        self.rows.append(top)
        return len(self.rows) - 1

    def __len__(self) -> int:
        return len(self.rows)


def _materialize_row(b, row: int, vocab) -> List[Tuple[int, float]]:
    """One stored row -> ``[(external other, score), ...]``."""
    if isinstance(b, _ListBatch):
        return [(vocab.to_external(j), s) for j, s in b.rows[row]]
    vals = b.vals[row]
    keep = np.isfinite(vals)
    if not keep.any():
        return []
    ext = vocab.to_external_batch(b.idx[row][keep].astype(np.int64))
    return list(zip(ext.tolist(), vals[keep].astype(float).tolist()))


class ResultsSnapshot(Mapping):
    """Consistent point-in-time view of a :class:`LatestResults` (pointer
    arrays copied under the store's lock; batches are immutable once
    absorbed)."""

    def __init__(self, vocab, batches: list, ptr_batch: np.ndarray,
                 ptr_row: np.ndarray) -> None:
        self._vocab = vocab
        self.batches = batches
        self.ptr_batch = ptr_batch
        self.ptr_row = ptr_row
        self._n_vocab = len(vocab)

    def _live_dense(self) -> np.ndarray:
        n = min(len(self.ptr_batch), self._n_vocab)
        return np.nonzero(self.ptr_batch[:n] >= 0)[0]

    def __len__(self) -> int:
        return int(len(self._live_dense()))

    def __iter__(self) -> Iterator[int]:
        live = self._live_dense()
        if len(live) == 0:
            return iter(())
        return iter(self._vocab.to_external_batch(live).tolist())

    def __getitem__(self, ext_item) -> List[Tuple[int, float]]:
        dense = self._vocab.to_dense(ext_item)
        if (dense is None or dense >= len(self.ptr_batch)
                or self.ptr_batch[dense] < 0):
            raise KeyError(ext_item)
        return _materialize_row(self.batches[self.ptr_batch[dense]],
                                int(self.ptr_row[dense]), self._vocab)


class LatestResults(Mapping):
    """``{external item -> [(external other, score), ...]}`` view, array-backed.

    A dense pointer table maps each item to its most recent result row
    across all absorbed batches; superseded rows linger until
    :meth:`_compact` trims them.
    """

    _COMPACT_MIN_ROWS = 1 << 20

    def __init__(self, vocab) -> None:
        self._vocab = vocab
        self._batches: list = []
        self._ptr_batch = np.full(1024, -1, dtype=np.int64)
        self._ptr_row = np.zeros(1024, dtype=np.int64)
        self._total_rows = 0
        self._lock = threading.RLock()

    def _ensure(self, n: int) -> None:
        if n <= len(self._ptr_batch):
            return
        cap = len(self._ptr_batch)
        while cap < n:
            cap *= 2
        grown = np.full(cap, -1, dtype=np.int64)
        grown[: len(self._ptr_batch)] = self._ptr_batch
        grown_rows = np.zeros(cap, dtype=np.int64)
        grown_rows[: len(self._ptr_row)] = self._ptr_row
        self._ptr_batch = grown
        self._ptr_row = grown_rows

    def absorb_batch(self, batch: TopKBatch) -> None:
        if len(batch) == 0:
            return
        with self._lock:
            bid = len(self._batches)
            self._batches.append(batch)
            rows = batch.rows.astype(np.int64)
            self._ensure(int(rows.max()) + 1)
            self._ptr_batch[rows] = bid
            self._ptr_row[rows] = np.arange(len(rows), dtype=np.int64)
            self._total_rows += len(rows)
            if (self._total_rows >= self._COMPACT_MIN_ROWS
                    and self._total_rows > 2 * len(self)):
                self._compact()

    def set_row(self, dense_item: int, top: List[Tuple[int, float]]) -> None:
        """One row as a ``[(dense other, score), ...]`` list (restore)."""
        with self._lock:
            if (not self._batches
                    or not isinstance(self._batches[-1], _ListBatch)):
                self._batches.append(_ListBatch())
            bid = len(self._batches) - 1
            row = self._batches[bid].append(top)
            self._ensure(dense_item + 1)
            self._ptr_batch[dense_item] = bid
            self._ptr_row[dense_item] = row
            self._total_rows += 1
            if (self._total_rows >= self._COMPACT_MIN_ROWS
                    and self._total_rows > 2 * len(self)):
                self._compact()

    def clear(self) -> None:
        with self._lock:
            self._batches = []
            self._ptr_batch[:] = -1
            self._total_rows = 0

    def _compact(self) -> None:
        """Drop superseded rows: rebuild live array rows into one batch
        (list rows are set again as they are)."""
        live = np.nonzero(self._ptr_batch[: len(self._vocab)] >= 0)[0]
        bids = self._ptr_batch[live]
        rows = self._ptr_row[live]
        keep_lists = []
        arr_rows, arr_idx, arr_vals = [], [], []
        for bid in np.unique(bids):
            b = self._batches[bid]
            sel = bids == bid
            r = rows[sel]
            if isinstance(b, _ListBatch):
                keep_lists.append((b, live[sel], r))
                continue
            arr_rows.append(b.rows[r])
            arr_idx.append(b.idx[r])
            arr_vals.append(b.vals[r])
        self._batches = []
        self._ptr_batch[:] = -1
        self._total_rows = 0
        if arr_rows:
            self.absorb_batch(TopKBatch(np.concatenate(arr_rows),
                                        np.concatenate(arr_idx),
                                        np.concatenate(arr_vals)))
        for b, dense_ids, r in keep_lists:
            for d, row in zip(dense_ids.tolist(), r.tolist()):
                self.set_row(d, b.rows[row])

    def _live_dense(self) -> np.ndarray:
        n = min(len(self._ptr_batch), len(self._vocab))
        return np.nonzero(self._ptr_batch[:n] >= 0)[0]

    def __len__(self) -> int:
        with self._lock:
            return int(len(self._live_dense()))

    def __iter__(self) -> Iterator[int]:
        with self._lock:
            live = self._live_dense()
            if len(live) == 0:
                return iter(())
            return iter(self._vocab.to_external_batch(live).tolist())

    def __getitem__(self, ext_item) -> List[Tuple[int, float]]:
        dense = self._vocab.to_dense(ext_item)
        with self._lock:
            if (dense is None or dense >= len(self._ptr_batch)
                    or self._ptr_batch[dense] < 0):
                raise KeyError(ext_item)
            b = self._batches[self._ptr_batch[dense]]
            row = int(self._ptr_row[dense])
        return _materialize_row(b, row, self._vocab)

    def snapshot(self) -> ResultsSnapshot:
        """Consistent copy for lock-free reading (the stdout dump)."""
        with self._lock:
            return ResultsSnapshot(self._vocab, list(self._batches),
                                   self._ptr_batch.copy(),
                                   self._ptr_row.copy())
