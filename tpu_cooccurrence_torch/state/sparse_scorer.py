"""Device-resident sparse backend: slab matrix on the card, index on the host.

Port of ``tpu_cooccurrence/state/sparse_scorer.py`` (the single-process
chained path). It carries catalogues where a dense item x item ``C`` does
not fit (at 1M items a dense int32 ``C`` is 4 TB): the co-occurrence
counts live in device memory as a slab, and only a window's folded deltas
travel up.

* **The host keeps the index, the device keeps the data.** The host holds
  the sorted packed-key array of all matrix cells (:class:`SlabIndex`)
  and, per cell, the device slot its count lives in. Every placement
  decision (slot assignment, row growth, compaction) is host numpy.
* **Per-row slab allocation.** Each item row owns a contiguous device
  region of power-of-two capacity. New cells append at ``start + len``;
  an outgrown row is relocated on the device (the move instructions, old
  start, new start and length, are the only upload). Freed regions are
  reclaimed by an infrequent whole-heap compaction.
* **Narrow cells** (``--cell-dtype int16|int8``, ``auto`` = int16): the
  slab's counts are stored narrow, and a row whose sum reaches the
  dtype's bound (``wire.cell_promote_threshold``) moves whole, before the
  window's deltas apply, to a wide int32 side-table with its own index
  (``index_w``, ``cnt_w``, ``dst_w``). No cell can saturate, so scores
  equal an int32 slab's. A promoted row's cells are re-laid in key order.
* **Packed uplink** (``--wire-format packed``, ``auto``): the window's
  update buffer goes up bit-packed (``wire.encode_update``) and is decoded
  on the card (``wire.decode_update``) into the same buffer the raw path
  uploads, sorted inside each section.
* **Scoring reads the slab.** Every updated row is scored by
  :func:`~..ops.rect_topk.rect_topk` straight out of the slab that holds
  it (``cnt``/``dst``, or the wide pair) with the row sums resident too:
  the hand-written CUDA kernel on a card, its plain PyTorch version on the
  CPU. Narrow rows are scored first, then wide ones: the emitted order.

Tie-breaking among equal scores: the earliest slab slot of the row, i.e.
the earliest-inserted cell, as ``lax.top_k`` keeps the lowest index.

Not ported yet: the tiered spill store (the direct store is a
pass-through), the fused one-dispatch window, fixed-shape scoring, and the
native hash-table cell index (``HashSlabIndex``; the sorted index has the
same allocator, so slots and tie order do not change).

Eager PyTorch compiles nothing per shape, so the reference package's
pow2/pow4 transfer buckets and sentinel pads are gone: every upload and
scatter carries exactly its live entries.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import tuning
from ..device import resolve_device
from ..metrics import Counters, RESCORED_ITEMS, ROW_SUM_PROCESS_WINDOW
from ..observability import LEDGER
from ..ops.aggregate import (AggregatedPairs, aggregate_window_coo,
                             distinct_sorted, merge_sorted_insert,
                             narrow_deltas_int32)
from ..ops.device_scorer import DeferredResultsTable
from ..ops.rect_topk import (MAX_TOP_K, ladder_bits, min_rect_width,
                             rect_topk, score_buckets, short_rows)
from ..sampling.reservoir import _ragged_arange
from .results import TopKBatch
from .wire import (CELL_DTYPES, cell_promote_threshold, checked_narrow,
                   decode_update, encode_update, words_tensor)

#: ``--cell-dtype`` values -> torch dtype of the slab ``cnt`` cells.
_TORCH_CELLS = {"int32": torch.int32, "int16": torch.int16,
                "int8": torch.int8}

# -- device bodies (in place, on the slab's device) ------------------------


def _moves_body(cnt: torch.Tensor, dst: torch.Tensor, mv: torch.Tensor,
                total: int) -> None:
    """Relocate outgrown rows inside the slab, in place.

    ``mv``: [3, Mv] int32 (old start, new start, len) on the slab's
    device; ``total`` = the sum of the lens (known on the host, so the
    expansion needs no device sync). Every cell is read before any is
    written; new regions never overlap old ones (fresh space past the
    heap end).
    """
    if total == 0:
        return
    ln = mv[2].long()
    first = torch.cumsum(ln, 0) - ln
    row_of = torch.repeat_interleave(
        torch.arange(ln.shape[0], device=cnt.device), ln, output_size=total)
    col = torch.arange(total, device=cnt.device) - first[row_of]
    src = mv[0].long()[row_of] + col
    out = mv[1].long()[row_of] + col
    moved_cnt, moved_dst = cnt[src], dst[src]
    cnt[out] = moved_cnt
    dst[out] = moved_dst


def _apply_cells(cnt: torch.Tensor, dst: torch.Tensor, upd: torch.Tensor,
                 bounds: Tuple[int, int]) -> None:
    """New-cell and delta sections of an update buffer, in place.

    ``upd``: [2, N] int32 (index, value) in three sections split at
    ``bounds``: ``[0, b0)`` new cells (slot, partner id) write ``dst`` and
    zero ``cnt`` (a slot may hold stale bytes of a freed region);
    ``[b0, b1)`` cell deltas (slot, +/-count) add into ``cnt``. Zeroing
    precedes the add. Slots are distinct within a section, so the add is
    a gather, a sum and a plain store: deterministic, and at a narrow cell
    dtype no compare-and-swap loop. The sum is cast to the slab's dtype
    (wrapping, as the reference package's ``astype``): exact by the
    promotion invariant, since a row still on a narrow slab has a sum, so
    every cell and delta, under the dtype's bound.
    """
    b0, b1 = bounds
    new_idx = upd[0, :b0].long()
    dst[new_idx] = upd[1, :b0]
    cnt[new_idx] = 0
    d_idx = upd[0, b0:b1].long()
    cnt[d_idx] = (cnt[d_idx] + upd[1, b0:b1]).to(cnt.dtype)


def _update_body(cnt: torch.Tensor, dst: torch.Tensor,
                 row_sums: torch.Tensor, upd: torch.Tensor,
                 bounds: Tuple[int, int]) -> None:
    """One window's state changes, in place: cells (:func:`_apply_cells`),
    then the row-sum section ``[b1, N)`` (row, +/-sum) added into
    ``row_sums`` (``index_add_``: exact for repeated rows too)."""
    _apply_cells(cnt, dst, upd, bounds)
    b1 = bounds[1]
    row_sums.index_add_(0, upd[0, b1:].long(), upd[1, b1:])


def _promote_cells(cnt: torch.Tensor, dst: torch.Tensor, cnt_w: torch.Tensor,
                   dst_w: torch.Tensor, src: torch.Tensor,
                   out: torch.Tensor) -> None:
    """Copy promoted rows' cells from the narrow slab (slots ``src``) into
    the wide int32 side-table (slots ``out``), in place. The cast widens,
    so it is exact for any narrow cell."""
    s, o = src.long(), out.long()
    cnt_w[o] = cnt[s].to(torch.int32)
    dst_w[o] = dst[s]


def _grow(t: torch.Tensor, n: int) -> torch.Tensor:
    """``t`` zero-extended to length ``n``."""
    out = torch.zeros((n,), dtype=t.dtype, device=t.device)
    out[: t.shape[0]] = t
    return out


def _compact_gather(cnt: torch.Tensor, dst: torch.Tensor,
                    gmap: torch.Tensor, cap: int):
    """Rebuild the slab through a host-made gather map (compaction)."""
    g = gmap.long()
    new_cnt = torch.zeros((cap,), dtype=cnt.dtype, device=cnt.device)
    new_dst = torch.zeros((cap,), dtype=dst.dtype, device=dst.device)
    new_cnt[: g.shape[0]] = cnt[g]
    new_dst[: g.shape[0]] = dst[g]
    return new_cnt, new_dst


# -- host index -------------------------------------------------------------


class SlabCapacityError(ValueError):
    """Slab/registry capacity crossed the int32 slot space (2^31 cells).

    A permanent configuration error (cell addressing is int32 by design):
    the CLI maps it to EX_CONFIG.
    """


def _pow2ceil(x: np.ndarray, minimum: int) -> np.ndarray:
    v = np.maximum(x, minimum).astype(np.int64)
    out = 1 << np.ceil(np.log2(v)).astype(np.int64)
    if int(out.max(initial=0)) >= 2**31:
        raise SlabCapacityError(
            f"capacity growth to {int(out.max())} cells crosses the int32 "
            f"slot space (2^31); the sparse backend's cell addressing is "
            f"int32")
    return out.astype(np.int32)


# The per-row slab placement record (start, len, cap), two layouts behind
# one batch API: ``dense`` (three int32 arrays over the whole row space)
# and ``bitmap`` (one occupancy bit per possible row, a per-64-bit-word
# rank directory, and the fields packed over occupied rows in row-id
# order). Default bitmap (tuning ``row_index``).

if hasattr(np, "bitwise_count"):  # numpy >= 2.0
    def _popcount(words: np.ndarray) -> np.ndarray:
        return np.bitwise_count(words)
else:  # portable fallback: byte-table popcount over the uint8 view
    _POP8 = np.asarray([bin(i).count("1") for i in range(256)],
                       dtype=np.uint8)

    def _popcount(words: np.ndarray) -> np.ndarray:
        return _POP8[words.view(np.uint8).reshape(-1, 8)].sum(
            axis=1).astype(np.uint64)


class _RegistryDirtyLog:
    """Dirty-row tracking shared by both registry layouts.

    The fused sparse window (not ported yet) keeps a device mirror of the
    (start, len) columns and syncs it by delta: every registry mutation
    logs its rows here once :meth:`enable_dirty_log` is called. Off
    (``None``) by default, so the chained path pays nothing.
    """

    #: Logged-entry bound: past it the log collapses to the all-dirty flag.
    DIRTY_CAP = 1 << 20

    def __init__(self) -> None:
        self._dirty_log = None  # None = tracking off
        self._dirty_count = 0
        self._all_dirty = False

    def enable_dirty_log(self) -> None:
        if self._dirty_log is None:
            self._dirty_log = []

    def _mark_dirty(self, rows) -> None:
        if self._dirty_log is None or self._all_dirty or not len(rows):
            return
        self._dirty_log.append(np.asarray(rows, dtype=np.int64))
        self._dirty_count += len(rows)
        if self._dirty_count > self.DIRTY_CAP:
            self._mark_all_dirty()

    def _mark_all_dirty(self) -> None:
        if self._dirty_log is not None:
            self._all_dirty = True
            self._dirty_log.clear()
            self._dirty_count = 0

    def drain_dirty(self):
        """``(rows, all_dirty)`` accumulated since the last drain."""
        all_d = self._all_dirty
        if all_d or self._dirty_log is None or not self._dirty_log:
            rows = np.zeros(0, dtype=np.int64)
        else:
            rows = np.unique(np.concatenate(self._dirty_log))
        if self._dirty_log is not None:
            self._dirty_log.clear()
        self._dirty_count = 0
        self._all_dirty = False
        return rows, all_d


class DenseRowRegistry(_RegistryDirtyLog):
    """Three int32 arrays over the row space."""

    kind = "dense"

    def __init__(self, rows_capacity: int) -> None:
        super().__init__()
        cap = max(int(rows_capacity), 64)
        self.start = np.zeros(cap, dtype=np.int32)
        self.length = np.zeros(cap, dtype=np.int32)
        self.cap = np.zeros(cap, dtype=np.int32)

    @property
    def rows_cap(self) -> int:
        return len(self.start)

    @property
    def nbytes(self) -> int:
        return self.start.nbytes + self.length.nbytes + self.cap.nbytes

    def ensure(self, max_row: int) -> None:
        if max_row < self.rows_cap:
            return
        new_cap = int(_pow2ceil(np.asarray([max_row + 1]), 1024)[0])
        for name in ("start", "length", "cap"):
            old = getattr(self, name)
            grown = np.zeros(new_cap, dtype=old.dtype)
            grown[: len(old)] = old
            setattr(self, name, grown)

    def get(self, rows: np.ndarray):
        rows = np.asarray(rows, dtype=np.int64)
        if len(rows) and int(rows.max()) >= self.rows_cap:
            # Beyond-capacity rows read as absent (0, 0, 0).
            safe = np.minimum(rows, self.rows_cap - 1)
            in_r = rows < self.rows_cap
            return (np.where(in_r, self.start[safe], 0).astype(np.int32),
                    np.where(in_r, self.length[safe], 0).astype(np.int32),
                    np.where(in_r, self.cap[safe], 0).astype(np.int32))
        return self.start[rows], self.length[rows], self.cap[rows]

    def update(self, rows: np.ndarray, start=None, length=None,
               cap=None) -> None:
        rows = np.asarray(rows, dtype=np.int64)
        if len(rows):
            self.ensure(int(rows.max()))
        self._mark_dirty(rows)
        if start is not None:
            self.start[rows] = start
        if length is not None:
            self.length[rows] = length
        if cap is not None:
            self.cap[rows] = cap

    def clear(self, rows: np.ndarray) -> None:
        rows = np.asarray(rows, dtype=np.int64)
        rows = rows[rows < self.rows_cap]
        self._mark_dirty(rows)
        self.start[rows] = 0
        self.length[rows] = 0
        self.cap[rows] = 0

    def occupied(self) -> np.ndarray:
        return np.flatnonzero(self.cap > 0).astype(np.int32)

    def reset(self) -> None:
        self._mark_all_dirty()
        self.start[:] = 0
        self.length[:] = 0
        self.cap[:] = 0


class BitmapRowRegistry(_RegistryDirtyLog):
    """Bitmap + rank directory + packed per-occupied-row fields.

    ``bits`` holds one occupancy bit per possible row; ``rank`` the
    exclusive popcount prefix sum per 64-bit word, so the packed position
    of row r is ``rank[r >> 6] + popcount(bits[r >> 6] below bit r)``.
    Rows are never removed: ``clear`` zeroes the fields, matching the
    dense registry's observable behaviour exactly.
    """

    kind = "bitmap"

    def __init__(self, rows_capacity: int) -> None:
        super().__init__()
        cap = max(int(rows_capacity), 64)
        cap = int(_pow2ceil(np.asarray([cap]), 64)[0])
        self.bits = np.zeros(cap // 64, dtype=np.uint64)
        self.rank = np.zeros(cap // 64, dtype=np.int64)
        self.start = np.zeros(0, dtype=np.int32)
        self.length = np.zeros(0, dtype=np.int32)
        self.cap = np.zeros(0, dtype=np.int32)

    @property
    def rows_cap(self) -> int:
        return len(self.bits) * 64

    @property
    def nbytes(self) -> int:
        return (self.bits.nbytes + self.rank.nbytes + self.start.nbytes
                + self.length.nbytes + self.cap.nbytes)

    def ensure(self, max_row: int) -> None:
        if max_row < self.rows_cap:
            return
        new_cap = int(_pow2ceil(np.asarray([max_row + 1]), 1024)[0])
        n_words = new_cap // 64
        grown = np.zeros(n_words, dtype=np.uint64)
        grown[: len(self.bits)] = self.bits
        self.bits = grown
        self.rank = np.zeros(n_words, dtype=np.int64)
        self._rebuild_rank()

    def _rebuild_rank(self) -> None:
        pc = _popcount(self.bits).astype(np.int64)
        np.cumsum(pc[:-1], out=self.rank[1:])
        self.rank[0] = 0

    def _pos(self, rows: np.ndarray):
        """(packed position, occupied) per row. Beyond-capacity rows
        report unoccupied."""
        in_r = rows < self.rows_cap
        w = np.minimum(rows >> 6, len(self.bits) - 1)
        b = (rows & 63).astype(np.uint64)
        wbits = self.bits[w]
        occ = ((wbits >> b) & np.uint64(1)).astype(bool) & in_r
        below = wbits & ((np.uint64(1) << b) - np.uint64(1))
        return self.rank[w] + _popcount(below).astype(np.int64), occ

    def get(self, rows: np.ndarray):
        rows = np.asarray(rows, dtype=np.int64)
        pos, occ = self._pos(rows)
        s = np.zeros(len(rows), dtype=np.int32)
        ln = np.zeros(len(rows), dtype=np.int32)
        c = np.zeros(len(rows), dtype=np.int32)
        p = pos[occ]
        s[occ] = self.start[p]
        ln[occ] = self.length[p]
        c[occ] = self.cap[p]
        return s, ln, c

    def update(self, rows: np.ndarray, start=None, length=None,
               cap=None) -> None:
        """Batch insert-or-update; ``rows`` unique and ascending (every
        caller passes ``np.unique`` output)."""
        rows = np.asarray(rows, dtype=np.int64)
        if not len(rows):
            return
        self.ensure(int(rows.max()))
        self._mark_dirty(rows)
        pos, occ = self._pos(rows)
        new = rows[~occ]
        if len(new):
            ins = pos[~occ]  # positions in the PRE-insert packed arrays
            self.start = np.insert(self.start, ins, 0)
            self.length = np.insert(self.length, ins, 0)
            self.cap = np.insert(self.cap, ins, 0)
            np.bitwise_or.at(self.bits, new >> 6,
                             np.uint64(1) << (new & 63).astype(np.uint64))
            self._rebuild_rank()
            pos, _occ = self._pos(rows)
        if start is not None:
            self.start[pos] = start
        if length is not None:
            self.length[pos] = length
        if cap is not None:
            self.cap[pos] = cap

    def clear(self, rows: np.ndarray) -> None:
        rows = np.asarray(rows, dtype=np.int64)
        self._mark_dirty(rows)
        pos, occ = self._pos(rows)
        p = pos[occ]
        self.start[p] = 0
        self.length[p] = 0
        self.cap[p] = 0

    def occupied(self) -> np.ndarray:
        ids = np.flatnonzero(np.unpackbits(
            self.bits.view(np.uint8), bitorder="little"))
        return ids[self.cap > 0].astype(np.int32)

    def reset(self) -> None:
        self._mark_all_dirty()
        self.bits[:] = 0
        self.rank[:] = 0
        self.start = np.zeros(0, dtype=np.int32)
        self.length = np.zeros(0, dtype=np.int32)
        self.cap = np.zeros(0, dtype=np.int32)


def make_row_registry(rows_capacity: int, kind: Optional[str] = None):
    """Row-registry factory (``kind`` defaults to tuning ``row_index``)."""
    kind = tuning.default("row_index") if kind is None else kind
    if kind == "dense":
        return DenseRowRegistry(rows_capacity)
    if kind == "bitmap":
        return BitmapRowRegistry(rows_capacity)
    raise ValueError(f"row index must be bitmap or dense, got {kind!r}")


class _RowField:
    """Read-only vectorized view of one registry column
    (``index.row_start[rows]``). Scalar in, scalar out."""

    def __init__(self, reg, field: int) -> None:
        self._reg = reg
        self._field = field

    def __getitem__(self, rows):
        scalar = np.isscalar(rows) or getattr(rows, "ndim", 1) == 0
        out = self._reg.get(np.atleast_1d(np.asarray(rows)))[self._field]
        return out[0] if scalar else out

    def __len__(self) -> int:
        return self._reg.rows_cap


@dataclasses.dataclass
class AllocPlan:
    """Device-facing output of one window's :meth:`SlabIndex.apply`."""

    mv: Optional[np.ndarray]      # [3, Mv] int32 moves (old, new, len)
    slots: np.ndarray             # slab slot per window cell (d_key order)
    new_sel: np.ndarray           # bool per window cell: newly inserted

    @property
    def n_new(self) -> int:
        return int(self.new_sel.sum())


class SlabIndex:
    """Sorted-key cell index + per-row slab registry + allocator.

    Keys pack ``row << 32 | dst``; slots are offsets into the caller's
    slab arrays; the index never touches a device. A row's live slots are
    always exactly ``[start, start + len)`` (appends are contiguous and
    cells are never removed).
    """

    def __init__(self, rows_capacity: int = 1 << 10,
                 row_index: Optional[str] = None) -> None:
        self.g_key = np.zeros(0, dtype=np.int64)
        self.g_slot = np.zeros(0, dtype=np.int32)
        self.rows = make_row_registry(rows_capacity, row_index)
        self.heap_end = 0
        self.garbage = 0  # cells in freed (moved-out) regions
        self.compactions = 0

    def __len__(self) -> int:
        return len(self.g_key)

    @property
    def rows_cap(self) -> int:
        return self.rows.rows_cap

    @property
    def row_start(self) -> _RowField:
        return _RowField(self.rows, 0)

    @property
    def row_len(self) -> _RowField:
        return _RowField(self.rows, 1)

    @property
    def row_cap(self) -> _RowField:
        return _RowField(self.rows, 2)

    @property
    def nbytes(self) -> int:
        """Host memory of the index (registry + cell index)."""
        return self.rows.nbytes + self.g_key.nbytes + self.g_slot.nbytes

    def ensure_rows(self, max_row: int) -> None:
        self.rows.ensure(max_row)

    def apply(self, d_key: np.ndarray) -> AllocPlan:
        """Classify one window's (sorted unique) cell keys against the
        index, allocate slots for the new ones (recording relocations of
        outgrown rows), and insert them. The caller runs the moves BEFORE
        any cell write and sizes its slab to ``heap_end`` first."""
        pos = np.searchsorted(self.g_key, d_key)
        if len(self.g_key):
            safe = np.minimum(pos, len(self.g_key) - 1)
            exists = self.g_key[safe] == d_key
        else:
            exists = np.zeros(len(d_key), dtype=bool)
        new_key = d_key[~exists]
        mv = None
        new_slots = np.zeros(0, dtype=np.int32)
        if len(new_key):
            mv, new_slots = self._allocate(new_key)
        slots = np.empty(len(d_key), dtype=np.int32)
        slots[exists] = self.g_slot[pos[exists]]
        if len(new_key):
            slots[~exists] = new_slots
            self.g_key, self.g_slot = merge_sorted_insert(
                self.g_key, self.g_slot, pos[~exists], new_key, new_slots)
        return AllocPlan(mv, slots, ~exists)

    def _shift_moved(self, rows: np.ndarray, old_starts: np.ndarray,
                     lens: np.ndarray, new_starts: np.ndarray) -> None:
        """Re-point the index at relocated rows' new slots (their g_key
        segment is contiguous in the sorted layout)."""
        seg_lo = np.searchsorted(self.g_key, rows.astype(np.int64) << 32)
        idx = np.repeat(seg_lo, lens) + _ragged_arange(lens)
        self.g_slot[idx] += np.repeat(new_starts - old_starts, lens)

    def keys_and_slots(self):
        """(sorted packed cell keys, matching slots): the checkpoint view."""
        return self.g_key, self.g_slot

    def row_cells(self, rows: np.ndarray):
        """Live cells of ``rows`` as ``(keys, slots)``, rows concatenated in
        order, keys sorted within each row (the sorted layout's per-row
        segments). Promotion reads a row's cells through this."""
        lo = np.searchsorted(self.g_key, rows.astype(np.int64) << 32)
        _s, lens, _c = self.rows.get(rows)
        idx = np.repeat(lo, lens) + _ragged_arange(lens)
        return self.g_key[idx], self.g_slot[idx]

    def free_rows(self, rows: np.ndarray) -> None:
        """Drop rows and their cells from the index (promotion moved them
        to the wide side-table): the slab regions become garbage for the
        next compaction, and the keys are deleted, so a freed key may
        insert again later as a fresh cell."""
        _s, lens, cap = self.rows.get(rows)
        self.garbage += int(cap.sum())
        lo = np.searchsorted(self.g_key, rows.astype(np.int64) << 32)
        idx = np.repeat(lo, lens) + _ragged_arange(lens)
        self.g_key = np.delete(self.g_key, idx)
        self.g_slot = np.delete(self.g_slot, idx)
        self.rows.clear(rows)

    def _allocate(self, new_key: np.ndarray):
        n_src = (new_key >> 32).astype(np.int64)
        rows_new, first_idx, counts = np.unique(
            n_src, return_index=True, return_counts=True)
        rows_new32 = rows_new.astype(np.int32)
        self.ensure_rows(int(rows_new32.max()))
        r_start, r_len, r_cap = self.rows.get(rows_new)
        need = r_len + counts.astype(np.int32)
        grow_mask = need > r_cap
        mv = None
        if grow_mask.any():
            grow_rows = rows_new32[grow_mask]
            new_caps = _pow2ceil(need[grow_mask], minimum=4)
            new_end = self.heap_end + int(new_caps.astype(np.int64).sum())
            if new_end >= 2**31:
                raise SlabCapacityError(
                    f"slab heap growth to {new_end} cells crosses the "
                    f"int32 slot space (2^31)")
            offs = (self.heap_end
                    + np.concatenate([[0], np.cumsum(new_caps)[:-1]])
                    ).astype(np.int32)
            self.heap_end = new_end
            old_start = r_start[grow_mask].copy()
            old_len = r_len[grow_mask].copy()
            self.garbage += int(r_cap[grow_mask].sum())
            moved = old_len > 0
            if moved.any():
                self._shift_moved(grow_rows[moved], old_start[moved],
                                  old_len[moved], offs[moved])
                mv = np.stack([old_start[moved], offs[moved],
                               old_len[moved]]).astype(np.int32)
            self.rows.update(grow_rows, start=offs, cap=new_caps)
        # Append slots: start + len + within-row rank (new_key is sorted,
        # so same-row entries are contiguous and rank is positional).
        rank = (np.arange(len(new_key))
                - np.repeat(first_idx, counts)).astype(np.int32)
        k_start, k_len, _ = self.rows.get(n_src)
        new_slots = (k_start + k_len + rank).astype(np.int32)
        self.rows.update(rows_new32, length=need)
        return mv, new_slots

    def needs_compaction(self, min_heap: int) -> bool:
        # At 1/3: cap-doubling alone converges to garbage just UNDER half
        # the heap, so a 1/2 threshold would never fire.
        return self.garbage * 3 > self.heap_end and self.heap_end > min_heap

    def compact(self) -> np.ndarray:
        """Defragment: re-lay rows contiguously (row-id order). Returns the
        slot-space gather map (new slab = old slab[gmap]); updates the
        index in place. The caller runs the device gather."""
        alloc = self.rows.occupied()
        old_starts, lens, _caps = self.rows.get(alloc)
        new_caps = _pow2ceil(lens, minimum=4)
        new_starts = np.concatenate(
            [[0], np.cumsum(new_caps)[:-1]]).astype(np.int32)
        new_end = int(new_caps.sum())
        within = _ragged_arange(lens).astype(np.int32)
        gmap = np.zeros(max(new_end, 1), dtype=np.int32)
        gmap[np.repeat(new_starts, lens) + within] = (
            np.repeat(old_starts, lens) + within)
        self._shift_moved(alloc, old_starts, lens, new_starts)
        self.rows.update(alloc, start=new_starts, cap=new_caps)
        self.heap_end = new_end
        self.garbage = 0
        self.compactions += 1
        return gmap

    def rebuild_from_keys(self, keys: np.ndarray) -> np.ndarray:
        """Reset to a fresh contiguous layout for ``keys`` (sorted packed
        cell keys, e.g. from a checkpoint). Returns the slot per key."""
        rows_all = (keys >> 32).astype(np.int64)
        self.rows.reset()
        if len(keys) == 0:
            self.g_key = keys.copy()
            self.g_slot = np.zeros(0, dtype=np.int32)
            self.heap_end = 0
            self.garbage = 0
            return self.g_slot
        self.ensure_rows(int(rows_all.max()))
        rows_u, counts = np.unique(rows_all, return_counts=True)
        caps = _pow2ceil(counts.astype(np.int32), minimum=4)
        starts = np.concatenate([[0], np.cumsum(caps)[:-1]]).astype(np.int32)
        self.rows.update(rows_u.astype(np.int32), start=starts,
                         length=counts.astype(np.int32), cap=caps)
        self.heap_end = int(caps.sum())
        self.garbage = 0
        self.g_key = keys.copy()
        self.g_slot = (np.repeat(starts, counts)
                       + _ragged_arange(counts)).astype(np.int32)
        return self.g_slot


def make_slab_index(rows_capacity: int = 1 << 10) -> SlabIndex:
    """The cell index: the sorted one (the native hash index waits for
    the native helpers)."""
    return SlabIndex(rows_capacity=rows_capacity)


# -- the scorer -------------------------------------------------------------


class SparseDeviceScorer:
    """Single-device scorer over a :class:`SlabIndex`-managed slab.

    ``cell_dtype`` (int32, int16, int8) is the slab's count dtype; a
    narrow one adds the wide int32 side-table. ``wire_format`` (raw,
    packed) is the update uplink's. ``device`` defaults to the card; the
    CPU runs only when asked for.
    """

    # The pipelined window loop (pipeline.py) may hand this scorer
    # pre-folded AggregatedPairs: the producer thread runs the per-cell
    # fold, and process_window starts at slot allocation. Bit-identical
    # either way (the fold is the same aggregate_window_coo call).
    accepts_aggregated = True

    def __init__(self, top_k: int, counters: Optional[Counters] = None,
                 development_mode: bool = False,
                 capacity: int = 1 << 16,
                 items_capacity: int = 1 << 10,
                 compact_min_heap: int = 1 << 16,
                 score_ladder: Optional[int] = None,
                 defer_results: bool = False,
                 cell_dtype: str = "int32",
                 wire_format: str = "raw",
                 device="cuda") -> None:
        if cell_dtype not in CELL_DTYPES:
            raise ValueError(
                f"cell_dtype must be one of {sorted(CELL_DTYPES)}, got "
                f"{cell_dtype!r}")
        if wire_format not in ("raw", "packed"):
            raise ValueError(
                f"wire_format must be raw or packed, got {wire_format!r}")
        self.device = resolve_device(device)
        if self.device.type == "cuda" and top_k > MAX_TOP_K:
            raise ValueError(
                f"--top-k {top_k} exceeds the CUDA kernel's {MAX_TOP_K}")
        self.cell_dtype = cell_dtype
        # Narrow-cell promotion bound (None for int32): a row whose sum
        # reaches it moves to the wide side-table before this window's
        # deltas apply.
        self.promote_threshold = cell_promote_threshold(cell_dtype)
        self.wire_packed = wire_format == "packed"
        self.top_k = top_k
        self.score_ladder = int(score_ladder if score_ladder is not None
                                else tuning.default("score_ladder"))
        ladder_bits(self.score_ladder)  # validate at construction
        self.counters = counters if counters is not None else Counters()
        self.development_mode = development_mode
        self.index = make_slab_index(items_capacity)
        self.items_cap = int(items_capacity)
        # Exact host mirror of the row sums (int64); the device copy
        # (int32) feeds the kernel's rsi/rsj reads.
        self.row_sums_host = np.zeros(self.items_cap, dtype=np.int64)
        self.compact_min_heap = int(compact_min_heap)
        self.capacity = int(capacity)
        self.cnt = torch.zeros(self.capacity, dtype=_TORCH_CELLS[cell_dtype],
                               device=self.device)
        self.dst = torch.zeros(self.capacity, dtype=torch.int32,
                               device=self.device)
        self.row_sums = torch.zeros(self.items_cap, dtype=torch.int32,
                                    device=self.device)
        self.observed = 0
        self.live_cells = 0  # exact count of allocated cells
        # The wide int32 side-table of a narrow slab: its own index over
        # the same row ids and its own slab pair. A row is entirely narrow
        # or entirely wide, so scoring stays per row.
        self.index_w = None
        if self.promote_threshold is not None:
            self.index_w = make_slab_index(items_capacity)
            self.capacity_w = 1 << 10
            self.cnt_w = torch.zeros(self.capacity_w, dtype=torch.int32,
                                     device=self.device)
            self.dst_w = torch.zeros(self.capacity_w, dtype=torch.int32,
                                     device=self.device)
            self.wide_rows = np.zeros(self.items_cap, dtype=bool)
        # One-window-deep result pipeline (--emit-updates): a window's
        # [(rows, vals, ids), ...] are fetched while the next window runs.
        self._pending: Optional[List[Tuple]] = None
        self.last_dispatched_rows = 0
        # Without --emit-updates the results wait in a device table until
        # flush() drains the rows scored since the last drain.
        self.defer_results = bool(defer_results)
        self._results = (DeferredResultsTable(top_k, self.items_cap,
                                              self.device)
                         if self.defer_results else None)

    @property
    def heap_end(self) -> int:
        return self.index.heap_end

    @property
    def compactions(self) -> int:
        return self.index.compactions

    @property
    def promoted_rows(self) -> int:
        """Rows on the wide side-table (0 at int32 cells)."""
        return int(self.wide_rows.sum()) if self.index_w is not None else 0

    @property
    def slab_device_bytes(self) -> int:
        """Device bytes of the slab (``cnt`` + ``dst``, narrow and wide)."""
        slabs = [self.cnt, self.dst]
        if self.index_w is not None:
            slabs += [self.cnt_w, self.dst_w]
        return sum(t.numel() * t.element_size() for t in slabs)

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        LEDGER.up(arr)
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    # -- capacity management --------------------------------------------

    def _ensure_items(self, max_id: int) -> None:
        if max_id >= (1 << 31) - 1:
            raise ValueError("sparse backend supports item ids < 2^31 - 1")
        if max_id < self.items_cap:
            return
        new_cap = int(_pow2ceil(np.asarray([max_id + 1]), 1024)[0])
        grown = np.zeros(new_cap, dtype=np.int64)
        grown[: len(self.row_sums_host)] = self.row_sums_host
        self.row_sums_host = grown
        self.row_sums = _grow(self.row_sums, new_cap)
        if self.index_w is not None:
            wide = np.zeros(new_cap, dtype=bool)
            wide[: len(self.wide_rows)] = self.wide_rows
            self.wide_rows = wide
        self.items_cap = new_cap
        if self._results is not None:
            self._results.resize(new_cap)

    def _ensure_heap(self, need_end: int) -> None:
        if need_end <= self.capacity:
            return
        new_cap = self.capacity
        while new_cap < need_end:
            new_cap *= 2
        self.cnt = _grow(self.cnt, new_cap)
        self.dst = _grow(self.dst, new_cap)
        self.capacity = new_cap

    def _ensure_heap_w(self, need_end: int) -> None:
        if need_end <= self.capacity_w:
            return
        new_cap = self.capacity_w
        while new_cap < need_end:
            new_cap *= 2
        self.cnt_w = _grow(self.cnt_w, new_cap)
        self.dst_w = _grow(self.dst_w, new_cap)
        self.capacity_w = new_cap

    # -- the window step --------------------------------------------------

    def process_window(self, ts: int, pairs) -> TopKBatch:
        """Apply one window's pair deltas (a :class:`PairDeltaBatch`, or
        the same window already folded, :class:`AggregatedPairs`) and
        rescore its touched rows.

        Returns the previous window's top-K rows under ``--emit-updates``
        (one window late), or an empty batch in deferred mode.
        """
        self.last_dispatched_rows = 0
        if len(pairs) == 0:
            if self.defer_results:
                return TopKBatch.empty(self.top_k)
            return self.flush()  # nothing new: hand over the pending rows
        # Reclaim freed slab regions once they dominate the heap, between
        # windows only (a window's instructions carry slab addresses).
        if self.index.needs_compaction(self.compact_min_heap):
            gmap = self.index.compact()
            self.cnt, self.dst = _compact_gather(
                self.cnt, self.dst, self._to_device(gmap), self.capacity)
        if (self.index_w is not None
                and self.index_w.needs_compaction(self.compact_min_heap)):
            gmap = self.index_w.compact()
            self.cnt_w, self.dst_w = _compact_gather(
                self.cnt_w, self.dst_w, self._to_device(gmap),
                self.capacity_w)
        self._ensure_items(int(max(pairs.src.max(), pairs.dst.max())))
        if isinstance(pairs, AggregatedPairs):
            src_d, d_val, d_key = pairs.src, pairs.delta, pairs.key
        else:
            src_d, _, d_val, d_key = aggregate_window_coo(
                pairs.src, pairs.dst, pairs.delta.astype(np.int64),
                return_key=True)
        d_val32 = narrow_deltas_int32(d_val)

        # Row sums first (watermark ordering, reference
        # ItemRowRescorerTwoInputStreamOperator.java:116-142). The host
        # mirror is exact (int64).
        rows = distinct_sorted(src_d)
        row_ends = np.searchsorted(src_d, rows, side="right")
        cum = np.concatenate([[0], np.cumsum(d_val)])
        rs_delta = cum[row_ends] - cum[np.searchsorted(src_d, rows)]
        self.row_sums_host[rows] += rs_delta
        if self.row_sums_host[rows].max(initial=0) >= 2**31:
            raise ValueError("row sum exceeds int32 range")
        window_sum = int(d_val.sum())
        self.observed += window_sum
        self.counters.add(ROW_SUM_PROCESS_WINDOW, window_sum)

        # Promotion, then the per-slab split: a cell goes to the slab of
        # its row, decided before this window's deltas apply. The narrow
        # update carries the row sums; the wide one none.
        cell_wide = None
        if self.index_w is not None:
            self._promote_rows(rows)
            cell_wide = self.wide_rows[src_d]
        if cell_wide is not None and cell_wide.any():
            self._window_update(d_key[~cell_wide], d_val32[~cell_wide],
                                rows, rs_delta)
            self._window_update(d_key[cell_wide], d_val32[cell_wide],
                                rows[:0], rs_delta[:0], wide=True)
        else:
            self._window_update(d_key, d_val32, rows, rs_delta)
        if self.development_mode:
            self._check_row_sums(rows)

        self.counters.add(RESCORED_ITEMS, len(rows))
        self.last_dispatched_rows = len(rows)
        if self.index_w is not None and self.wide_rows[rows].any():
            wmask = self.wide_rows[rows]
            scored = (self._dispatch_scoring(rows[~wmask])
                      + self._dispatch_scoring(rows[wmask], wide=True))
        else:
            scored = self._dispatch_scoring(rows)
        if self.defer_results:
            return TopKBatch.empty(self.top_k)
        prev, self._pending = self._pending, scored
        return self._materialize(prev)

    def _promote_rows(self, rows: np.ndarray) -> None:
        """Move rows whose (already updated) sum reached the narrow bound
        to the wide side-table, before this window's deltas touch them:
        no cell can saturate. Their cells enter the wide index in key
        order."""
        sel = ((self.row_sums_host[rows] >= self.promote_threshold)
               & ~self.wide_rows[rows])
        if not sel.any():
            return
        newly = rows[sel]
        self.wide_rows[newly] = True
        keys, slots = self.index.row_cells(newly)
        self.index.free_rows(newly)
        if not len(keys):
            return  # a row past the bound in its first window: no cells yet
        order = np.argsort(keys, kind="stable")
        plan_w = self.index_w.apply(keys[order])
        self._ensure_heap_w(self.index_w.heap_end)
        _promote_cells(self.cnt, self.dst, self.cnt_w, self.dst_w,
                       self._to_device(slots[order].astype(np.int32)),
                       self._to_device(plan_w.slots))

    def _window_update(self, d_key: np.ndarray, d_val32: np.ndarray,
                       rows: np.ndarray, rs_delta: np.ndarray,
                       wide: bool = False) -> None:
        """Allocate slots and apply the window to one slab (the wide
        side-table with ``wide``): moves, then new-cell zeroing, then the
        delta add, then the row sums. Packed: the buffer goes up encoded
        and is decoded on the slab's device."""
        index = self.index_w if wide else self.index
        plan = index.apply(d_key)
        if wide:
            self._ensure_heap_w(index.heap_end)
            cnt, dst = self.cnt_w, self.dst_w
        else:
            self._ensure_heap(index.heap_end)
            cnt, dst = self.cnt, self.dst
        self.live_cells += plan.n_new
        if plan.mv is not None:
            _moves_body(cnt, dst, self._to_device(plan.mv),
                        int(plan.mv[2].astype(np.int64).sum()))
        upd, bounds = self._pack_update(plan, d_key, d_val32, rows, rs_delta)
        if self.wire_packed:
            words_i, words_v, header = encode_update(upd, bounds,
                                                     upd.shape[1])
            wi = words_tensor(words_i, self.device)
            wv = words_tensor(words_v, self.device)
            LEDGER.up_encoded(upd.nbytes, wi, wv)
            upd_t, bounds = decode_update(wi, wv, header, upd.shape[1])
        else:
            upd_t = self._to_device(upd)
        _update_body(cnt, dst, self.row_sums, upd_t, bounds)

    @staticmethod
    def _pack_update(plan: AllocPlan, d_key: np.ndarray,
                     d_val32: np.ndarray, rows: np.ndarray,
                     rs_delta: np.ndarray):
        """THE window update buffer: ``[2, N]`` int32, new cells | cell
        deltas | row sums (see :func:`_update_body`), exactly its live
        entries. Returns ``(upd, bounds)``."""
        n_new, n_d = plan.n_new, len(d_key)
        upd = np.empty((2, n_new + n_d + len(rows)), dtype=np.int32)
        upd[0, :n_new] = plan.slots[plan.new_sel]
        upd[1, :n_new] = (d_key[plan.new_sel] & 0xFFFFFFFF).astype(np.int32)
        upd[0, n_new: n_new + n_d] = plan.slots
        upd[1, n_new: n_new + n_d] = d_val32
        upd[0, n_new + n_d:] = rows
        upd[1, n_new + n_d:] = rs_delta.astype(np.int32)
        return upd, (n_new, n_new + n_d)

    def _dispatch_scoring(self, rows: np.ndarray, wide: bool = False
                          ) -> List[Tuple]:
        """Score ``rows`` out of one slab (the wide side-table with
        ``wide``): one :func:`rect_topk` call over all of them, in the
        reference package's length-bucket order (the order rows are
        emitted in; the kernel starts the longest rows first). Returns
        ``[(rows, vals, ids)]``, or ``[]`` once scattered into the
        deferred table."""
        if len(rows) == 0:
            return []
        index, cnt, dst = ((self.index_w, self.cnt_w, self.dst_w) if wide
                           else (self.index, self.cnt, self.dst))
        starts, lens, _caps = index.rows.get(rows)
        _bucket, order = score_buckets(lens, min_rect_width(self.top_k),
                                       self.score_ladder)
        rows_o = rows[order].astype(np.int32)
        meta = self._to_device(np.stack([rows_o, starts[order],
                                         lens[order]]).astype(np.int32))
        vals, ids = rect_topk(cnt, dst, self.row_sums, meta[0], meta[1],
                              meta[2], float(np.float32(self.observed)),
                              self.top_k, short_rows(lens[order]))
        if self.defer_results:
            self._results.scatter(meta[0], vals, ids)
            self._results.mark(rows)
            return []
        return [(rows_o, vals, ids)]

    def _check_row_sums(self, rows: np.ndarray) -> None:
        """Dev-mode invariant: slab row contents sum to the tracked row sum
        (reference check, ItemRowRescorerTwoInputStreamOperator.java:183-193),
        on whichever slab holds the row."""
        slabs = [(self.index, self.cnt.cpu().numpy().astype(np.int64))]
        if self.index_w is not None:
            slabs.append((self.index_w,
                          self.cnt_w.cpu().numpy().astype(np.int64)))
        for r in rows.tolist():
            wide = self.index_w is not None and self.wide_rows[r]
            index, cnt = slabs[int(wide)]
            s, ln = int(index.row_start[r]), int(index.row_len[r])
            actual = int(cnt[s: s + ln].sum())
            if actual != int(self.row_sums_host[r]):
                raise AssertionError(
                    f"Item row {int(self.row_sums_host[r])} does not match "
                    f"actual row sum {actual} (item {r})")

    # -- results ----------------------------------------------------------

    def flush(self) -> TopKBatch:
        """End of stream (or an idle window): the rows not yet handed
        over, from the device table or the one-window pipeline."""
        if self.defer_results:
            return self._results.drain()
        prev, self._pending = self._pending, None
        return self._materialize(prev)

    def _materialize(self, scored: Optional[List[Tuple]]) -> TopKBatch:
        if not scored:
            return TopKBatch.empty(self.top_k)
        rows = np.concatenate([r for r, _, _ in scored])
        vals = torch.cat([v for _, v, _ in scored]).cpu().numpy()
        ids = torch.cat([i for _, _, i in scored]).cpu().numpy()
        LEDGER.down(vals, ids)
        return TopKBatch(rows, ids, vals)

    # -- checkpoint -------------------------------------------------------

    def _cells(self, cnt: torch.Tensor, slots: np.ndarray) -> np.ndarray:
        """The counts at ``slots``, gathered on the device (the fetch is
        the cells, not the whole slab), as int64."""
        if not len(slots):
            return np.zeros(0, np.int64)
        fetched = cnt[self._to_device(slots).long()].cpu().numpy()
        LEDGER.down(fetched)
        return fetched.astype(np.int64)

    def checkpoint_state(self) -> dict:
        """The canonical sparse snapshot, as the reference package writes
        it: sorted live cell keys ``rows_key`` (int64 ``row << 32 | dst``)
        and counts ``rows_cnt`` (int64, zero cells dropped), the exact row
        sums (int64, one per item of the capacity) and ``observed``. The
        narrow and wide slabs merge into one key order, so the file does
        not depend on the cell dtype."""
        keys, slots = self.index.keys_and_slots()
        vals = self._cells(self.cnt, slots)
        if self.index_w is not None and len(self.index_w):
            keys_w, slots_w = self.index_w.keys_and_slots()
            keys = np.concatenate([keys, keys_w])
            vals = np.concatenate([vals, self._cells(self.cnt_w, slots_w)])
            order = np.argsort(keys, kind="stable")
            keys, vals = keys[order], vals[order]
        nz = vals != 0
        return {
            "rows_key": keys[nz],
            "rows_cnt": vals[nz],
            "row_sums": self.row_sums_host.copy(),
            "observed": np.asarray([self.observed], dtype=np.int64),
        }

    def _rebuild_slab(self, index: SlabIndex, key: np.ndarray,
                      cnt_vals: np.ndarray, capacity: int, dtype):
        """A fresh contiguous slab for ``key``/``cnt_vals`` (rows in key
        order) on the device; returns ``(cnt, dst, capacity)``."""
        slots = index.rebuild_from_keys(key)
        while capacity < index.heap_end:
            capacity *= 2
        cnt_host = np.zeros(capacity, dtype=dtype)
        dst_host = np.zeros(capacity, dtype=np.int32)
        cnt_host[slots] = checked_narrow(cnt_vals, dtype)
        dst_host[slots] = (key & 0xFFFFFFFF).astype(np.int32)
        return self._to_device(cnt_host), self._to_device(dst_host), capacity

    def restore_state(self, st: dict) -> None:
        """Restore a canonical snapshot written by either package at any
        cell dtype. The slabs are laid out afresh (rows contiguous in key
        order); a row goes to the wide side-table when its restored sum
        is at or past the bound (a row whose sum fell back under it fits
        narrow again: every cell is at most the sum)."""
        key = np.asarray(st["rows_key"], dtype=np.int64)
        cnt_vals = np.asarray(st["rows_cnt"], dtype=np.int64)
        max_id = int(max((key >> 32).max(initial=0),
                         int((key & 0xFFFFFFFF).max(initial=0))))
        if max_id >= self.items_cap:
            self.items_cap = int(_pow2ceil(np.asarray([max_id + 1]),
                                           1024)[0])
        rs = np.asarray(st["row_sums"], dtype=np.int64)
        if len(rs) > self.items_cap and rs[self.items_cap:].any():
            # A row sum is the sum of its row's cells, so a nonzero sum
            # past the largest cell id marks a corrupt checkpoint.
            raise ValueError("checkpoint row sums extend past its cells")
        self.row_sums_host = np.zeros(self.items_cap, dtype=np.int64)
        m = min(len(rs), self.items_cap)
        self.row_sums_host[:m] = rs[:m]
        if self.index_w is not None:
            self.wide_rows = self.row_sums_host >= self.promote_threshold
            wide = self.wide_rows[(key >> 32).astype(np.int64)]
            self.cnt_w, self.dst_w, self.capacity_w = self._rebuild_slab(
                self.index_w, key[wide], cnt_vals[wide], 1 << 10, np.int32)
            key, cnt_vals = key[~wide], cnt_vals[~wide]
        self.cnt, self.dst, self.capacity = self._rebuild_slab(
            self.index, key, cnt_vals, self.capacity,
            CELL_DTYPES[self.cell_dtype])
        self.row_sums = self._to_device(
            checked_narrow(self.row_sums_host, np.int32))
        self.observed = int(st["observed"][0])
        self.live_cells = len(st["rows_key"])
        # In-flight results belong to windows before the checkpoint.
        self._pending = None
        if self._results is not None:
            self._results.reset(self.items_cap)
