"""Single-device dense scoring backend, in PyTorch.

Port of ``tpu_cooccurrence/ops/device_scorer.py``. On the chained path,
per window, the folded COO pair deltas are scatter-added into a dense
item x item count matrix ``C`` kept in device memory, row sums are
maintained by a scatter-add by source row, and every touched row is
LLR-scored and top-K'd by :func:`~.score_topk.score_topk` (the
hand-written CUDA kernel on a card, its plain PyTorch version on the CPU).

On the fused window (``fused_window="on"``, ``--fused-window``) the
sampler hands over un-expanded star ops (:class:`BasketBatch`) instead:
the host neither expands nor folds them, :func:`~.expand.apply_baskets`
expands and scatters them into ``C`` and the row sums on the card, and
the same score launches follow on the same stream, with no host
synchronisation between the upload and the last score launch. The
integer state and the rows equal the chained path's exactly.

Counts are int32 by default; ``count_dtype="int16"`` keeps reference-style
short counts that wrap on overflow. Row sums are int32 always. ``observed``
is tracked exactly on the host and fed to the kernel as float32.

Eager PyTorch compiles nothing per shape, so the reference package's
pow2/pow4 shape buckets are gone: the port scatters exactly the folded
cells and scores exactly the touched rows (no pad triple, no sentinel
row). The ``max_pairs_per_step`` and score-row chunking stay: they bound
device memory.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from .. import tuning
from ..device import resolve_device
from ..metrics import Counters, RESCORED_ITEMS, ROW_SUM_PROCESS_WINDOW
from ..observability import LEDGER
from ..observability.registry import REGISTRY
from ..sampling.reservoir import BasketBatch, PairDeltaBatch
from ..state.results import TopKBatch
from .aggregate import (aggregate_window_coo, distinct_sorted,
                        narrow_deltas_int32)
# pack_block is looked up here at call time, so a caller may wrap it to
# keep the blocks a run uploads (chip_smoke.py replays the largest).
from .expand import apply_baskets, pack_block
from .score_topk import MAX_TOP_K, score_topk, topk_padded  # noqa: F401

# Not ported, by design: the chunked-upload split (a TPU-link workaround),
# the uint16 COO wire format (halved bytes on the TPU link), the XLA
# compilation cache and buffer donation (XLA-only).


def resolve_fused_flag(fused_window: str, device: torch.device) -> bool:
    """Resolve an ``auto|on|off`` ``--fused-window`` request: ``auto`` is
    on where the scorer runs on the card (as the reference package turns
    it on on its accelerator) and off on the CPU."""
    if fused_window not in ("auto", "on", "off"):
        raise ValueError(
            f"fused_window must be auto|on|off, got {fused_window!r}")
    if fused_window == "auto":
        return device.type == "cuda"
    return fused_window == "on"


def score_row_budget(num_items: int, cap: int) -> int:
    """Rows per score call keeping an ``[S, I]`` working set near 1 GB
    int32 (the plain version materializes one; the kernel does not)."""
    budget_rows = max(64, (1 << 28) // max(num_items, 1))
    return min(cap, 1 << (budget_rows.bit_length() - 1))


def fit_count_dtype(arr, dtype: np.dtype) -> np.ndarray:
    """Cast checkpointed counts to a scorer's dtype: widening is always
    safe; narrowing scans for out-of-range values instead of wrapping."""
    arr = np.asarray(arr)
    if arr.dtype == dtype:
        return arr
    if not np.can_cast(arr.dtype, dtype, casting="safe"):
        info = np.iinfo(dtype)
        if arr.size and (arr.min() < info.min or arr.max() > info.max):
            raise ValueError(
                f"checkpoint counts exceed {np.dtype(dtype).name} range — "
                f"restore with --count-dtype {arr.dtype.name}")
    return arr.astype(dtype)


def _apply_coo(C: torch.Tensor, row_sums: torch.Tensor, src: torch.Tensor,
               dst: torch.Tensor, delta: torch.Tensor,
               row_lo: int = 0) -> None:
    """``C[src - row_lo, dst] += delta`` and ``row_sums[src] += delta``, in
    place (``C`` is the block of rows from ``row_lo``: the whole matrix,
    or one shard's rows).

    ``(src, dst)`` cells are distinct (the window fold); ``src`` repeats,
    and ``index_add_`` accumulates those atomically. int16 ``C`` wraps
    like the reference's Java shorts (``ItemRowAggregator.java:16``).
    """
    local = src - row_lo if row_lo else src
    C.index_put_((local, dst), delta.to(C.dtype), accumulate=True)
    row_sums.index_add_(0, src, delta)


def _grow_dense(C: torch.Tensor, row_sums: torch.Tensor, n: int):
    """Re-allocate the dense state at an ``n x n`` capacity."""
    old = C.shape[0]
    new_c = torch.zeros((n, n), dtype=C.dtype, device=C.device)
    new_c[:old, :old] = C
    new_rs = torch.zeros((n,), dtype=row_sums.dtype, device=row_sums.device)
    new_rs[:old] = row_sums
    return new_c, new_rs


def upload(arr: np.ndarray, dtype, device: torch.device) -> torch.Tensor:
    """``arr`` as a ``dtype`` tensor on ``device``, without a host sync: on
    the card it is staged in pinned memory and copied non-blocking (the
    caching host allocator holds the pinned buffer until its copy has run,
    so ``arr`` may be reused at once)."""
    LEDGER.up(arr)
    host = torch.from_numpy(np.ascontiguousarray(arr)).to(dtype)
    if device.type == "cpu":
        return host
    return host.pin_memory().to(device, non_blocking=True)


class DeferredResultsTable:
    """Device-resident latest-results table (no ``--emit-updates``).

    Each window's top-K rows scatter into ``vals``/``idx``
    (``[items_cap, K]`` on the device) instead of returning to the host;
    :meth:`drain` fetches only the rows scattered since the last drain.
    """

    def __init__(self, top_k: int, items_cap: int,
                 device: torch.device) -> None:
        self.top_k = top_k
        self.device = device
        self.vals: Optional[torch.Tensor] = None  # allocated at first use
        self.idx: Optional[torch.Tensor] = None
        self.dirty = np.zeros(items_cap, dtype=bool)

    def _alloc(self, n: int):
        return (torch.full((n, self.top_k), -torch.inf, dtype=torch.float32,
                           device=self.device),
                torch.zeros((n, self.top_k), dtype=torch.int32,
                            device=self.device))

    def resize(self, items_cap: int) -> None:
        """Track a capacity change, preserving entries and marks."""
        m = min(items_cap, len(self.dirty))
        dirty = np.zeros(items_cap, dtype=bool)
        dirty[:m] = self.dirty[:m]
        self.dirty = dirty
        if self.vals is not None and self.vals.shape[0] != items_cap:
            vals, idx = self._alloc(items_cap)
            vals[:m] = self.vals[:m]
            idx[:m] = self.idx[:m]
            self.vals, self.idx = vals, idx

    def scatter(self, rows: torch.Tensor, vals: torch.Tensor,
                idx: torch.Tensor) -> None:
        if self.vals is None:
            self.vals, self.idx = self._alloc(len(self.dirty))
        r = rows.long()
        self.vals[r] = vals
        self.idx[r] = idx

    def mark(self, rows: np.ndarray) -> None:
        self.dirty[rows] = True

    def drain(self) -> TopKBatch:
        """Rows scored since the last drain, as a :class:`TopKBatch`."""
        rows = np.flatnonzero(self.dirty)
        if self.vals is None or len(rows) == 0:
            return TopKBatch.empty(self.top_k)
        r = torch.from_numpy(rows).to(self.device)
        LEDGER.up(rows)
        vals = self.vals[r].cpu().numpy()
        idx = self.idx[r].cpu().numpy()
        LEDGER.down(vals, idx)
        self.dirty[rows] = False
        return TopKBatch(rows.astype(np.int32), idx, vals)

    def reset(self, items_cap: int) -> None:
        """Restart empty (the restore path)."""
        self.vals = self.idx = None
        self.dirty = np.zeros(items_cap, dtype=bool)


class DeviceScorer:
    """Dense device backend over an item-vocab capacity.

    ``device`` defaults to the card; the CPU runs only when asked for.
    """

    def __init__(self, num_items: int, top_k: int,
                 counters: Optional[Counters] = None,
                 max_score_rows_per_call: int = tuning.default(
                     "max_score_rows_per_call"),
                 max_pairs_per_step: int = tuning.default(
                     "max_pairs_per_step"),
                 count_dtype: str = "int32",
                 device="cuda",
                 defer_results: bool = False,
                 fused_window: str = "off") -> None:
        if count_dtype not in ("int32", "int16"):
            raise ValueError(
                f"count_dtype must be int32|int16, got {count_dtype}")
        self.device = resolve_device(device)
        if self.device.type == "cuda" and top_k > MAX_TOP_K:
            raise ValueError(
                f"--top-k {top_k} exceeds the CUDA kernel's {MAX_TOP_K}")
        self.count_dtype = np.dtype(count_dtype)
        self._torch_dtype = getattr(torch, count_dtype)
        self.top_k = top_k
        self.counters = counters if counters is not None else Counters()
        self._max_score_rows_cap = max_score_rows_per_call
        self.max_pairs_per_step = max_pairs_per_step
        # num_items <= 0 derives the vocab from the data: start small and
        # double C whenever a window's max dense id outgrows it.
        self.auto_capacity = num_items <= 0
        if self.auto_capacity:
            num_items = 1 << (max(1 << 10, top_k) - 1).bit_length()
        self.num_items = num_items
        self.max_score_rows = score_row_budget(num_items,
                                               max_score_rows_per_call)
        self.C = torch.zeros((num_items, num_items), dtype=self._torch_dtype,
                             device=self.device)
        self.row_sums = torch.zeros((num_items,), dtype=torch.int32,
                                    device=self.device)
        self.observed = 0  # exact, host-side; fed to the kernel as f32
        self.last_dispatched_rows = 0
        self.defer_results = bool(defer_results)
        self._results = (DeferredResultsTable(top_k, num_items, self.device)
                         if self.defer_results else None)
        # The fused window: the job has the sampler emit baskets iff this
        # resolved on.
        self.wants_baskets = resolve_fused_flag(fused_window, self.device)
        # Which path the last process_window took.
        self.last_dispatch_fused = False
        self._fused_dispatches = REGISTRY.gauge(
            "cooc_fused_dispatches_total",
            help="windows dispatched through the fused window")
        self._chained_dispatches = REGISTRY.gauge(
            "cooc_chained_dispatches_total",
            help="windows dispatched through the chained scatter+score "
                 "path")

    def _ensure_capacity(self, max_id: int) -> None:
        if max_id < self.num_items:
            return
        if not self.auto_capacity:
            raise ValueError(f"item id {max_id} exceeds --num-items "
                             f"capacity {self.num_items}")
        n = self.num_items
        while n <= max_id:
            n *= 2
        self.C, self.row_sums = _grow_dense(self.C, self.row_sums, n)
        self.num_items = n
        self.max_score_rows = score_row_budget(n, self._max_score_rows_cap)
        if self._results is not None:
            self._results.resize(n)

    def process_window(self, ts: int, pairs) -> TopKBatch:
        """Apply one window's pair deltas (a :class:`PairDeltaBatch`, or a
        :class:`BasketBatch` from a sampler in basket mode) and rescore
        its touched rows.

        Returns the window's top-K rows, or an empty batch in deferred
        mode (the rows wait in the device table for :meth:`flush`).
        """
        self.last_dispatched_rows = 0
        self.last_dispatch_fused = False
        if isinstance(pairs, BasketBatch):
            if self.wants_baskets:
                routed = self._try_fused(pairs)
                if routed is not None:
                    return routed
            # Fused off, or a window with no pairs: the chained path on
            # the host expansion (the same pair multiset).
            pairs = pairs.to_pairs()
        if len(pairs) == 0:
            return TopKBatch.empty(self.top_k)
        self._ensure_capacity(int(max(pairs.src.max(), pairs.dst.max())))
        src, dst, agg_delta = aggregate_window_coo(
            pairs.src, pairs.dst, pairs.delta)
        agg_delta = narrow_deltas_int32(agg_delta)
        for lo in range(0, len(src), self.max_pairs_per_step):
            hi = lo + self.max_pairs_per_step
            _apply_coo(self.C, self.row_sums,
                       upload(src[lo:hi], torch.long, self.device),
                       upload(dst[lo:hi], torch.long, self.device),
                       upload(agg_delta[lo:hi], torch.int32, self.device))

        window_sum = int(pairs.delta.sum())
        self.observed += window_sum
        self.counters.add(ROW_SUM_PROCESS_WINDOW, window_sum)
        self._chained_dispatches.add(1)
        return self._score_rows(distinct_sorted(src))

    def _try_fused(self, b: BasketBatch) -> Optional[TopKBatch]:
        """One window through the fused path, or ``None`` for a window
        with no pairs (the chained empty-window contract applies)."""
        per_op = b.pairs_per_op()
        if int(per_op.sum()) == 0:
            return None
        # Capacity from the valid cells only: the others are unspecified.
        valid = b._valid()
        active = per_op > 0
        self._ensure_capacity(int(max(b.new_items[active].max(),
                                      b.baskets[valid].max())))
        # Rescore set: every item an emitted pair touches, i.e. the
        # chained path's distinct_sorted(src) (its fold keeps zero-sum
        # cells).
        rows = np.unique(np.concatenate([
            b.new_items[active].astype(np.int64),
            b.baskets[valid].astype(np.int64)])).astype(np.int32)
        # No lane or one-chunk row gate: those bound XLA's padded [N, 2W]
        # lane tensors and one-chunk score program; no lane exists here.
        # The ops axis is cut so one uploaded block holds at most
        # max_pairs_per_step basket cells (at least one op); one launch
        # each.
        ops_per_launch = max(1, self.max_pairs_per_step
                             // max(b.baskets.shape[1], 1))
        for lo in range(0, b.n_ops, ops_per_launch):
            hi = lo + ops_per_launch
            if not active[lo:hi].any():
                continue
            block = pack_block(b.new_items[lo:hi], b.baskets[lo:hi],
                               b.lens[lo:hi], b.skips[lo:hi],
                               b.signs[lo:hi])
            apply_baskets(self.C, self.row_sums,
                          upload(block, torch.int32, self.device))

        # Exact host-side observed, as the chained pairs.delta.sum():
        # each op contributes 2 * sign * pairs.
        window_sum = int((2 * b.signs.astype(np.int64) * per_op).sum())
        self.observed += window_sum
        self.counters.add(ROW_SUM_PROCESS_WINDOW, window_sum)
        self.last_dispatch_fused = True
        self._fused_dispatches.add(1)
        return self._score_rows(rows)

    def _score_rows(self, rows: np.ndarray) -> TopKBatch:
        """LLR + top-K of the sorted distinct ``rows`` in
        ``max_score_rows`` chunks, every launch queued before any result
        is fetched. Returns the rows, or an empty batch in deferred mode.
        """
        self.counters.add(RESCORED_ITEMS, len(rows))
        self.last_dispatched_rows = len(rows)
        observed = float(np.float32(self.observed))
        launched = []
        for lo in range(0, len(rows), self.max_score_rows):
            chunk = rows[lo: lo + self.max_score_rows]
            rows_t = upload(chunk, torch.int32, self.device)
            vals, idx = score_topk(self.C, self.row_sums, rows_t, observed,
                                   self.top_k)
            if self.defer_results:
                self._results.scatter(rows_t, vals, idx)
            else:
                launched.append((chunk, vals, idx))
        if self.defer_results:
            self._results.mark(rows)
            return TopKBatch.empty(self.top_k)
        # Streaming mode materializes each window at once (the reference
        # package fetches one window late to hide its link latency; the
        # stdout order is the same either way).
        rows_l: List[np.ndarray] = []
        idx_l: List[np.ndarray] = []
        vals_l: List[np.ndarray] = []
        for chunk, vals, idx in launched:
            rows_l.append(chunk)
            vals_l.append(vals.cpu().numpy())
            idx_l.append(idx.cpu().numpy())
            LEDGER.down(vals_l[-1], idx_l[-1])
        return TopKBatch.concatenate(rows_l, idx_l, vals_l, self.top_k)

    def flush(self) -> TopKBatch:
        """End of stream: in deferred mode, drain the rows scored since the
        last flush from the device table."""
        if self.defer_results:
            return self._results.drain()
        return TopKBatch.empty(self.top_k)

    # -- checkpoint ------------------------------------------------------

    def checkpoint_state(self) -> dict:
        """The reference package's keys, as numpy arrays (copies: on the
        CPU a plain ``.numpy()`` would alias the live, in-place-updated
        state)."""
        return {
            "C": self.C.to("cpu", copy=True).numpy(),
            "row_sums": self.row_sums.to("cpu", copy=True).numpy(),
            "observed": np.asarray([self.observed], dtype=np.int64),
        }

    def restore_state(self, st: dict) -> None:
        """Restore a state dict written by either package. A capacity
        that differs (the reference package pads its vocab to the Pallas
        tile) is translated: a larger checkpoint is sliced once its extra
        rows and columns are verified empty, a smaller one zero-extended.
        """
        ck = fit_count_dtype(st["C"], self.count_dtype)
        n = ck.shape[0]
        if self.auto_capacity and n > self.num_items:
            self.num_items = n
            self.max_score_rows = score_row_budget(n,
                                                   self._max_score_rows_cap)
        rs = np.asarray(st["row_sums"], dtype=np.int32)
        if ck.shape != (self.num_items, self.num_items):
            if n > self.num_items and (ck[self.num_items:].any()
                                       or ck[:, self.num_items:].any()):
                raise ValueError(
                    f"checkpoint C shape {ck.shape} holds counts beyond "
                    f"this scorer's capacity {self.num_items} — restore "
                    f"with --num-items >= the checkpointing run's")
            m = min(n, self.num_items)
            fitted = np.zeros((self.num_items, self.num_items),
                              dtype=self.count_dtype)
            fitted[:m, :m] = ck[:m, :m]
            ck = fitted
            fitted_rs = np.zeros((self.num_items,), dtype=np.int32)
            fitted_rs[:m] = rs[:m]
            rs = fitted_rs
        # Copies: the state is updated in place, and must not write
        # through to the caller's arrays.
        self.C = torch.tensor(ck, device=self.device)
        self.row_sums = torch.tensor(rs, device=self.device)
        self.observed = int(st["observed"][0])
        if self._results is not None:
            self._results.reset(self.num_items)


def state_from_jax(st: dict) -> dict:
    """The reference package's ``DeviceScorer.checkpoint_state()`` or
    single-process ``ShardedScorer.checkpoint_state()`` (numpy arrays, the
    same keys) in the port's layout: the counterpart of converting weights.

    ``C`` stays in its count dtype (int32 or int16), contiguous; row sums
    become int32 and ``observed`` an int64 ``[1]`` array. The result feeds
    :meth:`DeviceScorer.restore_state` and the sharded scorer's. A
    multi-host sharded state (one process's ``C_local`` row block) is
    refused: multi-host runs are not ported.
    """
    if "C_local" in st:
        raise ValueError(
            "state was written by a multi-host sharded run (per-process "
            "row blocks): multi-host runs are not ported")
    c = np.ascontiguousarray(np.asarray(st["C"]))
    if c.ndim != 2 or c.shape[0] != c.shape[1]:
        raise ValueError(f"C must be square, got {c.shape}")
    if c.dtype not in (np.int32, np.int16):
        raise ValueError(f"C must be int32 or int16, got {c.dtype}")
    rs = np.ascontiguousarray(np.asarray(st["row_sums"], dtype=np.int32))
    if rs.shape != (c.shape[0],):
        raise ValueError(f"row_sums shape {rs.shape} does not match C "
                         f"{c.shape}")
    obs = np.asarray(st["observed"], dtype=np.int64).reshape(1)
    return {"C": c, "row_sums": rs, "observed": obs}
