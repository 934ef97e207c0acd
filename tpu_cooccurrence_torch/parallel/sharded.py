"""Sharded dense scoring backend: ``C`` row-sharded over a list of devices.

Port of ``tpu_cooccurrence/parallel/sharded.py`` (``ShardedScorer``) for
one process. The reference package drives a 1-D mesh through
``shard_map``; here one process drives the shards of :func:`.mesh.make_mesh`
in turn:

* ``C`` is **row-sharded**: shard d holds rows ``[d*R, (d+1)*R)`` as its
  block ``C_loc[d]`` (``[R, I]``) on ``mesh[d]`` (the analogue of the
  reference's ``keyBy(item)`` partitioned state).
* the row sums are **replicated**, one int32 copy per distinct device.
  Each shard scatters its slice of the window into its block and builds
  its partial row sums; the partials are summed into every replica (the
  reference package's ``lax.psum``).
* pair deltas and rows to score are partitioned by owner on the host, and
  each shard scores its own rows with
  :func:`~..ops.score_topk.score_topk_local` (the CUDA kernel over the
  local block, against the replicated global row sums; its plain version
  on the CPU). Top-K is shard-local: no cross-shard merge.

The one-window-deep result pipeline stays as in the reference package:
:meth:`ShardedScorer.process_window` returns the previous window's rows,
and :meth:`~ShardedScorer.flush` drains the last.

Eager PyTorch compiles nothing per shape, so the reference's pow2 padding
of each shard's pairs and rows is gone (padding rows were dropped before
any answer), and the vocabulary pads to a multiple of the shard count
only: the kernel takes any ``I``, so there is no column-tile multiple.
Score rows still go in ``max_score_rows`` chunks per shard, which bound
the plain version's ``[S, I]`` working set and fix the order rows come
out in (chunk by chunk, shards in order within a chunk, as the
reference package emits them).

Multi-process runs (``--coordinator``, per-process ``C_local``
checkpoints) are not ported: a ``C_local`` checkpoint is refused.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import tuning
from ..metrics import Counters, RESCORED_ITEMS, ROW_SUM_PROCESS_WINDOW
from ..observability import LEDGER
from ..observability.registry import REGISTRY, log_buckets
from ..ops.aggregate import (aggregate_window_coo, distinct_sorted,
                             narrow_deltas_int32)
from ..ops.device_scorer import (_apply_coo, fit_count_dtype,
                                 score_row_budget, upload)
from ..ops.score_topk import MAX_TOP_K, score_topk_local
from ..state.results import TopKBatch
from .mesh import make_mesh, pad_to_multiple

#: Row-count ladder for the dispatch-size histogram: 1 .. 2^24 rows.
ROWS_BUCKETS = log_buckets(1.0, 2.0 ** 24)


def _record_shard_metrics(n_rows: int, per_shard_counts) -> None:
    """Per-dispatch distribution metrics (the reference package's).

    ``cooc_scorer_dispatch_rows`` is the per-window scored-row
    distribution; the imbalance gauge is max/mean owned rows across
    shards: 1.0 is a balanced dispatch, and a sustained high value means
    one shard's rows gate every window.
    """
    REGISTRY.histogram(
        "cooc_scorer_dispatch_rows", ROWS_BUCKETS,
        help="distinct rows dispatched for scoring per window").observe(
            max(n_rows, 1))
    counts = np.asarray(per_shard_counts, dtype=np.float64)
    mean = counts.mean()
    if mean > 0:
        REGISTRY.gauge(
            "cooc_shard_row_imbalance",
            help="max/mean owned scored rows across shards "
                 "(1.0 = balanced)").set(float(counts.max() / mean))


class ShardedScorer:
    """Item-row-sharded dense co-occurrence state over a device list.

    ``mesh`` is a list of devices, one per shard (it may repeat a card);
    without it, :func:`~.mesh.make_mesh` takes ``num_shards`` of the
    visible cards, or of the CPU with ``device="cpu"``.
    """

    #: Initial per-shard row capacity in derive-from-data mode
    #: (``num_items == 0``): the vocab grows with the stream, at least
    #: doubling on overflow, as in the reference package.
    AUTO_INITIAL_ROWS = 64

    #: Rows come back one window late (never from a device table).
    defer_results = False

    def __init__(self, num_items: int, top_k: int,
                 num_shards: Optional[int] = None,
                 counters: Optional[Counters] = None,
                 mesh=None,
                 max_score_rows_per_call: int = tuning.default(
                     "max_score_rows_per_call"),
                 count_dtype: str = "int32",
                 device="cuda") -> None:
        if count_dtype not in ("int32", "int16"):
            raise ValueError(
                f"count_dtype must be int32|int16, got {count_dtype}")
        self.mesh = make_mesh(num_shards, devices=mesh, device=device)
        self.n_shards = len(self.mesh)
        if (any(d.type == "cuda" for d in self.mesh)
                and top_k > MAX_TOP_K):
            raise ValueError(
                f"--top-k {top_k} exceeds the CUDA kernel's {MAX_TOP_K}")
        self.count_dtype = np.dtype(count_dtype)
        self._torch_dtype = getattr(torch, count_dtype)
        self.auto_grow = num_items <= 0
        if self.auto_grow:
            num_items = self.AUTO_INITIAL_ROWS * self.n_shards
        self.top_k = top_k
        self.counters = counters if counters is not None else Counters()
        self._max_score_rows_per_call = max_score_rows_per_call
        self.observed = 0  # exact host-side total; fed as float32
        self._pending: Optional[list] = None
        self.last_dispatched_rows = 0
        self._build(num_items)
        R, n = self.rows_per_shard, self.num_items
        self.C_loc = [torch.zeros((R, n), dtype=self._torch_dtype,
                                  device=dev) for dev in self.mesh]
        # One replica per distinct device (a repeated card holds one).
        self.row_sums = {dev: torch.zeros((n,), dtype=torch.int32,
                                          device=dev) for dev in self.mesh}

    def _build(self, num_items: int) -> None:
        """(Re)set the capacity-dependent shard geometry."""
        self.num_items = pad_to_multiple(num_items, self.n_shards)
        self.rows_per_shard = self.num_items // self.n_shards
        # Bound each shard's per-call [S, I] plain-version working set.
        self.max_score_rows = score_row_budget(
            self.num_items, self._max_score_rows_per_call)

    def _place(self, C: np.ndarray, row_sums: np.ndarray) -> None:
        """Lay host ``C`` and row sums out on the mesh (copies: the state
        is updated in place and must not write through)."""
        R = self.rows_per_shard
        self.C_loc = [torch.tensor(C[d * R:(d + 1) * R], device=dev)
                      for d, dev in enumerate(self.mesh)]
        self.row_sums = {dev: torch.tensor(row_sums, device=dev)
                         for dev in self.mesh}

    def _grow(self, need: int) -> None:
        """At least double the vocab capacity and reshard the state, on
        the devices (derive-from-data mode only). Growth moves rows to
        other shards (``rows_per_shard`` changes); a rare event whose cost
        is one copy of ``C``, like the dense backend's reallocation."""
        old_blocks, old_R, old_n = self.C_loc, self.rows_per_shard, \
            self.num_items
        self._build(max(2 * old_n, int(need)))
        R, n = self.rows_per_shard, self.num_items
        blocks = []
        for d, dev in enumerate(self.mesh):
            blk = torch.zeros((R, n), dtype=self._torch_dtype, device=dev)
            for e, old in enumerate(old_blocks):
                a, b = max(d * R, e * old_R), min((d + 1) * R,
                                                  (e + 1) * old_R)
                if a < b:
                    blk[a - d * R:b - d * R, :old_n] = \
                        old[a - e * old_R:b - e * old_R].to(dev)
            blocks.append(blk)
        self.C_loc = blocks
        for dev, rs in self.row_sums.items():
            grown = torch.zeros((n,), dtype=torch.int32, device=dev)
            grown[:old_n] = rs
            self.row_sums[dev] = grown

    def _owner_bounds(self, sorted_ids: np.ndarray) -> np.ndarray:
        """``[D + 1]`` offsets of each shard's slice of sorted ids."""
        return np.searchsorted(
            sorted_ids, np.arange(self.n_shards + 1, dtype=np.int64)
            * self.rows_per_shard)

    def _update(self, src: np.ndarray, dst: np.ndarray,
                delta: np.ndarray) -> None:
        """Each shard scatters its slice of the folded window into its
        block and builds its partial row sums; the partials are summed
        into every replica (the reference package's ``psum``)."""
        bounds = self._owner_bounds(src)
        partials = []
        for d, dev in enumerate(self.mesh):
            lo, hi = bounds[d], bounds[d + 1]
            if lo == hi:
                continue
            part = torch.zeros((self.num_items,), dtype=torch.int32,
                               device=dev)
            _apply_coo(self.C_loc[d], part,
                       upload(src[lo:hi], torch.long, dev),
                       upload(dst[lo:hi], torch.long, dev),
                       upload(delta[lo:hi], torch.int32, dev),
                       row_lo=d * self.rows_per_shard)
            partials.append(part)
        for dev, rs in self.row_sums.items():
            for part in partials:
                rs += part.to(dev)

    def process_window(self, ts: int, pairs) -> TopKBatch:
        """One sharded update + score step; returns the *previous*
        window's rows (one-window-deep pipeline)."""
        self.last_dispatched_rows = 0
        if len(pairs) == 0:
            # No new dispatch: drain the in-flight results now instead of
            # withholding them behind idle windows.
            return self.flush()
        src, dst, delta64 = aggregate_window_coo(
            pairs.src, pairs.dst, pairs.delta)
        delta = narrow_deltas_int32(delta64)
        max_id = int(max(src.max(), dst.max()))
        if max_id >= self.num_items:
            if not self.auto_grow:
                raise ValueError(f"item id {max_id} exceeds --num-items "
                                 f"capacity {self.num_items}")
            self._grow(max_id + 1)
        self._update(src, dst, delta)

        window_sum = int(pairs.delta.sum())
        self.observed += window_sum
        self.counters.add(ROW_SUM_PROCESS_WINDOW, window_sum)

        rows = distinct_sorted(src)
        self.counters.add(RESCORED_ITEMS, len(rows))
        self.last_dispatched_rows = len(rows)
        bounds = self._owner_bounds(rows)
        counts = np.diff(bounds)
        _record_shard_metrics(len(rows), counts)

        observed = float(np.float32(self.observed))
        launched = []
        for lo in range(0, int(counts.max()), self.max_score_rows):
            for d, dev in enumerate(self.mesh):
                chunk = rows[bounds[d] + lo:min(
                    bounds[d] + lo + self.max_score_rows, bounds[d + 1])]
                if not len(chunk):
                    continue
                vals, idx = score_topk_local(
                    self.C_loc[d], self.row_sums[dev],
                    upload(chunk, torch.int32, dev), d * self.rows_per_shard,
                    observed, self.top_k)
                launched.append((chunk, vals, idx))
        prev, self._pending = self._pending, launched
        return (self._materialize(prev) if prev is not None
                else TopKBatch.empty(self.top_k))

    def flush(self) -> TopKBatch:
        """Emit the in-flight window's rows (end of the pipeline)."""
        prev, self._pending = self._pending, None
        return (self._materialize(prev) if prev is not None
                else TopKBatch.empty(self.top_k))

    def _materialize(self, launched) -> TopKBatch:
        rows_l, idx_l, vals_l = [], [], []
        for chunk, vals, idx in launched:
            rows_l.append(chunk)
            vals_l.append(vals.cpu().numpy())
            idx_l.append(idx.cpu().numpy())
            LEDGER.down(vals_l[-1], idx_l[-1])
        return TopKBatch.concatenate(rows_l, idx_l, vals_l, self.top_k)

    # -- checkpoint ------------------------------------------------------

    def checkpoint_state(self) -> dict:
        """The single-process layout (the dense backend's keys): the full
        ``C``, the row sums and ``observed``, as numpy copies."""
        return {
            "C": np.concatenate([blk.cpu().numpy() for blk in self.C_loc]),
            "row_sums": self.row_sums[self.mesh[0]].to(
                "cpu", copy=True).numpy(),
            "observed": np.asarray([self.observed], dtype=np.int64),
        }

    def restore_state(self, st: dict) -> None:
        """Restore a single-process state dict written by either package
        under any shard count or capacity: the state is rebuilt at the
        larger of the checkpoint's capacity and this scorer's (never below
        the configured ``--num-items``), padded to a multiple of the shard
        count, and zero-extended."""
        if "C_local" in st:
            raise ValueError(
                "checkpoint was written by a multi-host run (per-process "
                "row blocks): multi-host runs are not ported")
        C = fit_count_dtype(st["C"], self.count_dtype)
        if C.shape[0] != self.num_items:
            self._build(max(C.shape[0], self.num_items))
            grown = np.zeros((self.num_items, self.num_items), C.dtype)
            grown[:C.shape[0], :C.shape[1]] = C
            C = grown
        rs = np.asarray(st["row_sums"], dtype=np.int32)
        if len(rs) != self.num_items:
            grown_rs = np.zeros((self.num_items,), dtype=np.int32)
            grown_rs[:len(rs)] = rs
            rs = grown_rs
        self._place(C, rs)
        self.observed = int(st["observed"][0])
        # In-flight rows belong to windows after the checkpoint.
        self._pending = None
