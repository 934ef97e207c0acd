"""Pipelined window loop: overlap host sampling with the scorer stage.

Copy of ``tpu_cooccurrence/pipeline.py`` without its degradation and
fault-injection hooks (neither plane is ported). The serial job pays
``sample + score`` per window: it samples a window on the caller thread,
then runs the scorer's host work (fold, slot allocation, block packing)
and its launches before sampling the next one. Here a bounded-depth
producer/consumer pipeline overlaps the two:

* the **caller thread** (producer) runs windowing, the cuts and pair
  generation for window ``N+1``, the per-cell fold too when the scorer
  accepts pre-aggregated deltas (:class:`~.ops.aggregate.AggregatedPairs`),
  and applies the feedback edge (item-cut decrements) *before* firing the
  next window, so the sampled stream is bit-identical to the serial
  path's;
* one **scorer worker thread** (consumer) runs ``process_window`` for
  window ``N`` (host index and packing work, uploads and kernel launches
  on the card) and absorbs the window's top-K rows into
  ``LatestResults``, one step behind the producer.

Every launch and every upload of the scorer is issued from the worker
thread; the producer touches the card only at a :meth:`PipelineDriver.barrier`
(the checkpoint, and the end-of-stream flush), when the worker is idle.

**Staging ring.** Folded windows ride a ring of ``depth + 1`` reusable
host buffers: one slot per queue position plus one for whichever side is
packing or scoring. When every slot is in flight the producer blocks in
``stage`` until the worker recycles one. A slot is recycled only after
the worker's ``process_window`` for it returns; by then the scorer has
copied what it needs into its own arrays and synchronous uploads, so
nothing in flight reads a slot the producer refills.

**Ordering and shutdown.** The queue is FIFO and the worker is single:
windows are scored in exactly the serial order, and
:meth:`PipelineDriver.close` processes everything already submitted
before joining the thread, so a mid-stream shutdown drops or
double-applies nothing. A worker failure (a kernel build or launch that
fails included) is latched and re-raised on the caller thread as
:class:`PipelineError` at the next ``submit``/``barrier``/``close``; the
worker keeps draining and recycling queued slots so the producer can
never deadlock against a dead consumer.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Optional

import numpy as np

from .observability import WindowStats, clock
from .observability.registry import REGISTRY
from .ops.aggregate import AggregatedPairs

#: Queue sentinel: process everything already enqueued, then exit.
_SHUTDOWN = object()


class PipelineError(RuntimeError):
    """A scorer-worker failure, re-raised on the caller thread."""


@dataclasses.dataclass
class StagedWindow:
    """One sampled window handed from the producer to the scorer worker."""

    ts: int
    payload: object          # PairDeltaBatch | BasketBatch | AggregatedPairs
    events: int              # window event count (observability)
    raw_pairs: int           # pre-fold pair count (stats parity w/ serial)
    sample_seconds: float    # producer-side stage time for this window
    slot: Optional["_StagingSlot"] = None  # ring slot backing the payload


class _StagingSlot:
    """One ring slot: growable buffers for a folded window."""

    __slots__ = ("key", "delta", "src", "dst")

    def __init__(self) -> None:
        self.key = np.empty(0, np.int64)
        self.delta = np.empty(0, np.int64)
        self.src = np.empty(0, np.int32)
        self.dst = np.empty(0, np.int32)

    def pack(self, src, dst, delta, key) -> AggregatedPairs:
        m = len(key)
        if m > len(self.key):
            cap = max(1 << 12, 1 << (m - 1).bit_length())
            self.key = np.empty(cap, np.int64)
            self.delta = np.empty(cap, np.int64)
            self.src = np.empty(cap, np.int32)
            self.dst = np.empty(cap, np.int32)
        self.key[:m] = key
        self.delta[:m] = delta
        self.src[:m] = src
        self.dst[:m] = dst
        return AggregatedPairs(self.src[:m], self.dst[:m], self.delta[:m],
                               self.key[:m])


class StagingRing:
    """Bounded pool of :class:`_StagingSlot`; ``stage`` blocks when every
    slot is in flight (the memory-bound form of backpressure)."""

    def __init__(self, depth: int) -> None:
        self._free: "queue.Queue[_StagingSlot]" = queue.Queue()
        # depth queue positions + 1 for the side actively packing or
        # scoring: the producer can block here, but the worker's release
        # always unblocks it.
        for _ in range(depth + 1):
            self._free.put(_StagingSlot())

    def stage(self, pairs) -> "tuple[AggregatedPairs, _StagingSlot, float]":
        """Fold one window's raw pair deltas and pack them into a slot.
        Returns the payload, its slot and the seconds spent waiting for
        the slot."""
        with clock() as wait:
            slot = self._free.get()
        agg = AggregatedPairs.fold(pairs.src, pairs.dst, pairs.delta)
        return (slot.pack(agg.src, agg.dst, agg.delta, agg.key), slot,
                wait.seconds)

    def release(self, slot: _StagingSlot) -> None:
        self._free.put(slot)


class PipelineDriver:
    """Depth-bounded scorer pipeline owned by a :class:`~.job.CooccurrenceJob`.

    ``depth`` bounds how many sampled-but-unscored windows may be queued;
    the producer blocks on ``submit`` beyond that (backpressure, not
    unbounded buffering). Depth 1 overlaps one window of sampling with
    one window of scoring; depth 2 also rides out jitter between the two
    stages' per-window costs.
    """

    def __init__(self, job, depth: int) -> None:
        if depth < 1:
            raise ValueError(f"pipeline depth must be >= 1, got {depth}")
        self.job = job
        self.depth = depth
        self.ring = StagingRing(depth)
        self._queue: "queue.Queue[object]" = queue.Queue(maxsize=depth)
        self._worker: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        # Written by the worker only; read after a barrier or close.
        self.windows_processed = 0
        self.scorer_busy_seconds = 0.0
        # Cumulative producer block time (producer only): in submit, the
        # queue-bound backpressure; in stage, the wait for a free ring
        # slot, the memory-bound form (billed to sampling too, as the
        # reference package bills it).
        self.queue_wait_seconds = 0.0
        self.ring_stall_seconds = 0.0
        self._hist_queue_wait = REGISTRY.histogram(
            "cooc_pipeline_queue_wait_seconds",
            help="producer block time submitting a window (backpressure)")

    # -- producer side ---------------------------------------------------

    def stage(self, pairs) -> "tuple[AggregatedPairs, _StagingSlot]":
        """Fold ``pairs`` into a free ring slot (blocks while every slot is
        in flight)."""
        payload, slot, wait = self.ring.stage(pairs)
        self.ring_stall_seconds += wait
        return payload, slot

    def submit(self, staged: StagedWindow) -> None:
        """Enqueue one sampled window (blocks at ``depth`` queued)."""
        self._raise_if_failed()
        self._ensure_worker()
        with clock() as wait:
            self._queue.put(staged)
        self.queue_wait_seconds += wait.seconds
        self._hist_queue_wait.observe(wait.seconds)

    def barrier(self) -> None:
        """Block until every submitted window is scored and absorbed: after
        it, the scorer and ``LatestResults`` hold exactly the serial
        path's state for the submitted prefix."""
        if self._worker is not None:
            self._queue.join()
        self._raise_if_failed()

    def close(self) -> None:
        """Ordered shutdown: drain everything submitted, then join."""
        self._shutdown_worker()
        self._raise_if_failed()

    def _shutdown_worker(self) -> None:
        """Drain the queue, stop the worker, join it. Idempotent."""
        if self._worker is not None and self._worker.is_alive():
            self._queue.put(_SHUTDOWN)
            self._worker.join()
        self._worker = None

    def _raise_if_failed(self) -> None:
        if self._error is not None:
            # Tear the worker down before surfacing the error: a caller
            # that catches PipelineError and drops the job must not leak
            # a parked thread pinning the scorer and its device memory.
            self._shutdown_worker()
            raise PipelineError(
                "pipeline scorer worker failed; the job cannot continue "
                f"({type(self._error).__name__}: {self._error})"
            ) from self._error

    def _ensure_worker(self) -> None:
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(
                target=self._run, name="cooc-pipeline-scorer", daemon=True)
            self._worker.start()

    # -- worker side -----------------------------------------------------

    def _run(self) -> None:
        while True:
            item = self._queue.get()
            if item is _SHUTDOWN:
                self._queue.task_done()
                return
            try:
                if self._error is None:
                    self._process(item)
            except BaseException as exc:  # latched; re-raised on caller
                self._error = exc
            finally:
                # Recycle even on failure: the producer may be blocked in
                # ring.stage() and must never deadlock on a dead worker.
                if item.slot is not None:
                    self.ring.release(item.slot)
                self._queue.task_done()

    def _process(self, item: StagedWindow) -> None:
        job = self.job
        with clock() as score_clock:
            window_out = job.scorer.process_window(item.ts, item.payload)
        self.scorer_busy_seconds += score_clock.seconds
        job._record_window(WindowStats(
            timestamp=item.ts, events=item.events, pairs=item.raw_pairs,
            rows_scored=getattr(job.scorer, "last_dispatched_rows",
                                len(window_out)),
            sample_seconds=item.sample_seconds,
            score_seconds=score_clock.seconds))
        job._absorb(window_out)
        self.windows_processed += 1
