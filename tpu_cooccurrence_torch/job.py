"""The job: ingest -> windowing -> sampling -> device scoring.

Port of ``tpu_cooccurrence/job.py`` with the dense (``--backend device``,
chained or ``--fused-window``), the sparse slab (``--backend sparse``) and
the row-sharded dense (``--backend sharded``) scorers, serial or
pipelined (``--pipeline-depth``, ``pipeline.py``), and full checkpoints
(``--checkpoint-dir``, ``state/checkpoint.py``).
The host streams micro-batches through the window engine and the
vectorized cut operators, and each fired window becomes one scorer step
(scatter-update, then LLR + top-K on the card). The feedback edge
(reject -> item-counter decrement) is a plain update applied on the
sampling thread between window fires, at every depth.

Duration and the accumulator dump mirror the reference's end-of-run
logging (``FlinkCooccurrences.java:173-181``).
"""

from __future__ import annotations

import json
import logging
import time
from typing import Iterable

import numpy as np

from .config import Config
from .io.parse import InteractionBatch
from .metrics import (Counters, FEEDBACK_QUEUES, ITEM_LATE_ELEMENTS,
                      RESCORED_ITEMS, USER_LATE_ELEMENTS,
                      USER_RECEIVED_ELEMENTS)
from .observability import StepTimer, WindowStats, clock
from .observability.registry import REGISTRY
from .ops.device_scorer import DeviceScorer
from .parallel.sharded import ShardedScorer
from .pipeline import PipelineDriver, StagedWindow
from .sampling.item_cut import ItemInteractionCut
from .sampling.reservoir import UserReservoirSampler
from .state import checkpoint as ckpt
from .state.results import LatestResults, TopKBatch
from .state.sparse_scorer import SparseDeviceScorer
from .state.vocab import IdMap
from .windowing.engine import WindowEngine

LOG = logging.getLogger("tpu_cooccurrence_torch")


class CooccurrenceJob:
    """Streaming co-occurrence job over a device scorer."""

    def __init__(self, config: Config, scorer=None) -> None:
        if config.window_millis <= 0:
            raise ValueError("window size must be positive")
        self.config = config
        self.counters = Counters()
        self.engine = WindowEngine(config.window_millis)
        self.item_vocab = IdMap()
        self.user_vocab = IdMap()
        self.item_cut = ItemInteractionCut(config.item_cut, capacity=1024)
        self.sampler = UserReservoirSampler(
            config.user_cut, config.seed, config.skip_cuts,
            counters=self.counters)
        self.scorer = scorer if scorer is not None else self._make_scorer()
        if getattr(self.scorer, "wants_baskets", False):
            # The fused window: the sampler hands the scorer un-expanded
            # star ops, which the card expands (ops/expand.py).
            self.sampler.emit_baskets = True
        # external item id -> [(external other, score) desc]
        self.latest = LatestResults(self.item_vocab)
        # Optional streaming hook, called with every absorbed window
        # output (dense-id rows); None = final-state only.
        self.on_update = None
        self.emissions = 0
        self.windows_fired = 0
        self.duration_ms = 0
        self.step_timer = StepTimer()
        self._hist_sample = REGISTRY.histogram(
            "cooc_window_sample_seconds",
            help="host sampling stage seconds per fired window")
        self._hist_score = REGISTRY.histogram(
            "cooc_window_score_seconds",
            help="scorer stage seconds per fired window")
        # File source attached by the CLI, so periodic checkpoints record
        # the input position too (a resumed run continues mid-file).
        self.source = None
        # One in-process feedback channel (the reference counts one queue
        # handshake per subtask open,
        # UserInteractionCounterOneInputStreamOperator.java:109).
        if not config.skip_cuts:
            self.counters.add(FEEDBACK_QUEUES, 1)
        # Pipelined window loop (--pipeline-depth > 0): the caller thread
        # samples window N+1 while a worker thread scores window N. Depth
        # 0 is the serial path, bit-identical by the parity tests.
        self.pipeline = (PipelineDriver(self, config.pipeline_depth)
                         if config.pipeline_depth > 0 else None)

    def _make_scorer(self):
        """The configured backend's scorer. Without --emit-updates results
        stay in a device table until the final flush."""
        cfg = self.config
        if cfg.backend == "hybrid":
            LOG.warning("--backend hybrid is retired; running the sparse "
                        "backend (checkpoints are interchangeable)")
        if cfg.sparse:
            # --cell-dtype / --wire-format auto: int16 cells and the packed
            # uplink, as in the JAX package.
            return SparseDeviceScorer(
                cfg.top_k, self.counters, cfg.development_mode,
                score_ladder=cfg.score_ladder,
                defer_results=not cfg.emit_updates,
                cell_dtype=cfg.resolved_cell_dtype,
                wire_format=cfg.resolved_wire_format, device=cfg.device)
        if cfg.backend == "sharded":
            # One process over --num-shards devices (the visible cards, or
            # the CPU); num_items == 0 derives the vocab from the data
            # (growth reshards).
            return ShardedScorer(
                cfg.num_items, cfg.top_k, num_shards=cfg.num_shards,
                counters=self.counters, count_dtype=cfg.count_dtype,
                device=cfg.device)
        # num_items == 0 derives the vocab from the data (the scorer
        # doubles C on growth); an explicit value is a hard capacity.
        return DeviceScorer(
            cfg.num_items, cfg.top_k, self.counters,
            max_pairs_per_step=cfg.max_pairs_per_step,
            count_dtype=cfg.count_dtype, device=cfg.device,
            defer_results=not cfg.emit_updates,
            fused_window=cfg.fused_window)

    def add_batch(self, users: np.ndarray, items: np.ndarray,
                  ts: np.ndarray) -> None:
        """Ingest one parsed interaction batch (stream order)."""
        dense_items = self.item_vocab.map_batch(items)
        if (self.config.num_items
                and len(self.item_vocab) > self.config.num_items):
            raise ValueError(
                f"item vocabulary exceeded --num-items capacity "
                f"({len(self.item_vocab)} > {self.config.num_items})")
        dense_users = self.user_vocab.map_batch(users)
        n_late = self.engine.add_batch(dense_users, dense_items, ts)
        if n_late:
            # The reference counts late drops at both cut operators.
            self.counters.add(ITEM_LATE_ELEMENTS, n_late)
            self.counters.add(USER_LATE_ELEMENTS, n_late)
        if self.config.development_mode:
            self.counters.add(USER_RECEIVED_ELEMENTS, len(users) - n_late)
        self._drain(final=False)

    def finish(self) -> None:
        """End of stream: Watermark(MAX_VALUE) fires everything."""
        try:
            self._drain(final=True)
        except BaseException:
            if self.pipeline is not None:
                # Join the worker so no thread outlives the job, but keep
                # the in-flight exception as THE failure (a close() here
                # could replace it with the worker's latched error).
                self.pipeline._shutdown_worker()
            raise
        if self.pipeline is not None:
            # Ordered shutdown: the final drain already barriered, so the
            # close is immediate; it also surfaces any latched worker
            # error before the balance check below can mask it.
            self.pipeline.close()
        if (self.config.development_mode
                and not self.scorer.defer_results):
            # Every row dispatched must be materialized exactly once (the
            # reference's buffered-element balance counters). Deferred
            # results are exempt: a row rescored in N windows drains once.
            rescored = self.counters.get(RESCORED_ITEMS)
            if self.emissions != rescored:
                raise AssertionError(
                    f"result pipeline out of balance: {rescored} rows "
                    f"dispatched but {self.emissions} materialized")

    def abort(self) -> None:
        """Teardown after a failure outside :meth:`finish` (or a run left
        unfinished on purpose): join the scorer worker so no thread keeps
        launching. Idempotent."""
        if self.pipeline is not None:
            self.pipeline._shutdown_worker()

    def run(self, batches: Iterable[InteractionBatch]) -> LatestResults:
        start = time.monotonic_ns()
        try:
            for users, items, ts in batches:
                self.add_batch(users, items, ts)
        except BaseException:
            self.abort()
            raise
        self.finish()
        duration_ms = (time.monotonic_ns() - start) // 1_000_000
        LOG.info("Duration\t%d", duration_ms)
        LOG.info("Accumulator results: %s", self.counters)
        LOG.info("Step timing: %s", self.step_timer.summary())
        LOG.info("Stage occupancy: %s", self.step_timer.occupancy(
            duration_ms / 1000.0, self.pipeline))
        LOG.info("Slowest windows: %s",
                 json.dumps(self.step_timer.slowest_as_dicts()))
        LOG.info("Window stage seconds: %s", json.dumps(REGISTRY.summaries()))
        self.duration_ms = duration_ms
        return self.latest

    def _drain(self, final: bool) -> None:
        for ts, users, items in self.engine.fire_ready(final=final):
            self.windows_fired += 1
            with clock() as sample_clock:
                if self.config.skip_cuts:
                    sampled = np.ones(len(items), dtype=bool)
                else:
                    sampled = self.item_cut.fire(items)
                pairs, feedback_items = self.sampler.fire(users, items,
                                                          sampled)
                # Feedback decrements before the next window fire
                # (ItemInteractionCounterTwoInputStreamOperator.java:94-116).
                if not self.config.skip_cuts and len(feedback_items):
                    self.item_cut.apply_feedback(
                        feedback_items, self.config.development_mode,
                        self.counters)
                if self.pipeline is not None:
                    # Fold on the sampling thread for a scorer that takes
                    # folded deltas: the worker's turn then starts at slot
                    # allocation.
                    payload, slot = self._stage(pairs)
            if self.pipeline is not None:
                self.pipeline.submit(StagedWindow(
                    ts=ts, payload=payload, events=len(items),
                    raw_pairs=len(pairs),
                    sample_seconds=sample_clock.seconds, slot=slot))
            else:
                with clock() as score_clock:
                    window_out = self.scorer.process_window(ts, pairs)
                self._record_window(WindowStats(
                    timestamp=ts, events=len(items), pairs=len(pairs),
                    rows_scored=self.scorer.last_dispatched_rows,
                    sample_seconds=sample_clock.seconds,
                    score_seconds=score_clock.seconds))
                self._absorb(window_out)
            every = self.config.checkpoint_every_windows
            if (self.config.checkpoint_dir and every > 0
                    and self.windows_fired % every == 0):
                # checkpoint() barriers the pipeline first, so the
                # snapshot point is the serial path's.
                self.checkpoint(source=self.source)
        if final:
            if self.pipeline is not None:
                self.pipeline.barrier()
            # The deferred device table (or the sparse scorer's one-window
            # pipeline) holds the scored rows; drain it.
            self._absorb(self.scorer.flush())

    def _stage(self, pairs):
        """Producer-side staging: fold into a ring slot when the scorer
        accepts folded deltas, raw pass-through otherwise. Returns
        ``(payload, slot)``."""
        if len(pairs) and getattr(self.scorer, "accepts_aggregated", False):
            return self.pipeline.stage(pairs)
        return pairs, None

    def _record_window(self, stats: WindowStats) -> None:
        """One fired window's observability: the step timer and the stage
        histograms. Runs on whichever thread scores windows (the caller
        serially, the scorer worker pipelined)."""
        self.step_timer.record(stats)
        self._hist_sample.observe(stats.sample_seconds)
        self._hist_score.observe(stats.score_seconds)

    def _absorb(self, window_out: TopKBatch) -> None:
        self.latest.absorb_batch(window_out)
        self.emissions += len(window_out)
        if self.on_update is not None and len(window_out):
            self.on_update(window_out)

    def checkpoint(self, source=None) -> None:
        """Write a checkpoint generation of the job (and ``source``'s
        position) to ``--checkpoint-dir``."""
        if self.pipeline is not None:
            # Every submitted window must be scored and absorbed before
            # the snapshot, or the scorer state would lag the sampler's.
            self.pipeline.barrier()
        # Rows still in the scorer's result pipeline or deferred table
        # belong to windows already processed: land them first.
        self._absorb(self.scorer.flush())
        ckpt.save(self, self.config.checkpoint_dir, source=source)

    def restore(self, source=None) -> None:
        """Restore the newest checkpoint in ``--checkpoint-dir`` that
        verifies (and ``source``'s position); raises :class:`ValueError`
        for one this job cannot take."""
        ckpt.restore(self, self.config.checkpoint_dir, source=source)
