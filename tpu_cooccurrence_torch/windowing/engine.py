"""Batch-oriented event-time windowing engine (tumbling windows).

Copy of ``tpu_cooccurrence/windowing/engine.py`` trimmed to the tumbling
assigner the port's slice runs (``--window-slide`` is not ported yet):

  * ascending watermarks: ``wm = max_ts_seen - 1`` (Flink
    ``AscendingTimestampExtractor`` semantics,
    ``FlinkCooccurrences.java:221-229``),
  * vectorized late-drop: an event is late iff ``ts < running_max`` at
    arrival (reference :121-123), computed with a prefix max,
  * window buffers keyed by window start, fired in timestamp order once the
    watermark passes ``max_timestamp``.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from .assigners import TumblingWindows


class WindowEngine:
    """Accumulates interaction batches, drops late events, fires windows."""

    def __init__(self, size_ms: int) -> None:
        self.assigner = TumblingWindows(size_ms)
        self.size_ms = size_ms
        self.max_ts_seen: Optional[int] = None
        # window start -> list of (users, items, ts) array chunks
        self._buffers: Dict[int, List[Tuple[np.ndarray, np.ndarray, np.ndarray]]] = {}

    @property
    def watermark(self) -> Optional[int]:
        return None if self.max_ts_seen is None else self.max_ts_seen - 1

    def add_batch(self, users: np.ndarray, items: np.ndarray, ts: np.ndarray) -> int:
        """Buffer a batch; returns the number of late-dropped events."""
        if len(ts) == 0:
            return 0
        carry = self.max_ts_seen if self.max_ts_seen is not None else np.iinfo(np.int64).min
        running = np.maximum.accumulate(np.concatenate(([carry], ts)))
        late = ts < running[:-1]
        n_late = int(late.sum())
        if n_late:
            keep = ~late
            users, items, ts = users[keep], items[keep], ts[keep]
        self.max_ts_seen = int(running[-1])
        if len(ts):
            # Post-drop ``ts`` is non-decreasing and the assigner is
            # monotone, so window starts are already sorted: group with a
            # boundary scan, keeping each window's chunks in arrival order.
            starts = self.assigner.assign(ts)
            bounds = np.flatnonzero(starts[1:] != starts[:-1]) + 1
            lo = 0
            for hi in (*bounds.tolist(), len(starts)):
                self._buffers.setdefault(int(starts[lo]), []).append(
                    (users[lo:hi], items[lo:hi], ts[lo:hi]))
                lo = hi
        return n_late

    def fire_ready(self, final: bool = False) -> Iterator[Tuple[int, np.ndarray, np.ndarray]]:
        """Yield ``(window_max_ts, users, items)`` for every complete window,
        in timestamp order. ``final=True`` == Watermark(MAX_VALUE): fire all."""
        wm = np.iinfo(np.int64).max if final else self.watermark
        if wm is None:
            return
        ready = sorted(s for s in self._buffers
                       if self.assigner.max_timestamp(s) <= wm)
        for start in ready:
            chunks = self._buffers.pop(start)
            users = np.concatenate([c[0] for c in chunks])
            items = np.concatenate([c[1] for c in chunks])
            yield self.assigner.max_timestamp(start), users, items
