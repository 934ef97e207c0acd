"""Event-time window assigners (tumbling).

Copy of ``tpu_cooccurrence/windowing/assigners.py`` trimmed to the
tumbling assigner the reference wires everywhere
(``FlinkCooccurrences.java:139,153``). A window is identified by its
start; it covers ``[start, start + size)`` and its ``max_timestamp`` is
``start + size - 1`` (Flink ``TimeWindow`` semantics).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TumblingWindows:
    size_ms: int

    def assign(self, ts: np.ndarray) -> np.ndarray:
        """Vectorized window-start assignment (one window per event)."""
        ts = np.asarray(ts, dtype=np.int64)
        return (ts // self.size_ms) * self.size_ms

    def max_timestamp(self, start: int) -> int:
        return start + self.size_ms - 1
