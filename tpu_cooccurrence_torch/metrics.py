"""Counter registry mirroring the reference's Flink accumulators.

Copy of ``tpu_cooccurrence/metrics.py`` trimmed to the counters the
port's slice reads. Counter names are byte-identical to the reference
accumulators (``FlinkCooccurrences.java:181``) so runs of either package
are comparable.
"""

from __future__ import annotations

import threading
from collections import defaultdict
from typing import Dict


class Counters:
    """A flat named-counter registry (Flink accumulator analogue)."""

    def __init__(self) -> None:
        self._counters: Dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()

    def add(self, name: str, delta: int = 1) -> None:
        with self._lock:
            self._counters[name] += delta

    def get(self, name: str) -> int:
        with self._lock:
            return self._counters.get(name, 0)

    def as_dict(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counters)

    def replace_all(self, values: Dict[str, int]) -> None:
        """Overwrite all counters (checkpoint restore)."""
        with self._lock:
            self._counters.clear()
            self._counters.update(values)

    def __repr__(self) -> str:
        with self._lock:
            inner = ", ".join(
                f"{k}={v}" for k, v in sorted(self._counters.items()))
        return f"{{{inner}}}"


# Canonical counter names (kept identical to the reference accumulators).
ITEM_LATE_ELEMENTS = "ItemInteractionCounterLateElements"
ITEM_FEEDBACK_ELEMENTS = "ItemInteractionCounterFeedbackElements"  # dev-mode
USER_LATE_ELEMENTS = "UserInteractionCounterLateElements"
OBSERVED_COOCCURRENCES = "UserInteractionCounterObservedCooccurrences"
FEEDBACK_QUEUES = "UserInteractionCounterFeedbackQueues"
USER_RECEIVED_ELEMENTS = "UserInteractionCounterReceivedElements"  # dev-mode
RESCORED_ITEMS = "ItemRowRescorerRescoredItems"
ROW_SUM_PROCESS_WINDOW = "RowSumProcessWindowRowSum"
SPLIT_READER_NUM_SPLITS = "SplitReaderNumSplits"
