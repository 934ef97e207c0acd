"""Per-window instrumentation (trimmed copy of the reference package's).

Copy of ``tpu_cooccurrence/observability/__init__.py`` holding what the
port's slice reads: :class:`StepTimer` (per-window stage seconds),
:class:`clock`, and the host<->device :data:`LEDGER`. The journal, the
HTTP plane and the profiler wrapper are not ported yet.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Deque, Dict


@dataclasses.dataclass
class WindowStats:
    timestamp: int
    events: int
    pairs: int
    rows_scored: int
    sample_seconds: float
    score_seconds: float

    @property
    def seconds(self) -> float:
        return self.sample_seconds + self.score_seconds

    def as_dict(self) -> Dict[str, object]:
        return {
            "timestamp": self.timestamp,
            "events": self.events,
            "pairs": self.pairs,
            "rows_scored": self.rows_scored,
            "sample_seconds": round(self.sample_seconds, 6),
            "score_seconds": round(self.score_seconds, 6),
            "seconds": round(self.seconds, 6),
        }


class StepTimer:
    """Ring buffer of per-window stats with aggregate summary."""

    def __init__(self, keep: int = 1024) -> None:
        self.windows: Deque[WindowStats] = collections.deque(maxlen=keep)
        self.total_windows = 0
        self.total_events = 0
        self.total_pairs = 0
        self.total_sample_seconds = 0.0
        self.total_score_seconds = 0.0

    def record(self, stats: WindowStats) -> None:
        self.windows.append(stats)
        self.total_windows += 1
        self.total_events += stats.events
        self.total_pairs += stats.pairs
        self.total_sample_seconds += stats.sample_seconds
        self.total_score_seconds += stats.score_seconds

    def summary(self) -> Dict[str, float]:
        total = self.total_sample_seconds + self.total_score_seconds
        return {
            "windows": self.total_windows,
            "events": self.total_events,
            "pairs": self.total_pairs,
            "sample_seconds": round(self.total_sample_seconds, 4),
            "score_seconds": round(self.total_score_seconds, 4),
            "pairs_per_sec": round(self.total_pairs / total, 1) if total else 0.0,
        }

    def slowest(self, n: int = 3) -> list:
        return sorted(self.windows, key=lambda w: -w.seconds)[:n]

    def slowest_as_dicts(self, n: int = 3) -> list:
        return [w.as_dict() for w in self.slowest(n)]

    def occupancy(self, wall_seconds: float,
                  pipeline=None) -> Dict[str, float]:
        """Per-stage busy fractions of a run's wall clock.

        A serial run's ``host_busy_pct + score_busy_pct`` sums to at most
        ~100 (plus ingest outside both stages); a pipelined run's stages
        overlap and may sum past 100, by the overlap won. On the card
        ``score_busy_pct`` is host time in the scorer stage (launches plus
        the synchronising result copies), not device occupancy. With a
        ``pipeline`` (``pipeline.PipelineDriver``) it also reports the
        producer's block time in ``submit`` (``queue_wait_seconds``) and
        waiting for a free staging slot (``ring_stall_seconds``; part of
        the sampling stage's seconds), both growing while the scorer
        stage is the bottleneck, and the worker's busy seconds.
        """
        w = max(wall_seconds, 1e-9)
        out = {
            "host_busy_pct": round(100.0 * self.total_sample_seconds / w, 1),
            "score_busy_pct": round(100.0 * self.total_score_seconds / w, 1),
            "wall_seconds": round(wall_seconds, 4),
        }
        if pipeline is not None:
            out["queue_wait_seconds"] = round(pipeline.queue_wait_seconds, 4)
            out["ring_stall_seconds"] = round(pipeline.ring_stall_seconds, 4)
            out["scorer_busy_seconds"] = round(
                pipeline.scorer_busy_seconds, 4)
        return out


class TransferLedger:
    """Host<->device byte accounting: the scorer records every buffer it
    ships up and every buffer it fetches down, at the call site. Encoded
    uploads (the sparse backend's packed uplink) also record the bytes
    the raw layout would have shipped (``uplink_raw_bytes`` beside
    ``uplink_enc_bytes``)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self.h2d_bytes = 0
            self.d2h_bytes = 0
            self.h2d_calls = 0
            self.d2h_calls = 0
            self.uplink_raw_bytes = 0
            self.uplink_enc_bytes = 0

    def up(self, *arrays) -> None:
        n = sum(int(a.nbytes) for a in arrays)
        with self._lock:
            self.h2d_bytes += n
            self.h2d_calls += 1

    def up_encoded(self, raw_nbytes: int, *arrays) -> None:
        """One encoded upload: ``arrays`` ship (counted on the h2d totals
        like any upload); ``raw_nbytes`` is what the raw layout would have
        shipped for the same window."""
        n = sum(int(a.nbytes) for a in arrays)
        with self._lock:
            self.h2d_bytes += n
            self.h2d_calls += 1
            self.uplink_raw_bytes += int(raw_nbytes)
            self.uplink_enc_bytes += n

    def down(self, *arrays) -> None:
        n = sum(int(a.nbytes) for a in arrays)
        with self._lock:
            self.d2h_bytes += n
            self.d2h_calls += 1

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {"h2d_bytes": self.h2d_bytes, "h2d_calls": self.h2d_calls,
                    "d2h_bytes": self.d2h_bytes, "d2h_calls": self.d2h_calls,
                    "uplink_raw_bytes": self.uplink_raw_bytes,
                    "uplink_enc_bytes": self.uplink_enc_bytes}


#: Process-wide ledger the scorer records into.
LEDGER = TransferLedger()


class clock:  # noqa: N801 - tiny helper
    """``with clock() as c: ...; c.seconds``"""

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        return False
