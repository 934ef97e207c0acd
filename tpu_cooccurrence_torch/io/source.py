"""File ingestion (copy of ``tpu_cooccurrence/io/source.py``, trimmed).

Monitors a file or directory and streams its lines: files are forwarded
sorted by modification time (then path), each read whole in line order
(``ContinuousFileMonitoringFunction.java:239-257``). ``PROCESS_ONCE`` reads
the current snapshot and stops; ``PROCESS_CONTINUOUSLY`` re-lists and
forwards newer files. Checkpoint cursors, the quarantine, the degradation
admission gate and fault injection are not ported yet.
"""

from __future__ import annotations

import os
import time
from typing import Iterator, List, Optional, Tuple

from ..metrics import Counters, SPLIT_READER_NUM_SPLITS


class FileMonitorSource:
    """Streams lines from a file or directory in modification-time order."""

    def __init__(self, path: str, counters: Optional[Counters] = None,
                 process_continuously: bool = False,
                 poll_interval_s: float = 1.0) -> None:
        self.path = path
        self.counters = counters or Counters()
        self.process_continuously = process_continuously
        self.poll_interval_s = poll_interval_s
        self.global_modification_time: int = -1
        self._current_file: Optional[str] = None
        self._current_line: int = 0

    def _list_splits(self) -> List[Tuple[int, str]]:
        """New files as (mtime_ns, path), sorted by modification time then
        path, filtered to mtime > max seen."""
        if os.path.isdir(self.path):
            candidates = [
                os.path.join(self.path, name)
                for name in os.listdir(self.path)
                if not name.startswith((".", "_"))
            ]
        else:
            candidates = [self.path]
        splits = []
        for p in candidates:
            if not os.path.isfile(p):
                continue
            mtime = os.stat(p).st_mtime_ns
            if mtime > self.global_modification_time:
                splits.append((mtime, p))
        splits.sort()
        return splits

    def origin(self) -> Tuple[str, int]:
        """``(path, lineno)`` of the line most recently yielded."""
        return (self._current_file or self.path, self._current_line)

    def lines(self) -> Iterator[Optional[str]]:
        """Yield all input lines, file by file, in order."""
        while True:
            splits = self._list_splits()
            for pos, (mtime, p) in enumerate(splits):
                self.counters.add(SPLIT_READER_NUM_SPLITS, 1)
                self._current_file = p
                self._current_line = 0
                with open(p, "r") as f:
                    for line in f:
                        self._current_line += 1
                        line = line.rstrip("\n")
                        if line:
                            yield line
                # Advance the marker once the LAST file sharing this mtime
                # completes (the listing filters with a strict >).
                last_of_mtime = (pos + 1 == len(splits)
                                 or splits[pos + 1][0] > mtime)
                if last_of_mtime and mtime > self.global_modification_time:
                    self.global_modification_time = mtime
                self._current_file = None
            if not self.process_continuously:
                return
            yield None  # idle heartbeat for the batcher's latency flush
            time.sleep(self.poll_interval_s)
