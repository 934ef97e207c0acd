"""File ingestion (copy of ``tpu_cooccurrence/io/source.py``, trimmed).

Monitors a file or directory and streams its lines: files are forwarded
sorted by modification time (then path), each read whole in line order
(``ContinuousFileMonitoringFunction.java:239-257``). ``PROCESS_ONCE`` reads
the current snapshot and stops; ``PROCESS_CONTINUOUSLY`` re-lists and
forwards newer files.

The position is checkpointable (reference :380-392), mid-file included:
the cursor markers ride ``meta["source"]`` (:meth:`checkpoint_state`),
and the ingest-offset section ``meta["ingest_offsets"]``
(:meth:`offsets_state`) carries the rewrite guard of the file a
checkpoint is inside, so a restored run resumes at the exact line of an
unchanged or append-only grown file and skips a rewritten one. The
partitioned log, the dead-letter quarantine, the degradation admission
gate and fault injection are not ported.
"""

from __future__ import annotations

import hashlib
import logging
import os
import time
from typing import Iterator, List, Optional, Tuple

from ..metrics import Counters, SPLIT_READER_NUM_SPLITS

LOG = logging.getLogger("tpu_cooccurrence_torch.io.source")

#: Cap on the head-prefix hash that guards a checkpointed in-flight file:
#: enough bytes to make an accidental rewrite collision implausible, few
#: enough that restore verification never re-reads a large file.
HEAD_HASH_BYTES = 65536


def head_hash(path: str, nbytes: int) -> str:
    """SHA-256 hex digest of the first ``min(nbytes, HEAD_HASH_BYTES)``
    bytes of ``path``: the rewrite guard both sides of a checkpoint
    compute over the same prefix length (append-only growth beyond the
    checkpointed length never changes it)."""
    limit = min(int(nbytes), HEAD_HASH_BYTES)
    digest = hashlib.sha256()
    with open(path, "rb") as f:
        digest.update(f.read(limit))
    return digest.hexdigest()


class FileMonitorSource:
    """Streams lines from a file or directory in modification-time order."""

    def __init__(self, path: str, counters: Optional[Counters] = None,
                 process_continuously: bool = False,
                 poll_interval_s: float = 1.0) -> None:
        self.path = path
        self.counters = counters or Counters()
        self.process_continuously = process_continuously
        self.poll_interval_s = poll_interval_s
        # Monotone progress marker, advanced only when a file has been
        # fully consumed; the mid-file position is carried separately.
        self.global_modification_time: int = -1
        self._current_file: Optional[str] = None
        self._current_mtime: int = -1
        self._current_line: int = 0
        # Restored in-flight rewrite guard, consumed once by lines(); a
        # file it condemns is never listed again.
        self._in_flight_guard: Optional[dict] = None
        self._dropped_paths: set = set()

    # -- checkpoint hooks ------------------------------------------------

    def checkpoint_state(self) -> dict:
        return {
            "global_modification_time": self.global_modification_time,
            "current_file": self._current_file,
            "current_mtime": self._current_mtime,
            "current_line": self._current_line,
        }

    def restore_state(self, state: dict) -> None:
        self.global_modification_time = int(state["global_modification_time"])
        self._current_file = state.get("current_file")
        self._current_mtime = int(state.get("current_mtime", -1))
        self._current_line = int(state.get("current_line", 0))

    def offsets_state(self) -> dict:
        return {"v": 1, "format": "files",
                "in_flight": self._in_flight_state()}

    def restore_offsets(self, state: dict) -> None:
        state = state or {}
        if int(state.get("v", 1)) != 1:
            LOG.warning("ingest offset section v=%s is newer than this "
                        "reader (v=1): applying best-effort",
                        state.get("v"))
        fmt = state.get("format", "files")
        if fmt != "files":
            raise ValueError(
                f"checkpoint ingest offsets carry format {fmt!r}; the "
                f"port reads files only (--source-format partitioned is "
                f"not ported)")
        self._in_flight_guard = state.get("in_flight")

    def _in_flight_state(self) -> Optional[dict]:
        """Rewrite guard for the file a mid-file checkpoint is inside:
        (mtime, size, head-prefix hash), enough for a restore to tell an
        append-only grown file (resume exactly) from a rewritten one
        (skip it, never silently re-read it whole)."""
        if self._current_file is None:
            return None
        try:
            st = os.stat(self._current_file)
            digest = head_hash(self._current_file, st.st_size)
        except OSError:
            return None
        return {"path": self._current_file, "mtime": int(st.st_mtime_ns),
                "size": int(st.st_size), "head_hash": digest}

    def _verify_in_flight(self, guard: dict) -> str:
        """``"ok"`` (unchanged or append-only grown), ``"rewritten"``
        (shrunk or head-prefix mismatch) or ``"missing"`` for the
        checkpointed in-flight file."""
        path = guard.get("path")
        size = int(guard.get("size", 0))
        try:
            st = os.stat(path)
            if (st.st_size == size
                    and int(st.st_mtime_ns) == int(guard.get("mtime", -1))):
                return "ok"  # untouched since the checkpoint
            if st.st_size < size:
                return "rewritten"
            if head_hash(path, size) != guard.get("head_hash"):
                return "rewritten"
        except OSError:
            return "missing"
        return "ok"

    # -- listing ---------------------------------------------------------

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
            if not os.path.isfile(p) or p in self._dropped_paths:
                continue
            mtime = os.stat(p).st_mtime_ns
            if mtime > self.global_modification_time:
                splits.append((mtime, p))
        splits.sort()
        return splits

    def origin(self) -> Tuple[str, int]:
        """``(path, lineno)`` of the line most recently yielded."""
        return (self._current_file or self.path, self._current_line)

    # -- reading ---------------------------------------------------------

    def lines(self) -> Iterator[Optional[str]]:
        """Yield all input lines, file by file, in order.

        While a file is open, (path, mtime, lines yielded) track the exact
        position, so a checkpoint taken between batches loses nothing. A
        restored source skips the consumed prefix of the in-flight file:
        with the checkpoint's guard an unchanged or append-only grown file
        resumes at the exact line even when its mtime moved, and a shrunk
        or rewritten one is skipped (its events beyond the checkpoint are
        not recoverable); without a guard it resumes only on an unchanged
        mtime and is re-read whole otherwise.
        """
        skip_file = self._current_file
        skip_mtime = self._current_mtime
        skip_lines = self._current_line
        resume_any_mtime = False
        guard, self._in_flight_guard = self._in_flight_guard, None
        if (skip_file is not None and guard is not None
                and guard.get("path") == skip_file):
            verdict = self._verify_in_flight(guard)
            if verdict == "ok":
                resume_any_mtime = True
            elif verdict == "rewritten":
                LOG.warning("in-flight input file %s was rewritten under a "
                            "checkpoint (shrunk or head-prefix mismatch): "
                            "skipping it", skip_file)
                self._dropped_paths.add(skip_file)
        while True:
            splits = self._list_splits()
            if skip_file is not None:
                # Consumption order is the (mtime, path) sort, so files
                # ordered before the in-flight one were fully consumed even
                # when they share its mtime.
                splits = [s for s in splits if s >= (skip_mtime, skip_file)]
            for pos, (mtime, p) in enumerate(splits):
                self.counters.add(SPLIT_READER_NUM_SPLITS, 1)
                to_skip = skip_lines if (p == skip_file
                                         and (mtime == skip_mtime
                                              or resume_any_mtime)) else 0
                self._current_file = p
                self._current_mtime = mtime
                self._current_line = to_skip
                with open(p, "r") as f:
                    for line in f:
                        if to_skip:  # raw-line count, blank lines included
                            to_skip -= 1
                            continue
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
                self._current_mtime = -1
                self._current_line = 0
            skip_file = None  # the restored position applies only once
            if not self.process_continuously:
                return
            yield None  # idle heartbeat for the batcher's latency flush
            time.sleep(self.poll_interval_s)
