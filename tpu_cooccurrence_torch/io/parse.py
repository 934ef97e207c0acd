"""Interaction line parsing (copy of ``tpu_cooccurrence/io/parse.py``).

Parses ``user,item,timestamp`` CSV lines into numpy int64 batches. The
quarantine and fault-injection hooks of the reference are not ported yet:
a malformed line raises :class:`ParseError` with ``path:lineno``
provenance.
"""

from __future__ import annotations

import time
import warnings
from typing import Callable, Iterable, Iterator, List, Optional, Tuple

import numpy as np

# Structured batch: parallel arrays (users, items, timestamps).
InteractionBatch = Tuple[np.ndarray, np.ndarray, np.ndarray]

_INT64_MIN = -(1 << 63)
_INT64_MAX = (1 << 63) - 1
#: Characters of an offending line quoted in a parse error.
RAW_TRUNCATE = 200


class ParseError(ValueError):
    """A rejected interaction line, with full provenance."""

    def __init__(self, source_path: str, lineno: int, raw: str,
                 reason: object) -> None:
        self.source_path = source_path
        self.lineno = lineno
        self.raw = raw
        super().__init__(
            f"{source_path}:{lineno}: {reason} — offending line: "
            f"{raw[:RAW_TRUNCATE]!r}")


def _parse_one(line: str) -> Tuple[int, int, int]:
    u, i, t = line.split(",")
    out = (int(u), int(i), int(t))
    for v in out:
        if not (_INT64_MIN <= v <= _INT64_MAX):
            raise ValueError(f"value {v} out of int64 range")
    return out


def parse_lines(lines: Iterable[str],
                provenance: Optional[List[Tuple[str, int]]] = None
                ) -> InteractionBatch:
    """Parse ``user,item,ts`` lines: numpy's C parser first, the strict
    per-line parse (the reference's ``String.split`` semantics) when the
    fast parse fails or is not faithful."""
    if not isinstance(lines, list):
        lines = list(lines)
    if lines:
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("error", DeprecationWarning)
                arr = np.atleast_2d(np.loadtxt(
                    lines, delimiter=",", dtype=np.int64, comments=None))
            if arr.shape[1] == 3 and arr.shape[0] == len(lines):
                return (arr[:, 0].copy(), arr[:, 1].copy(),
                        arr[:, 2].copy())
        except (ValueError, DeprecationWarning, OverflowError):
            pass  # fall through for the per-line verdict
    users: List[int] = []
    items: List[int] = []
    tss: List[int] = []
    for idx, line in enumerate(lines):
        try:
            u, i, t = _parse_one(line)
        except (ValueError, OverflowError) as exc:
            if provenance is not None and idx < len(provenance):
                src, lineno = provenance[idx]
            else:
                src, lineno = "<stream>", idx + 1
            raise ParseError(src, lineno, line, exc) from exc
        users.append(u)
        items.append(i)
        tss.append(t)
    return (
        np.asarray(users, dtype=np.int64),
        np.asarray(items, dtype=np.int64),
        np.asarray(tss, dtype=np.int64),
    )


def batched_lines(lines: Iterable[Optional[str]], batch_size: int = 65536,
                  max_latency_s: Optional[float] = None,
                  origin: Optional[Callable[[], Tuple[str, int]]] = None
                  ) -> Iterator[InteractionBatch]:
    """Group a line stream into parsed batches, flushed at ``batch_size``
    lines or once the oldest buffered line has waited ``max_latency_s``
    (``None`` items are idle heartbeats from a continuous source)."""
    buf: List[str] = []
    prov: Optional[List[Tuple[str, int]]] = [] if origin is not None else None
    oldest = 0.0

    def flush() -> InteractionBatch:
        out = parse_lines(buf, provenance=prov)
        buf.clear()
        if prov is not None:
            prov.clear()
        return out

    for line in lines:
        if line is None:
            if buf and max_latency_s is not None \
                    and time.monotonic() - oldest >= max_latency_s:
                yield flush()
            continue
        if not buf:
            oldest = time.monotonic()
        buf.append(line)
        if prov is not None:
            prov.append(origin())
        if len(buf) >= batch_size or (
                max_latency_s is not None
                and time.monotonic() - oldest >= max_latency_s):
            yield flush()
    if buf:
        yield flush()
