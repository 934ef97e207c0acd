"""Command-line entry point (port of ``tpu_cooccurrence/cli.py``).

Parses the config, echoes it, builds the job (restoring the newest
checkpoint in ``--checkpoint-dir`` if there is one, the input position
included) and runs it over the file input on the card (``--device cpu``
to run the plain PyTorch path on the CPU), then prints the latest top-K
per item to stdout in the reference package's row format.

    python -m tpu_cooccurrence_torch.cli -i FILE -ws MS [-s SEED] ...
"""

from __future__ import annotations

import logging
import sys
from typing import Optional, Sequence

from .config import Config
from .device import DeviceUnavailable
from .io.parse import batched_lines
from .io.source import FileMonitorSource
from .job import CooccurrenceJob
from .state import checkpoint as ckpt
from .state.sparse_scorer import SlabCapacityError

LOG = logging.getLogger("tpu_cooccurrence_torch")

#: sysexits: a configuration error, permanent (no retry helps).
EX_CONFIG = 78
#: sysexits: the requested device is not available on this machine.
EX_UNAVAILABLE = 69


def _render_row(item, top) -> str:
    """The output row format (stream and final dump share it)."""
    return f"{item}\t" + " ".join(f"{other}:{score:.4f}"
                                  for other, score in top)


def main(argv: Optional[Sequence[str]] = None) -> int:
    logging.basicConfig(
        level=logging.INFO, stream=sys.stderr,
        format="%(asctime)s %(levelname)s %(name)s - %(message)s")
    try:
        config = Config.from_args(argv)
    except ValueError as exc:  # NotPorted included
        LOG.error("configuration error: %s", exc)
        return EX_CONFIG
    config.log_configuration(LOG)
    if config.pipeline_depth > 0:
        # With --emit-updates the result stream comes from the pipeline's
        # scorer worker, not the ingest thread: worth knowing when reading
        # stdout against stderr's timing lines.
        LOG.info("pipelined execution: depth=%d (host sampling overlaps "
                 "the scorer stage; output is bit-identical to serial)",
                 config.pipeline_depth)
    try:
        job = CooccurrenceJob(config)
    except DeviceUnavailable as exc:
        LOG.error("device unavailable: %s", exc)
        return EX_UNAVAILABLE
    except ValueError as exc:  # e.g. more shards than devices
        LOG.error("configuration error: %s", exc)
        return EX_CONFIG
    source = FileMonitorSource(config.input, job.counters,
                               process_continuously=config.process_continuously)
    # Checkpoints snapshot the source's position (job.source).
    job.source = source
    if config.checkpoint_dir and ckpt.exists(config.checkpoint_dir):
        try:
            job.restore(source=source)
        except ValueError as exc:
            # Permanent: a restart would meet the same checkpoint.
            LOG.error("restore refused: %s", exc)
            return EX_CONFIG
        LOG.info("restored checkpoint from %s (windows_fired=%d)",
                 config.checkpoint_dir, job.windows_fired)
    if config.emit_updates:
        def _stream(window_out) -> None:
            # One line per updated row as windows land; job.latest already
            # holds each row in its final (external-id, finite) form.
            to_ext = job.item_vocab.to_external
            for dense in window_out.rows.tolist():
                item = to_ext(dense)
                print(_render_row(item, job.latest[item]),
                      flush=config.process_continuously)

        job.on_update = _stream
        if job.windows_fired:
            # Resumed run: replay the restored rows so the stream is
            # complete (rows not updated after the checkpoint would
            # otherwise never appear).
            snap = job.latest.snapshot()
            for item in sorted(snap):
                print(_render_row(item, snap[item]),
                      flush=config.process_continuously)
    # --buffer-timeout bounds how long a parsed line may wait in a partial
    # batch; it only matters when tailing input continuously.
    latency = (config.buffer_timeout / 1000.0
               if config.process_continuously else None)
    try:
        job.run(batched_lines(source.lines(), max_latency_s=latency,
                              origin=source.origin))
    except SlabCapacityError as exc:
        # Permanent: the stream outgrew the int32 cell-slot space of one
        # slab; no retry helps.
        LOG.error("slab capacity exhausted: %s", exc)
        return EX_CONFIG
    if config.development_mode:
        for w in job.step_timer.slowest():
            LOG.info("slow window ts=%d events=%d pairs=%d rows=%d "
                     "sample=%.4fs score=%.4fs", w.timestamp, w.events,
                     w.pairs, w.rows_scored, w.sample_seconds,
                     w.score_seconds)
    if not config.emit_updates:
        snap = job.latest.snapshot()
        for item in sorted(snap):
            print(_render_row(item, snap[item]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
