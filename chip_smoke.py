"""Quickest proof that the PyTorch/CUDA port builds and runs on the card.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; imports nothing of JAX. Phases, each
fatal on failure:

1. Card: name and power limit; build every kernel from ``csrc/`` (one
   ``nvcc`` per source, started together).
2. Dense kernel vs plain on the card: ``score_topk`` (kernel) against
   ``score_topk_reference`` under ``topk_parity`` on edge cases and two
   full-width shapes, with times (CUDA events), nonzero cells, bounds and
   the ``torch.topk`` selection-only yardstick. The tie cases (scores
   equal across warps, odd I at int16, K = 1 and 128, K above a row's
   nonzero cells, all-zero rows) and the main path's shape must also
   equal the plain version's ids on every finite lane. Also: the int16
   scatter-add (``index_put_`` with accumulate) wraps on the card as on
   the CPU.
3. Dense path parity: a seeded Zipf stream through ``CooccurrenceJob`` on
   cuda and on cpu, int32 and int16: counters, ``C``, row sums and
   ``observed`` exactly equal, final rows in ``topk_parity``.
4. Dense main path at full width: the bench workload (400k events, 20k
   items) through ``CooccurrenceJob`` on cuda, with the kernel launch
   counter reset just before and read just after; invariants checked;
   the kernel then timed at the shapes that run gave it.
5. Sparse kernel vs plain on the card: ``rect_topk`` against
   ``rect_topk_reference`` on the edge cases (earliest-slot tie, rows
   shorter than K, cancelled cells, a 100k-cell row, observed ~ 3e10,
   partner ids above 2^24) and on the size classes of its launch plan
   (lengths at the class edges, a 100,000-cell row in one block, rows
   that tie in every class, all-cancelled rows, K = 1, 10, 128), ids
   exact on every finite lane.
6. Sparse path parity: a prefix of the config-4 stream through
   ``CooccurrenceJob --backend sparse`` on cuda and on cpu, deferred and
   streamed: counters and the canonical checkpoint exactly equal, rows
   in the same order and in ``topk_parity``.
7. Sparse main path at full size: the JAX package's config 4 (1M events,
   1M-item vocabulary, 100k users, Zipf 1.1) through ``CooccurrenceJob
   --backend sparse`` on cuda, the rect kernel's count reset just before
   and read just after; invariants checked; the device's busy share from
   a profiled second run; the kernel then timed at the shape of the
   run's largest launch.
8. Expand kernel vs plain on the card: ``apply_baskets`` (kernel) against
   ``apply_baskets_reference`` on copies of the same ``C`` and row sums,
   exactly equal, on append ops, replacement pairs, len 0 / len W /
   skip >= len, 10,000 ops on one new item, 200,000 one-cell ops,
   Zipf-hot partners at the main path's shape, int16 cells driven past
   the short range, the last cell of an odd int16 ``C`` and the first of
   one that starts off a 4-byte boundary (guard cells untouched), and
   ids near I - 1 at I = 61,440 int16 (cell offsets past 2^31); each
   case timed, kernel and plain.
9. Dense fused window: phase 4's bench workload with ``--fused-window
   on`` on cuda, the expand and score counts reset just before and read
   just after: every pair-carrying window fused, none chained; state,
   counters and rows exactly equal to phase 4's chained run; the busy
   share from a profiled second run. Then phase 3's stream with user cut
   3 (replacement ops) fused on cuda against fused on cpu, int32 and
   int16. Then the run's largest expand launch replayed against the
   plain version and timed beside its bound and the chained scatter.
   Last, the bench workload at ``--count-dtype int16``, fused (counts
   reset just before, read just after) against chained on cuda: state
   and counters exactly equal, rows in ``topk_parity``; its wall,
   pairs/s, launches and largest launch against its bound.

10. The pipelined window loop and checkpoint/resume. (a) The bench
   workload fused and chained, and config 4 on the sparse path, each at
   ``--pipeline-depth`` 0 and 2 (depth 1 runs the same worker with one
   slot; the CPU tests hold it), the path's kernel
   counts reset just before each run and read just after: every run's
   state, counters and rows exactly equal to phase 4's (for the fused
   runs: and so to phase 9's) or phase 7's depth-0 run; wall, pairs/s,
   sampling and scorer seconds, queue wait and occupancy per run. (b) The
   bench stream written to a CSV and run fused at depth 2 through the
   file source and the batcher with ``--checkpoint-every-windows 10``,
   dropped right after the window-10 checkpoint commits (no finish());
   a fresh job restores from the directory and finishes from the
   source's restored position: state, counters and rows exactly equal to
   the uninterrupted run. (c) The same on config 4 (sparse, a 25-window
   boundary): slab, counters and scores exactly equal, ids equal except
   where scores tie exactly (the restored slab keeps each row's cells in
   key order). (d) One byte of the newest sparse generation flipped: it
   is quarantined and the restore falls back to the previous one, equal
   to the dropped run's state. Every save and restore prints its bytes
   and seconds.
11. Narrow cells and the packed uplink: ``rect_topk`` at int16 and int8
   cells against the plain version and the int32 kernel; config 4 at
   every cell dtype and wire format, each exactly equal to phase 7's
   int32 raw run (ids but on tied lanes of promoted rows); the card's
   decode of the largest packed window; the bench stream on the sparse
   backend; the defaults at depth 2; a packed resume on the first
   500,000 events (cut to make room for phases 19 and 21) at int16 and
   at int8, where a row must have promoted before the checkpoint.
12. The sharded dense backend (``--backend sharded``): (a)
   ``score_topk_local`` against its plain version on the first and last
   of four blocks of phase 2's edge cases (rows outside the block score
   as empty rows) and on each of four blocks of a [20000, 20000] int32
   and a [61440, 61440] int16 ``C`` (the first and last row of every
   block among 2,048), ids exact on every finite lane; one block of each
   timed. (b) The bench workload through ``CooccurrenceJob`` on the
   sharded backend at D = 1 (the CLI's mesh), at D = 4 on one card
   (derive from data, int32) and at D = 4 with ``--count-dtype int16
   --num-items 61440`` (7.5 GB of ``C`` in four blocks), the score
   kernel's count reset just before each run and read just after: every
   run's counters, ``C`` blocks, row-sum replicas and rows exactly equal
   to the dense run at the same flags (phase 4's, or a dense int16 run at
   61,440 items); the local kernel timed at the shape the D = 4 run gave
   it. (c) The bench stream from a CSV at D = 4, depth 2, dropped after
   the window-10 checkpoint and restored at D = 1: exactly equal to
   phase 4's run.
13. Incremental checkpoints, supervised restarts and the oracle: config
   4's first 300,000 events (15 of its 50 windows; the whole stream
   until phase 19 needed the time, 600,000 until phase 20, 400,000
   until phase 22) at the JAX defaults (int16 cells, packed uplink),
   depth 2, a checkpoint every 3 windows (five generations; fulls and
   deltas still alternate), through the file source and the batcher.
   (a) ``--checkpoint-incremental`` and full generations in turns
   (incremental, then full; a second incremental turn was cut to make
   room for phase 17), the rect kernel's count reset
   just before each run and read just after: per generation its kind,
   bytes, chain length and save seconds split into the snapshot (the
   device-to-host copy), ``extract_delta``, the encodes and write+fsync,
   and the slab re-layout after it; the two cadences' stdout identical,
   slab and counters equal. (b) A run dropped right after the newest
   delta generation but the last commits, restored from base + deltas
   and finished from the
   source's position: counters, slab and rows (ids included) exactly
   equal to the uninterrupted run; restore seconds beside the same
   generation restored from the full cadence. (c) The CLI's run under
   ``--restart-on-failure 2``, the first attempt SIGKILLed as soon as its
   third generation commits (``tests/torch_supervised_crash_worker.py``):
   stdout byte-identical to the uninterrupted run's; seconds from the
   kill to the resumed child's first scored window. (d) One byte flipped
   in the first delta of the longest chain: quarantined with a log line,
   the restore falls back to the chain's full base, equal to that
   generation alone. (e) ``--backend oracle`` (float64, host) on config
   4's first 50,000 events (200,000 until phase 19 needed the time,
   100,000 until phase 22) against the card's sparse run on the same
   prefix, with ``tests/test_torch_cli.py``'s oracle comparator; the
   oracle's wall.
14. The native host helpers and sliding windows, on the JAX package's
   config 3 (``ml25m_calibrated(500_000)``: 59,047 items, 162,541 users;
   4,000 ms windows sliding by 1,000 ms, cuts 500/500, seed 3, dense
   int16 over all 59,047 items, 6.97 GB of ``C``). Phases 1-13 already
   ran on the native host path (the library builds at first use). (a)
   Config 3 through ``CooccurrenceJob`` on cuda at depth 0, the score
   kernel's count reset just before and read just after: 13 windows, the
   counters against the pair deltas handed over, the row sums against
   ``C``'s, every row with ``min(K, nonzero cells)`` partners; wall,
   pairs/s, stage seconds, ``C``'s bytes, the busy share from a profiled
   second run; the kernel at the run's largest launch shape beside its
   bound, the plain version and the ``torch.topk`` yardstick. (b) The
   same at depth 2, exactly equal to (a). (e) Config 3 from a CSV at
   depth 2, dropped right after the window-6 checkpoint commits (four
   windows in flight), restored and finished: exactly equal to (a); the
   save's bytes and seconds split, the restore's seconds. (c) cuda
   against cpu on the first 30,000 events at dense int16 and the first
   50,000 at the sparse defaults (100,000 until phase 19 needed the
   time; counters and ``C``/slab exactly
   equal, rows in ``topk_parity``), and ``SlidingOracleJob`` (float64,
   host) on the first 50,000 against the card's dense run. (d) Each
   native host step against its numpy plain version in turns (native,
   numpy): config 3's sliding sampling (byte-equal) and
   its largest window fold; the bench workload chained, each run
   exactly equal to phase 4's, and config 4's first 500,000 events
   sparse (the whole stream until phase 22 needed the time), the numpy
   turn exactly equal to the native one; the sampling, index ``apply``,
   fold and scorer seconds and the wall.
15. K past 128 (the select-and-sort path), config 4 at the JAX
   package's accelerator defaults, the tiered spill store and
   ``--fixed-score on``. (a) ``score_topk`` (whole ``C`` and a local row
   block, int32 and wrapped int16) and ``rect_topk`` (int32, int16, int8
   cells, rows about a warp's select buffer of 512 cells) against their
   plain versions at K = 129, 256, 1024, 1025 and 4096: phase 2's and phase
   5's edge and tie cases, K above I, rows with fewer nonzero cells than
   K, a 100,000-cell row (also at K = 5,000 and 120,000, sorted in the
   output slice), the size-class edges; fully dense rows of config 3's
   width (59,047 int16 columns: distinct scores, every cell in two tied
   scores, 700 cells above a threshold tie) at K = 1024, 4096, 5000
   and 59,057 (K > I); phase 12's shard block through
   ``score_topk_local`` at K = 1024; ids exact on every finite lane.
   Each kernel timed at K = 1024 and 4096 against K = 10 at the main
   path's shapes (the bench ``C``, 8,192 x 20,000 int32; config 4's
   largest launch) beside its bound and the ``torch.topk`` yardstick;
   each path's dynamic shared memory and blocks an SM. (b)
   Config 4 at the JAX package's accelerator defaults (int16 cells, the
   packed uplink, ``--fused-window auto``, which the sparse backend
   scores chained) at depths 0 and 2: every window counted chained,
   depth 2's slab, counters and rows (ids included) exactly equal to
   depth 0's; wall, pairs/s, the busy share; cuda against cpu on a
   50,000-event prefix. (c) The same with ``--spill-threshold-windows
   5 --spill-target-hbm-frac 0``: rows, counters and the checkpoint's
   cell arrays byte-identical to the spill-off run, with rows spilled
   and re-promoted (both counted); slab bytes and heap cells against
   spill-off, the arena's bytes, the wall; then an incremental run under
   spill, whose saves must keep the spilled rows on the host (the slab's
   heap printed after each save), dropped after its first delta
   generation, restored and finished, exactly equal to the
   uninterrupted run (config 4's first 600,000 events, a generation
   every 10 windows; the whole stream every 20 until phase 22 needed
   the time). (d) The bench
   workload at ``-k 1024`` chained and fused and config 4 at ``-k 1024``
   on the defaults, counts reset just before each run and read just
   after: every row with ``min(K, nonzero cells)`` partners, fused equal
   to chained, the results table's bytes beside the slab's; the same at
   ``-k 4096`` for the bench workload chained and fused and for the bench
   stream on the sparse backend. (e)
   ``--fixed-score on`` through the CLI on config 4's prefix:
   byte-identical to ``auto``.
16. The host planes. (a) The bench workload through the CLI, dense fused
   at K = 10 with ``--emit-updates``, ``--journal``, ``--metrics-port``,
   ``--serve-port 0`` and ``--profile-dir``, every route queried over
   and over while it runs (each answer checked as the CPU tests check
   it): stdout byte-identical to the run with every plane off, the
   journal reconciled by the port's ``cooc-trace``, the profiler's
   Chrome trace naming ``score_topk_kernel`` and
   ``expand_scatter_kernel`` with device time above 0 and as many
   launches as the counts; ``cooc_query_seconds`` p50/p99, publish and
   journal-append seconds a window; then planes off and all of them,
   one round.
   (b) Config 4's first 500,000 events (the whole stream until phase 22
   needed the time) at the defaults with ``--journal`` and
   ``--scorer-breaker-threshold 3``, no fault: no trip, ``rect_topk``
   launched in every scored window, rows equal to breaker off. (c) The
   breaker under ``scorer_breaker`` faults: it opens, scores on the
   host, probes and closes, the host-scored windows exactly the plan's.
   (d) A forced degradation ladder, levels and rows equal to the CPU
   run's. (e) A child stalled by ``window_fire:6:delay_ms`` killed by
   the hang watchdog, restarted and resumed byte-identically.
17. The partitioned log and the replica. (a) The bench stream dealt
   into 8 ``part-*`` files in blocks of 256 records (record j in
   partition (j // 256) mod 8, so the round-robin reads the stream in
   its own order) through the CLI with ``--source-format partitioned
   --ingest-partitions 8`` on the dense backend: 0 late events; stdout
   and counters (but the split count) byte-identical to the ``files``
   run on the one CSV; the wall and the ingest share (the batcher's read
   and parse seconds over the wall) of both. Then the same log cut to
   its first 100,000 records (each partition file a prefix of its full
   file; the float64 oracle takes over two minutes on the whole log):
   the card's stdout within the oracle comparator of ``--backend
   oracle`` on that directory (run while (c)'s replica child starts).
   (b) The sparse backend on the directory with
   ``--checkpoint-every-windows 5 --checkpoint-incremental --journal``,
   SIGKILLed at window 12 by an injected ``window_fire`` crash in a
   child process (beside the uninterrupted run), then resumed: stdout equal to an uninterrupted run's,
   every window seq journaled once with the events summing to the
   stream, and the newest generation's offsets summing to every record.
   (c) ``python -m tpu_cooccurrence_torch.serving.replica`` as a child
   on (b)'s directory, started before the resume and tailing it; a
   replica in this process bootstraps from the directory as the crash
   left it and tails it too: its rows bit-identical to the writer's
   serving plane restored at the newest generation, and 1,000
   ``/recommend`` answers of the child equal to this replica's (the
   generation tag included); ``min_gen`` past the log answers 503.
   Bootstrap seconds, apply seconds a generation and the queries'
   p50/p99 (host clock).
18. The sharded sparse backend (``--backend sparse --num-shards 4``, four
   shards on the one card through an explicit mesh, as phase 12 does).
   (a) Config 4 at the sharded defaults (int32 cells, the raw uplink),
   deferred, depth 0, the rect kernel's count reset just before and read
   just after: counters, the canonical blob and every row (ids included)
   exactly equal to phase 7's single-device run; wall, pairs/s,
   ``cooc_shard_row_imbalance``, each shard's live cells, the launches.
   (b) The same at int16 and at int8 cells with the packed uplink (rows
   promote at int8; none of config 4's reaches int16's bound): blob,
   counters and scores equal to (a), ids but on exactly tied lanes. (c)
   cuda against cpu at D = 4 on config 4's first 50,000 events with
   ``--emit-updates``: counters and blob exactly equal, every handover's
   rows in the same order and in ``topk_parity``. (d) Config 4 from a CSV
   at D = 4, depth 2, dropped right after the window-25 checkpoint,
   restored at D = 1 (the single-device scorer) and finished: equal to
   (a) (ids but on exact ties); save and restore bytes and seconds. (e)
   ``rect_topk`` against its plain version on (a)'s largest per-shard
   launch (ids exact), timed beside its bound, the plain version and the
   ``torch.topk`` yardstick.

19. The multi-process runtime: two port processes on the one card
   (``--coordinator 127.0.0.1:<free port> --num-processes 2
   --process-id i --collective-timeout-s 30``; a gloo group for the host
   collectives, each process's own shards on ``cuda:0``), each a child of
   this script (``chip_smoke.py --gang-child SPEC``: the CLI in-process,
   the kernels' counts set to 0 just before and read just after); two
   gangs share the card at a time, (a) beside (c) and (b) beside (c)'s
   resume. (a)
   The bench workload through the CLI, ``--backend sharded --num-items
   20000``: the two processes' rows, merged in item order, byte-identical
   to one process over an explicit two-entry mesh. (b) Config 4's first
   300,000 events (the phase's budget) with ``--backend sparse
   --num-shards 2 --wire-format packed`` (int32 cells: narrow cells stay
   single-controller, as in the JAX package): the same. (c), (d) Phase
   3's stream at 10 ms windows with a generation every 5 windows;
   process 1 killed by a ``barrier_enter`` crash at its 16th collective,
   process 0 must exit 75 within the watchdog's timeout plus 10 s; then
   both resume from the agreed epoch, byte-identical to one uninterrupted
   process. (e) In each gang of (a) and (b), process 0 saves the
   arguments of its largest ``score_topk_local`` or ``rect_topk``
   launch; once both rounds have ended, this script replays each alone
   on the otherwise idle card, against its plain version (bit for bit),
   and times it; the launches by process. Every wall and the phase's
   seconds printed.
20. The gang supervisor and the replica fleet, as an operator starts
   them: ``python -m tpu_cooccurrence_torch.cli ... --gang-workers 2``
   (each worker a ``python -m tpu_cooccurrence_torch.cli`` process the
   supervisor spawns, its shards on ``cuda:0``). (a) Phase 19(c)'s stream
   and cadence with ``--restart-on-failure 2 --inject-fault
   ckpt_commit@1:2:crash``: exit 0, stdout byte-identical to the
   uninterrupted supervised gang's and, merged in item order, to phase
   19's one process over a two-entry mesh; generation 2 quarantined as
   ``*.partial`` on both workers, exactly ``fault0.p1.fired``, the restore
   vote and the gang restart in stderr. (b) Phase 19(b)'s config 4 cut
   with ``--gang-heartbeat-s 1 --gang-stale-after-s 3 --inject-fault
   peer_heartbeat@1:3:delay_ms:600000``: the supervisor kills the gang on
   the stale heartbeat and relaunches it; stdout byte-identical to the
   uninterrupted gang's and to phase 19's reference; the freeze-to-kill
   and kill-to-first-scored-window seconds (the marker's mtime, the
   supervisor's log line, the workers' ``--journal``). Each worker's own
   stderr line ``Kernel launches (--device cuda, process i)`` must show
   its kernel launched. (c) A sparse single-process writer (phase 3's
   stream, incremental checkpoints), then ``python -m
   tpu_cooccurrence_torch.serving.replica --fleet 2 --run-seconds 60``
   over its directory: replica 1 SIGKILLed (its pid from its port file),
   slot 1 alone relaunched, replica 0 answering every ``/recommend``
   meanwhile, the relaunched replica serving the writer's generation with
   replica 0's answers for 200 users; the fleet ends on SIGTERM with its
   replicas. The four gangs run at once, beside (c).
21. The autoscaler: ``cli.main(... --gang-workers 2 --autoscale on)`` in
   a child of this script (``chip_smoke.py --autoscale-supervisor``),
   whose workers are the CLI in children of this script too
   (``--autoscale-worker``: each worker's ``rect_topk`` count set to 0
   just before and read just after, its restore vote and restore timed,
   process 0's largest launch saved), their shards on ``cuda:0``. (a)
   Phase 19(b)'s config 4 cut at the sharded sparse defaults, a
   generation a window, ``--restart-on-failure 1``, the JAX chaos test's
   levers (``--degrade --degrade-window-wall-s 2 --autoscale-trip-windows
   2 --autoscale-clear-windows 3 --autoscale-cooldown-windows 2``, 2 to
   4 workers), worker 0's windows 2-4 stalled 2.5 s each and
   ``rescale_drain@1:crash``: exit 0 with AUTOSCALE records grow 2 -> 4
   (pressure) and shrink 4 -> 2 (idle), exactly one ``gang-restarting``
   (the seam crash: the gang relaunches at the pending 4 and restores
   the 2-writer generation through the topology vote), generations
   committed by 2 and by 4 writers, the ladder at NORMAL in every window
   record, process 0's window seqs once each, at least two windows after
   the shrink; the seconds from each decision to its drain and from the
   drain to the relaunched gang's first window, and each gang's vote and
   restore; ``rect_topk`` launches by gang and process. (b) Stdout
   byte-identical to a fixed 2-worker gang crash-recovered at the drain
   windows (started beside the elastic gang at the windows the policy
   gives when each poll sees each window, 4 and 10, and run again after
   it if the journal shows others). (c) Merged in item
   order, the same rows and scores as phase 19's one process over a
   two-entry mesh, ids equal wherever a score is untied. (d) Process 0's
   largest launch at 4 workers, replayed on the idle card against its
   plain version (bit for bit) and timed.
22. Benchmark configs 1, 2 and 5 of ``tpu_cooccurrence/bench/configs.py``
   through ``cli.main`` in this process, each stream made by the port's
   own generator and written by its ``write_interactions_csv``, with the
   configs' flags (the CLI's default ``--backend device``, chained;
   ``--num-items`` from the data's largest id): config 1, the tiny text
   times 50, one 1,000,000 ms window, ``--skip-cuts``; config 2,
   ``ml100k_calibrated()``, 4,000 ms windows, cuts 500/500; config 5,
   ``instacart_calibrated(20_000)`` (201,638 events), 1,000 ms windows,
   cuts 500/500, int16 over all 49,688 items (4.94 GB of ``C``), chained
   and with ``--fused-window on``. Each run's kernel counts set to 0 just
   before and read just after; its events, pairs, wall, pairs/s,
   sampling and scorer seconds, launches, largest launch and largest
   |cell| of ``C`` (whether int16 wrapped: ``C``'s sum against the row
   sums'); the busy share from a profiled second run (config 1: 20
   runs, each a few ms). Config 5 fused and chained: stdout
   byte-identical, state and counters exactly equal. Beside the card's
   runs, two children of this script (``chip_smoke.py --oracle22
   SPEC``) run ``--backend oracle --device cpu`` (float64, host) on
   configs 1 and 2 whole and on config 5's first 20,000 events (its wall
   grows faster than the events; the first 10,000 too, to show it),
   which the card also runs: counters and every item's row sum exactly
   equal, every row within the oracle comparator. ``score_topk`` at
   each config's largest launch and ``expand_scatter`` at config 5's
   largest fused block, on the final state, bit-equal to their plain
   versions and timed beside their bounds.

The last lines: each phase's wall seconds, the card, a
``{"kernels": [...]}`` JSON line naming all
three kernels (``score_topk`` carries its local-block launches of phase
12 under ``local`` and config 3's of phase 14 under ``sliding``; it and
``rect_topk`` carry their K = 1024 and K = 4096 launches and times under
``k1024`` and ``k4096``, ``rect_topk`` its per-shard launches of
phase 18 under ``sharded``, both phase 19's under ``gang`` and phase
20's chaos gangs' launches by worker under ``supervised``, and
``rect_topk`` phase 21's under ``autoscale``; ``score_topk`` carries
phase 22's configs under ``configs`` and ``expand_scatter`` config 5's
fused run under ``config5``) and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

#: Published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s and
#: float32 operations/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
#: Operations the kernel spends per nonzero cell: 4 log1pf + 4 divisions.
OPS_PER_CELL = 8
#: Parity tolerance of kernel vs plain: both are IEEE float32 with the
#: same operation order (no fast math, no FMA contraction), so they agree
#: to float32 rounding of log1pf; the reference package's default.
RTOL = ATOL = 1e-5


def _fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def _time_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn()`` on the card (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _bound(C, rows, k: int, row_lo: int = 0):
    """Least time for the same work: bytes (the scored rows of ``C``, a
    row block from global row ``row_lo``; row sums, rows and the outputs,
    each once) over HBM rate vs 8 ops per nonzero cell of the scored rows
    over the f32 rate. Returns (ms, "bytes" or "operations", nonzero
    cells)."""
    import torch

    s, n = rows.shape[0], C.shape[1]
    nbytes = s * n * C.element_size() + 4 * n + 4 * s + s * k * 8
    nnz = 0
    for lo in range(0, s, 1024):
        nnz += int((C[rows[lo:lo + 1024].long() - row_lo] != 0).sum(
            dtype=torch.int64))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nnz * OPS_PER_CELL / FP32_OPS_PER_S * 1e3
    return ((t_bytes, "bytes", nnz) if t_bytes >= t_ops
            else (t_ops, "operations", nnz))


def _reference_chunked(C, rs, rows, observed, k, chunk=2048, row_lo=None):
    """The plain version in row chunks (bounds its [S, I] temporaries);
    with ``row_lo``, the local one over the row block ``C`` from there."""
    import torch

    from tpu_cooccurrence_torch.ops.score_topk import (
        score_topk_local_reference, score_topk_reference)

    def plain(r):
        if row_lo is None:
            return score_topk_reference(C, rs, r, observed, k)
        return score_topk_local_reference(C, rs, r, row_lo, observed, k)

    parts = [plain(rows[lo:lo + chunk])
             for lo in range(0, rows.shape[0], chunk)]
    return (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]))


class Parity:
    """Kernel-vs-plain comparisons; keeps the worst absolute error."""

    def __init__(self) -> None:
        self.max_abs_err = 0.0
        self.cases = 0

    def check(self, name, C, rs, rows, observed, k, exact=False):
        """``score_topk`` against its plain version."""
        from tpu_cooccurrence_torch.ops.score_topk import score_topk

        return self.compare(name, score_topk(C, rs, rows, observed, k),
                            _reference_chunked(C, rs, rows, observed, k),
                            exact)

    def compare(self, name, kernel_out, plain_out, exact=False):
        """Kernel ``(vals, idx)`` against plain ``(vals, idx)``: the same
        ``-inf`` lanes, and ``topk_parity``; ``exact`` (the tie cases,
        where ``topk_parity`` does not look at ids, and every large K):
        every finite lane's score bits and id equal instead. Returns the
        kernel's ``(vals, idx)`` on the host."""
        import torch

        from tpu_cooccurrence_torch.ops.score_topk import topk_parity

        (kv, ki), (pv, pi) = kernel_out, plain_out
        torch.cuda.synchronize()
        kv, ki, pv, pi = (t.cpu().numpy() for t in (kv, ki, pv, pi))
        if not np.array_equal(np.isfinite(kv), np.isfinite(pv)):
            _fail(f"{name}: -inf lanes differ between kernel and plain")
        fin = np.isfinite(pv)
        err = float(np.abs(kv[fin] - pv[fin]).max()) if fin.any() else 0.0
        if exact:
            # Bit for bit, which implies topk_parity (whose [S, K, K] tie
            # test would not fit the host's memory at large K).
            if not (np.array_equal(kv[fin].view(np.int32),
                                   pv[fin].view(np.int32))
                    and np.array_equal(ki[fin], pi[fin])):
                _fail(f"{name}: lanes differ between kernel and plain "
                      f"(max_abs_err {err:.3g}, "
                      f"{int((ki[fin] != pi[fin]).sum())} ids)")
        else:
            ok, mism = topk_parity(kv, ki, pv, pi, rtol=RTOL, atol=ATOL)
            if not ok or mism:
                _fail(f"{name}: kernel vs plain scores_ok={ok} "
                      f"untied_id_mismatches={mism}")
        self.max_abs_err = max(self.max_abs_err, err)
        self.cases += 1
        print(f"  parity {name}: ok (max_abs_err {err:.3g}"
              f"{', ids exact' if exact else ''})", flush=True)
        return kv, ki


def _edge_case(rng, n, s, k, dtype, big=False, wrap=False, zero_rows=0):
    """Seeded counts, row sums, rows for one small kernel case."""
    import torch

    C = rng.integers(0, 6, size=(n, n)) * (rng.random((n, n)) < 0.3)
    if big:   # the N ~ 3e10 regime of the reference's LLR tests
        C = C * rng.integers(1_000, 100_000, size=(n, n))
    if wrap:  # int16 counts past the short range, wrapped like the ref
        C[rng.random((n, n)) < 0.02] = 40_000
        C[rng.random((n, n)) < 0.02] = -5
    rows = rng.choice(n, size=s, replace=False).astype(np.int32)
    if zero_rows:
        C[rows[:zero_rows]] = 0
    C = C.astype(np.int64).astype(dtype)   # int16: wraps
    rs = np.abs(C.astype(np.int64)).sum(1)
    if big:
        rs = np.maximum(rs, rng.integers(500_000_000, 2_000_000_000, n))
    rs = np.minimum(rs, 2**31 - 1).astype(np.int32)
    observed = 3e10 if big else float(rs.astype(np.int64).sum())
    dev = torch.device("cuda")
    return (torch.from_numpy(C).to(dev), torch.from_numpy(rs).to(dev),
            torch.from_numpy(rows).to(dev), observed, k)


def _dense_tie_cases(parity: Parity, rng) -> None:
    """Cases aimed at the warp-level selection: rows whose scores tie
    across warps (one or two distinct counts and one row sum for every
    column, so the top K are the lowest columns; warp 0 queues the
    highest columns, the unaligned tail, first), odd I at int16 (every
    row starts at another alignment), K = 1 and 128, K above a row's
    nonzero cells, and all-zero rows. Ids must equal the plain version's
    on every finite lane."""
    import torch

    dev = torch.device("cuda")
    for n, dt, k in ((4099, np.int16, 128), (4099, np.int16, 1),
                     (5003, np.int32, 128), (20_000, np.int32, 10)):
        C = rng.integers(1, 3, size=(n, n)).astype(dt)
        C[rng.random((n, n)) < 0.5] = 0
        C[1] = 1                          # one count: every column ties
        C[2] = 0                          # an all-zero row
        C[3] = 0
        C[3, [n - 1, n - 2, 7]] = 2       # fewer nonzero cells than K
        rows = np.r_[np.arange(8), rng.choice(np.arange(8, n), 57,
                                              replace=False)]
        rs = np.full(n, 5 * n, dtype=np.int32)
        t = [torch.from_numpy(a).to(dev) for a in (C, rs,
                                                   rows.astype(np.int32))]
        _, ki = parity.check(f"ties_S65_I{n}_{np.dtype(dt).name}_K{k}", *t,
                             float(50 * n * n), k, exact=True)
        if ki[1].tolist() != list(range(k)):
            _fail(f"tie row at I={n}: ids {ki[1][:8].tolist()}... are not "
                  f"the lowest columns")
        del C, t


def _full_width(n, s, dtype, seed):
    """A [S] x I scoring problem generated on the card: ~25% nonzero
    cells with counts 1..3; row sums are C's row sums."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    C = torch.empty((n, n), dtype=dtype, device="cuda")
    for lo in range(0, n, 4096):
        blk = torch.randint(0, 16, (min(4096, n - lo), n), generator=g,
                            device="cuda", dtype=dtype)
        C[lo:lo + 4096] = blk.sub_(12).clamp_(min=0)
    rs = C.sum(1, dtype=torch.int32)
    rows = torch.randperm(n, generator=g, device="cuda")[:s].to(torch.int32)
    observed = float(rs.sum(dtype=torch.int64).item())
    return C, rs, rows, observed


def _measure(name, C, rs, rows, observed, k, reps=10, row_lo=None):
    """Kernel, plain and torch.topk-yardstick times plus the bound; with
    ``row_lo``, ``score_topk_local`` over the row block ``C`` from
    there."""
    import torch

    from tpu_cooccurrence_torch.ops.score_topk import (score_topk,
                                                       score_topk_local)

    if row_lo is None:
        ms = _time_ms(lambda: score_topk(C, rs, rows, observed, k), reps)
    else:
        ms = _time_ms(lambda: score_topk_local(C, rs, rows, row_lo,
                                               observed, k), reps)
    plain_ms = _time_ms(
        lambda: _reference_chunked(C, rs, rows, observed, k,
                                   row_lo=row_lo), 3)
    # Yardstick for the selection alone: torch.topk on a materialized
    # [S, I] f32 score matrix (never called by the port).
    scores = torch.rand((rows.shape[0], C.shape[1]), device="cuda")
    topk_ms = _time_ms(lambda: torch.topk(scores, k, dim=1), reps)
    del scores
    bound_ms, bound_by, nnz = _bound(C, rows, k, row_lo or 0)
    print(f"  time {name}: {nnz} nonzero cells of {rows.shape[0]} x "
          f"{C.shape[1]}: kernel {ms:.4f} ms "
          f"({nnz / ms / 1e6:.3f} G nonzero cells/s), plain {plain_ms:.4f} "
          f"ms, torch.topk yardstick {topk_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}; {100 * bound_ms / ms:.1f}% of "
          f"it reached)", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, topk_ms=topk_ms,
                bound_ms=bound_ms, bound_by=bound_by, nnz=nnz)


def phase_kernels(parity: Parity) -> None:
    import torch

    from tpu_cooccurrence_torch.ops.device_scorer import _apply_coo

    print("phase 2: kernel vs plain on the card", flush=True)
    rng = np.random.default_rng(20261016)
    cases = [
        ("S1_I50_K128_int32_KgtI", 50, 1, 128, np.int32, {}),
        ("S7_I1007_K10_int32_zero_rows", 1007, 7, 10, np.int32,
         dict(zero_rows=3)),
        ("S65_I2053_K128_int16_wrapped", 2053, 65, 128, np.int16,
         dict(wrap=True, zero_rows=1)),
        ("S65_I3001_K1_int32", 3001, 65, 1, np.int32, {}),
        ("S7_I513_K10_int32_N3e10", 513, 7, 10, np.int32, dict(big=True)),
        ("S65_I700_K10_int16", 700, 65, 10, np.int16, {}),
    ]
    for name, n, s, k, dt, kw in cases:
        parity.check(name, *_edge_case(rng, n, s, k, dt, **kw))
    _dense_tie_cases(parity, rng)

    # int16 scatter-add: index_put_ with accumulate wraps on the card as
    # on the CPU (the reference's Java-short semantics).
    for dev in ("cuda", "cpu"):
        C = torch.tensor([[32_767, -32_768], [5, 0]], dtype=torch.int16,
                         device=dev)
        rs = torch.zeros(2, dtype=torch.int32, device=dev)
        idx = torch.tensor([0, 0, 1], dtype=torch.long, device=dev)
        jdx = torch.tensor([0, 1, 1], dtype=torch.long, device=dev)
        delta = torch.tensor([1, -1, 70_000], dtype=torch.int32, device=dev)
        _apply_coo(C, rs, idx, jdx, delta)
        got = C.cpu().tolist(), rs.cpu().tolist()
        want = ([[-32_768, 32_767], [5, 70_000 - 65_536]], [0, 70_000])
        if got != want:
            _fail(f"int16 scatter-add on {dev}: {got} != {want}")
    print("  int16 scatter-add wraps on cuda and cpu: ok", flush=True)

    for name, n, dt, seed in (("S8192_I20000_int32", 20_000, torch.int32, 1),
                              ("S8192_I61440_int16", 61_440, torch.int16,
                               2)):
        C, rs, rows, observed = _full_width(n, 8192, dt, seed)
        parity.check(name, C, rs, rows, observed, 10)
        _measure(name, C, rs, rows, observed, 10)
        del C, rs, rows
        torch.cuda.empty_cache()


def _run_job(device, count_dtype, users, items, ts, num_items=0, **extra):
    from tpu_cooccurrence_torch.config import Config
    from tpu_cooccurrence_torch.job import CooccurrenceJob

    cfg = Config(**{**dict(window_size=100, seed=0xC0FFEE, item_cut=500,
                           user_cut=500, num_items=num_items,
                           count_dtype=count_dtype, device=device), **extra})
    job = CooccurrenceJob(cfg)
    start = time.monotonic()
    job.add_batch(users, items, ts)
    job.finish()
    if device == "cuda":
        import torch

        torch.cuda.synchronize()
    return job, time.monotonic() - start


def _rows_table(job, k):
    return _table_of(job.latest.snapshot(), k)


def _table_of(snap, k):
    """``{item: [(other, score)]}`` -> (items, scores [N, K], ids [N, K]);
    lanes past a row's partners are (-inf, -1)."""
    items = sorted(snap)
    vals = np.full((len(items), k), -np.inf, dtype=np.float32)
    ids = np.full((len(items), k), -1, dtype=np.int64)
    for r, item in enumerate(items):
        for c, (other, score) in enumerate(snap[item]):
            vals[r, c], ids[r, c] = score, other
    return items, vals, ids


def _parity_stream():
    """Phase 3's seeded Zipf stream (60k events, 5k items)."""
    from tpu_cooccurrence_torch.io.synthetic import zipfian_interactions

    return zipfian_interactions(60_000, n_items=5_000, n_users=2_000,
                                alpha=1.1, seed=3, events_per_ms=200)


def _bench_stream():
    """``bench.py``'s dense workload stream (400k events, 20k items)."""
    from tpu_cooccurrence_torch.io.synthetic import zipfian_interactions

    return zipfian_interactions(400_000, n_items=20_000, n_users=5_000,
                                alpha=1.1, seed=3, events_per_ms=200)


def phase_path_parity() -> None:
    from tpu_cooccurrence_torch.ops import score_topk as st
    from tpu_cooccurrence_torch.ops.score_topk import topk_parity

    print("phase 3: path parity, cuda vs cpu", flush=True)
    users, items, ts = _parity_stream()
    for dtype in ("int32", "int16"):
        before = st.LAUNCHES
        gpu, t_gpu = _run_job("cuda", dtype, users, items, ts)
        launches = st.LAUNCHES - before
        cpu, t_cpu = _run_job("cpu", dtype, users, items, ts)
        if gpu.counters.as_dict() != cpu.counters.as_dict():
            _fail(f"{dtype}: counters differ {gpu.counters} vs "
                  f"{cpu.counters}")
        a, b = gpu.scorer.checkpoint_state(), cpu.scorer.checkpoint_state()
        for key in ("C", "row_sums", "observed"):
            if not np.array_equal(a[key], b[key]):
                _fail(f"{dtype}: {key} differs between cuda and cpu")
        ia, va, da = _rows_table(gpu, 10)
        ib, vb, db = _rows_table(cpu, 10)
        ok, mism = topk_parity(va, da, vb, db, rtol=RTOL, atol=ATOL)
        if ia != ib or not ok or mism:
            _fail(f"{dtype}: final rows differ (same items {ia == ib}, "
                  f"scores_ok {ok}, untied id mismatches {mism})")
        if launches <= 0:
            _fail(f"{dtype}: the cuda run launched no kernel")
        print(f"  {dtype}: {gpu.windows_fired} windows, {len(ia)} rows, "
              f"counters/C/row_sums/observed equal, rows in parity; "
              f"{launches} kernel launches; cuda {t_gpu:.2f} s, "
              f"cpu {t_cpu:.2f} s", flush=True)


def _device_profile(run, elapsed: float, reps: int = 1) -> None:
    """The main path once more (``run()``, returning its seconds; ``reps``
    times for a run too short for the profiler to catch its device
    time) under ``torch.profiler``: device time by kernel, and its share
    of the counted run's wall time (the device's busy share, a run's
    device time over it; its launches are made after the counts were
    read)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_elapsed = sum(run() for _ in range(reps)) / reps
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.device_time_total / 1e3 / reps
    busy_ms = sum(by_name.values())
    if busy_ms <= 0:
        print("  device busy share: not measured (the profiler saw no "
              "device time)", flush=True)
        return
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    runs = f"{reps} profiled runs, a run" if reps > 1 else "profiled run"
    print(f"  device busy {busy_ms:.3f} ms = "
          f"{100 * busy_ms / (elapsed * 1e3):.2f}% of the counted run's "
          f"{elapsed:.3f} s ({runs} {prof_elapsed:.3f} s)", flush=True)
    for name, ms in top:
        print(f"    {ms:10.3f} ms  {name[:90]}", flush=True)


def phase_main_path(parity: Parity, card: str) -> dict:
    import torch

    from tpu_cooccurrence_torch.metrics import OBSERVED_COOCCURRENCES
    from tpu_cooccurrence_torch.ops import score_topk as st

    print("phase 4: main path at full width (bench workload)", flush=True)
    users, items, ts = _bench_stream()
    st.LAUNCHES = 0
    job, elapsed = _run_job("cuda", "int32", users, items, ts,
                            num_items=20_000)
    launches = st.LAUNCHES
    pairs = job.counters.get(OBSERVED_COOCCURRENCES)
    print(f"  {card}: {elapsed:.3f} s, {pairs / elapsed:.1f} pairs/s, "
          f"{job.windows_fired} windows, {launches} kernel launches",
          flush=True)
    if launches <= 0:
        _fail("the main path launched the score_topk kernel no time")
    sc = job.scorer
    obs = sc.observed
    if int(sc.row_sums.sum(dtype=torch.int64)) != obs:
        _fail("row_sums.sum() != observed")
    if int(sc.C.sum(dtype=torch.int64)) != obs:
        _fail("C.sum() != observed")
    snap = job.latest.snapshot()
    if len(snap) == 0:
        _fail("no rows came out")
    for item in snap:
        scores = [s for _, s in snap[item]]
        if (not np.all(np.isfinite(scores)) or len(scores) > 10
                or scores != sorted(scores, reverse=True)):
            _fail(f"row {item} malformed: {snap[item]}")
    print(f"  invariants hold; {len(snap)} rows, finite and descending",
          flush=True)
    print(f"  host stages: {job.step_timer.summary()}", flush=True)
    _device_profile(lambda: _run_job("cuda", "int32", users, items, ts,
                                     num_items=20_000)[1], elapsed)

    # The kernel at the shape the main path gave it: the final C, one
    # full score chunk of touched rows.
    touched = torch.nonzero(sc.row_sums).flatten().to(torch.int32)
    rows = touched[:sc.max_score_rows].contiguous()
    parity.check("main_path_final_state", sc.C, sc.row_sums, rows,
                 float(np.float32(obs)), sc.top_k, exact=True)
    m = _measure(f"main_path_S{rows.shape[0]}_I{sc.num_items}_int32",
                 sc.C, sc.row_sums, rows, float(np.float32(obs)), sc.top_k)
    return dict(launches=launches, job=job, **m)


def _kernel_entry(name, replaces, parity: Parity, run: dict) -> dict:
    return {
        "name": name,
        "route": "cuda",
        "source": f"tpu_cooccurrence_torch/csrc/{name}.cu",
        "replaces": f"tpu_cooccurrence/ops/{replaces}",
        "launches": run["launches"],
        "max_abs_err": parity.max_abs_err,
        "ms": run["ms"],
        "plain_ms": run["plain_ms"],
        "bound_ms": run["bound_ms"],
        "bound_by": run["bound_by"],
        "library_ms": run.get("library_ms"),
    }


#: The JAX package's config 4 (``tpu_cooccurrence/bench/configs.py``,
#: ``config4_zipfian_1m``): a 1M-item Zipfian stream, its job seed, window
#: and cuts. Events, vocabulary, users, alpha, stream seed, events per ms.
CONFIG4 = dict(n_events=1_000_000, n_items=1_000_000, n_users=100_000,
               alpha=1.1, seed=4, events_per_ms=200)
CONFIG4_JOB = dict(window_size=100, seed=4, item_cut=500, user_cut=500,
                   top_k=10, backend="sparse", cell_dtype="int32",
                   wire_format="raw")
#: Events of the config-4 prefix that phase 6 runs on both devices.
PARITY_PREFIX = 400_000


def _config4_stream():
    from tpu_cooccurrence_torch.io.synthetic import zipfian_interactions

    return zipfian_interactions(**CONFIG4)


def _run_sparse_job(device, users, items, ts, emit=False, sink=None):
    from tpu_cooccurrence_torch.config import Config
    from tpu_cooccurrence_torch.job import CooccurrenceJob

    job = CooccurrenceJob(Config(**CONFIG4_JOB, device=device,
                                 emit_updates=emit))
    if sink is not None:
        job.on_update = sink.append
    start = time.monotonic()
    job.add_batch(users, items, ts)
    job.finish()
    if device == "cuda":
        import torch

        torch.cuda.synchronize()
    return job, time.monotonic() - start


def _rect_case(rng, n_rows, num_items, max_len, zero_frac=0.1, big=False,
               short_rows=0, hot_len=0, id_base=0):
    """Seeded slab rows for one rect-kernel case: random lens in
    [0, max_len] (``short_rows`` under 4 cells, row 0 ``hot_len`` cells
    when given), contiguous regions, counts with some cancelled (zero),
    partner ids in [id_base, num_items). ``big``: counts and row sums of
    the observed ~ 3e10 regime."""
    lens = rng.integers(0, max_len + 1, n_rows)
    lens[:short_rows] = rng.integers(1, 4, short_rows)
    if hot_len:
        lens[0] = hot_len
    starts = 3 + np.concatenate([[0], np.cumsum(lens)[:-1]])
    cap = int(starts[-1] + lens[-1] + 8)
    cnt = rng.integers(1, 100_000 if big else 50, cap)
    cnt[rng.random(cap) < zero_frac] = 0
    dst = rng.integers(id_base, num_items, cap)
    rows = rng.choice(num_items, n_rows, replace=False)
    if big:
        rs = rng.integers(500_000_000, 2_000_000_000, num_items)
    else:
        rs = rng.integers(1, 1 << 16, num_items)
    return (cnt, dst, rs, rows, starts, lens), 3e10 if big else 1e7


def _tie_case():
    """Six cells with identical counts and partner sums: an exact tie,
    which the earliest slots win, in slot order."""
    cnt = np.zeros(256, dtype=np.int64)
    cnt[:6] = 5
    dst = np.zeros(256, dtype=np.int64)
    dst[:6] = [40, 30, 20, 10, 50, 60]
    rs = np.full(512, 1000)
    return (cnt, dst, rs, [7], [0], [6]), 1e6


def _cuda_int32(arrays):
    import torch

    return [torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(
        "cuda") for a in arrays]


def phase_rect_kernel(parity: Parity) -> None:
    from tpu_cooccurrence_torch.ops.rect_topk import (rect_topk,
                                                      rect_topk_reference)

    print("phase 5: sparse kernel vs plain on the card", flush=True)
    rng = np.random.default_rng(20261017)
    big_ids = (1 << 24) + 4096
    cases = [
        ("tie_earliest_slot_K4", _tie_case(), 4),
        ("S300_short_rows_K10", _rect_case(rng, 300, 4096, 12,
                                           short_rows=100), 10),
        ("S64_cancelled_cells_K128", _rect_case(rng, 64, 4096, 300,
                                                zero_frac=0.5), 128),
        ("S33_hot_row_100k_cells_K10", _rect_case(
            rng, 33, 200_000, 3000, hot_len=100_000), 10),
        ("S40_N3e10_K10", _rect_case(rng, 40, 4096, 500, big=True), 10),
        ("S50_ids_above_2^24_K10", _rect_case(
            rng, 50, big_ids, 400, id_base=1 << 24), 10),
        ("S17_K1", _rect_case(rng, 17, 4096, 200), 1),
    ]
    for name, (arrays, observed), k in cases:
        t = _cuda_int32(arrays)
        got = rect_topk(*t, observed, k)
        parity.compare(name, got, rect_topk_reference(*t, observed, k))
        if name.startswith("tie") and got[1][0].tolist() != [40, 30, 20, 10]:
            _fail(f"{name}: ids {got[1][0].tolist()} are not the earliest "
                  f"slots' partners")
        if "2^24" in name and not bool((got[1] >= 1 << 24).any()):
            _fail(f"{name}: no partner id above 2^24 came out")
    _rect_class_cases(parity, rng)


def _rect_class_cases(parity: Parity, rng, narrow=None,
                      ks=(1, 10, 128)) -> None:
    """Cases aimed at the size classes (a warp per short row, a block per
    long row): lengths at the class edges L - 1, L, L + 1, rows of 4,095
    to 12,293 cells and a 100,000-cell row in one block, rows whose cells
    all tie (one count, one partner row sum) in every class, so the
    earliest slots must win across warps and blocks, all-cancelled rows,
    and K in ``ks``; past K = 128 also lengths at a warp's select
    buffer (511-513), where the select kernel moves a row from a warp to
    the block. Rows go in the scorer's bucket order; ids must equal the
    plain version's on every finite lane. ``narrow``: a cell
    dtype and its largest count, the cases run at that cell dtype
    (:func:`_narrow_case`)."""
    from tpu_cooccurrence_torch.ops.rect_topk import (
        SHORT_MAX, min_rect_width, score_buckets, short_rows)
    from tpu_cooccurrence_torch.ops.score_topk import (LIST_MAX_K,
                                                       SELECT_WARP_BUFFER)

    num_items = 8192
    for k in ks:
        edges = [SHORT_MAX - 1, SHORT_MAX, SHORT_MAX + 1, 4095, 4096, 4097,
                 12_293, 100_000, 1, 0, 40]
        if k > LIST_MAX_K:
            edges += [SELECT_WARP_BUFFER + d for d in (-1, 0, 1)]
        lens = np.r_[edges, edges, edges, rng.integers(0, 600, 200)]
        n = len(lens)
        tie = np.zeros(n, dtype=bool)
        tie[len(edges):2 * len(edges)] = True        # second copy: all tie
        dead = np.zeros(n, dtype=bool)
        dead[2 * len(edges):3 * len(edges)] = True   # third: all cancelled
        _, order = score_buckets(lens, min_rect_width(k), 4)
        lens, tie, dead = lens[order], tie[order], dead[order]
        starts = 5 + np.concatenate([[0], np.cumsum(lens)[:-1]])
        cap = int(starts[-1] + lens[-1] + 16)
        cnt = rng.integers(1, 40, cap)
        cnt[rng.random(cap) < 0.1] = 0
        dst = rng.integers(0, num_items, cap)
        rs = rng.integers(1, 1 << 16, num_items)
        rs[:64] = 1 << 15                             # the tie partners
        for i in np.flatnonzero(tie | dead):
            cell = slice(starts[i], starts[i] + lens[i])
            cnt[cell] = 0 if dead[i] else 3
            dst[cell] = rng.integers(0, 64, lens[i])
        rows = rng.choice(num_items, n, replace=False)
        n_short = short_rows(lens)
        t = _cuda_int32((cnt, dst, rs, rows, starts, lens))
        name = (f"classes_S{n}_K{k} ({n_short} short rows, {n - n_short} "
                f"long)")
        if narrow is not None:
            cells = np.zeros(cap, dtype=bool)
            for i in np.flatnonzero(tie):
                cells[starts[i]:starts[i] + lens[i]] = True
            _, ki = _narrow_case(parity, name, t, 1e8, k, n_short, *narrow,
                                 rng, keep=cells)
        else:
            ki = _rect_exact(parity, f"classes_S{n}_K{k}", t, 1e8, k, lens)
        for i in np.flatnonzero(tie & (lens > 0)):
            want = dst[starts[i]:starts[i] + min(k, lens[i])]
            if ki[i, :len(want)].tolist() != want.tolist():
                _fail(f"tie row of {lens[i]} cells, K={k}: not the earliest "
                      f"slots' partners")


def _topk_batches(batches):
    batches = [b for b in batches if len(b)]
    return (np.concatenate([b.rows for b in batches]),
            np.concatenate([b.vals for b in batches]),
            np.concatenate([b.idx for b in batches]))


def phase_sparse_path_parity() -> None:
    from tpu_cooccurrence_torch.ops import rect_topk as rt
    from tpu_cooccurrence_torch.ops.score_topk import topk_parity

    print(f"phase 6: sparse path parity, cuda vs cpu (config-4 prefix, "
          f"{PARITY_PREFIX} events)", flush=True)
    users, items, ts = (a[:PARITY_PREFIX] for a in _config4_stream())
    for emit in (False, True):
        mode = "emit-updates" if emit else "deferred"
        outs = {"cuda": [], "cpu": []}
        before = rt.LAUNCHES
        gpu, t_gpu = _run_sparse_job("cuda", users, items, ts, emit,
                                     outs["cuda"])
        launches = rt.LAUNCHES - before
        cpu, t_cpu = _run_sparse_job("cpu", users, items, ts, emit,
                                     outs["cpu"])
        if gpu.counters.as_dict() != cpu.counters.as_dict():
            _fail(f"{mode}: counters differ {gpu.counters} vs "
                  f"{cpu.counters}")
        a, b = gpu.scorer.checkpoint_state(), cpu.scorer.checkpoint_state()
        for key in a:
            if not np.array_equal(a[key], b[key]):
                _fail(f"{mode}: checkpoint {key} differs between cuda and "
                      f"cpu")
        # Rows in the order they were handed over (stdout's order under
        # --emit-updates), scores in parity.
        ra, va, ia = _topk_batches(outs["cuda"])
        rb, vb, ib = _topk_batches(outs["cpu"])
        ok, mism = topk_parity(va, ia, vb, ib, rtol=RTOL, atol=ATOL)
        if not np.array_equal(ra, rb) or not ok or mism:
            _fail(f"{mode}: rows differ (same order "
                  f"{np.array_equal(ra, rb)}, scores_ok {ok}, untied id "
                  f"mismatches {mism})")
        if launches <= 0:
            _fail(f"{mode}: the cuda run launched no rect kernel")
        print(f"  {mode}: {gpu.windows_fired} windows, {len(ra)} rows "
              f"handed over, {int(len(a['rows_key']))} live cells, "
              f"{gpu.scorer.compactions} compactions; counters and "
              f"checkpoint equal, rows in order and in parity; {launches} "
              f"kernel launches; cuda {t_gpu:.2f} s, cpu {t_cpu:.2f} s",
              flush=True)


def _measure_rect(name, args):
    """Kernel, plain and torch.topk-yardstick times for one ``rect_topk``
    call (``args`` as the scorer passed them), plus the bound."""
    import torch

    from tpu_cooccurrence_torch.ops.rect_topk import (
        PLAIN_LADDER, bucket_r, min_rect_width, rect_topk,
        rect_topk_reference, score_buckets)
    from tpu_cooccurrence_torch.sampling.reservoir import _ragged_arange

    cnt, _dst, _rs, rows, starts, lens, _obs, k, n_short = args
    ms = _time_ms(lambda: rect_topk(*args), 20)
    plain_ms = _time_ms(lambda: rect_topk_reference(*args[:8]), 3)
    # Yardstick for the selection alone: torch.topk over the plain
    # version's [S_b, R_b] rectangles of random scores (never called by
    # the port).
    starts, lens = starts.cpu().numpy(), lens.cpu().numpy()
    min_r = min_rect_width(k)
    buckets, counts = np.unique(score_buckets(lens, min_r, PLAIN_LADDER)[0],
                                return_counts=True)
    rects = [torch.rand((int(c), bucket_r(int(b), min_r, PLAIN_LADDER)),
                        device="cuda") for b, c in zip(buckets, counts)]
    topk_ms = _time_ms(lambda: [torch.topk(r, k, dim=1) for r in rects], 20)
    del rects
    # Bound: each input byte once (cnt of every cell at the slab's cell
    # width, dst and the partner row sum of every live cell, the row's
    # meta and own sum) and the outputs once, against 8 f32 operations
    # per live cell.
    cells = np.repeat(starts.astype(np.int64), lens) + _ragged_arange(lens)
    nnz = int((cnt.cpu().numpy()[cells] != 0).sum())
    s = rows.shape[0]
    nbytes = (cnt.element_size() * len(cells) + 8 * nnz + 16 * s
              + 8 * s * k)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nnz * OPS_PER_CELL / FP32_OPS_PER_S * 1e3
    bound_ms, bound_by = ((t_bytes, "bytes") if t_bytes >= t_ops
                          else (t_ops, "operations"))
    print(f"  time {name}: S={s} rows, {len(cells)} cells ({nnz} live, "
          f"longest {int(lens.max())}; {n_short} short rows, "
          f"{s - n_short} long): kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, torch.topk yardstick {topk_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}; {100 * bound_ms / ms:.1f}% of it "
          f"reached)", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, topk_ms=topk_ms, bound_ms=bound_ms,
                bound_by=bound_by, nnz=nnz)


def phase_sparse_main_path(parity: Parity, card: str) -> dict:
    import torch

    from tpu_cooccurrence_torch.metrics import OBSERVED_COOCCURRENCES
    from tpu_cooccurrence_torch.ops import rect_topk as rt
    from tpu_cooccurrence_torch.state import sparse_scorer as ss

    print("phase 7: sparse main path at full size (config 4, nothing cut)",
          flush=True)
    users, items, ts = _config4_stream()
    # Keep the arguments of the run's largest launch (most rows), and every
    # launch's lengths and short-row count: device copies, no sync, to time
    # the kernel at exactly that shape and report the classes afterwards.
    largest = {"s": -1}
    classes = []
    launch = ss.rect_topk

    def recording(*args):
        classes.append((args[5].clone(), args[8]))
        if args[3].shape[0] > largest["s"]:
            largest.update(s=args[3].shape[0], args=tuple(
                a.clone() if torch.is_tensor(a) else a for a in args))
        return launch(*args)

    ss.rect_topk = recording
    try:
        rt.LAUNCHES = 0
        job, elapsed = _run_sparse_job("cuda", users, items, ts)
        launches = rt.LAUNCHES
    finally:
        ss.rect_topk = launch
    pairs = job.counters.get(OBSERVED_COOCCURRENCES)
    sc = job.scorer
    print(f"  {card}: {elapsed:.3f} s, {pairs} pairs, "
          f"{pairs / elapsed:.1f} pairs/s, {job.windows_fired} windows, "
          f"{launches} kernel launches", flush=True)
    if launches <= 0:
        _fail("the sparse main path launched the rect_topk kernel no time")
    print(f"  slab: {sc.slab_device_bytes} device bytes (capacity "
          f"{sc.capacity} cells), {sc.live_cells} live cells, heap end "
          f"{sc.heap_end}, {sc.compactions} compactions, item capacity "
          f"{sc.items_cap}, host index {sc.index.nbytes} bytes", flush=True)
    st = sc.checkpoint_state()
    if int(sc.row_sums.sum(dtype=torch.int64)) != sc.observed:
        _fail("row_sums.sum() != observed")
    if int(st["rows_cnt"].sum()) != sc.observed or (st["rows_cnt"] < 0).any():
        _fail("the slab's live cells do not sum to observed")
    snap = job.latest.snapshot()
    if len(snap) == 0:
        _fail("no rows came out")
    for item in snap:
        scores = [s for _, s in snap[item]]
        if (not np.all(np.isfinite(scores)) or len(scores) > 10
                or scores != sorted(scores, reverse=True)):
            _fail(f"row {item} malformed: {snap[item]}")
    print(f"  invariants hold; {len(snap)} rows, finite and descending",
          flush=True)
    print(f"  host stages: {job.step_timer.summary()}", flush=True)
    _device_profile(lambda: _run_sparse_job("cuda", users, items, ts)[1],
                    elapsed)

    lens = [(ln.cpu().numpy(), n) for ln, n in classes]
    print(f"  size classes over the {len(lens)} launches: "
          f"{sum(n for _, n in lens)} short rows, "
          f"{sum(len(ln) - n for ln, n in lens)} long rows, "
          f"{sum(int((ln > 4096).sum()) for ln, _ in lens)} rows over 4,096 "
          f"cells; longest row {max(int(ln.max(initial=0)) for ln, _ in lens)}"
          f" cells", flush=True)
    args = largest["args"]
    parity.compare("main_path_largest_launch", rt.rect_topk(*args),
                   rt.rect_topk_reference(*args[:8]), exact=True)
    m = _measure_rect(f"main_path_largest_launch_S{largest['s']}", args)
    return dict(launches=launches, job=job, args=args, **m)

class ExpandParity:
    """Expand kernel vs plain: ``C`` and row sums must be exactly equal;
    keeps the worst absolute difference (0 when they are)."""

    def __init__(self) -> None:
        self.max_abs_err = 0.0
        self.cases = 0

    def compare(self, name, C, rs, block, reps=20):
        """``apply_baskets`` and ``apply_baskets_reference`` on two copies
        of ``C``/``rs`` (the inputs stay as they are); the kernel and the
        plain version then timed on the plain version's copy. Returns the
        kernel's results."""
        import torch

        from tpu_cooccurrence_torch.ops.expand import (
            apply_baskets, apply_baskets_reference)

        kc, krs = C.clone(), rs.clone()
        apply_baskets(kc, krs, block)
        pc, prs = C.clone(), rs.clone()
        apply_baskets_reference(pc, prs, block)
        torch.cuda.synchronize()
        if not (torch.equal(kc, pc) and torch.equal(krs, prs)):
            self.max_abs_err = max(self.max_abs_err, float(
                (krs.long() - prs.long()).abs().max()))
            _fail(f"{name}: expand kernel and plain differ: "
                  f"{int((kc != pc).sum())} C cells, "
                  f"{int((krs != prs).sum())} row sums")
        ms = _time_ms(lambda: apply_baskets(pc, prs, block), reps)
        plain_ms = _time_ms(
            lambda: apply_baskets_reference(pc, prs, block), 3)
        del pc, prs
        self.cases += 1
        print(f"  parity {name}: C and row sums exactly equal; kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
        return kc, krs


def _basket_block(rng, n, w, num_items, id_base=0, replacements=False,
                  hot_new=None, edges=False, zipf=False):
    """A packed ``[n, W + 4]`` block of seeded star ops on the card:
    partner ids in [id_base, num_items), garbage past each op's len.
    ``replacements``: ops in (+1, -1) pairs of full width with the same
    skip slot; ``edges``: len 0, len W and skip >= len ops among random
    lens; ``hot_new``: every op on that one new item; ``zipf``: random
    lens, and new items and partners drawn Zipf 1.1 (the bench stream's
    alpha), so the lowest ids recur in nearly every op."""
    import torch

    from tpu_cooccurrence_torch.ops.expand import pack_block

    lens = np.full(n, w)
    skips = np.full(n, -1)
    signs = np.ones(n)
    if replacements:
        skips = np.repeat(rng.integers(0, w, n // 2), 2)
        signs = np.tile([1, -1], n // 2)
    elif edges:
        lens = rng.integers(0, w + 1, n)
        lens[::7], lens[1::7] = 0, w
        skips = np.where(rng.random(n) < 0.5, rng.integers(0, w + 3, n), -1)
        signs = np.where(rng.random(n) < 0.7, 1, -1)
    elif zipf:
        lens = rng.integers(1, w + 1, n)
    j = np.arange(w)[None, :]
    if zipf:
        draw = (rng.zipf(1.1, (n, w + 1)) - 1) % num_items
        partners, hot_new = draw[:, :w], draw[:, w]
    else:
        partners = rng.integers(id_base, num_items, (n, w))
    baskets = np.where(j < lens[:, None], partners,
                       rng.integers(-2**31, 2**31 - 1, (n, w)))
    new = (np.broadcast_to(hot_new, n) if hot_new is not None
           else rng.integers(id_base, num_items, n))
    block = pack_block(*(np.asarray(a).astype(np.int32) for a in
                         (new, baskets, lens, skips, signs)))
    return torch.from_numpy(block).to("cuda")


def phase_expand_kernel(parity: ExpandParity) -> None:
    import torch

    print("phase 8: expand kernel vs plain on the card", flush=True)
    rng = np.random.default_rng(20261018)
    dev = torch.device("cuda")

    def state(n, dtype):
        c = torch.from_numpy(rng.integers(-1000, 1000, (n, n))).to(dtype)
        rs = rng.integers(0, 1 << 24, n).astype(np.int32)
        return c.to(dev), torch.from_numpy(rs).to(dev)

    parity.compare("append_ops_skip-1_N2000_W50_I5000_int32",
                   *state(5000, torch.int32),
                   _basket_block(rng, 2000, 50, 5000))
    parity.compare("replacement_pairs_pm1_N400_W500_I5000_int32",
                   *state(5000, torch.int32),
                   _basket_block(rng, 400, 500, 5000, replacements=True))
    parity.compare("len0_lenW_skip_ge_len_N3000_W71_I4099_int16",
                   *state(4099, torch.int16),
                   _basket_block(rng, 3000, 71, 4099, edges=True))
    for dtype in (torch.int32, torch.int16):
        parity.compare(f"contention_10000_ops_one_new_W32_I4096_"
                       f"{str(dtype).split('.')[-1]}",
                       *state(4096, dtype),
                       _basket_block(rng, 10_000, 32, 4096, hot_new=17))
    # One cell an op: each lane of a warp on another op.
    for dtype in (torch.int32, torch.int16):
        parity.compare(f"W1_200000_ops_I4096_{str(dtype).split('.')[-1]}",
                       *state(4096, dtype),
                       _basket_block(rng, 200_000, 1, 4096))
    # The main path's shape with Zipf-hot partners: the lowest ids, whose
    # row sums share a sector, recur in nearly every op.
    for dtype in (torch.int32, torch.int16):
        parity.compare(f"zipf_hot_partners_N8131_W71_I5000_"
                       f"{str(dtype).split('.')[-1]}",
                       *state(5000, dtype),
                       _basket_block(rng, 8131, 71, 5000, zipf=True))

    # int16 wraparound: 40,000 ops add +1 to the cells (3, 5)/(5, 3) and
    # 40,000 add -1 to (7, 11)/(11, 7), each starting 7 from its limit.
    n = 40_000
    ops = (np.r_[np.full(n, 3), np.full(n, 7)],
           np.r_[np.full((n, 1), 5), np.full((n, 1), 11)],
           np.ones(2 * n), np.full(2 * n, -1), np.r_[np.ones(n), -np.ones(n)])
    from tpu_cooccurrence_torch.ops.expand import pack_block

    block = torch.from_numpy(pack_block(*(a.astype(np.int32) for a in ops)))
    C = torch.zeros((64, 64), dtype=torch.int16)
    C[3, 5] = C[5, 3] = 32_760
    C[7, 11] = C[11, 7] = -32_760
    kc, _ = parity.compare("int16_wraparound_80000_ops", C.to(dev),
                           torch.zeros(64, dtype=torch.int32, device=dev),
                           block.to(dev))
    want_up, want_down = (int(np.int64(v).astype(np.int16))
                          for v in (32_760 + n, -32_760 - n))
    got = kc.cpu()
    if (int(got[3, 5]), int(got[5, 3]), int(got[7, 11]),
            int(got[11, 7])) != (want_up, want_up, want_down, want_down):
        _fail(f"int16 wraparound: got {got[3, 5]}, {got[7, 11]}, want "
              f"{want_up}, {want_down}")

    # An odd-sized int16 C inside a buffer of guard cells: at offset 0 its
    # last cell shares a 32-bit word with the guard after it; at offset 1
    # (C starts 2 bytes past a 4-byte boundary) its first cell shares one
    # with the guard before it. The adds must leave the guards alone.
    from tpu_cooccurrence_torch.ops.expand import apply_baskets

    odd, n = 4099, 64
    for start, cells, name in (
            (0, [odd - 1], "last_cell_odd_I4099_int16"),
            (1, [0, odd - 1], "first_cell_unaligned_start_I4099_int16")):
        buf = torch.full((odd * odd + 2,), 77, dtype=torch.int16, device=dev)
        C = buf[start:start + odd * odd].view(odd, odd)
        C.zero_()
        ids = np.repeat(cells, n)
        ops = (ids, ids[:, None], np.ones(len(ids)), np.full(len(ids), -1),
               np.ones(len(ids)))
        block = torch.from_numpy(
            pack_block(*(a.astype(np.int32) for a in ops))).to(dev)
        rs = torch.zeros(odd, dtype=torch.int32, device=dev)
        parity.compare(name, C, rs, block)
        apply_baskets(C, rs, block)
        got = [int(C[c, c]) for c in cells]
        guards = torch.cat([buf[:start], buf[start + odd * odd:]]).tolist()
        if got != [2 * n] * len(cells) or guards != [77, 77]:
            _fail(f"{name}: cells {got} (want {2 * n} each), guard cells "
                  f"{guards} (want [77, 77])")
        del buf, C, rs

    # Ids near I - 1 at the int16 vocabulary ceiling: cell offsets
    # new * I + p pass 2^31.
    big = 61_440
    C = torch.zeros((big, big), dtype=torch.int16, device=dev)
    rs = torch.zeros(big, dtype=torch.int32, device=dev)
    block = _basket_block(rng, 500, 64, big, id_base=big - 300)
    kc, _ = parity.compare("ids_near_I-1_I61440_int16", C, rs, block)
    hi = int((kc[big - 300:].ne(0)).sum())
    if hi == 0:
        _fail("ids near I - 1: no cell past offset 2^31 was written")
    print(f"  {hi} cells written past offset 2^31 "
          f"({(big - 300) * big} .. {big * big - 1})", flush=True)
    del C, rs, kc
    torch.cuda.empty_cache()


def _valid_pairs(block: np.ndarray) -> int:
    """Valid cells (pairs per direction) of a packed host block."""
    w = block.shape[1] - 4
    j = np.arange(w)[None, :]
    lens, skips = block[:, w + 1:w + 2], block[:, w + 2:w + 3]
    return int(((j < lens) & (j != skips)).sum())


def _recording_blocks(blocks: list):
    """Patch the scorer's ``pack_block`` to keep every host block it
    packs (a reference only; the block is not copied). Returns a restore
    function."""
    from tpu_cooccurrence_torch.ops import device_scorer as ds

    pack = ds.pack_block

    def recording(*args):
        block = pack(*args)
        blocks.append(block)
        return block

    ds.pack_block = recording

    def restore():
        ds.pack_block = pack
    return restore


def _measure_expand(name, C, rs, block_host):
    """Kernel, plain and chained-scatter yardstick times for one expand
    launch, on scratch copies of the state, plus the bound."""
    import torch

    from tpu_cooccurrence_torch.ops.aggregate import aggregate_window_coo
    from tpu_cooccurrence_torch.ops.device_scorer import _apply_coo
    from tpu_cooccurrence_torch.ops.expand import (
        apply_baskets, apply_baskets_reference, split_block)
    from tpu_cooccurrence_torch.sampling.reservoir import BasketBatch

    block = torch.from_numpy(block_host).to("cuda")
    Cs, rss = C.clone(), rs.clone()
    ms = _time_ms(lambda: apply_baskets(Cs, rss, block), 20)
    plain_ms = _time_ms(lambda: apply_baskets_reference(Cs, rss, block), 5)
    # Yardstick: the chained path's scatter of the same window's folded
    # lanes, handed over ready-made (the nearest PyTorch call; the port's
    # fused path never calls it).
    baskets, new, lens, skips, signs = (
        t.numpy() for t in split_block(torch.from_numpy(block_host)))
    pairs = BasketBatch(new, baskets, lens, skips, signs).to_pairs()
    src, dst, delta = aggregate_window_coo(pairs.src, pairs.dst, pairs.delta)
    src_t = torch.from_numpy(src.astype(np.int64)).to("cuda")
    dst_t = torch.from_numpy(dst.astype(np.int64)).to("cuda")
    delta_t = torch.from_numpy(delta.astype(np.int32)).to("cuda")
    library_ms = _time_ms(
        lambda: _apply_coo(Cs, rss, src_t, dst_t, delta_t), 20)
    # The scatter's floor: index_add_ of the launch's expanded C cells,
    # one atomic each, unfolded (the kernel's C atomics without the
    # expansion or the row sums).
    flat = torch.from_numpy(pairs.src.astype(np.int64) * C.shape[0]
                            + pairs.dst).to("cuda")
    ones = torch.from_numpy(pairs.delta).to(C.dtype).to("cuda")
    Cflat = Cs.view(-1)
    floor_ms = _time_ms(lambda: Cflat.index_add_(0, flat, ones), 20)
    del Cs, rss, Cflat, flat, ones
    # Bound: the block read once, and each distinct 32-byte sector of C
    # and of the row sums that the launch touches read and written once
    # (64 bytes over HBM; repeated adds to one sector can stay in L2).
    # The folded lanes are the distinct cells touched (the fold keeps
    # zero-sum cells), and their sources the distinct row sums.
    n, w = block_host.shape[0], block_host.shape[1] - 4
    p = _valid_pairs(block_host)
    cells = src.astype(np.int64) * C.shape[0] + dst
    c_sectors = len(np.unique(cells * C.element_size() // 32))
    rs_sectors = len(np.unique(src.astype(np.int64) * 4 // 32))
    nbytes = 4 * n * (w + 4) + 64 * (c_sectors + rs_sectors)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"  time {name}: {n} ops, W={w}, {p} pairs per direction, "
          f"{len(src)} folded cells in {c_sectors} C sectors, "
          f"{rs_sectors} row-sum sectors, {nbytes} bytes: kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, chained _apply_coo "
          f"yardstick {library_ms:.4f} ms, index_add_ of the {len(pairs.src)} "
          f"expanded C cells {floor_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"(bytes; {100 * bound_ms / ms:.1f}% of it reached)", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by="bytes")


def _reset_dispatch_gauges():
    from tpu_cooccurrence_torch.observability.registry import REGISTRY

    for name in ("cooc_fused_dispatches_total",
                 "cooc_chained_dispatches_total"):
        REGISTRY.gauge(name).set(0)


def _dispatches():
    from tpu_cooccurrence_torch.observability.registry import REGISTRY

    return (int(REGISTRY.gauge("cooc_fused_dispatches_total").get()),
            int(REGISTRY.gauge("cooc_chained_dispatches_total").get()))


def _score_seconds_ms(job):
    s = [w.score_seconds * 1e3 for w in job.step_timer.windows]
    return float(np.median(s)), float(np.sum(s))


def _counted_fused_run(dtype, card, users, items, ts):
    """The bench workload fused on cuda at ``dtype``, the expand and score
    counts and the dispatch gauges reset just before and read just after;
    fails unless every pair-carrying window was fused and launched the
    expand kernel. Returns the job, its seconds, its expand launches and
    the host blocks it packed."""
    from tpu_cooccurrence_torch.metrics import OBSERVED_COOCCURRENCES
    from tpu_cooccurrence_torch.ops import expand as ex
    from tpu_cooccurrence_torch.ops import score_topk as st

    blocks: list = []
    restore = _recording_blocks(blocks)
    try:
        _reset_dispatch_gauges()
        ex.LAUNCHES = st.LAUNCHES = 0
        job, elapsed = _run_job("cuda", dtype, users, items, ts,
                                num_items=20_000, fused_window="on")
        launches, score_launches = ex.LAUNCHES, st.LAUNCHES
        fused, chained = _dispatches()
    finally:
        restore()
    pair_windows = sum(1 for w in job.step_timer.windows if w.pairs > 0)
    pairs = job.counters.get(OBSERVED_COOCCURRENCES)
    print(f"  {card}: fused {dtype} {elapsed:.3f} s, {pairs} pairs, "
          f"{pairs / elapsed:.1f} pairs/s, {job.windows_fired} windows "
          f"({pair_windows} with pairs), {launches} expand launches, "
          f"{score_launches} score launches; dispatches fused {fused}, "
          f"chained {chained}", flush=True)
    if launches < pair_windows or launches <= 0:
        _fail(f"{dtype}: the fused path launched the expand kernel "
              f"{launches} times for {pair_windows} pair-carrying windows")
    if fused != pair_windows or chained != 0:
        _fail(f"{dtype} routing: {fused} fused and {chained} chained "
              f"dispatches for {pair_windows} pair-carrying windows")
    return job, elapsed, launches, blocks


def phase_fused_main_path(parity: ExpandParity, card: str,
                          chained_job) -> dict:
    from tpu_cooccurrence_torch.ops import expand as ex
    from tpu_cooccurrence_torch.ops.score_topk import topk_parity

    print("phase 9: dense fused window (--fused-window on), bench "
          "workload", flush=True)
    users, items, ts = _bench_stream()
    job, elapsed, launches, blocks = _counted_fused_run(
        "int32", card, users, items, ts)
    if job.counters.as_dict() != chained_job.counters.as_dict():
        _fail(f"counters differ from the chained run: {job.counters} vs "
              f"{chained_job.counters}")
    a = job.scorer.checkpoint_state()
    b = chained_job.scorer.checkpoint_state()
    for key in ("C", "row_sums", "observed"):
        if not np.array_equal(a[key], b[key]):
            _fail(f"fused vs chained: {key} differs")
    ia, va, da = _rows_table(job, 10)
    ib, vb, db = _rows_table(chained_job, 10)
    if ia != ib or not np.array_equal(va, vb) or not np.array_equal(da, db):
        _fail("fused vs chained: rows differ (ids or float32 scores)")
    f_med, f_sum = _score_seconds_ms(job)
    c_med, c_sum = _score_seconds_ms(chained_job)
    print(f"  state, counters and {len(ia)} rows exactly equal to phase 4's "
          f"chained run; score_seconds per window: fused median "
          f"{f_med:.3f} ms (sum {f_sum:.3f} ms), chained median "
          f"{c_med:.3f} ms (sum {c_sum:.3f} ms)", flush=True)
    print(f"  host stages: {job.step_timer.summary()}", flush=True)
    _device_profile(lambda: _run_job("cuda", "int32", users, items, ts,
                                     num_items=20_000,
                                     fused_window="on")[1], elapsed)

    print("  phase 3's stream, user cut 3: fused cuda vs fused cpu",
          flush=True)
    users3, items3, ts3 = _parity_stream()
    for dtype in ("int32", "int16"):
        small: list = []
        restore = _recording_blocks(small)
        try:
            before = ex.LAUNCHES
            gpu, t_gpu = _run_job("cuda", dtype, users3, items3, ts3,
                                  user_cut=3, fused_window="on")
            n_launch = ex.LAUNCHES - before
        finally:
            restore()
        cpu, t_cpu = _run_job("cpu", dtype, users3, items3, ts3,
                              user_cut=3, fused_window="on")
        if gpu.counters.as_dict() != cpu.counters.as_dict():
            _fail(f"uc3 {dtype}: counters differ {gpu.counters} vs "
                  f"{cpu.counters}")
        a, b = gpu.scorer.checkpoint_state(), cpu.scorer.checkpoint_state()
        for key in ("C", "row_sums", "observed"):
            if not np.array_equal(a[key], b[key]):
                _fail(f"uc3 {dtype}: {key} differs between cuda and cpu")
        ia, va, da = _rows_table(gpu, 10)
        ib, vb, db = _rows_table(cpu, 10)
        ok, mism = topk_parity(va, da, vb, db, rtol=RTOL, atol=ATOL)
        if ia != ib or not ok or mism:
            _fail(f"uc3 {dtype}: final rows differ (same items {ia == ib},"
                  f" scores_ok {ok}, untied id mismatches {mism})")
        rep_ops = sum(int((blk[:, -1] < 0).sum()) for blk in small)
        if n_launch <= 0 or rep_ops <= 0:
            _fail(f"uc3 {dtype}: {n_launch} expand launches, {rep_ops} "
                  f"replacement ops on the card")
        print(f"  uc3 {dtype}: {gpu.windows_fired} windows, {len(ia)} "
              f"rows, {n_launch} expand launches carrying {rep_ops} "
              f"replacement (-1) ops; counters/C/row_sums/observed equal, "
              f"rows in parity; cuda {t_gpu:.2f} s, cpu {t_cpu:.2f} s",
              flush=True)

    # The main run's largest launch, replayed on its final state.
    largest = max(blocks, key=_valid_pairs)
    sc = job.scorer
    import torch

    parity.compare(f"main_path_largest_launch_N{largest.shape[0]}_"
                   f"W{largest.shape[1] - 4}", sc.C, sc.row_sums,
                   torch.from_numpy(largest).to("cuda"), reps=5)
    m = _measure_expand(f"main_path_largest_launch_N{largest.shape[0]}",
                        sc.C, sc.row_sums, largest)
    del job, sc
    _fused_int16_run(parity, card, users, items, ts)
    return dict(launches=launches, **m)


def _fused_int16_run(parity: ExpandParity, card: str, users, items,
                     ts) -> None:
    """The bench workload at ``--count-dtype int16`` (``C`` 800 MB), fused
    on cuda with the counts reset just before and read just after, then
    chained on cuda: state and counters exactly equal, rows in
    ``topk_parity``; the largest expand launch replayed and timed."""
    import torch

    from tpu_cooccurrence_torch.metrics import OBSERVED_COOCCURRENCES
    from tpu_cooccurrence_torch.ops.score_topk import topk_parity

    print("  bench workload at --count-dtype int16: fused vs chained",
          flush=True)
    job, _, _, blocks = _counted_fused_run("int16", card, users, items, ts)
    pairs = job.counters.get(OBSERVED_COOCCURRENCES)
    print(f"  host stages: {job.step_timer.summary()}", flush=True)
    ref, ref_elapsed = _run_job("cuda", "int16", users, items, ts,
                                num_items=20_000)
    print(f"  chained int16 {ref_elapsed:.3f} s, "
          f"{pairs / ref_elapsed:.1f} pairs/s", flush=True)
    if job.counters.as_dict() != ref.counters.as_dict():
        _fail(f"int16: counters differ from the chained run: "
              f"{job.counters} vs {ref.counters}")
    a, b = job.scorer.checkpoint_state(), ref.scorer.checkpoint_state()
    for key in ("C", "row_sums", "observed"):
        if not np.array_equal(a[key], b[key]):
            _fail(f"int16 fused vs chained: {key} differs")
    del a, b
    ia, va, da = _rows_table(job, 10)
    ib, vb, db = _rows_table(ref, 10)
    ok, mism = topk_parity(va, da, vb, db, rtol=RTOL, atol=ATOL)
    if ia != ib or not ok or mism:
        _fail(f"int16 fused vs chained: rows differ (same items "
              f"{ia == ib}, scores_ok {ok}, untied id mismatches {mism})")
    print(f"  int16: state, counters equal to the chained run; {len(ia)} "
          f"rows in parity (bit-equal: "
          f"{np.array_equal(va, vb) and np.array_equal(da, db)})",
          flush=True)
    del ref
    largest = max(blocks, key=_valid_pairs)
    sc = job.scorer
    parity.compare(f"main_path_int16_largest_launch_N{largest.shape[0]}_"
                   f"W{largest.shape[1] - 4}", sc.C, sc.row_sums,
                   torch.from_numpy(largest).to("cuda"), reps=5)
    _measure_expand(f"main_path_int16_largest_launch_N{largest.shape[0]}",
                    sc.C, sc.row_sums, largest)
    del job, sc
    torch.cuda.empty_cache()


# -- phase 10: the pipelined window loop and checkpoint/resume ----------


#: The modules under ``ops/`` whose kernels each path launches.
_PATH_KERNELS = {"chained": ("score_topk",),
                 "fused": ("expand", "score_topk"),
                 "sparse": ("rect_topk",),
                 "sharded": ("score_topk",)}


def _kernel_modules(path):
    import importlib

    return [importlib.import_module(f"tpu_cooccurrence_torch.ops.{m}")
            for m in _PATH_KERNELS[path]]


def _counted(path, run):
    """``run()`` with the path's kernel counts set to 0 just before and
    read just after; fails unless each kernel of the path launched.
    Returns ``run()``'s result and the counts."""
    mods = _kernel_modules(path)
    for m in mods:
        m.LAUNCHES = 0
    out = run()
    counts = {m.__name__.rsplit(".", 1)[1]: m.LAUNCHES for m in mods}
    for name, n in counts.items():
        if n <= 0:
            _fail(f"{path}: the {name} kernel launched no time")
    return out, counts


def _stage_line(job, wall):
    """Wall, pairs/s and the stage seconds of one run (host clocks)."""
    from tpu_cooccurrence_torch.metrics import OBSERVED_COOCCURRENCES

    pairs = job.counters.get(OBSERVED_COOCCURRENCES)
    pipe = job.pipeline
    wait = (f"queue wait {pipe.queue_wait_seconds:.4f} s, ring stall "
            f"{pipe.ring_stall_seconds:.4f} s" if pipe else "serial")
    return (f"wall {wall:.4f} s, {pairs / wall:.1f} pairs/s, sampling "
            f"{job.step_timer.total_sample_seconds:.4f} s, scorer "
            f"{job.step_timer.total_score_seconds:.4f} s, {wait}, "
            f"occupancy {job.step_timer.occupancy(wall, pipe)}")


def _dense_equal(job, ref, what):
    """Counters, ``C``, row sums, ``observed`` and every row of two dense
    jobs exactly equal (the integer state compared on the card)."""
    import torch

    got = {k: v for k, v in job.counters.as_dict().items()
           if k != "SplitReaderNumSplits"}
    want = {k: v for k, v in ref.counters.as_dict().items()
            if k != "SplitReaderNumSplits"}
    if got != want:
        _fail(f"{what}: counters differ {got} vs {want}")
    a, b = job.scorer, ref.scorer
    if (a.observed != b.observed or not torch.equal(a.C, b.C)
            or not torch.equal(a.row_sums, b.row_sums)):
        _fail(f"{what}: C, row sums or observed differ")
    ia, va, da = _rows_table(job, 10)
    ib, vb, db = _rows_table(ref, 10)
    if ia != ib or not np.array_equal(va, vb) or not np.array_equal(da, db):
        _fail(f"{what}: rows differ (ids or float32 scores)")
    return len(ia)


def _tie_aware_mismatches(va, ia, vb, ib):
    """Finite lanes whose ids differ although their score is untied: unique
    in its row, and in a full row not equal to its K-th score (a partner
    past the K-th lane may share it)."""
    untied = (va[:, :, None] == va[:, None, :]).sum(-1) == 1
    untied &= ~(np.isfinite(va[:, -1:]) & (va == va[:, -1:]))
    return int(((ia != ib) & np.isfinite(va) & untied).sum())


def _sparse_equal(job, ref, what, ties_may_swap=False):
    """Counters, the canonical slab state and every row of two sparse jobs
    exactly equal. After a restore the slab is laid out afresh (cells in
    key order) and the top-K keeps the earliest slot among equal scores:
    with ``ties_may_swap`` ids may then differ where scores tie."""
    got = {k: v for k, v in job.counters.as_dict().items()
           if k != "SplitReaderNumSplits"}
    want = {k: v for k, v in ref.counters.as_dict().items()
            if k != "SplitReaderNumSplits"}
    if got != want:
        _fail(f"{what}: counters differ {got} vs {want}")
    a, b = job.scorer.checkpoint_state(), ref.scorer.checkpoint_state()
    n = min(len(a["row_sums"]), len(b["row_sums"]))
    if (not all(np.array_equal(a[k], b[k])
                for k in ("rows_key", "rows_cnt", "observed"))
            or not np.array_equal(a["row_sums"][:n], b["row_sums"][:n])
            or a["row_sums"][n:].any() or b["row_sums"][n:].any()):
        _fail(f"{what}: the slab's cells, row sums or observed differ")
    ia, va, da = _rows_table(job, 10)
    ib, vb, db = _rows_table(ref, 10)
    if ia != ib or not np.array_equal(va, vb):
        _fail(f"{what}: rows differ (items or float32 scores)")
    if ties_may_swap:
        mism = _tie_aware_mismatches(va, da, vb, db)
        if mism:
            _fail(f"{what}: {mism} untied ids differ")
        return len(ia), int((da != db).sum())
    if not np.array_equal(da, db):
        _fail(f"{what}: rows differ (ids)")
    return len(ia), 0


def _depth_parity(card, chained_job, sparse_job):
    """(a) Each path at depths 0 and 2, every run exactly equal to
    the depth-0 run of phase 4 (the
    dense paths: phase 9 equals it) or phase 7 (sparse)."""
    users, items, ts = _bench_stream()
    for path, extra in (("fused", dict(fused_window="on")),
                        ("chained", {})):
        for depth in (0, 2):
            (job, wall), counts = _counted(path, lambda: _run_job(
                "cuda", "int32", users, items, ts, num_items=20_000,
                pipeline_depth=depth, **extra))
            rows = _dense_equal(job, chained_job,
                                f"{path} depth {depth}")
            print(f"  {card}: {path} depth {depth}: {_stage_line(job, wall)}"
                  f"; launches {counts}; state, counters and {rows} rows "
                  f"exactly equal to depth 0", flush=True)
            del job
    users, items, ts = _config4_stream()
    from tpu_cooccurrence_torch.config import Config
    from tpu_cooccurrence_torch.job import CooccurrenceJob

    for depth in (0, 2):
        def run():
            job = CooccurrenceJob(Config(**CONFIG4_JOB, device="cuda",
                                         pipeline_depth=depth))
            start = time.monotonic()
            job.add_batch(users, items, ts)
            job.finish()
            import torch

            torch.cuda.synchronize()
            return job, time.monotonic() - start

        (job, wall), counts = _counted("sparse", run)
        rows, _ = _sparse_equal(job, sparse_job, f"sparse depth {depth}")
        print(f"  {card}: sparse config 4 depth {depth}: "
              f"{_stage_line(job, wall)}; launches {counts}; slab, "
              f"counters and {rows} rows exactly equal to phase 7",
              flush=True)
        del job


def _write_csv(path, users, items, ts):
    with open(path, "w") as f:
        f.write("".join(f"{u},{i},{t}\n" for u, i, t in
                        zip(users.tolist(), items.tolist(), ts.tolist())))


class _Abandon(Exception):
    """Raised right after a checkpoint commits: the run is dropped there."""


def _commit_line(what):
    from tpu_cooccurrence_torch.observability.registry import REGISTRY
    from tpu_cooccurrence_torch.state import checkpoint as ckpt

    gen = int(REGISTRY.gauge(ckpt.GENERATION_GAUGE).get())
    nbytes = int(REGISTRY.gauge(ckpt.COMMIT_BYTES_GAUGE).get())
    secs = REGISTRY.gauge(ckpt.COMMIT_SECONDS_GAUGE).get()
    print(f"    {what}: generation {gen}, commit {nbytes} bytes in "
          f"{secs:.4f} s", flush=True)
    return nbytes, secs


def _resume(card, path, cfg, csv, every, check, make_first=None,
            resumed_cfg=None):
    """Run ``cfg`` over ``csv`` through the file source and the batcher,
    checkpointing every ``every`` windows; drop the run right after the
    first checkpoint commits (no finish()); restore a fresh job from the
    directory and finish from the source's restored position; hold it to
    ``check(job, what)``. ``make_first(cfg)`` builds the first job (by
    default, as the resumed one: ``CooccurrenceJob(cfg)``); the resumed
    job runs ``resumed_cfg`` (by default ``cfg``). Returns the dropped job
    (its state is the checkpoint's), the checkpoint directory and the
    first save's bytes and seconds with the restore's seconds."""
    import torch

    from tpu_cooccurrence_torch.io.parse import batched_lines
    from tpu_cooccurrence_torch.io.source import FileMonitorSource
    from tpu_cooccurrence_torch.job import CooccurrenceJob

    a = (make_first or CooccurrenceJob)(cfg)
    save = a.checkpoint

    def checkpoint_then_drop(source=None):
        save(source=source)
        raise _Abandon

    a.checkpoint = checkpoint_then_drop
    a.source = FileMonitorSource(csv, a.counters)

    def first():
        start = time.monotonic()
        try:
            a.run(batched_lines(a.source.lines()))
        except _Abandon:
            torch.cuda.synchronize()
            return time.monotonic() - start
        _fail(f"{path}: the run ended without a checkpoint")

    wall_a, counts_a = _counted(path, first)
    meta = a.source.checkpoint_state()
    if a.windows_fired != every or not 0 < meta["current_line"]:
        _fail(f"{path}: dropped at window {a.windows_fired}, source "
              f"{meta} (wanted window {every}, mid-file)")
    print(f"  {card}: {path} run dropped after the window-{every} "
          f"checkpoint, {wall_a:.3f} s, at line {meta['current_line']} of "
          f"{os.path.basename(csv)}; launches {counts_a}", flush=True)
    save_bytes, save_s = _commit_line("save")

    b = CooccurrenceJob(resumed_cfg or cfg)
    b.source = FileMonitorSource(csv, b.counters)
    start = time.monotonic()
    b.restore(source=b.source)
    torch.cuda.synchronize()
    restore_s = time.monotonic() - start
    print(f"    restore: {restore_s:.4f} s, windows_fired "
          f"{b.windows_fired}", flush=True)

    def rest():
        start = time.monotonic()
        b.run(batched_lines(b.source.lines()))
        torch.cuda.synchronize()
        return time.monotonic() - start

    wall_b, counts_b = _counted(path, rest)
    if b.config.checkpoint_every_windows:
        _commit_line("save by the resumed run")
    result = check(b, f"{path} resumed")
    print(f"  {path} resumed run {wall_b:.3f} s, launches {counts_b}: "
          f"{result}", flush=True)
    return a, cfg.checkpoint_dir, dict(save_bytes=save_bytes,
                                       save_s=save_s, restore_s=restore_s)


def _corrupt_fallback(card, dropped, directory, check):
    """(d) One byte of the newest generation flipped: the restore
    quarantines it and falls back one generation, to the dropped run's
    state."""
    import torch

    from tpu_cooccurrence_torch.job import CooccurrenceJob
    from tpu_cooccurrence_torch.observability.registry import REGISTRY
    from tpu_cooccurrence_torch.state import checkpoint as ckpt

    gens = ckpt.generations(directory)
    newest = gens[0][1]
    with open(newest, "r+b") as f:
        f.seek(os.path.getsize(newest) // 2)
        byte = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([byte[0] ^ 0x01]))
    before = REGISTRY.gauge(ckpt.QUARANTINE_GAUGE).get()
    job = CooccurrenceJob(dropped.config)
    start = time.monotonic()
    job.restore()
    torch.cuda.synchronize()
    took = time.monotonic() - start
    if (not os.path.exists(newest + ".corrupt") or os.path.exists(newest)
            or REGISTRY.gauge(ckpt.QUARANTINE_GAUGE).get() != before + 1
            or job.windows_fired != dropped.windows_fired):
        _fail(f"corrupt generation {gens[0][0]}: not quarantined, or the "
              f"restore did not fall back to generation {gens[1][0]}")
    result = check(job, "fallback restore")
    print(f"  {card}: generation {gens[0][0]} with one byte flipped "
          f"quarantined; restore fell back to generation {gens[1][0]} "
          f"(windows_fired {job.windows_fired}) in {took:.4f} s; equal to "
          f"the dropped run's state: {result}", flush=True)


def phase_pipeline_and_resume(card: str, chained_job, sparse_job) -> dict:
    """Returns the raw sparse checkpoint's save bytes and seconds and its
    restore seconds."""
    import tempfile

    from tpu_cooccurrence_torch.config import Config

    print("phase 10: pipelined window loop (--pipeline-depth 1|2) and "
          "checkpoint/resume", flush=True)
    _depth_parity(card, chained_job, sparse_job)

    with tempfile.TemporaryDirectory() as tmp:
        print("  (b) resume on the fused bench path, depth 2", flush=True)
        csv = os.path.join(tmp, "bench.csv")
        _write_csv(csv, *_bench_stream())
        cfg = Config(window_size=100, seed=0xC0FFEE, item_cut=500,
                     user_cut=500, num_items=20_000, device="cuda",
                     fused_window="on", pipeline_depth=2,
                     checkpoint_dir=os.path.join(tmp, "dense"),
                     checkpoint_every_windows=10)
        # The resumed run saves no further generation: one save of the
        # 1.6 GB dense C measures the dense checkpoint.
        dropped, _, _ = _resume(
            card, "fused", cfg, csv, 10,
            lambda job, what: f"state, counters and "
            f"{_dense_equal(job, chained_job, what)} rows exactly equal "
            f"to the uninterrupted depth-0 run",
            resumed_cfg=dataclasses.replace(cfg,
                                            checkpoint_every_windows=0))
        del dropped

        print("  (c) resume on sparse config 4, depth 2", flush=True)
        csv = os.path.join(tmp, "config4.csv")
        _write_csv(csv, *_config4_stream())
        cfg = Config(**CONFIG4_JOB, device="cuda", pipeline_depth=2,
                     checkpoint_dir=os.path.join(tmp, "sparse"),
                     checkpoint_every_windows=25)

        def sparse_check(job, what, ref=sparse_job):
            rows, swapped = _sparse_equal(job, ref, what, ties_may_swap=True)
            return (f"slab, counters and {rows} rows' scores exactly equal, "
                    f"ids equal but on {swapped} lanes of exactly tied "
                    f"scores")

        dropped, directory, raw_ckpt = _resume(card, "sparse", cfg, csv, 25,
                                               sparse_check)
        print("  (d) a corrupted newest generation", flush=True)
        _corrupt_fallback(card, dropped, directory,
                          lambda job, what: sparse_check(job, what, dropped))
    return raw_ckpt


# -- phase 11: narrow cells, the packed uplink, the packed checkpoint ----


#: The narrow slab cell dtypes and their largest count.
NARROW = (("int16", 32_767), ("int8", 127))


def _narrow_case(parity, name, t, observed, k, n_short, cell, top, rng,
                 keep=None):
    """One rect-kernel case at a narrow cell dtype: phase 5's int32 device
    arrays ``t`` with the counts folded into [0, ``top``] (zeros stay
    zero) and about 1% of the live cells outside ``keep`` set to ``top``.
    The kernel must equal the plain version at that dtype bit for bit,
    and the int32 kernel on the same counts; both kernels timed. Returns
    the narrow kernel's ``(vals, idx)`` on the host."""
    import torch

    from tpu_cooccurrence_torch.ops.rect_topk import (rect_topk,
                                                      rect_topk_reference)

    cnt = t[0].cpu().numpy().astype(np.int64)
    live = cnt != 0
    cnt = np.where(live, 1 + (np.abs(cnt) - 1) % top, 0)
    hit = live & (rng.random(len(cnt)) < 0.01)
    if keep is not None:
        hit &= ~keep
    cnt[hit] = top
    wide = [torch.from_numpy(cnt.astype(np.int32)).to("cuda"), *t[1:]]
    narrow = [wide[0].to(getattr(torch, cell)), *t[1:]]
    kv, ki = parity.compare(f"{cell} {name}",
                            rect_topk(*narrow, observed, k, n_short),
                            rect_topk_reference(*narrow, observed, k),
                            exact=True)
    wv, wi = (x.cpu().numpy() for x in rect_topk(*wide, observed, k,
                                                   n_short))
    if not (np.array_equal(kv, wv) and np.array_equal(ki, wi)):
        _fail(f"{cell} {name}: the narrow kernel differs from the int32 "
              f"kernel on the same counts")
    ms = _time_ms(lambda: rect_topk(*narrow, observed, k, n_short), 20)
    ms32 = _time_ms(lambda: rect_topk(*wide, observed, k, n_short), 20)
    print(f"    time {cell} {name}: {int(hit.sum())} cells at {top}; "
          f"kernel {ms:.4f} ms, int32 kernel on the same counts "
          f"{ms32:.4f} ms", flush=True)
    return kv, ki


def _narrow_kernel_cases(parity: Parity) -> None:
    """(a) ``rect_topk`` at int16 and int8 cells on phase 5's cases and
    size classes: exact against the plain version and the int32 kernel,
    with counts at the dtype's maximum, a 100k-cell row, ids above 2^24
    and exact ties."""
    from tpu_cooccurrence_torch.ops.rect_topk import short_rows

    rng = np.random.default_rng(20261018)
    big_ids = (1 << 24) + 4096
    cases = [
        ("tie_earliest_slot_K4", _tie_case(), 4),
        ("S300_short_rows_K10", _rect_case(rng, 300, 4096, 12,
                                           short_rows=100), 10),
        ("S64_cancelled_cells_K128", _rect_case(rng, 64, 4096, 300,
                                                zero_frac=0.5), 128),
        ("S33_hot_row_100k_cells_K10", _rect_case(
            rng, 33, 200_000, 3000, hot_len=100_000), 10),
        ("S50_ids_above_2^24_K10", _rect_case(
            rng, 50, big_ids, 400, id_base=1 << 24), 10),
        ("S17_K1", _rect_case(rng, 17, 4096, 200), 1),
    ]
    for cell, top in NARROW:
        for name, (arrays, observed), k in cases:
            t = _cuda_int32(arrays)
            _, ki = _narrow_case(parity, name, t, observed, k,
                                 short_rows(np.asarray(arrays[5])), cell,
                                 top, rng, keep=np.ones(len(arrays[0]),
                                                        dtype=bool)
                                 if name.startswith("tie") else None)
            if name.startswith("tie") and ki[0].tolist() != [40, 30, 20, 10]:
                _fail(f"{cell} {name}: ids {ki[0].tolist()} are not the "
                      f"earliest slots' partners")
            if "2^24" in name and not bool((ki >= 1 << 24).any()):
                _fail(f"{cell} {name}: no partner id above 2^24 came out")
        _rect_class_cases(parity, rng, narrow=(cell, top))


class _Recorder:
    """Patches the sparse scorer's ``encode_update`` and ``rect_topk``:
    keeps the largest window's raw update buffer (most entries), the
    arguments of the largest launch (most rows) over the narrow slab
    (``cnt`` at ``dtype``) and the host seconds spent encoding."""

    def __init__(self, dtype):
        self.dtype = dtype
        self.upd = None
        self.largest = {"s": -1}
        self.encode_s = 0.0
        self.windows = 0

    def __enter__(self):
        import torch

        from tpu_cooccurrence_torch.state import sparse_scorer as ss

        self._ss = ss
        self._enc, self._rect = ss.encode_update, ss.rect_topk

        def encode(upd, bounds, n):
            start = time.perf_counter()
            out = self._enc(upd, bounds, n)
            self.encode_s += time.perf_counter() - start
            self.windows += 1
            if self.upd is None or upd.shape[1] > self.upd[0].shape[1]:
                self.upd = (upd.copy(), tuple(bounds))
            return out

        def rect(*args):
            if (args[0].dtype == self.dtype
                    and args[3].shape[0] > self.largest["s"]):
                self.largest.update(s=args[3].shape[0], args=tuple(
                    a.clone() if torch.is_tensor(a) else a for a in args))
            return self._rect(*args)

        ss.encode_update, ss.rect_topk = encode, rect
        return self

    def __exit__(self, *exc):
        self._ss.encode_update, self._ss.rect_topk = self._enc, self._rect
        return False


def _sparse_run(cfg, users, items, ts, recorder=None):
    """One counted sparse run of ``cfg``; returns the job, its wall, its
    launch counts and the ledger's snapshot."""
    import torch

    from tpu_cooccurrence_torch.job import CooccurrenceJob
    from tpu_cooccurrence_torch.observability import LEDGER

    def run():
        LEDGER.reset()
        job = CooccurrenceJob(cfg)
        start = time.monotonic()
        job.add_batch(users, items, ts)
        job.finish()
        torch.cuda.synchronize()
        return job, time.monotonic() - start

    if recorder is None:
        (job, wall), counts = _counted("sparse", run)
    else:
        with recorder:
            (job, wall), counts = _counted("sparse", run)
    return job, wall, counts, LEDGER.snapshot()


def _slab_line(job, wall, counts, ledger):
    """Wall, pairs/s, promoted rows, slab bytes (both tables), uplink."""
    from tpu_cooccurrence_torch.metrics import OBSERVED_COOCCURRENCES

    sc = job.scorer
    pairs = job.counters.get(OBSERVED_COOCCURRENCES)
    cells = len(sc.index)
    wide = "no wide table"
    if sc.index_w is not None:
        n_w = len(sc.index_w)
        wide = (f"wide table {sc.cnt_w.nbytes + sc.dst_w.nbytes} bytes "
                f"({sc.capacity_w} cells, {n_w} live, "
                f"{100 * n_w / max(cells + n_w, 1):.2f}% of the live "
                f"cells)")
    up = (f"uplink raw {ledger['uplink_raw_bytes']} bytes, encoded "
          f"{ledger['uplink_enc_bytes']} "
          f"({ledger['uplink_raw_bytes'] / ledger['uplink_enc_bytes']:.3f}x)"
          if ledger["uplink_enc_bytes"] else "uplink raw")
    return (f"wall {wall:.4f} s, {pairs / wall:.1f} pairs/s, "
            f"{sc.promoted_rows} promoted rows; slab "
            f"{sc.slab_device_bytes} device bytes: narrow "
            f"{sc.cnt.nbytes + sc.dst.nbytes} bytes ({sc.capacity} cells "
            f"of {sc.cnt.element_size() + 4} bytes, {cells} live), {wide}; "
            f"{up}; h2d {ledger['h2d_bytes']} bytes in {ledger['h2d_calls']}"
            f" calls; launches {counts}")


def _config4_cells(card, sparse_job, parity: Parity) -> dict:
    """(b)-(c) Config 4 at each (cell dtype, wire format), in turns, each
    equal to phase 7's int32 raw run; the largest packed window decoded on
    the card against the host; the int16 run's largest launch against
    its plain version and as int32. Returns the int16 packed job."""
    import torch

    from tpu_cooccurrence_torch.config import Config
    from tpu_cooccurrence_torch.ops import rect_topk as rt
    from tpu_cooccurrence_torch.state import wire

    users, items, ts = _config4_stream()
    recs = {cell: _Recorder(getattr(torch, cell)) for cell, _ in NARROW}
    runs = {}
    for cell, fmt in (("int16", "packed"), ("int16", "raw"),
                      ("int32", "raw"), ("int8", "packed")):
        cfg = Config(**{**CONFIG4_JOB, "cell_dtype": cell,
                        "wire_format": fmt}, device="cuda")
        job, wall, counts, ledger = _sparse_run(
            cfg, users, items, ts, recs[cell] if fmt == "packed" else None)
        rows, swapped = _sparse_equal(job, sparse_job,
                                      f"config 4 {cell} {fmt}",
                                      ties_may_swap=cell != "int32")
        print(f"  {card}: config 4 {cell} {fmt}: "
              f"{_slab_line(job, wall, counts, ledger)}; state, counters "
              f"and {rows} rows' scores exactly equal to phase 7's int32 "
              f"raw run, ids equal but on {swapped} lanes of exactly tied "
              f"scores", flush=True)
        if cell == "int8" and job.scorer.promoted_rows <= 0:
            _fail("config 4 at int8: no row promoted")
        runs[(cell, fmt)] = job
        del job
    _sparse_equal(runs[("int16", "raw")], runs[("int16", "packed")],
                  "config 4 int16 raw against packed")
    for cell, rec in recs.items():
        print(f"  {cell} packed: {rec.windows} encoded updates, "
              f"{rec.encode_s:.4f} s of host encoding", flush=True)

    upd, bounds = recs["int16"].upd
    n = upd.shape[1]
    start = time.perf_counter()
    words_i, words_v, header = wire.encode_update(upd, bounds, n)
    enc_ms = 1e3 * (time.perf_counter() - start)
    wi = wire.words_tensor(words_i, "cuda")
    wv = wire.words_tensor(words_v, "cuda")
    got, got_b = wire.decode_update(wi, wv, header, n)
    want, want_b = wire.decode_update_host(words_i, words_v, header, n)
    if not (np.array_equal(got.cpu().numpy(), want)
            and list(got_b) == want_b.tolist()):
        _fail("the card's decode of config 4's largest window differs from "
              "the host decode")
    dec_ms = _time_ms(lambda: wire.decode_update(wi, wv, header, n), 20)
    print(f"  decode: config 4's largest window ({n} entries, sections "
          f"{bounds[0]}, {bounds[1] - bounds[0]}, {n - bounds[1]}; widths "
          f"{int(header[1])}, {int(header[2])} bits) decoded on the card "
          f"exactly equal to the host decode; {upd.nbytes} raw bytes, "
          f"{wi.nbytes + wv.nbytes} encoded; host encode {enc_ms:.4f} ms, "
          f"card decode {dec_ms:.4f} ms", flush=True)

    for cell, rec in recs.items():
        args = rec.largest["args"]
        name = f"{cell} main_path_largest_launch_S{rec.largest['s']}"
        parity.compare(name, rt.rect_topk(*args),
                       rt.rect_topk_reference(*args[:8]), exact=True)
        m = _measure_rect(name, args)
        args32 = (args[0].to(torch.int32), *args[1:])
        m32 = _measure_rect("the same launch at int32 cells", args32)
        # In turns, narrow and int32 alike: a difference within their
        # spread is none.
        turns = [_time_ms(lambda a=a: rt.rect_topk(*a), 50)
                 for a in (args, args32, args32, args)]
        print(f"  {cell} largest launch: kernel {m['ms']:.4f} ms against "
              f"{m32['ms']:.4f} ms at int32 (bounds {m['bound_ms']:.4f}, "
              f"{m32['bound_ms']:.4f} ms); in turns {cell}, int32, int32, "
              f"{cell}: {', '.join(f'{t:.4f}' for t in turns)} ms",
              flush=True)
    return runs[("int16", "packed")]


def _bench_sparse(card) -> None:
    """(d) Phase 4's bench stream through the sparse backend at int16
    packed against int32 raw."""
    from tpu_cooccurrence_torch.config import Config

    users, items, ts = _bench_stream()
    base = dict(window_size=100, seed=0xC0FFEE, item_cut=500, user_cut=500,
                backend="sparse", device="cuda")
    ref, wall, counts, ledger = _sparse_run(
        Config(**base, cell_dtype="int32", wire_format="raw"), users, items,
        ts)
    print(f"  {card}: bench stream sparse int32 raw: "
          f"{_slab_line(ref, wall, counts, ledger)}", flush=True)
    job, wall, counts, ledger = _sparse_run(Config(**base), users, items, ts)
    rows, swapped = _sparse_equal(job, ref, "bench stream int16 packed",
                                  ties_may_swap=True)
    top = int(job.scorer.row_sums_host.max())
    none = ("" if job.scorer.promoted_rows else ": no row reaches 32,768, "
            "none promotes (the int8 runs show promotion)")
    print(f"  {card}: bench stream sparse at the defaults (int16 packed): "
          f"{_slab_line(job, wall, counts, ledger)}; largest row sum "
          f"{top}{none}; state, counters and {rows} rows' scores exactly "
          f"equal to int32 raw, ids equal but on {swapped} lanes of "
          f"exactly tied scores", flush=True)


def _codec_of(directory):
    """The ``ckpt_codec`` record of every generation in ``directory``."""
    from tpu_cooccurrence_torch.state import checkpoint as ckpt

    out = []
    for gen, path in ckpt.generations(directory):
        with np.load(path) as f:
            meta = json.loads(f["meta_json"].tobytes().decode())
        out.append((gen, meta.get("ckpt_codec")))
    return out


#: Phase 11(f)'s turns: config 4's first events and the window of their
#: checkpoint (25 windows, dropped after the 20th; int16 ran the whole
#: stream, dropped after the 25th, until phase 21 needed the time).
RESUME_EVENTS11 = 500_000
RESUME_EVERY11 = 20


def phase_narrow_cells(card: str, parity: Parity, sparse_job,
                       raw_ckpt: dict) -> None:
    import tempfile

    from tpu_cooccurrence_torch.config import Config

    print("phase 11: narrow cells (int16, int8) with promotion, the packed "
          "uplink and the packed checkpoint", flush=True)
    print("  (a) rect_topk at narrow cells vs plain", flush=True)
    _narrow_kernel_cases(parity)
    print("  (b)-(c) config 4 at each cell dtype and wire format", flush=True)
    ref = _config4_cells(card, sparse_job, parity)
    print("  (d) the bench stream on the sparse backend", flush=True)
    _bench_sparse(card)

    print("  (e) config 4 at the defaults, depth 2", flush=True)
    users, items, ts = _config4_stream()
    cfg = Config(**{**CONFIG4_JOB, "cell_dtype": "int16",
                    "wire_format": "packed"}, device="cuda")
    job, wall, counts, ledger = _sparse_run(
        dataclasses.replace(cfg, pipeline_depth=2), users, items, ts)
    rows, _ = _sparse_equal(job, ref, "config 4 int16 packed depth 2")
    print(f"  {card}: depth 2: {_stage_line(job, wall)}; launches {counts};"
          f" slab, counters and {rows} rows exactly equal to depth 0",
          flush=True)
    del job

    with tempfile.TemporaryDirectory() as tmp:
        n, every = RESUME_EVENTS11, RESUME_EVERY11
        for cell in ("int16", "int8"):
            # A prefix, dropped near its end (the depth cuts that made room
            # for phases 19 and 21); at int8 a row must promote before the
            # drop.
            print(f"  (f) resume on config 4's first {n} events at {cell} "
                  f"packed, depth 2, dropped after window {every}",
                  flush=True)
            csv = os.path.join(tmp, f"config4-{cell}.csv")
            _write_csv(csv, users[:n], items[:n], ts[:n])
            directory = os.path.join(tmp, cell)
            cell_ref, _, _, _ = _sparse_run(
                dataclasses.replace(cfg, cell_dtype=cell), users[:n],
                items[:n], ts[:n])
            run_cfg = dataclasses.replace(
                cfg, cell_dtype=cell, pipeline_depth=2,
                checkpoint_dir=directory, checkpoint_every_windows=every)

            def check(job, what, want=cell_ref):
                rows, swapped = _sparse_equal(job, want, what,
                                              ties_may_swap=True)
                return (f"slab, counters and {rows} rows' scores exactly "
                        f"equal, ids equal but on {swapped} lanes of "
                        f"exactly tied scores")

            dropped, _, info = _resume(card, "sparse", run_cfg, csv, every,
                                       check)
            codecs = _codec_of(directory)
            if not codecs or not all(
                    c and c["arrays"].get("scorer_rows_key", [""])[0] == "sdv"
                    for _g, c in codecs):
                _fail(f"{cell}: a generation lacks the packed ckpt_codec: "
                      f"{codecs}")
            promoted = dropped.scorer.promoted_rows
            print(f"    {cell}: {promoted} rows promoted at the window-"
                  f"{every} checkpoint; generations {[g for g, _ in codecs]} "
                  f"carry ckpt_codec {sorted(codecs[0][1]['arrays'])}; "
                  f"packed save {info['save_bytes']} bytes in "
                  f"{info['save_s']:.4f} s, restore {info['restore_s']:.4f} "
                  f"s; raw (phase 10: the whole stream at window 25) "
                  f"{raw_ckpt['save_bytes']} bytes in "
                  f"{raw_ckpt['save_s']:.4f} s, restore "
                  f"{raw_ckpt['restore_s']:.4f} s", flush=True)
            if cell == "int8" and promoted <= 0:
                _fail("int8 resume: no row promoted before the checkpoint")
            del dropped, cell_ref


# -- phase 12: the sharded dense backend ---------------------------------


#: Shards of phase 12's explicit mesh (all on the one card).
SHARDS = 4


def _local_check(parity, name, C, rs, rows_np, lo, observed, k):
    """``score_topk_local`` over the row block ``C`` (global rows from
    ``lo``) against its plain version; ids exact on every finite lane."""
    import torch

    from tpu_cooccurrence_torch.ops.score_topk import score_topk_local

    rows = torch.from_numpy(np.asarray(rows_np, dtype=np.int32)).to(
        C.device)
    return parity.compare(
        name, score_topk_local(C, rs, rows, lo, observed, k),
        _reference_chunked(C, rs, rows, observed, k, row_lo=lo), exact=True)


def _local_kernel_cases(parity: Parity) -> None:
    """(a) Kernel vs plain: the first and the last of four blocks of phase
    2's edge cases (each case's rows lie all over the matrix, so most are
    outside the block and score as empty rows; all-zero rows, K = 1 and
    128, int16 wrapped); then each of four blocks of a [20000, 20000]
    int32 and a [61440, 61440] int16 C, with 2,048 rows of the block,
    its first and last row among them."""
    import torch

    rng = np.random.default_rng(20261019)
    cases = [
        ("I1007_K10_int32_zero_rows", 1007, 65, 10, np.int32,
         dict(zero_rows=3)),
        ("I2053_K128_int16_wrapped", 2053, 65, 128, np.int16,
         dict(wrap=True, zero_rows=2)),
        ("I3001_K1_int32", 3001, 65, 1, np.int32, {}),
    ]
    for name, n, s, k, dt, kw in cases:
        C, rs, rows, observed, _ = _edge_case(rng, n, s, k, dt, **kw)
        r = n // SHARDS
        for d in (0, SHARDS - 1):
            lo = d * r
            picked = np.r_[lo, lo + r - 1, rows.cpu().numpy()]
            kv, _ = _local_check(parity, f"local_{name}_block{d}",
                                 C[lo:lo + r], rs, picked, lo, observed, k)
            outside = (picked < lo) | (picked >= lo + r)
            if not np.isneginf(kv[outside]).all():
                _fail(f"local {name}: a row outside block {d} scored")
    for name, n, dt, seed in (("I20000_int32", 20_000, torch.int32, 5),
                              ("I61440_int16", 61_440, torch.int16, 6)):
        C, rs, _, observed = _full_width(n, 1, dt, seed)
        r = C.shape[0] // SHARDS
        for d in range(SHARDS):
            lo = d * r
            inner = rng.choice(np.arange(lo + 1, lo + r - 1), 2046,
                               replace=False)
            picked = np.r_[lo, inner, lo + r - 1]
            _local_check(parity, f"local_S2048_{name}_block{d}",
                         C[lo:lo + r], rs, picked, lo, observed, 10)
        rows = torch.from_numpy(picked.astype(np.int32)).to(C.device)
        _measure(f"local_S2048_{name}_block{SHARDS - 1}", C[lo:lo + r], rs,
                 rows, observed, 10, row_lo=lo)
        del C, rs
        torch.cuda.empty_cache()


def _sharded_job(cfg, mesh):
    """A job on a ``ShardedScorer`` over an explicit ``mesh`` (the CLI
    builds its mesh from the visible cards, one shard each)."""
    from tpu_cooccurrence_torch.job import CooccurrenceJob
    from tpu_cooccurrence_torch.parallel.sharded import ShardedScorer

    scorer = ShardedScorer(cfg.num_items, cfg.top_k, mesh=mesh,
                           count_dtype=cfg.count_dtype)
    job = CooccurrenceJob(cfg, scorer=scorer)
    scorer.counters = job.counters  # the job's, as _make_scorer does
    return job


def _sharded_cfg(count_dtype, num_items, num_shards, **extra):
    from tpu_cooccurrence_torch.config import Config

    return Config(window_size=100, seed=0xC0FFEE, item_cut=500,
                  user_cut=500, num_items=num_items, count_dtype=count_dtype,
                  device="cuda", backend="sharded", num_shards=num_shards,
                  **extra)


def _sharded_equal(job, ref, what):
    """Counters, observed, every block of ``C``, every row-sum replica and
    every row of a sharded job exactly equal to a dense job's, on the
    common capacity (zeros past it)."""
    import torch

    got = {k: v for k, v in job.counters.as_dict().items()
           if k != "SplitReaderNumSplits"}
    want = {k: v for k, v in ref.counters.as_dict().items()
            if k != "SplitReaderNumSplits"}
    if got != want:
        _fail(f"{what}: counters differ {got} vs {want}")
    a, b = job.scorer, ref.scorer
    m = min(a.num_items, b.num_items)
    if a.observed != b.observed or b.C[m:].any() or b.C[:, m:].any():
        _fail(f"{what}: observed differs, or the dense C is not zero past "
              f"{m}")
    for d, blk in enumerate(a.C_loc):
        lo = d * a.rows_per_shard
        h = max(min(m - lo, blk.shape[0]), 0)
        if (not torch.equal(blk[:h, :m], b.C[lo:lo + h, :m].to(blk.device))
                or blk[h:].any() or blk[:, m:].any()):
            _fail(f"{what}: block {d} of C differs")
    for dev, rs in a.row_sums.items():
        if (not torch.equal(rs[:m], b.row_sums[:m].to(dev)) or rs[m:].any()
                or b.row_sums[m:].any()):
            _fail(f"{what}: the row sums on {dev} differ")
    ia, va, da = _rows_table(job, 10)
    ib, vb, db = _rows_table(ref, 10)
    if ia != ib or not np.array_equal(va, vb) or not np.array_equal(da, db):
        _fail(f"{what}: rows differ (ids or float32 scores)")
    return len(ia)


def _sharded_path(card, what, cfg, mesh, ref, users, items, ts,
                  profile=False):
    """One counted run of ``cfg`` (``mesh`` None: the CLI's mesh), held
    exactly to the dense job ``ref``; with ``profile``, the device's busy
    share from a profiled second run. Returns the job and its launches."""
    import torch

    from tpu_cooccurrence_torch.job import CooccurrenceJob

    def run():
        job = (_sharded_job(cfg, mesh) if mesh is not None
               else CooccurrenceJob(cfg))
        start = time.monotonic()
        job.add_batch(users, items, ts)
        job.finish()
        torch.cuda.synchronize()
        return job, time.monotonic() - start

    (job, wall), counts = _counted("sharded", run)
    sc = job.scorer
    rows = _sharded_equal(job, ref, what)
    print(f"  {card}: {what}: {sc.n_shards} shards of {sc.rows_per_shard} "
          f"x {sc.num_items} {sc.count_dtype.name} on "
          f"{sorted({str(d) for d in sc.mesh})}; {_stage_line(job, wall)}; "
          f"launches {counts}; state, counters and {rows} rows exactly "
          f"equal to the dense run", flush=True)
    if profile:
        _device_profile(lambda: run()[1], wall)
    return job, counts["score_topk"]


def phase_sharded(card: str, parity: Parity, dense_job) -> dict:
    """Returns the D = 4 int32 run's launches, the kernel's times at the
    shape that run gave it, and shard 0's block (``block``: its ``C``
    rows, row sums, scored rows and observed)."""
    import tempfile

    import torch

    print("phase 12: the sharded dense backend (--backend sharded)",
          flush=True)
    _local_kernel_cases(parity)

    print("  (b) the bench workload on the sharded backend", flush=True)
    users, items, ts = _bench_stream()
    one = [dense_job.scorer.device]  # the card of phase 4's run
    job, _ = _sharded_path(card, "D=1 (the CLI's mesh), int32, 20000 items",
                           _sharded_cfg("int32", 20_000, 1), None,
                           dense_job, users, items, ts)
    del job
    job, launches = _sharded_path(
        card, f"D={SHARDS} on one card, int32, derive from data",
        _sharded_cfg("int32", 0, SHARDS), one * SHARDS, dense_job, users,
        items, ts, profile=True)
    sc = job.scorer
    row_sums = sc.row_sums[sc.mesh[0]]
    touched = torch.nonzero(row_sums[:sc.rows_per_shard]).flatten()
    rows = touched[:sc.max_score_rows].to(torch.int32).contiguous()
    observed = float(np.float32(sc.observed))
    _local_check(parity, "local_main_path_final_state_block0", sc.C_loc[0],
                 row_sums, rows.cpu().numpy(), 0, observed, sc.top_k)
    m = _measure(f"local_main_path_S{rows.shape[0]}_R{sc.rows_per_shard}_"
                 f"I{sc.num_items}_int32", sc.C_loc[0], row_sums, rows,
                 observed, sc.top_k, row_lo=0)
    # Shard 0's block, kept for phase 15(a)'s K = 1024 case.
    block = (sc.C_loc[0], row_sums, rows, observed)
    del job, sc, row_sums
    dense16, wall16 = _run_job("cuda", "int16", users, items, ts,
                               num_items=61_440)
    print(f"  {card}: dense int16, 61440 items (the reference): "
          f"{_stage_line(dense16, wall16)}", flush=True)
    job, _ = _sharded_path(
        card, f"D={SHARDS} on one card, --count-dtype int16 --num-items "
        f"61440", _sharded_cfg("int16", 61_440, SHARDS), one * SHARDS,
        dense16, users, items, ts)
    del job, dense16
    torch.cuda.empty_cache()

    print(f"  (c) resume: a D={SHARDS} run at depth 2 dropped after the "
          f"window-10 checkpoint, restored at D=1", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        csv = os.path.join(tmp, "bench.csv")
        _write_csv(csv, users, items, ts)
        cfg = _sharded_cfg("int32", 20_000, 1, pipeline_depth=2,
                           checkpoint_dir=os.path.join(tmp, "sharded"),
                           checkpoint_every_windows=10)
        dropped, _, _ = _resume(
            card, "sharded", cfg, csv, 10,
            lambda job, what: f"state, counters and "
            f"{_sharded_equal(job, dense_job, what)} rows exactly equal to "
            f"phase 4's dense run",
            make_first=lambda c: _sharded_job(c, one * SHARDS),
            resumed_cfg=dataclasses.replace(cfg,
                                            checkpoint_every_windows=0))
        del dropped
    return dict(launches=launches, block=block, **m)



# -- phase 13: incremental checkpoints, supervised restarts, the oracle --


#: Phase 13's checkpoint cadence (windows) and the generation after
#: whose commit the supervised run's first attempt is killed.
#: Phase 13 runs config 4's first PREFIX13 events (15 of its 50
#: windows; cut from the whole stream and a checkpoint every 10 windows
#: to make room for phases 19, 20 and 22), a checkpoint every EVERY
#: windows: five generations, as before the cuts.
PREFIX13 = 300_000
EVERY = 3
KILL_GEN = 3
#: Events of the config-4 prefix the oracle runs (host only, float64).
ORACLE_PREFIX = 50_000


def _ckpt_cfg(directory, incremental):
    """Config 4 at the JAX defaults (int16 cells, packed uplink), depth
    2, a checkpoint every EVERY windows (full or incremental)."""
    from tpu_cooccurrence_torch.config import Config

    return Config(**{**CONFIG4_JOB, "cell_dtype": "auto",
                     "wire_format": "auto"}, device="cuda",
                  pipeline_depth=2, checkpoint_dir=directory,
                  checkpoint_every_windows=EVERY, checkpoint_retain=50,
                  checkpoint_incremental=incremental)


def _cli_args(csv, directory, incremental):
    """The same run as :func:`_ckpt_cfg`, as a command line."""
    return ["-i", csv, "-ws", "100", "-s", "4", "-ic", "500", "-uc", "500",
            "-k", "10", "--backend", "sparse", "--pipeline-depth", "2",
            "--checkpoint-dir", directory, "--checkpoint-every-windows",
            str(EVERY), "--checkpoint-retain", "50",
            *(["--checkpoint-incremental"] if incremental else [])]


class _SaveClock:
    """Records every save's ``checkpoint.LAST_COMMIT`` and the slab
    re-layout after it (``SparseDeviceScorer.relayout``)."""

    def __init__(self):
        from tpu_cooccurrence_torch.state import checkpoint as ckpt
        from tpu_cooccurrence_torch.state import sparse_scorer as ss

        self.ckpt, self.ss = ckpt, ss
        self.commits = []
        self._save, self._relayout = ckpt.save, ss.SparseDeviceScorer.relayout

    def __enter__(self):
        import torch

        save, relayout, commits = self._save, self._relayout, self.commits

        def timed_save(*a, **kw):
            path = save(*a, **kw)
            commits.append(dict(self.ckpt.LAST_COMMIT))
            return path

        def timed_relayout(scorer):
            start = time.monotonic()
            relayout(scorer)
            torch.cuda.synchronize()
            commits[-1]["relayout_s"] = time.monotonic() - start

        self.ckpt.save = timed_save
        self.ss.SparseDeviceScorer.relayout = timed_relayout
        return self

    def __exit__(self, *exc):
        self.ckpt.save = self._save
        self.ss.SparseDeviceScorer.relayout = self._relayout


def _cli_job(cfg, csv, stop_after_gen=None):
    """The CLI's path in process: the file source and the batcher, the
    final rows rendered as the CLI prints them. With ``stop_after_gen``
    the run is dropped right after that generation commits (no
    finish()). Returns the job, its stdout text (None when dropped), the
    wall seconds and the save records."""
    import torch

    from tpu_cooccurrence_torch.cli import _render_row
    from tpu_cooccurrence_torch.io.parse import batched_lines
    from tpu_cooccurrence_torch.io.source import FileMonitorSource
    from tpu_cooccurrence_torch.job import CooccurrenceJob

    job = CooccurrenceJob(cfg)
    job.source = FileMonitorSource(csv, job.counters)
    if stop_after_gen is not None:
        save = job.checkpoint

        def checkpoint_then_drop(source=None):
            save(source=source)
            if len(clock.commits) >= stop_after_gen:
                raise _Abandon

        job.checkpoint = checkpoint_then_drop
    with _SaveClock() as clock:
        start = time.monotonic()
        try:
            job.run(batched_lines(job.source.lines(),
                                  origin=job.source.origin))
        except _Abandon:
            torch.cuda.synchronize()
            return job, None, time.monotonic() - start, clock.commits
        torch.cuda.synchronize()
        wall = time.monotonic() - start
    snap = job.latest.snapshot()
    text = "".join(_render_row(item, snap[item]) + "\n"
                   for item in sorted(snap))
    return job, text, wall, clock.commits


def _commit_table(card, what, wall, commits):
    print(f"  {card}: {what}: wall {wall:.4f} s, {len(commits)} "
          f"generations", flush=True)
    for c in commits:
        other = c["seconds"] - sum(c[k] for k in ("snapshot_s", "extract_s",
                                                  "encode_s", "write_s"))
        print(f"    generation {c['gen']}: {c['kind']}, {c['bytes']} bytes, "
              f"chain {c['chain_len']}, save {c['seconds']:.4f} s (snapshot "
              f"{c['snapshot_s']:.4f}, extract_delta {c['extract_s']:.4f}, "
              f"encode {c['encode_s']:.4f}, write+fsync "
              f"{c['write_s']:.4f}, the rest: host state and the top-K "
              f"table {other:.4f}), re-layout {c['relayout_s']:.4f} s",
              flush=True)


def _exactly_equal(job, ref, what):
    """Counters, the canonical slab and every row (ids included) of two
    sparse jobs exactly equal."""
    rows, _ = _sparse_equal(job, ref, what)
    return rows


def _dir_upto(src_dir, dst_dir, gen):
    """A copy of ``src_dir`` holding generation ``gen`` and older only."""
    import shutil

    from tpu_cooccurrence_torch.state import checkpoint as ckpt
    from tpu_cooccurrence_torch.state import delta as deltalog

    shutil.copytree(src_dir, dst_dir)
    for g, path in ckpt.generations(dst_dir):
        if g > gen:
            os.remove(path)
            dpath = deltalog.delta_path(dst_dir, "", g)
            if os.path.exists(dpath):
                os.remove(dpath)
    return dst_dir


def _restore_timed(cfg, source_csv=None):
    import torch

    from tpu_cooccurrence_torch.io.source import FileMonitorSource
    from tpu_cooccurrence_torch.job import CooccurrenceJob

    job = CooccurrenceJob(cfg)
    job.source = (FileMonitorSource(source_csv, job.counters)
                  if source_csv else None)
    start = time.monotonic()
    job.restore(source=job.source)
    torch.cuda.synchronize()
    return job, time.monotonic() - start


def _chain_restore(card, csv, tmp, ref_job):
    """(b) A run dropped right after a delta generation commits, restored
    from base + deltas in a fresh job that finishes from the source's
    restored position: counters, slab and rows exactly equal to the
    uninterrupted run. The same generation restored from the full
    cadence's directory, timed beside it."""
    import torch

    from tpu_cooccurrence_torch.io.parse import batched_lines
    from tpu_cooccurrence_torch.state import checkpoint as ckpt

    directory = os.path.join(tmp, "dropped")
    cfg = _ckpt_cfg(directory, True)
    # The newest delta generation that leaves windows to run after it.
    gens = [c["gen"] for c in ref_job["commits"] if c["kind"] == "delta"
            and c["gen"] < ref_job["commits"][-1]["gen"]]
    if not gens:
        _fail("the incremental run wrote no delta generation before its "
              "last")
    target = gens[-1]
    dropped, _, wall, commits = _cli_job(cfg, csv, stop_after_gen=target)
    base, chain = ckpt.chain_of(directory, target)
    print(f"  (b) dropped after generation {target} ({wall:.4f} s): base "
          f"{base} + deltas {chain}", flush=True)
    del dropped
    job, restore_s = _restore_timed(cfg, csv)
    full_job, full_restore_s = _restore_timed(_ckpt_cfg(_dir_upto(
        os.path.join(tmp, "full-1"), os.path.join(tmp, "full-upto"), target),
        False))
    if full_job.windows_fired != target * EVERY:
        _fail("the full cadence's generation restored at another window")
    del full_job
    if job.windows_fired != target * EVERY:
        _fail(f"chain restore landed on window {job.windows_fired}, not "
              f"{target * EVERY}")
    start = time.monotonic()
    job.run(batched_lines(job.source.lines(), origin=job.source.origin))
    torch.cuda.synchronize()
    rest = time.monotonic() - start
    rows = _exactly_equal(job, ref_job["job"], "chain-restored run")
    print(f"  {card}: chain restore (generation {target}: base {base} + "
          f"{len(chain)} deltas) {restore_s:.4f} s; the full cadence's "
          f"generation {target} restored in {full_restore_s:.4f} s; the "
          f"resumed run {rest:.4f} s: counters, "
          f"slab and {rows} rows (ids included) exactly equal to the "
          f"uninterrupted run", flush=True)
    return dict(restore_s=restore_s, full_restore_s=full_restore_s)


def _supervised(card, csv, tmp, want_stdout):
    """(c) The CLI's run under ``--restart-on-failure 2``, its first
    attempt SIGKILLed as soon as generation KILL_GEN commits: stdout
    byte-identical to the uninterrupted run's. The supervisor is the
    CLI's (its flags parsed as the CLI parses them, the child's argv
    stripped of them), with the crash worker in the child's place."""
    from tpu_cooccurrence_torch.config import Config
    from tpu_cooccurrence_torch.supervisor import child_argv, supervise

    here = os.path.dirname(os.path.abspath(__file__))
    worker = os.path.join(here, "tests", "torch_supervised_crash_worker.py")
    directory = os.path.join(tmp, "supervised")
    marker = os.path.join(tmp, "crashed-once")
    out_path = os.path.join(tmp, "supervised.out")
    argv = _cli_args(csv, directory, True) + [
        "--restart-on-failure", "2", "--restart-delay-ms", "0"]
    config = Config.from_args(argv)
    start = time.monotonic()
    with open(out_path, "w") as sink:
        rc = supervise([sys.executable, worker, directory, marker,
                        str(KILL_GEN), *child_argv(argv)],
                       config.restart_on_failure,
                       delay_s=config.restart_delay_ms / 1000.0,
                       crash_loop_threshold=config.crash_loop_threshold,
                       crash_loop_window_s=config.crash_loop_window_s,
                       checkpoint_dir=config.checkpoint_dir, stdout=sink)
    wall = time.monotonic() - start
    if rc != 0:
        _fail(f"supervised run exited {rc}")
    with open(marker) as f:
        killed = f.read().strip()
    if not killed or not os.path.exists(marker + ".resumed"):
        _fail("supervised run: the first attempt was never killed, or the "
              "second scored no window")
    with open(marker + ".resumed") as f:
        resumed = float(f.read())
    with open(out_path) as f:
        got = f.read()
    if got != want_stdout:
        _fail(f"supervised stdout ({len(got)} bytes) differs from the "
              f"uninterrupted run's ({len(want_stdout)} bytes)")
    print(f"  {card}: supervised run ({KILL_GEN}rd generation killed) "
          f"{wall:.4f} s; kill to the resumed child's first scored window "
          f"{resumed - float(killed):.4f} s; stdout {len(got)} bytes, "
          f"{got.count(chr(10))} rows, byte-identical to the uninterrupted "
          f"run's", flush=True)
    return resumed - float(killed)


def _corrupt_middle_delta(card, tmp, ref_dir):
    """(d) One byte flipped in the first delta of the longest chain: the
    restore quarantines it (a log line says so) and falls back to the
    chain's full base, equal to that generation's state restored from a
    directory holding nothing newer."""
    import logging
    import shutil

    from tpu_cooccurrence_torch.observability.registry import REGISTRY
    from tpu_cooccurrence_torch.state import checkpoint as ckpt
    from tpu_cooccurrence_torch.state import delta as deltalog

    directory = os.path.join(tmp, "corrupt")
    shutil.copytree(ref_dir, directory)
    chains = [ckpt.chain_of(directory, g)
              for g in deltalog.delta_generations(directory, "")]
    base, chain = max(chains, key=lambda bc: len(bc[1]))
    victim = deltalog.delta_path(directory, "", chain[0])
    with open(victim, "r+b") as f:
        f.seek(os.path.getsize(victim) // 2)
        byte = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([byte[0] ^ 0x01]))
    lines = []

    class _Lines(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    handler = _Lines(level=logging.ERROR)
    logging.getLogger("tpu_cooccurrence_torch").addHandler(handler)
    before = REGISTRY.gauge(ckpt.QUARANTINE_GAUGE).get()
    try:
        cfg = _ckpt_cfg(directory, True)
        # The newest generation chains through the victim only when it is
        # on the longest chain; step back until it is, as the breaker
        # would, so the walk meets the victim.
        while ckpt.generations(directory)[0][0] > chain[-1]:
            ckpt.step_back(directory)
        job, took = _restore_timed(cfg)
    finally:
        logging.getLogger("tpu_cooccurrence_torch").removeHandler(handler)
    said = [m for m in lines if "quarantined corrupt checkpoint delta" in m]
    if (not os.path.exists(victim + ".corrupt")
            or REGISTRY.gauge(ckpt.QUARANTINE_GAUGE).get() != before + 1
            or not said or job.windows_fired != base * EVERY):
        _fail(f"corrupt delta {chain[0]}: not quarantined, or the restore "
              f"did not fall back to the full base {base} "
              f"(windows_fired {job.windows_fired})")
    want, _ = _restore_timed(_ckpt_cfg(_dir_upto(
        ref_dir, os.path.join(tmp, "base-only"), base), True))
    rows = _exactly_equal(job, want, "fallback restore")
    print(f"  {card}: delta {chain[0]} of chain {base} + {chain} with one "
          f"byte flipped: quarantined (log: \"{said[0]}\"); the restore "
          f"fell back to full generation {base} (windows_fired "
          f"{job.windows_fired}) in {took:.4f} s; counters, slab and "
          f"{rows} rows exactly equal to generation {base} alone",
          flush=True)


def _latest_close(oracle, port, rtol=1e-4, atol=1e-3, gap=1e-2):
    """The oracle comparator of ``tests/test_torch_cli.py`` (float32 card
    rows against float64 host rows): the same items and row lengths,
    scores allclose, ids equal wherever every in-row gap exceeds
    ``gap``. Returns the rows compared and the rows whose ids it held."""
    if set(oracle) != set(port):
        _fail(f"oracle and card rows cover different items "
              f"({len(oracle)} vs {len(port)})")
    held = 0
    for item in oracle:
        o, p = oracle[item], port[item]
        if len(o) != len(p):
            _fail(f"row {item}: {o} vs {p}")
        o_scores = np.array([s for _, s in o])
        if not np.allclose([s for _, s in p], o_scores, rtol=rtol,
                           atol=atol):
            _fail(f"row {item}: scores {p} vs the oracle's {o}")
        if len(o_scores) > 1 and np.min(np.abs(np.diff(o_scores))) > gap:
            if [j for j, _ in o][:-1] != [j for j, _ in p][:-1]:
                _fail(f"row {item}: ids {p} vs the oracle's {o}")
            held += 1
    return len(oracle), held


def _oracle_gate(card, users, items, ts):
    """(e) ``--backend oracle`` (float64, on the host) on a prefix of
    config 4 against the card's sparse run on the same prefix."""
    import torch

    from tpu_cooccurrence_torch.config import Config
    from tpu_cooccurrence_torch.job import CooccurrenceJob

    n = ORACLE_PREFIX
    oracle = CooccurrenceJob(Config(**{**CONFIG4_JOB, "backend": "oracle",
                                       "cell_dtype": "auto",
                                       "wire_format": "auto"},
                                    device="cuda"))
    start = time.monotonic()
    oracle.add_batch(users[:n], items[:n], ts[:n])
    oracle.finish()
    oracle_wall = time.monotonic() - start

    def card_run():
        job = CooccurrenceJob(Config(**{**CONFIG4_JOB, "cell_dtype": "auto",
                                        "wire_format": "auto"},
                                     device="cuda"))
        begin = time.monotonic()
        job.add_batch(users[:n], items[:n], ts[:n])
        job.finish()
        torch.cuda.synchronize()
        return job, time.monotonic() - begin

    (port, port_wall), counts = _counted("sparse", card_run)
    if port.counters.as_dict() != oracle.counters.as_dict():
        _fail("oracle and card runs count differently")
    snap_o, snap_p = oracle.latest.snapshot(), port.latest.snapshot()
    rows, held = _latest_close({i: snap_o[i] for i in snap_o},
                               {i: snap_p[i] for i in snap_p})
    print(f"  {card}: the first {n} events of config 4: oracle (float64, "
          f"host) wall {oracle_wall:.4f} s; the card's sparse run "
          f"{port_wall:.4f} s, launches {counts}; counters equal, {rows} "
          f"rows within the oracle comparator (rtol 1e-4, atol 1e-3; ids "
          f"held on the {held} rows whose in-row gaps all exceed 1e-2)",
          flush=True)
    return oracle_wall


def phase_incremental_and_supervised(card: str) -> None:
    import tempfile

    print("phase 13: incremental checkpoints (--checkpoint-incremental), "
          "supervised restarts (--restart-on-failure) and --backend oracle "
          "on config 4 at the defaults, depth 2", flush=True)
    users, items, ts = _config4_stream()
    with tempfile.TemporaryDirectory() as tmp:
        csv = os.path.join(tmp, "config4.csv")
        _write_csv(csv, users[:PREFIX13], items[:PREFIX13], ts[:PREFIX13])
        print(f"  (a) config 4's first {PREFIX13} events, every {EVERY} "
              f"windows: incremental and full "
              f"generations, in turns", flush=True)
        runs = {}
        for turn, incremental in enumerate((True, False)):
            kind = "incremental" if incremental else "full"
            directory = os.path.join(tmp, f"{kind[:4]}-{turn}")
            (job, text, wall, commits), counts = _counted(
                "sparse", lambda: _cli_job(_ckpt_cfg(directory, incremental),
                                           csv))
            _commit_table(card, f"{kind} run (turn {turn + 1}), launches "
                          f"{counts}", wall, commits)
            runs[kind] = dict(job=job, text=text, commits=commits,
                              dir=directory)
            del job
        inc, full = runs["incremental"], runs["full"]
        if inc["text"] != full["text"]:
            _fail("the incremental run's stdout differs from the full "
                  "cadence's")
        _exactly_equal(inc["job"], full["job"], "incremental vs full run")
        delta_b = [c["bytes"] for c in inc["commits"] if c["kind"] == "delta"]
        full_b = {c["gen"]: c["bytes"] for c in full["commits"]}
        ratios = [c["bytes"] / full_b[c["gen"]] for c in inc["commits"]
                  if c["kind"] == "delta"]
        print(f"  incremental and full runs: stdout identical "
              f"({len(inc['text'])} bytes), slab and counters equal; "
              f"{len(delta_b)} delta generations, their bytes "
              f"{min(ratios):.4f}-{max(ratios):.4f} of the full generation "
              f"at the same window", flush=True)
        del full["job"]
        _chain_restore(card, csv, tmp, inc)
        recovery = _supervised(card, csv, tmp, inc["text"])
        _corrupt_middle_delta(card, tmp, inc["dir"])
        del inc["job"]
    oracle_wall = _oracle_gate(card, users, items, ts)
    print(f"  phase 13 done: recovery {recovery:.4f} s, oracle wall "
          f"{oracle_wall:.4f} s", flush=True)


# -- phase 14: native host helpers and sliding windows (config 3) -------


#: The JAX package's config 3 (``tpu_cooccurrence/bench/configs.py:143-154``,
#: ``config3_ml25m_sliding``): the calibrated MovieLens-25M stand-in
#: (``ml25m_calibrated``, 59,047 items, 162,541 users) at its default
#: 500,000 events, 4,000 ms windows sliding by 1,000 ms, cuts 500/500,
#: seed 3, the dense backend at int16 counts over the whole vocabulary.
CONFIG3_EVENTS = 500_000
CONFIG3_JOB = dict(window_size=4000, window_slide=1000, seed=3,
                   item_cut=500, user_cut=500, top_k=10,
                   count_dtype="int16", num_items=59_047)
CONFIG3_WINDOWS = 13
#: Prefixes of (c): the sparse defaults and the oracle on the first
#: 50,000 events; the dense int16 cuda-vs-cpu check on the first 30,000
#: (the CPU's plain score of 100,000 events takes 105 s on 8 cores).
CONFIG3_PREFIX = 50_000
CONFIG3_DENSE_PREFIX = 30_000
#: (e): a checkpoint every 6 windows; the run is dropped after the first.
CONFIG3_EVERY = 6


def _config3_stream():
    from tpu_cooccurrence_torch.io.synthetic import ml25m_calibrated

    return ml25m_calibrated(CONFIG3_EVENTS)


def _config3_cfg(device="cuda", **extra):
    from tpu_cooccurrence_torch.config import Config

    return Config(**{**CONFIG3_JOB, **extra}, device=device)


def _config3_job(device="cuda", **extra):
    from tpu_cooccurrence_torch.job import CooccurrenceJob

    return CooccurrenceJob(_config3_cfg(device, **extra))


def _timed_run(job, users, items, ts):
    """Feed, finish and synchronize; returns the job and its wall."""
    import torch

    start = time.monotonic()
    job.add_batch(users, items, ts)
    job.finish()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return job, time.monotonic() - start


def _row_chunks(n, step=4096):
    return [(lo, min(lo + step, n)) for lo in range(0, n, step)]


def _config3_checks(job, pair_delta_sum):
    """(a)'s invariants: 13 windows; the counters agree with each other
    and with the pair deltas the sampler handed over; the row sums are
    ``C``'s row sums; every emitted row holds ``min(K, nonzero cells)``
    partners, finite and descending."""
    import torch

    from tpu_cooccurrence_torch.metrics import (FEEDBACK_QUEUES,
                                                OBSERVED_COOCCURRENCES,
                                                RESCORED_ITEMS,
                                                ROW_SUM_PROCESS_WINDOW)

    sc = job.scorer
    c = job.counters
    if job.windows_fired != CONFIG3_WINDOWS:
        _fail(f"config 3 fired {job.windows_fired} windows, not "
              f"{CONFIG3_WINDOWS}")
    if not (c.get(OBSERVED_COOCCURRENCES) == c.get(ROW_SUM_PROCESS_WINDOW)
            == sc.observed == pair_delta_sum > 0):
        _fail(f"config 3: observed {sc.observed}, counters {c}, pair "
              f"deltas {pair_delta_sum}")
    if c.get(FEEDBACK_QUEUES) or c.get(RESCORED_ITEMS) <= 0:
        _fail(f"config 3: counters {c} (a sliding run has no feedback edge)")
    nnz = torch.empty(sc.num_items, dtype=torch.int64, device=sc.C.device)
    for lo, hi in _row_chunks(sc.num_items):
        blk = sc.C[lo:hi]
        if not torch.equal(blk.sum(1, dtype=torch.int64),
                           sc.row_sums[lo:hi].to(torch.int64)):
            _fail(f"config 3: row sums differ from C's in rows {lo}-{hi}")
        nnz[lo:hi] = (blk != 0).sum(1)
    nnz = nnz.cpu().numpy()
    snap = job.latest.snapshot()
    to_dense = job.item_vocab.to_dense
    for item, top in snap.items():
        scores = [s for _, s in top]
        if (len(top) != min(sc.top_k, int(nnz[to_dense(item)]))
                or not np.all(np.isfinite(scores))
                or scores != sorted(scores, reverse=True)):
            _fail(f"config 3 row {item} malformed: {top}")
    return len(snap)


def _config3_main(card, parity: Parity, users, items, ts):
    """(a) Config 3 at full size on cuda, depth 0, the score kernel's
    count reset just before and read just after."""
    import torch

    from tpu_cooccurrence_torch.ops import device_scorer as ds
    from tpu_cooccurrence_torch.ops import score_topk as st

    job = _config3_job()
    deltas = []
    process = job.scorer.process_window

    def counting(ts_, pairs):
        deltas.append(int(pairs.delta.sum()))
        return process(ts_, pairs)

    job.scorer.process_window = counting
    largest = {"s": 0}
    launch = ds.score_topk

    def recording(C, rs, rows, observed, k):
        largest["s"] = max(largest["s"], rows.shape[0])
        return launch(C, rs, rows, observed, k)

    ds.score_topk = recording
    try:
        st.LAUNCHES = 0
        job, wall = _timed_run(job, users, items, ts)
        launches = st.LAUNCHES
    finally:
        ds.score_topk = launch
    if launches <= 0:
        _fail("config 3 launched the score_topk kernel no time")
    sc = job.scorer
    rows_out = _config3_checks(job, sum(deltas))
    c_bytes = sc.C.numel() * sc.C.element_size()
    print(f"  {card}: (a) config 3, {CONFIG3_EVENTS} events, "
          f"{len(job.item_vocab)} items seen, {job.windows_fired} windows, "
          f"C {tuple(sc.C.shape)} {str(sc.C.dtype).split('.')[-1]} = "
          f"{c_bytes} bytes: {_stage_line(job, wall)}; {launches} kernel "
          f"launches, the largest {largest['s']} rows; invariants hold, "
          f"{rows_out} rows of min(K, nonzero cells) partners", flush=True)
    _device_profile(lambda: _timed_run(_config3_job(), users, items, ts)[1],
                    wall)
    torch.cuda.empty_cache()
    touched = torch.nonzero(sc.row_sums).flatten().to(torch.int32)
    rows = touched[:largest["s"]].contiguous()
    observed = float(np.float32(sc.observed))
    parity.check("config3_final_state", sc.C, sc.row_sums, rows, observed,
                 sc.top_k, exact=True)
    m = _measure(f"config3_largest_launch_S{rows.shape[0]}_I{sc.num_items}"
                 f"_int16", sc.C, sc.row_sums, rows, observed, sc.top_k)
    return job, dict(launches=launches, wall=wall, **m)


def _config3_depth2(card, ref, users, items, ts):
    """(b) The same at ``--pipeline-depth 2``: state, counters and rows
    exactly equal to (a)."""
    (job, wall), counts = _counted("chained", lambda: _timed_run(
        _config3_job(pipeline_depth=2), users, items, ts))
    rows = _dense_equal(job, ref, "config 3 depth 2")
    print(f"  {card}: (b) config 3 depth 2: {_stage_line(job, wall)}; "
          f"launches {counts}; C, row sums, counters and {rows} rows "
          f"exactly equal to depth 0", flush=True)


def _config3_prefix_parity(card, users, items, ts):
    """(c) cuda against cpu on prefixes, then the float64 sliding oracle
    against the card's dense run."""
    import torch

    from tpu_cooccurrence_torch.metrics import (OBSERVED_COOCCURRENCES,
                                                RESCORED_ITEMS,
                                                ROW_SUM_PROCESS_WINDOW)
    from tpu_cooccurrence_torch.ops.score_topk import topk_parity
    from tpu_cooccurrence_torch.oracle.sliding import SlidingOracleJob

    for what, n, extra in (
            ("dense int16", CONFIG3_DENSE_PREFIX, dict(num_items=0)),
            ("sparse defaults", CONFIG3_PREFIX,
             dict(backend="sparse", count_dtype="int32", num_items=0))):
        path = "sparse" if "sparse" in what else "chained"
        (gpu, t_gpu), counts = _counted(path, lambda: _timed_run(
            _config3_job("cuda", **extra), users[:n], items[:n], ts[:n]))
        cpu, t_cpu = _timed_run(_config3_job("cpu", **extra), users[:n],
                                items[:n], ts[:n])
        if gpu.counters.as_dict() != cpu.counters.as_dict():
            _fail(f"config 3 {what}: counters differ")
        a, b = gpu.scorer.checkpoint_state(), cpu.scorer.checkpoint_state()
        for key in a:
            if not np.array_equal(a[key], b[key]):
                _fail(f"config 3 {what}: {key} differs between cuda and "
                      f"cpu")
        ia, va, da = _rows_table(gpu, 10)
        ib, vb, db = _rows_table(cpu, 10)
        ok, mism = topk_parity(va, da, vb, db, rtol=RTOL, atol=ATOL)
        if ia != ib or not ok or mism:
            _fail(f"config 3 {what}: rows differ (items {ia == ib}, "
                  f"scores_ok {ok}, untied ids {mism})")
        fin = np.isfinite(va)
        err = float(np.abs(va[fin] - vb[fin]).max()) if fin.any() else 0.0
        print(f"  {card}: (c) config 3's first {n} events, {what}: "
              f"{gpu.windows_fired} windows, counters and "
              f"{'slab' if path == 'sparse' else 'C'} exactly equal, "
              f"{len(ia)} rows in parity (max abs err {err:.3g}, ids "
              f"equal on {int(((da == db) & fin).sum())} of {int(fin.sum())}"
              f" finite lanes); launches {counts}; cuda {t_gpu:.3f} s, cpu "
              f"{t_cpu:.3f} s", flush=True)
        del gpu, cpu
    torch.cuda.empty_cache()

    n = CONFIG3_PREFIX
    oracle = SlidingOracleJob(_config3_cfg("cpu", backend="oracle"))
    start = time.monotonic()
    for u, i, t in zip(users[:n].tolist(), items[:n].tolist(),
                       ts[:n].tolist()):
        oracle.process(u, i, t)
    oracle.finish()
    oracle_wall = time.monotonic() - start
    (port, port_wall), counts = _counted("chained", lambda: _timed_run(
        _config3_job(), users[:n], items[:n], ts[:n]))
    for name in (OBSERVED_COOCCURRENCES, ROW_SUM_PROCESS_WINDOW,
                 RESCORED_ITEMS):
        if oracle.counters.get(name) != port.counters.get(name):
            _fail(f"config 3 oracle: {name} {oracle.counters.get(name)} vs "
                  f"the card's {port.counters.get(name)}")
    snap = port.latest.snapshot()
    rows, held = _latest_close(oracle.latest, {i: snap[i] for i in snap})
    print(f"  {card}: (c) SlidingOracleJob (float64, host) on the first {n} "
          f"events: wall {oracle_wall:.4f} s; the card's dense int16 run "
          f"{port_wall:.4f} s, launches {counts}; counters equal, {rows} "
          f"rows within the oracle comparator (ids held on {held})",
          flush=True)
    return oracle_wall


class _StepClock:
    """Host seconds of the steps (d) compares, summed over a run: the
    cell index's ``apply`` (either layout) and the window fold (the dense
    and sparse scorers' ``aggregate_window_coo``)."""

    def __init__(self):
        from tpu_cooccurrence_torch.ops import device_scorer as ds
        from tpu_cooccurrence_torch.state import sparse_scorer as ss

        self.targets = [(ss.SlabIndex, "apply", "apply"),
                        (ss.HashSlabIndex, "apply", "apply"),
                        (ds, "aggregate_window_coo", "fold"),
                        (ss, "aggregate_window_coo", "fold")]
        self.seconds = {"apply": 0.0, "fold": 0.0}

    def __enter__(self):
        self.saved = [getattr(o, a) for o, a, _ in self.targets]
        for (obj, attr, step), fn in zip(self.targets, self.saved):
            def timed(*args, _fn=fn, _step=step, **kw):
                start = time.monotonic()
                try:
                    return _fn(*args, **kw)
                finally:
                    self.seconds[_step] += time.monotonic() - start
            setattr(obj, attr, timed)
        return self

    def __exit__(self, *exc):
        for (obj, attr, _), fn in zip(self.targets, self.saved):
            setattr(obj, attr, fn)


class _PlainHost:
    """Every native host helper swapped for its numpy plain version: the
    reservoir's expansions, the grouped rank, the fold and the sorted
    cell index (the sliding sampler's plain version is called directly)."""

    def __enter__(self):
        from tpu_cooccurrence_torch import native
        from tpu_cooccurrence_torch.ops import aggregate
        from tpu_cooccurrence_torch.sampling import item_cut, reservoir
        from tpu_cooccurrence_torch.state import sparse_scorer as ss

        self.saved = [(native, "expand_appends"),
                      (native, "expand_replacements"),
                      (native, "grouped_rank_dense"),
                      (aggregate, "NATIVE_FOLD_MIN"),
                      (ss, "make_slab_index")]
        self.values = [getattr(o, a) for o, a in self.saved]
        native.expand_appends = reservoir.expand_appends_numpy
        native.expand_replacements = reservoir.expand_replacements_numpy
        native.grouped_rank_dense = (
            lambda keys, _max: item_cut.grouped_rank_numpy(keys))
        aggregate.NATIVE_FOLD_MIN = 1 << 62
        ss.make_slab_index = (
            lambda cap=1 << 10: ss.SlabIndex(rows_capacity=cap))
        return self

    def __exit__(self, *exc):
        for (obj, attr), value in zip(self.saved, self.values):
            setattr(obj, attr, value)


def _ab_turns(card, what, run, check):
    """``run()`` natively and on the plain versions in turns (native,
    numpy), each held to ``check(job, what)``; prints each
    turn's wall, sampling, index ``apply``, fold and scorer seconds.
    Returns the median wall of each side."""
    import contextlib

    walls = {"native": [], "numpy": []}
    for side in ("native", "numpy"):
        host = _PlainHost() if side == "numpy" else contextlib.nullcontext()
        with host, _StepClock() as steps:
            job, wall = run()
        result = check(job, f"{what} ({side})")
        t = job.step_timer
        walls[side].append(wall)
        print(f"  {card}: (d) {what}, {side}: wall {wall:.4f} s, sampling "
              f"{t.total_sample_seconds:.4f} s, index apply "
              f"{steps.seconds['apply']:.4f} s, fold "
              f"{steps.seconds['fold']:.4f} s, scorer "
              f"{t.total_score_seconds:.4f} s; {result}", flush=True)
        del job
    return {k: float(np.median(v)) for k, v in walls.items()}


def _config3_windows(users, items, ts):
    """Config 3's windows as the job fires them: dense ids, arrival
    order."""
    from tpu_cooccurrence_torch.state.vocab import IdMap
    from tpu_cooccurrence_torch.windowing.engine import WindowEngine

    engine = WindowEngine(CONFIG3_JOB["window_size"],
                          CONFIG3_JOB["window_slide"])
    engine.add_batch(IdMap().map_batch(users), IdMap().map_batch(items), ts)
    return [(u, i) for _, u, i in engine.fire_ready(final=True)]


#: Config 4's first events that (d) runs natively and on numpy.
NATIVE_EVENTS14 = 500_000


def _native_vs_numpy(card, users, items, ts, dense_job):
    """(d) Each native host step against its plain version in alternating
    turns, in this process: config 3's sliding sampling and its largest
    fold, the bench workload's chained run and a sparse run of config
    4's first NATIVE_EVENTS14 events."""
    import torch

    from tpu_cooccurrence_torch import native
    from tpu_cooccurrence_torch.ops import aggregate
    from tpu_cooccurrence_torch.sampling.sliding import SlidingBasketSampler

    windows = _config3_windows(users, items, ts)
    cut = CONFIG3_JOB["item_cut"], CONFIG3_JOB["user_cut"]
    ref = None
    secs = {"native": [], "numpy": []}
    for side in ("native", "numpy"):
        sampler = SlidingBasketSampler(*cut, skip_cuts=False)
        fire = sampler.fire if side == "native" else sampler._fire_numpy
        start = time.monotonic()
        out = [fire(u, i) for u, i in windows]
        secs[side].append(time.monotonic() - start)
        if ref is None:
            ref = out
        elif not all(np.array_equal(getattr(a, f), getattr(b, f))
                     for a, b in zip(out, ref)
                     for f in ("src", "dst", "delta")):
            _fail(f"config 3 sampling ({side}) differs from native")
    n_pairs = sum(len(p) for p in ref)
    print(f"  {card}: (d) config 3 sampling, {len(windows)} windows, "
          f"{n_pairs} pairs, byte-equal: native "
          f"{', '.join(f'{x:.4f}' for x in secs['native'])} s, numpy "
          f"{', '.join(f'{x:.4f}' for x in secs['numpy'])} s", flush=True)

    big = max(ref, key=len)
    key = (big.src << 32) | big.dst
    fold_s = {"native": [], "numpy": []}
    want = None
    for side in ("native", "numpy"):
        start = time.monotonic()
        got = (native.coo_aggregate(key, big.delta) if side == "native"
               else aggregate.fold_numpy(key, big.delta))
        fold_s[side].append(time.monotonic() - start)
        want = got if want is None else want
        if not all(np.array_equal(x, y) for x, y in zip(got, want)):
            _fail("config 3's largest fold differs native vs numpy")
    print(f"  {card}: (d) config 3's largest window fold, {len(key)} pair "
          f"deltas into {len(want[0])} cells, equal: native "
          f"{', '.join(f'{x:.4f}' for x in fold_s['native'])} s, numpy "
          f"{', '.join(f'{x:.4f}' for x in fold_s['numpy'])} s (the window "
          f"path folds natively from {aggregate.NATIVE_FOLD_MIN} deltas)",
          flush=True)
    del ref, windows

    bench = _bench_stream()
    bench_walls = _ab_turns(
        card, "bench workload, chained",
        lambda: _run_job("cuda", "int32", *bench, num_items=20_000),
        lambda job, what: f"C, counters and "
        f"{_dense_equal(job, dense_job, what)} rows exactly equal to phase 4")
    c4 = tuple(a[:NATIVE_EVENTS14] for a in _config4_stream())
    native: dict = {}

    def c4_check(job, what):
        if "job" not in native:
            native["job"] = job
            return "the numpy turn's reference"
        return (f"slab, counters and "
                f"{_sparse_equal(job, native['job'], what)[0]} rows (ids "
                f"included) exactly equal to the native turn")

    c4_walls = _ab_turns(
        card, f"config 4's first {NATIVE_EVENTS14} events, sparse int32 "
        f"raw", lambda: _run_sparse_job("cuda", *c4), c4_check)
    native.clear()
    torch.cuda.empty_cache()
    return dict(sampling=secs, fold=fold_s, bench=bench_walls,
                config4=c4_walls)


def _config3_resume(card, ref, users, items, ts):
    """(e) Config 3 from a CSV at depth 2, a checkpoint every 6 windows,
    dropped right after the first commits while four windows are in
    flight; a fresh job restores and finishes: exactly equal to (a)."""
    import tempfile

    from tpu_cooccurrence_torch.config import Config
    from tpu_cooccurrence_torch.state import checkpoint as ckpt

    with tempfile.TemporaryDirectory() as tmp:
        csv = os.path.join(tmp, "config3.csv")
        _write_csv(csv, users, items, ts)
        cfg = Config(**CONFIG3_JOB, device="cuda", pipeline_depth=2,
                     checkpoint_dir=os.path.join(tmp, "ck"),
                     checkpoint_every_windows=CONFIG3_EVERY)
        # The resumed run saves no further generation: one 7 GB save
        # measures the dense checkpoint.
        dropped, _, times = _resume(
            card, "chained", cfg, csv, CONFIG3_EVERY,
            lambda job, what: f"C, counters and "
            f"{_dense_equal(job, ref, what)} rows exactly equal to (a)",
            resumed_cfg=dataclasses.replace(cfg,
                                            checkpoint_every_windows=0))
        split = ckpt.LAST_COMMIT
        in_flight = len(dropped.engine._buffers)
        if in_flight < 2:
            _fail(f"config 3 was dropped with {in_flight} windows in "
                  f"flight; the resume must cross overlapping windows")
        print(f"  {card}: (e) config 3 dropped after window "
              f"{CONFIG3_EVERY} with {in_flight} overlapping windows in "
              f"flight: save {times['save_bytes']} bytes in "
              f"{times['save_s']:.4f} s (snapshot {split['snapshot_s']:.4f} "
              f"s, encode {split['encode_s']:.4f} s, write+fsync "
              f"{split['write_s']:.4f} s), restore {times['restore_s']:.4f} "
              f"s", flush=True)
        del dropped
    return times


def phase_native_and_sliding(card: str, parity: Parity,
                             dense_job) -> dict:
    """Returns config 3's score-kernel entry (launches, times, bound)."""
    import torch

    print("phase 14: native host helpers and sliding windows (config 3, "
          "ML-25M sliding, 59,047 items, int16 dense)", flush=True)
    t0 = time.monotonic()
    users, items, ts = _config3_stream()
    job, run = _config3_main(card, parity, users, items, ts)
    _config3_depth2(card, job, users, items, ts)
    torch.cuda.empty_cache()
    _config3_resume(card, job, users, items, ts)
    del job
    torch.cuda.empty_cache()
    _config3_prefix_parity(card, users, items, ts)
    _native_vs_numpy(card, users, items, ts, dense_job)
    print(f"  phase 14 done in {time.monotonic() - t0:.1f} s", flush=True)
    return run


# -- phase 15: K past 128, config 4's defaults, the tiered store --------

#: The K values phase 15(a) holds the kernels to: past the warp lists'
#: 128, and across the select path's buffer of 4,096 live cells.
LARGE_K = (129, 256, 1024, 1025, 4096)
#: The K values timed against K = 10 and run end to end in (d).
TIMED_K = (1024, 4096)
#: Events of config 4's prefix run on both devices and by the CLI.
PREFIX15 = 50_000
#: The tiered store's flags of phase 15(c).
SPILL = dict(spill_threshold_windows=5, spill_target_hbm_frac=0.0)
#: Config 4's first events, and the generation cadence (windows), of
#: (c)'s incremental run under spill.
SPILL_EVENTS15 = 600_000
SPILL_EVERY15 = 10
#: Config 3's vocabulary: the width of (a)'s fully dense rows.
WIDE_I = 59_047


def _large_k_dense(parity: Parity, rng, k: int) -> None:
    """(a) ``score_topk`` at ``k`` on the card: phase 2's edge cases
    (int32 and wrapped int16, K above a row's nonzero cells and above I,
    all-zero rows, the 3e10 regime), a row whose columns all tie (its top
    K are the lowest columns), and a local row block."""
    import torch

    from tpu_cooccurrence_torch.ops.score_topk import (
        score_topk_local, score_topk_local_reference)

    for name, n, s, dt, kw in (
            ("int32_zero_rows", 1500, 9, np.int32, dict(zero_rows=2)),
            ("int16_wrapped", 2053, 9, np.int16, dict(wrap=True)),
            ("int32_N3e10", 1200, 5, np.int32, dict(big=True)),
            ("int32_KgtI", 300, 3, np.int32, {})):
        parity.check(f"K{k}_S{s}_I{n}_{name}",
                     *_edge_case(rng, n, s, k, dt, **kw), exact=True)
    n = 4099
    C = rng.integers(1, 3, size=(n, n)).astype(np.int16)
    C[rng.random((n, n)) < 0.5] = 0
    C[1] = 1                         # every column ties
    C[2] = 0
    C[3] = 0
    C[3, [n - 1, n - 2, 7]] = 2      # fewer nonzero cells than K
    rows = np.r_[np.arange(8), rng.choice(np.arange(8, n), 9, replace=False)]
    rs = np.full(n, 5 * n, dtype=np.int32)
    t = [torch.from_numpy(a).to("cuda") for a in
         (C, rs, rows.astype(np.int32))]
    kv, ki = parity.check(f"K{k}_ties_S17_I{n}_int16", *t, float(50 * n * n),
                          k, exact=True)
    if ki[1][:min(k, n)].tolist() != list(range(min(k, n))):
        _fail(f"K={k}: the all-tie row's ids are not the lowest columns")
    if int(np.isfinite(kv[3]).sum()) != 3:
        _fail(f"K={k}: a row of 3 nonzero cells has "
              f"{int(np.isfinite(kv[3]).sum())} finite lanes")
    lo = 1024
    block = t[0][lo:lo + 2048].contiguous()
    parity.compare(f"K{k}_local_block_rows_{lo}_{lo + 2048}",
                   score_topk_local(block, t[1], t[2], lo,
                                    float(50 * n * n), k),
                   score_topk_local_reference(block, t[1], t[2], lo,
                                              float(50 * n * n), k),
                   exact=True)


def _wide_rows(parity: Parity, rng) -> None:
    """(a) Fully dense rows at config 3's width, a whole int16 ``C`` of
    59,047 columns (6.97 GB) and a local block of it: row 0 every cell
    live with distinct-looking counts, row 1 every cell 1 (two partner
    sums, so two scores and ~29,500 cells tied at each), row 2 700 cells
    at 3 above a tie of every other cell, row 3 empty, then sparse rows.
    At K = 1024 and 4096 (more live cells than the buffer: re-walked),
    5,000 (winners sorted in the output slice) and 59,057 (K > I)."""
    import torch

    from tpu_cooccurrence_torch.ops.score_topk import (
        score_topk_local, score_topk_local_reference)

    n = WIDE_I
    C = torch.zeros((n, n), dtype=torch.int16, device="cuda")
    dense = rng.integers(1, 30_000, n)
    C[0] = torch.from_numpy(dense.astype(np.int16)).cuda()
    C[1] = 1
    C[2] = 1
    C[2, torch.from_numpy(rng.choice(n, 700, replace=False)).cuda()] = 3
    for r in range(4, 64):
        cols = rng.choice(n, int(rng.integers(1, 6000)), replace=False)
        C[r, torch.from_numpy(cols).cuda()] = torch.from_numpy(
            rng.integers(1, 50, len(cols)).astype(np.int16)).cuda()
    rs = np.where(rng.random(n) < 0.5, 2_000_000, 3_000_000)
    rs[:64] = C[:64].sum(1, dtype=torch.int64).cpu().numpy()
    rs_t = torch.from_numpy(rs.astype(np.int32)).cuda()
    rows = torch.arange(64, dtype=torch.int32, device="cuda")
    observed = float(4e12)
    for k in (1024, 4096, 5000, n + 10):
        kv, ki = parity.check(f"wide_I{n}_int16_K{k}", C, rs_t, rows,
                              observed, k, exact=True)
        fin = np.isfinite(kv).sum(1)
        if fin[0] != min(k, n) or fin[1] != min(k, n) or fin[3] != 0:
            _fail(f"wide rows at K={k}: {fin[:4].tolist()} finite lanes")
    block = C[:64].contiguous()
    parity.compare(f"wide_local_block_I{n}_K4096",
                   score_topk_local(block, rs_t, rows, 0, observed, 4096),
                   score_topk_local_reference(block, rs_t, rows, 0,
                                              observed, 4096), exact=True)
    del C, block
    torch.cuda.empty_cache()


def _rect_exact(parity, name, t, observed, k, lens):
    """``rect_topk`` (with the scorer's launch plan) against the plain
    version, exactly. Returns the kernel's ids."""
    from tpu_cooccurrence_torch.ops.rect_topk import (rect_topk,
                                                      rect_topk_reference,
                                                      short_rows)

    n_short = short_rows(np.asarray(lens))
    return parity.compare(f"{name} ({n_short} short rows)",
                          rect_topk(*t, observed, k, n_short),
                          rect_topk_reference(*t, observed, k),
                          exact=True)[1]


def _large_k_rect(parity: Parity, rng, k: int) -> None:
    """(a) ``rect_topk`` at ``k`` on the card, int32, int16 and int8
    cells: the tie, short-row and cancelled-cell cases of phase 5 with a
    row of 100,000 cells, then the size-class edges of
    :func:`_rect_class_cases`."""
    from tpu_cooccurrence_torch.ops.rect_topk import short_rows

    cases = [
        (f"K{k}_tie_earliest_slot", _tie_case()),
        (f"K{k}_S300_short_rows", _rect_case(rng, 300, 4096, 12,
                                             short_rows=100)),
        (f"K{k}_S33_hot_row_100k_cells_cancelled", _rect_case(
            rng, 33, 200_000, 3000, zero_frac=0.5, hot_len=100_000)),
    ]
    for name, (arrays, observed) in cases:
        t = _cuda_int32(arrays)
        ki = _rect_exact(parity, name, t, observed, k, arrays[5])
        n_short = short_rows(np.asarray(arrays[5]))
        for cell, top in NARROW:
            keep = (np.ones(len(arrays[0]), dtype=bool) if "tie" in name
                    else None)
            _narrow_case(parity, name, t, observed, k, n_short, cell, top,
                         rng, keep=keep)
        if "tie" in name and ki[0][:6].tolist() != [40, 30, 20, 10, 50, 60]:
            _fail(f"{name}: ids {ki[0][:6].tolist()} are not the slots' "
                  f"partners in slot order")
    _rect_class_cases(parity, rng, ks=(k,))


def _rect_beyond_buffer(parity: Parity, rng) -> None:
    """(a) The 100,000-cell slab row at K past the block's buffer: the
    winners sort in the row's output slice (K = 5,000), and K above every
    length (120,000)."""
    for k in (5000, 120_000):
        arrays, observed = _rect_case(rng, 5, 200_000, 3000, zero_frac=0.2,
                                      hot_len=100_000)
        _rect_exact(parity, f"K{k}_hot_row_100k_cells", _cuda_int32(arrays),
                    observed, k, arrays[5])


def _time_pair(name, measure, k_small=10, ks=TIMED_K):
    """``measure(k)`` at K = ``k_small`` and at each of ``ks``; prints each
    against K = ``k_small``. Returns {k: measure(k)}."""
    small = measure(k_small)
    out = {}
    for k in ks:
        large = out[k] = measure(k)
        print(f"  time {name}: K={k} {large['ms']:.4f} ms against "
              f"K={k_small} {small['ms']:.4f} ms "
              f"({large['ms'] / small['ms']:.2f}x); bound "
              f"{large['bound_ms']:.4f} ms ({large['bound_by']}, "
              f"{100 * large['bound_ms'] / large['ms']:.1f}% of it "
              f"reached); torch.topk yardstick {large['topk_ms']:.4f} ms "
              f"against {small['topk_ms']:.4f} ms", flush=True)
    return out


def _phase15_kernels(card, score_parity, rect_parity, local_parity,
                     main_run, sparse_run, shard_block) -> dict:
    """(a) Both top-K kernels at K in LARGE_K against their plain
    versions, config 3's width and phase 12's shard block; their K = 1024
    and 4096 times at the main path's shapes beside K = 10; each path's
    dynamic shared memory and blocks an SM."""
    import torch

    from tpu_cooccurrence_torch.ops import score_topk as st

    rng = np.random.default_rng(20261019)
    for k in LARGE_K:
        _large_k_dense(score_parity, rng, k)
        _large_k_rect(rect_parity, rng, k)
        torch.cuda.empty_cache()
    _wide_rows(score_parity, rng)
    _rect_beyond_buffer(rect_parity, rng)
    C_loc, rs, rows, observed = shard_block
    _local_check(local_parity, f"local_shard_block_S{rows.shape[0]}_K1024",
                 C_loc, rs, rows.cpu().numpy(), 0, observed, 1024)
    for k in (128, 129):
        smem, blocks = st.class_info(k)
        per_cell = [st.class_info(k, c) for c in (4, 2, 1)]
        print(f"  K={k} ({st.kernel_path(k)}): {smem} bytes of dynamic "
              f"shared memory a block; blocks an SM: score_topk {blocks}, "
              f"rect_topk int32/int16/int8 "
              f"{'/'.join(str(b) for _, b in per_cell)}", flush=True)
    sc = main_run["job"].scorer
    touched = torch.nonzero(sc.row_sums).flatten().to(torch.int32)
    rows = touched[:sc.max_score_rows].contiguous()
    obs = float(np.float32(sc.observed))
    nnz = (sc.C[rows.long()] != 0).sum(1).cpu().numpy()
    print(f"  bench C rows: {int((nnz > st.SELECT_BUFFER).sum())} of "
          f"{len(nnz)} hold more nonzero cells than the select buffer's "
          f"{st.SELECT_BUFFER} (cut as they are walked, or re-walked at "
          f"K = 4096), {int((nnz > 1024).sum())} more than 1024; longest "
          f"{int(nnz.max())}", flush=True)
    score = _time_pair(
        f"score_topk, bench C {rows.shape[0]} x {sc.num_items} int32",
        lambda k: _measure(f"bench_C_K{k}", sc.C, sc.row_sums, rows, obs,
                           k))
    _time_pair(f"score_topk_local, phase 12's shard block "
               f"{shard_block[2].shape[0]} x {C_loc.shape[1]}",
               lambda k: _measure(f"shard_block_K{k}", C_loc, rs,
                                  shard_block[2], observed, k, row_lo=0),
               ks=(1024,))
    args = sparse_run["args"]
    rect = _time_pair(
        f"rect_topk, config 4's largest launch ({args[3].shape[0]} rows)",
        lambda k: _measure_rect(f"config4_largest_launch_K{k}",
                                args[:7] + (k, args[8])))
    return dict(score=score, rect=rect)


def _config4_cfg(device="cuda", **extra):
    """Config 4 at the JAX package's accelerator defaults: int16 cells,
    the packed uplink and ``--fused-window auto`` (which the port's sparse
    backend accepts and scores chained)."""
    from tpu_cooccurrence_torch.config import Config

    job = {**CONFIG4_JOB, "cell_dtype": "int16", "wire_format": "packed",
           "fused_window": "auto"}
    return Config(**{**job, **extra, "device": device})


def _all_chained(job, what) -> str:
    """The dispatch gauges of a sparse run since the last reset: every
    window that carried pairs counted chained, none fused."""
    windows = sum(1 for w in job.step_timer.windows if w.pairs)
    fused, chained = _dispatches()
    if fused or not 0 < chained <= windows:
        _fail(f"{what}: {fused} windows counted fused, {chained} chained, "
              f"of {windows} windows with pairs")
    return f"{chained} windows chained, 0 fused ({windows} carried pairs)"


def _phase15_defaults(card) -> dict:
    """(b) Config 4 at the JAX package's accelerator defaults
    (``--fused-window auto``) at depths 0 and 2: every window chained,
    depth 2 exactly equal to depth 0; then cuda against cpu on a
    prefix."""
    from tpu_cooccurrence_torch.job import CooccurrenceJob
    from tpu_cooccurrence_torch.ops.score_topk import topk_parity

    users, items, ts = _config4_stream()
    runs = {}
    for depth in (0, 2):
        _reset_dispatch_gauges()
        job, wall, counts, ledger = _sparse_run(
            _config4_cfg(pipeline_depth=depth), users, items, ts)
        runs[depth] = (job, wall)
        print(f"  {card}: config 4 defaults, depth {depth}: "
              f"{_all_chained(job, f'config 4 depth {depth}')}; "
              f"{_slab_line(job, wall, counts, ledger)}", flush=True)
    rows = _sparse_equal(runs[2][0], runs[0][0], "config 4 depth 2")[0]
    print(f"    depth 2: slab, counters and {rows} rows (ids included) "
          f"exactly equal to depth 0", flush=True)
    _device_profile(lambda: _sparse_run(_config4_cfg(), users, items,
                                        ts)[1], runs[0][1])
    outs = {}
    for device in ("cuda", "cpu"):
        sink: list = []
        pj = CooccurrenceJob(_config4_cfg(device, fused_window="on"))
        pj.on_update = sink.append
        start = time.monotonic()
        pj.add_batch(users[:PREFIX15], items[:PREFIX15], ts[:PREFIX15])
        pj.finish()
        outs[device] = (pj, sink, time.monotonic() - start)
    (a, sa, ta), (b, sb, tb) = outs["cuda"], outs["cpu"]
    if a.counters.as_dict() != b.counters.as_dict():
        _fail("defaults prefix: counters differ between cuda and cpu")
    ca, cb = a.scorer.checkpoint_state(), b.scorer.checkpoint_state()
    if not all(np.array_equal(ca[k], cb[k]) for k in ca):
        _fail("defaults prefix: the slab differs between cuda and cpu")
    ra, va, ia = _topk_batches(sa)
    rb, vb, ib = _topk_batches(sb)
    ok, mism = topk_parity(va, ia, vb, ib, rtol=RTOL, atol=ATOL)
    if not np.array_equal(ra, rb) or not ok or mism:
        _fail(f"defaults prefix: rows differ cuda vs cpu (scores_ok {ok}, "
              f"untied id mismatches {mism})")
    print(f"  --fused-window on prefix of {PREFIX15} events: cuda "
          f"{ta:.2f} s, cpu {tb:.2f} s; counters and slab equal, "
          f"{len(ra)} rows in parity", flush=True)
    del outs, a, b
    return runs


def _phase15_spill(card, runs) -> None:
    """(c) Config 4 at the defaults with the tiered store: rows, counters
    and the canonical checkpoint's cell arrays byte for byte those of the
    spill-off run; then an incremental run under spill, whose saves keep
    the spilled rows on the host, dropped after a delta generation,
    restored and finished, equal to the uninterrupted run."""
    import tempfile

    import torch

    from tpu_cooccurrence_torch.job import CooccurrenceJob
    from tpu_cooccurrence_torch.state import delta as deltalog

    users, items, ts = _config4_stream()
    off_job, off_wall = runs[0]
    off_blob = off_job.scorer.checkpoint_state()
    off_bytes = off_job.scorer.slab_device_bytes
    off_heap = off_job.scorer.heap_end
    torch.cuda.reset_peak_memory_stats()
    job, wall, counts, _ledger = _sparse_run(_config4_cfg(**SPILL), users,
                                             items, ts)
    peak = torch.cuda.max_memory_allocated()
    store = job.scorer.store
    if store.evictions <= 0 or store.promotions <= 0:
        _fail(f"spill: {store.evictions} rows spilled, {store.promotions} "
              f"re-promoted: the check is void")
    rows = _sparse_equal(job, off_job, "spill")[0]
    blob = job.scorer.checkpoint_state()
    for key in off_blob:
        if (blob[key].dtype != off_blob[key].dtype
                or blob[key].tobytes() != off_blob[key].tobytes()):
            _fail(f"spill: checkpoint {key} differs from the spill-off "
                  f"run's")
    print(f"  {card}: spill ({SPILL}): {store.evictions} rows spilled, "
          f"{store.promotions} re-promoted, {len(store.arena)} in the arena "
          f"at the end ({store.arena.nbytes} host bytes); slab "
          f"{job.scorer.slab_device_bytes} device bytes, heap "
          f"{job.scorer.heap_end} cells, against spill-off {off_bytes} "
          f"bytes, {off_heap} cells; peak allocated {peak} bytes; wall "
          f"{wall:.4f} s against spill-off {off_wall:.4f} s; launches "
          f"{counts}; counters, {rows} rows and the checkpoint's cell "
          f"arrays byte-identical to spill-off", flush=True)
    del job
    users, items, ts = (a[:SPILL_EVENTS15] for a in (users, items, ts))
    with tempfile.TemporaryDirectory() as tmp:
        every = SPILL_EVERY15
        kw = dict(checkpoint_every_windows=every,
                  checkpoint_incremental=True, checkpoint_retain=50, **SPILL)
        ref, ref_wall, _c, _l = _sparse_run(
            _config4_cfg(checkpoint_dir=os.path.join(tmp, "ref"), **kw),
            users, items, ts)
        d = os.path.join(tmp, "ck")
        cfg = _config4_cfg(checkpoint_dir=d, **kw)
        a = CooccurrenceJob(cfg)
        save = a.checkpoint
        saves = []

        def save_then_drop(source=None):
            held = sorted(a.scorer.store.arena.dir)
            save(source=source)
            if sorted(a.scorer.store.arena.dir) != held:
                _fail("spill incremental: a save moved spilled rows back "
                      "to the card")
            saves.append((a.windows_fired, len(held), a.scorer.heap_end,
                          a.scorer.slab_device_bytes))
            if deltalog.delta_generations(d, ""):
                raise _Abandon

        a.checkpoint = save_then_drop
        step = len(users) // 20
        for cut in range(step, len(users) + step, step):
            try:
                a.add_batch(users[cut - step:cut], items[cut - step:cut],
                            ts[cut - step:cut])
            except _Abandon:
                break
        else:
            _fail("spill incremental: no delta generation was written")
        _commit_line(f"delta generation at window {a.windows_fired}, "
                     f"{len(a.scorer.store.arena)} rows in the arena")
        print(f"    after each save (spill-off run at its end: heap "
              f"{off_heap} cells, slab {off_bytes} bytes): " + "; ".join(
                  f"window {w}: {n} rows held in the arena, heap {h} "
                  f"cells, slab {nb} bytes" for w, n, h, nb in saves),
              flush=True)
        if not any(n for _w, n, _h, _nb in saves):
            _fail("spill incremental: no save held spilled rows: the "
                  "check is void")
        b = CooccurrenceJob(cfg)
        start = time.monotonic()
        b.restore()
        restore_s = time.monotonic() - start
        # The checkpoint holds the events fed so far that no window fired
        # yet, so the rest of the stream continues the dropped run.
        b.add_batch(users[cut:], items[cut:], ts[cut:])
        b.finish()
        torch.cuda.synchronize()
        rows = _sparse_equal(b, ref, "spill incremental resumed")[0]
        print(f"  spill + --checkpoint-incremental every {every} windows: "
              f"dropped after its first delta generation, restored in "
              f"{restore_s:.4f} s, finished: slab, counters and {rows} rows "
              f"(ids included) exactly equal to the uninterrupted run "
              f"({ref_wall:.4f} s, {ref.scorer.store.evictions} rows "
              f"spilled)", flush=True)


def _partners_ok(vals, nnz, k) -> int:
    """Every row of a results table has min(K, nonzero cells) finite
    lanes; returns the rows holding K or more nonzero cells."""
    import torch

    got = torch.isfinite(vals).sum(1).cpu().numpy()
    want = np.minimum(nnz[:len(got)], k)
    if len(nnz) > len(got) and nnz[len(got):].any():
        return -1
    return int((nnz >= k).sum()) if np.array_equal(got, want) else -1


def _dense_large_k(card, k, users, items, ts) -> int:
    """(d) The bench workload at ``k``, dense chained and fused, counts
    reset just before each run and read just after: every row with
    min(K, nonzero cells) partners, fused equal to chained. Returns the
    chained run's launches."""
    import torch

    dense = {}
    for path, extra in (("chained", {}), ("fused",
                                          dict(fused_window="on"))):
        (job, wall), counts = _counted(path, lambda: _run_job(
            "cuda", "int32", users, items, ts, num_items=20_000, top_k=k,
            **extra))
        sc = job.scorer
        nnz = (sc.C != 0).sum(1).cpu().numpy()
        full = _partners_ok(sc._results.vals, nnz, k)
        if full < 0:
            _fail(f"K={k} dense {path}: a row's partners are not "
                  f"min(K, nonzero cells)")
        tbl = sc._results.vals.nbytes + sc._results.idx.nbytes
        print(f"  {card}: bench K={k} {path}: wall {wall:.4f} s, launches "
              f"{counts}, {int((nnz > 0).sum())} rows ({full} with K "
              f"partners), results table {tbl} bytes", flush=True)
        dense[path] = (job, counts)
    a, b = dense["chained"][0].scorer, dense["fused"][0].scorer
    if not (torch.equal(a.C, b.C) and torch.equal(a._results.vals,
                                                  b._results.vals)
            and torch.equal(a._results.idx, b._results.idx)):
        _fail(f"K={k} dense: fused differs from chained")
    print(f"    fused equals chained: C and the K={k} results table, "
          f"exactly", flush=True)
    launches = dense["chained"][1]["score_topk"]
    del dense, a, b
    torch.cuda.empty_cache()
    return launches


def _sparse_partners(job, k, what) -> tuple:
    """Every row of a sparse run's results table has min(K, live cells)
    partners; returns the rows with K."""
    sc = job.scorer
    row_of = (sc.checkpoint_state()["rows_key"] >> 32).astype(np.int64)
    nnz = np.bincount(row_of, minlength=sc.items_cap)
    full = _partners_ok(sc._results.vals, nnz, k)
    if full < 0:
        _fail(f"{what}: a row's partners are not min(K, nonzero cells)")
    return int((nnz > 0).sum()), full


def _phase15_large_k(card) -> dict:
    """(d) The bench workload at K = 1024 and 4096, dense chained and
    fused; the bench stream on the sparse backend at K = 4096; config 4
    at K = 1024 on the defaults (at 4096 its 1M-item results table would
    take 32 GB). Kernel counts reset just before each run and read just
    after; every row has min(K, nonzero cells) partners; fused equals
    chained. Returns the launch counts by kernel and K."""
    import torch

    from tpu_cooccurrence_torch.config import Config
    from tpu_cooccurrence_torch.state import sparse_scorer as ss

    users, items, ts = _bench_stream()
    score = {k: _dense_large_k(card, k, users, items, ts) for k in TIMED_K}
    job, wall, counts, ledger = _sparse_run(
        Config(window_size=100, seed=0xC0FFEE, item_cut=500, user_cut=500,
               backend="sparse", device="cuda", top_k=4096), users, items,
        ts)
    rows, full = _sparse_partners(job, 4096, "K=4096 bench sparse")
    print(f"  {card}: bench stream sparse K=4096 (the defaults): "
          f"{_slab_line(job, wall, counts, ledger)}; {rows} rows ({full} "
          f"with K partners)", flush=True)
    rect = {4096: counts["rect_topk"]}
    del job
    torch.cuda.empty_cache()

    k = 1024
    largest = {"s": -1}
    launch = ss.rect_topk

    def recording(*args):
        if args[3].shape[0] > largest["s"]:
            largest.update(s=args[3].shape[0], args=tuple(
                x.clone() if torch.is_tensor(x) else x for x in args))
        return launch(*args)

    ss.rect_topk = recording
    try:
        job, wall, counts, ledger = _sparse_run(_config4_cfg(top_k=k),
                                                *_config4_stream())
    finally:
        ss.rect_topk = launch
    sc = job.scorer
    rows, full = _sparse_partners(job, k, "K=1024 config 4")
    tbl = sc._results.vals.nbytes + sc._results.idx.nbytes
    print(f"  {card}: config 4 defaults K=1024: "
          f"{_slab_line(job, wall, counts, ledger)}; "
          f"results table {tbl} bytes beside the slab's "
          f"{sc.slab_device_bytes}; {rows} rows ({full} with K partners)",
          flush=True)
    _measure_rect(f"config4_int16_K1024_largest_launch_S{largest['s']}",
                  largest["args"])
    rect[k] = counts["rect_topk"]
    del job
    torch.cuda.empty_cache()
    return dict(score=score, rect=rect)


def _phase15_fixed_score(card) -> None:
    """(e) ``--fixed-score on`` through the CLI on config 4's prefix at
    the defaults: stdout byte-identical to ``auto``'s."""
    import contextlib
    import io
    import tempfile

    from tpu_cooccurrence_torch import cli

    users, items, ts = (a[:PREFIX15] for a in _config4_stream())
    with tempfile.TemporaryDirectory() as tmp:
        csv = os.path.join(tmp, "config4_prefix.csv")
        _write_csv(csv, users, items, ts)
        outs = {}
        for mode in ("auto", "on"):
            buf = io.StringIO()
            start = time.monotonic()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(["-i", csv, "-ws", "100", "-s", "4", "-ic",
                               "500", "-uc", "500", "--backend", "sparse",
                               "--fixed-score", mode])
            if rc != 0:
                _fail(f"--fixed-score {mode}: exit {rc}")
            outs[mode] = (buf.getvalue(), time.monotonic() - start)
    if outs["on"][0] != outs["auto"][0] or not outs["on"][0]:
        _fail("--fixed-score on printed other than auto")
    print(f"  {card}: (e) --fixed-score on, config 4 prefix of {PREFIX15} "
          f"events through the CLI: {len(outs['on'][0].splitlines())} lines "
          f"byte-identical to auto ({outs['on'][1]:.2f} s, "
          f"{outs['auto'][1]:.2f} s)", flush=True)


def phase_large_k_fused_spill(card: str, parity: Parity, rect_parity: Parity,
                              local_parity: Parity, main_run, sparse_run,
                              shard_block) -> dict:
    """Phase 15. Returns the K = 1024 and 4096 entries of both top-K
    kernels, by kernel and K."""
    import torch

    print("phase 15: K past 128 (select-and-sort), config 4 at the JAX "
          "package's accelerator defaults, the tiered spill store, "
          "--fixed-score on", flush=True)
    t0 = time.monotonic()
    timed = _phase15_kernels(card, parity, rect_parity, local_parity,
                             main_run, sparse_run, shard_block)
    print(f"  (a) done in {time.monotonic() - t0:.1f} s", flush=True)
    runs = _phase15_defaults(card)
    _phase15_spill(card, runs)
    del runs
    torch.cuda.empty_cache()
    launches = _phase15_large_k(card)
    _phase15_fixed_score(card)
    print(f"  phase 15 done in {time.monotonic() - t0:.1f} s", flush=True)
    return {name: {k: dict(launches=launches[name][k],
                           share=timed[name][k]["bound_ms"]
                           / timed[name][k]["ms"],
                           **{f: timed[name][k][f] for f in
                              ("ms", "plain_ms", "bound_ms", "bound_by")},
                           library_ms=None,
                           topk_yardstick_ms=timed[name][k]["topk_ms"])
                   for k in TIMED_K}
            for name in ("score", "rect")}

# -- phase 16: the host planes ------------------------------------------


#: (c)-(e)'s small stream: 20,000 events over 2,000 items and 1,000
#: users, 20 events a ms, so 100 ms windows give 10 windows (the breaker's
#: host fallback scores a window in a fraction of a second).
SMALL16 = dict(n_events=20_000, n_items=2_000, n_users=1_000, alpha=1.1,
               seed=16, events_per_ms=20)
#: (c)'s fault plan: the primary's 3rd and 5th dispatches raise. With
#: threshold 1 and a 2-window probe the breaker opens at window 3 (3 and
#: 4 on the host), the probe at 5 closes it, the primary's 5th dispatch
#: is window 6 (6 and 7 on the host) and the probe at 8 closes it.
BREAKER16 = ["--scorer-breaker-threshold", "1",
             "--scorer-breaker-probe-windows", "2",
             "--inject-fault", "scorer_breaker:3:exception",
             "--inject-fault", "scorer_breaker:5:exception"]
BREAKER16_HOST_WINDOWS = [3, 4, 6, 7]
#: Config 4's first events that (b) runs with the breaker armed and off.
BREAKER_EVENTS16 = 500_000


def _small16_csv(tmp):
    from tpu_cooccurrence_torch.io.synthetic import zipfian_interactions

    users, items, ts = zipfian_interactions(**SMALL16)
    csv = os.path.join(tmp, "small16.csv")
    _write_csv(csv, users, items, ts)
    return csv


class _PortLog:
    """Captures the ports the CLI's servers log at start-up."""

    def __init__(self):
        import logging
        import re

        self.ports = []
        pattern = re.compile(r"on http://127\.0\.0\.1:(\d+)")
        outer = self

        class _Handler(logging.Handler):
            def emit(self, record):
                m = pattern.search(record.getMessage())
                if m:
                    outer.ports.append(int(m.group(1)))

        self.handler = _Handler()
        self.logger = logging.getLogger(
            "tpu_cooccurrence_torch.metrics_http")

    def __enter__(self):
        self.logger.addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)


def _cli_run(argv, watch=None):
    """``cli.main(argv)`` in this process with stdout captured; with
    ``watch(ports, alive)``, a second thread queries the servers while
    the run is alive. Returns (rc, stdout, wall, watch's result)."""
    import contextlib
    import io
    import threading

    from tpu_cooccurrence_torch import cli

    buf = io.StringIO()
    box = {}

    def run():
        with contextlib.redirect_stdout(buf):
            box["rc"] = cli.main(argv)

    with _PortLog() as log:
        start = time.monotonic()
        t = threading.Thread(target=run)
        t.start()
        try:
            seen = watch(log.ports, t.is_alive) if watch else None
        finally:
            t.join()  # the run restores sys.stdout as it ends
        wall = time.monotonic() - start
    return box.get("rc"), buf.getvalue(), wall, seen


class _Gone(Exception):
    """The server closed: the run ended between two queries."""


def _get(port, path, alive):
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read().decode()
    except OSError as exc:
        # The CLI stops its servers just before it returns: a refused
        # query is the end of the run unless the run goes on.
        deadline = time.monotonic() + 10
        while alive() and time.monotonic() < deadline:
            time.sleep(0.01)
        if alive():
            _fail(f"GET {path} failed while the run lived: {exc}")
        raise _Gone() from exc


def _query_routes(ports, alive):
    """Every route of both servers, over and over while the run lives;
    each answer checked as the CPU tests check it."""
    from tpu_cooccurrence_torch.observability.registry import (
        CANONICAL_METRICS)

    seen = dict(metrics=0, healthz=0, recommend=0, items=0, gens=[])
    while alive() and len(ports) < 2:
        time.sleep(0.005)
    try:
        _query_loop(ports, alive, seen, CANONICAL_METRICS)
    except _Gone:
        pass
    if seen["gens"] != sorted(seen["gens"]):
        _fail("/recommend generations went backwards")
    if not (seen["metrics"] and seen["recommend"]):
        _fail(f"the servers answered no query while the run lived: {seen}")
    return seen


def _metric_family(name: str) -> str:
    """An exposed series name without its histogram suffix."""
    for suffix in ("_bucket", "_sum", "_count", "_p50", "_p95", "_p99"):
        if name.endswith(suffix):
            return name[:-len(suffix)]
    return name


def _query_loop(ports, alive, seen, canonical) -> None:
    while alive():
        for port in list(ports):
            code, body = _get(port, "/metrics", alive)
            names = {line.split()[0].split("{")[0]
                     for line in body.splitlines()
                     if line.startswith("cooc_")}
            bad = {n for n in names if _metric_family(n) not in canonical}
            if code != 200 or bad:
                _fail(f"/metrics: {code}, names outside "
                      f"CANONICAL_METRICS: {sorted(bad)}")
            seen["metrics"] += 1
            code, body = _get(port, "/healthz", alive)
            health = json.loads(body)
            if code != 200 or health["status"] not in ("ok", "starting"):
                _fail(f"/healthz: {code} {health}")
            seen["healthz"] += 1
        port = ports[-1]  # the --serve-port server
        for user in (0, 1, 2, 3, 4):
            code, body = _get(port, f"/recommend?user={user}&n=10", alive)
            rec = json.loads(body)
            scores = [x["score"] for x in rec["items"]]
            if (code != 200 or len(scores) > 10
                    or scores != sorted(scores, reverse=True)
                    or not all(np.isfinite(scores))):
                _fail(f"/recommend: {code} {rec}")
            seen["recommend"] += 1
            seen["items"] += len(scores)
            seen["gens"].append(rec["generation"])
        if _get(port, "/recommend?n=0", alive)[0] != 400:
            _fail("/recommend?n=0 did not answer 400")


def _trace_kernels(path):
    """Kernel events of a Chrome trace: name -> (count, device ms)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = {}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        for name in ("score_topk_kernel", "expand_scatter_kernel",
                     "rect_topk_kernel"):
            if name in e.get("name", ""):
                n, ms = out.get(name, (0, 0.0))
                out[name] = (n + 1, ms + float(e.get("dur", 0)) / 1e3)
    return out


def _timed_journal_appends():
    """Wraps ``RunJournal.record`` to time each append (host clock);
    returns the list the times land in and the undo."""
    from tpu_cooccurrence_torch.observability import journal

    times = []
    record = journal.RunJournal.record

    def timed(self, rec):
        t0 = time.perf_counter()
        record(self, rec)
        times.append(time.perf_counter() - t0)

    journal.RunJournal.record = timed
    return times, lambda: setattr(journal.RunJournal, "record", record)


def _phase16_bench(card, tmp):
    """(a) The bench stream through the CLI, dense fused at K = 10 with
    ``--emit-updates``, with every plane on (journal, both servers, the
    profiler) and its routes queried while it runs; then planes off, each
    plane alone and all of them, one round."""
    from tpu_cooccurrence_torch.observability import trace
    from tpu_cooccurrence_torch.observability.registry import REGISTRY

    csv = os.path.join(tmp, "bench.csv")
    _write_csv(csv, *_bench_stream())
    # --emit-updates: each window's rows reach the host and the serving
    # snapshot as it is scored (deferred, the snapshot fills at the end).
    base = ["-i", csv, "-ws", "100", "-s", "0xC0FFEE", "--num-items",
            "20000", "--fused-window", "on", "--emit-updates"]
    journal = os.path.join(tmp, "bench.jsonl")
    prof = os.path.join(tmp, "prof")
    # --serve-port 0 takes an ephemeral port; --metrics-port may not
    # name the same one (0 included, as in the reference package), so it
    # takes a port that was free a moment ago.
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        metrics_port = sock.getsockname()[1]
    planes = ["--journal", journal, "--metrics-port", str(metrics_port),
              "--serve-port", "0"]
    rc, plain, wall_off, _ = _cli_run(base)
    if rc != 0 or not plain:
        _fail(f"bench, planes off: exit {rc}")
    REGISTRY.reset()
    times, undo = _timed_journal_appends()
    try:
        (out, counts) = _counted("fused", lambda: _cli_run(
            base + planes + ["--profile-dir", prof], _query_routes))
    finally:
        undo()
    rc, stdout, wall_prof, seen = out
    if rc != 0 or stdout != plain:
        _fail(f"bench, planes on: exit {rc}, stdout "
              f"{'equal' if stdout == plain else 'differs'}")
    q = REGISTRY.histogram("cooc_query_seconds").summary()
    windows = [r for r in (json.loads(l) for l in open(journal))
               if "seq" in r]
    publish = [s[2] for r in windows for s in r["spans"]
               if s[0] == "snapshot-publish"]
    rep = trace.analyze([journal])["reconcile"]
    if not rep["ok"] or rep["windows_checked"] == 0:
        _fail(f"the analyzer does not reconcile the journal: {rep}")
    kernels = _trace_kernels(os.path.join(prof, "torch_trace.json"))
    for name, mod in (("score_topk_kernel", "score_topk"),
                      ("expand_scatter_kernel", "expand")):
        n, ms = kernels.get(name, (0, 0.0))
        if n != counts[mod] or ms <= 0:
            _fail(f"profile trace: {n} {name} launches ({ms} ms) against "
                  f"{counts[mod]} counted")
    print(f"  {card}: (a) bench, dense fused K=10 through the CLI with "
          f"--journal, --metrics-port {metrics_port}, --serve-port 0, "
          f"--profile-dir: "
          f"stdout ({plain.count(chr(10))} rows) byte-identical to planes "
          f"off; {len(windows)} window records, spans reconcile "
          f"({rep['windows_checked']} checked, max rel err "
          f"{rep['max_rel_err']}); served while running: "
          f"{seen['metrics']} /metrics, {seen['healthz']} /healthz, "
          f"{seen['recommend']} /recommend ({seen['items']} items, "
          f"generations {seen['gens'][0] if seen['gens'] else '-'}.."
          f"{seen['gens'][-1] if seen['gens'] else '-'}); profile trace: "
          + ", ".join(f"{k} {n} launches {ms:.3f} ms"
                      for k, (n, ms) in sorted(kernels.items()))
          + f" (launch counts {counts})", flush=True)
    print(f"    {card}: cooc_query_seconds p50 {q.get('p50')} s p99 "
          f"{q.get('p99')} "
          f"s over {q.get('count', 0)} queries (bucket upper bounds); "
          f"snapshot publish {np.mean(publish) if publish else 0:.6f} s a "
          f"window ({len(publish)} windows); journal append "
          f"{np.mean(times) if times else 0:.6f} s a record "
          f"({len(times)} records, host clock)", flush=True)
    # Planes off and all of them, one round (a second, reversed round
    # was cut to make room for phase 17, each plane alone for phase 19).
    arms = {"off": [], "all": planes}
    walls = {name: [] for name in arms}
    for name in arms:
        if os.path.exists(journal):
            os.remove(journal)
        rc, stdout, wall, _ = _cli_run(base + arms[name])
        if rc != 0 or stdout != plain:
            _fail(f"bench, planes {name}: exit {rc}")
        walls[name].append(wall)
    print(f"    {card}: wall by arm, one round (no queries): "
          + "; ".join(f"{name} {walls[name]} s" for name in arms)
          + f"; the first (cold) off run {wall_off:.4f} s, the profiled "
          f"run {wall_prof:.4f} s", flush=True)


def _phase16_config4_breaker(card):
    """(b) Config 4's first BREAKER_EVENTS16 events at the defaults with
    --journal and the breaker armed (threshold 3), no fault: no trip,
    every scored window launched on the card, rows equal to the
    breaker-off run."""
    import tempfile

    from tpu_cooccurrence_torch.state import sparse_scorer as ss

    stream = tuple(a[:BREAKER_EVENTS16] for a in _config4_stream())
    with tempfile.TemporaryDirectory() as tmp:
        journal = os.path.join(tmp, "c4.jsonl")
        launched = set()
        launch = ss.rect_topk
        box = {}

        def recording(*args):
            launched.add(box["job"].scorer.primary._breaker_seq)
            return launch(*args)

        from tpu_cooccurrence_torch.job import CooccurrenceJob

        make = CooccurrenceJob.__init__

        def grab(self, *a, **kw):
            make(self, *a, **kw)
            box["job"] = self

        CooccurrenceJob.__init__ = grab
        ss.rect_topk = recording
        try:
            job, wall, counts, _ = _sparse_run(_config4_cfg(
                journal=journal, scorer_breaker_threshold=3), *stream)
        finally:
            ss.rect_topk = launch
            CooccurrenceJob.__init__ = make
        recs = [json.loads(l) for l in open(journal)]
    scored = {r["seq"] for r in recs if "seq" in r and r["rows_scored"]}
    states = {r.get("breaker_state") for r in recs if "seq" in r}
    if job.scorer.trips or states != {"closed"}:
        _fail(f"config 4, breaker armed and no fault: {job.scorer.trips} "
              f"trips, states {states}")
    if launched != scored:
        _fail(f"config 4: rect_topk launched in windows {len(launched)}, "
              f"scored {len(scored)} (not the same windows)")
    ref, wall_off, counts_off, _ = _sparse_run(_config4_cfg(), *stream)
    _sparse_equal(job, ref, "config 4, breaker armed vs off")
    print(f"  {card}: (b) config 4's first {BREAKER_EVENTS16} events at "
          f"the defaults, --journal and "
          f"--scorer-breaker-threshold 3, no fault: 0 trips, every record "
          f"closed; rect_topk launched in each of the {len(scored)} "
          f"scored windows ({counts['rect_topk']} launches, "
          f"{counts_off['rect_topk']} breaker off); rows, counters and "
          f"slab equal to the breaker-off run; wall {wall:.4f} s "
          f"(breaker off {wall_off:.4f} s)", flush=True)


def _phase16_faulted(card, tmp, csv):
    """(c) The breaker under an injected fault and (d) a forced
    degradation ladder, through the CLI on the card and on the CPU."""
    from tpu_cooccurrence_torch.robustness import degrade

    base = ["-i", csv, "-ws", "100", "-s", "0xC0FFEE", "--emit-updates"]
    for what, flags in (
            ("(c) breaker, scorer_breaker faults at dispatches 3 and 5",
             BREAKER16),
            ("(d) forced degradation ladder",
             ["--degrade", "--degrade-window-wall-s", "1e-9",
              "--degrade-trip-windows", "2", "--degrade-pause-ms", "1"])):
        outs, logs = {}, {}
        for device in ("cuda", "cpu"):
            journal = os.path.join(tmp, f"{device}-{len(outs)}-{what[1]}"
                                        ".jsonl")
            host = []
            fallback = degrade.ScorerCircuitBreaker._fallback_process

            def tracked(self, ts, pairs, host=host):
                host.append(self._windows)
                return fallback(self, ts, pairs)

            degrade.ScorerCircuitBreaker._fallback_process = tracked
            try:
                counted = ("chained" if device == "cuda" else None)
                run = lambda: _cli_run(  # noqa: E731
                    base + flags + ["--journal", journal, "--device",
                                    device])
                (rc, out, wall, _), counts = (
                    _counted(counted, run) if counted else (run(), {}))
            finally:
                degrade.ScorerCircuitBreaker._fallback_process = fallback
            if rc != 0 or not out:
                _fail(f"{what} on {device}: exit {rc}")
            recs = [json.loads(l) for l in open(journal) if '"seq"' in l]
            outs[device] = out
            logs[device] = (recs, host, wall, counts)
        recs, host, wall, counts = logs["cuda"]
        if flags is BREAKER16:
            opened = [r["seq"] for r in recs
                      if r.get("breaker_state") == "open"]
            if host != BREAKER16_HOST_WINDOWS or opened != host:
                _fail(f"{what}: windows on the host {host}, open "
                      f"{opened}; the plan predicts "
                      f"{BREAKER16_HOST_WINDOWS}")
            if logs["cpu"][1] != host:
                _fail(f"{what}: the CPU run's host windows differ")
            detail = (f"windows {host} scored on the host (the plan's "
                      f"prediction), states "
                      f"{''.join(r['breaker_state'][0] for r in recs)}")
        else:
            levels = [r["degradation_level"] for r in recs]
            want = [min(3, (i + 1) // 2) for i in range(len(levels))]
            if levels != want or [r["degradation_level"]
                                  for r in logs["cpu"][0]] != levels:
                _fail(f"{what}: levels {levels}, expected {want}")
            detail = f"levels {levels}, the CPU run's equal"
        a = [line.split("\t") for line in outs["cuda"].splitlines()]
        b = [line.split("\t") for line in outs["cpu"].splitlines()]
        if [x[0] for x in a] != [x[0] for x in b]:
            _fail(f"{what}: cuda and cpu emitted other rows")
        bad = 0
        for x, y in zip(a, b):
            sx = [(int(p.split(":")[0]), float(p.split(":")[1]))
                  for p in x[1].split()] if len(x) > 1 else []
            sy = [(int(p.split(":")[0]), float(p.split(":")[1]))
                  for p in y[1].split()] if len(y) > 1 else []
            if len(sx) != len(sy) or not np.allclose(
                    [v for _, v in sx], [v for _, v in sy], atol=2e-4):
                bad += 1
        if bad:
            _fail(f"{what}: {bad} lines of cuda and cpu disagree")
        print(f"  {card}: {what}: {detail}; wall {wall:.4f} s, launches "
              f"{counts}; {len(a)} --emit-updates lines: the CPU run's "
              f"items, scores within 2e-4 (4 printed decimals)",
              flush=True)


def _phase16_watchdog(card, tmp, csv):
    """(e) A child stalled at window 6 (window_fire delay_ms) is killed by
    the hang watchdog, restarted and resumed from its checkpoint: stdout
    byte-identical to the uninterrupted run's; the supervisor quotes the
    dead child's journal tail."""
    base = ["-i", csv, "-ws", "100", "-s", "0xC0FFEE",
            "--checkpoint-every-windows", "3"]
    rc, want, _, _ = _cli_run(base + ["--checkpoint-dir",
                                      os.path.join(tmp, "wd-ref")])
    if rc != 0 or not want:
        _fail(f"watchdog reference run: exit {rc}")
    d = os.path.join(tmp, "wd")
    argv = base + ["--checkpoint-dir", os.path.join(d, "ck"),
                   "--journal", os.path.join(d, "j.jsonl"),
                   "--restart-on-failure", "1", "--restart-delay-ms", "0",
                   "--watchdog-stale-after-s", "3",
                   "--inject-fault", "window_fire:6:delay_ms:600000",
                   "--fault-state-dir", os.path.join(d, "faults")]
    start = time.monotonic()
    res = subprocess.run([sys.executable, "-m", "tpu_cooccurrence_torch",
                          *argv], capture_output=True, text=True,
                         timeout=300,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.monotonic() - start
    if res.returncode != 0 or res.stdout != want:
        _fail(f"watchdog run: exit {res.returncode}, stdout "
              f"{'equal' if res.stdout == want else 'differs'}: "
              f"{res.stderr[-1500:]}")
    for needle in ("hang watchdog: journal", "dead child's journal tail",
                   "restored checkpoint"):
        if needle not in res.stderr:
            _fail(f"watchdog run: no {needle!r} in the log")
    print(f"  {card}: (e) child stalled at window 6 killed by the hang "
          f"watchdog (3 s), {res.stderr.count('  journal: ')} journal "
          f"records quoted, restarted and resumed from its checkpoint: "
          f"stdout ({want.count(chr(10))} rows) byte-identical to the "
          f"uninterrupted run's; {wall:.2f} s", flush=True)


def phase_planes(card: str) -> None:
    """Phase 16."""
    import tempfile

    import torch

    print("phase 16: the host planes (journal, /metrics, /healthz, "
          "/recommend, the profiler, the breaker, degradation, the "
          "watchdog)", flush=True)
    t0 = time.monotonic()
    with tempfile.TemporaryDirectory() as tmp:
        _phase16_bench(card, tmp)
        torch.cuda.empty_cache()
        _phase16_config4_breaker(card)
        torch.cuda.empty_cache()
        csv = _small16_csv(tmp)
        _phase16_faulted(card, tmp, csv)
        _phase16_watchdog(card, tmp, csv)
    print(f"  phase 16 done in {time.monotonic() - t0:.1f} s", flush=True)



# -- phase 17: the partitioned log and the read replica ------------------


#: Partitions of phase 17's log (record j in partition (j // 256) mod 8).
PARTS17 = 8
#: Records of the log's head that the oracle gate of phase 17(a) runs.
HEAD17 = 100_000


def _write_partitions(root, users, items, ts, turn):
    """The stream as ``part-*`` files dealt in blocks of ``turn`` records,
    so the source's round-robin reads it in its own order."""
    os.makedirs(root)
    lines = [f"{u},{i},{t}\n" for u, i, t in
             zip(users.tolist(), items.tolist(), ts.tolist())]
    block = np.arange(len(lines)) // turn % PARTS17
    for p in range(PARTS17):
        with open(os.path.join(root, f"part-{p:03d}"), "w") as f:
            f.write("".join(lines[j] for j in np.flatnonzero(block == p)))


def _cli_job_run(argv):
    """``_cli_run(argv)`` keeping the job the CLI builds and timing the
    batcher (read and parse: ``cli.batched_lines``'s ``next``). Returns
    (rc, stdout, wall, job, ingest seconds)."""
    from tpu_cooccurrence_torch import cli
    from tpu_cooccurrence_torch.job import CooccurrenceJob

    box = {"ingest": 0.0}
    make, batched = CooccurrenceJob.__init__, cli.batched_lines

    def grab(self, *a, **kw):
        make(self, *a, **kw)
        box["job"] = self

    def timed(*a, **kw):
        it = batched(*a, **kw)
        while True:
            t0 = time.perf_counter()
            batch = next(it, None)
            box["ingest"] += time.perf_counter() - t0
            if batch is None:
                return
            yield batch

    CooccurrenceJob.__init__, cli.batched_lines = grab, timed
    try:
        rc, out, wall, _ = _cli_run(argv)
    finally:
        CooccurrenceJob.__init__, cli.batched_lines = make, batched
    return rc, out, wall, box.get("job"), box["ingest"]


def _parse_rows(out):
    rows = {}
    for line in out.splitlines():
        item, _, rest = line.partition("\t")
        rows[int(item)] = [(int(o), float(v)) for o, v in
                           (tok.split(":") for tok in rest.split())]
    return rows


def _phase17_dense(card, plog, csv):
    """(a) The dense backend on the partitioned log against the files
    source on the one CSV."""
    from tpu_cooccurrence_torch.metrics import (ITEM_LATE_ELEMENTS,
                                                SPLIT_READER_NUM_SPLITS,
                                                USER_LATE_ELEMENTS)

    base = ["-ws", "100", "-s", "0xC0FFEE", "--num-items", "20000"]
    part = ["-i", plog, "--source-format", "partitioned",
            "--ingest-partitions", str(PARTS17)]
    runs = {}
    for name, argv in (("files", ["-i", csv] + base),
                       ("partitioned", part + base)):
        (rc, out, wall, job, ingest), counts = _counted(
            "chained", lambda: _cli_job_run(argv))
        if rc != 0 or not out:
            _fail(f"phase 17 (a) {name}: exit {rc}")
        runs[name] = (out, wall, job, ingest, counts)
    out, wall, job, ingest, counts = runs["partitioned"]
    f_out, f_wall, f_job, f_ingest, f_counts = runs["files"]
    late = (job.counters.get(ITEM_LATE_ELEMENTS),
            job.counters.get(USER_LATE_ELEMENTS))
    if late != (0, 0):
        _fail(f"phase 17 (a): {late} late events on the partitioned log")
    mine, theirs = ({k: v for k, v in j.counters.as_dict().items()
                     if k != SPLIT_READER_NUM_SPLITS} for j in (job, f_job))
    if out != f_out or mine != theirs:
        _fail("phase 17 (a): the partitioned run's stdout or counters "
              "differ from the files run's")
    health = job.source.ingest_health()
    records = sum(p["records"] for p in health["partitions"].values())
    print(f"  {card}: (a) bench stream as {PARTS17} part-* files, dense, "
          f"--ingest-partitions {PARTS17}: {records} records read, 0 late; "
          f"stdout ({out.count(chr(10))} rows) and counters byte-identical "
          f"to the files run (split counts "
          f"{job.counters.get(SPLIT_READER_NUM_SPLITS)} and "
          f"{f_job.counters.get(SPLIT_READER_NUM_SPLITS)}); launches "
          f"{counts} and {f_counts}", flush=True)
    print(f"    {card}: wall partitioned {wall:.4f} s, ingest "
          f"{ingest:.4f} s ({100 * ingest / wall:.1f}%); files "
          f"{f_wall:.4f} s, ingest {f_ingest:.4f} s "
          f"({100 * f_ingest / f_wall:.1f}%) (host clock, CLI in this "
          f"process)", flush=True)


def _phase17_oracle(card, head):
    """(a) The log's first records, dense on the card against the
    float64 oracle."""
    part = ["-i", head, "--source-format", "partitioned",
            "--ingest-partitions", str(PARTS17), "-ws", "100", "-s",
            "0xC0FFEE", "--num-items", "20000"]
    rc, out, _, _ = _cli_run(part)
    rc_o, o_out, o_wall, _ = _cli_run(part + ["--backend", "oracle"])
    if rc != 0 or rc_o != 0 or not out:
        _fail(f"phase 17 (a) the log's head: exits {rc} and {rc_o}")
    rows, held = _latest_close(_parse_rows(o_out), _parse_rows(out))
    print(f"  {card}: (a) the log's first {HEAD17} records: {rows} rows of "
          f"the card's dense run within the oracle comparator ({held} with "
          f"ids held); oracle wall {o_wall:.4f} s (beside the replica "
          f"child's start)", flush=True)


def _newest_meta(directory):
    from tpu_cooccurrence_torch.state import checkpoint as ckpt

    gen, path = ckpt.generations(directory)[0]
    with np.load(path) as f:
        return gen, json.loads(bytes(f["meta_json"]).decode())


def _wait_replica(port_file, want_gen, child, timeout=120):
    """The child replica's port once its /healthz reports ``want_gen``."""
    import urllib.request

    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if child.poll() is not None:
            _fail(f"the replica exited {child.returncode}: "
                  f"{child.stderr.read()[-1500:]}")
        try:
            with open(port_file) as f:
                port = json.load(f)["port"]
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/healthz", timeout=5) as r:
                if json.load(r)["replica"]["generation"] == want_gen:
                    return port
        except (OSError, ValueError, KeyError):
            pass
        time.sleep(0.05)
    _fail(f"the replica did not reach generation {want_gen}")


def _phase17_replica_rows(card, early, live, plog):
    """(c), this process: a replica bootstraps from the directory as the
    crash left it and tails the live one; its rows must be bit-identical
    to the writer's serving plane restored at the newest generation."""
    from tpu_cooccurrence_torch.config import Config
    from tpu_cooccurrence_torch.job import CooccurrenceJob
    from tpu_cooccurrence_torch.serving.replica import ReadReplica
    from tpu_cooccurrence_torch.state import checkpoint as ckpt

    rep = ReadReplica(early)
    start = time.perf_counter()
    g0 = rep.bootstrap()
    boot_s = time.perf_counter() - start
    rep.state_dir = live
    start = time.perf_counter()
    applied = rep.poll()
    apply_s = time.perf_counter() - start
    newest = ckpt.generations(live)[0][0]
    if rep.generation != newest or rep.resyncs or applied < 1:
        _fail(f"phase 17 (c): replica at {rep.generation} after {applied} "
              f"generations, {rep.resyncs} resyncs; newest {newest}")
    writer = CooccurrenceJob(Config(
        input=plog, window_size=100, seed=0xC0FFEE, backend="sparse",
        checkpoint_dir=live, checkpoint_incremental=True, serve_port=0,
        device="cuda"))
    writer.restore()
    snap_w, snap_r = writer.serving.builder.current, rep.plane.builder.current
    if not np.array_equal(writer.item_vocab.external_array(),
                          rep.item_vocab.external_array()):
        _fail("phase 17 (c): the replica's item vocabulary differs")
    checked = 0
    for dense in range(len(writer.item_vocab)):
        rw, rr = snap_w.row(dense), snap_r.row(dense)
        if (rw is None) != (rr is None) or (rw is not None and not (
                np.array_equal(rw[0], rr[0])
                and np.array_equal(rw[1], rr[1]))):
            _fail(f"phase 17 (c): row {dense} differs from the writer's")
        checked += rw is not None
    if checked != snap_w.rows or not checked or snap_r.generation != newest:
        _fail(f"phase 17 (c): {checked} rows checked of {snap_w.rows}, "
              f"snapshot generation {snap_r.generation}")
    writer.abort()
    print(f"  {card}: (c) replica in this process: bootstrap at generation "
          f"{g0} {boot_s:.4f} s, {applied} delta generations applied in "
          f"{apply_s:.4f} s ({apply_s / applied:.4f} s a generation) to "
          f"generation {newest}; {checked} rows (ids and float32 scores) "
          f"bit-identical to the writer's serving plane restored there",
          flush=True)
    return rep


def _phase17_queries(card, rep, port, users):
    """(c), the child: 1,000 /recommend answers equal to this process's
    replica's; ``min_gen`` past the log answers 503."""
    import urllib.error
    import urllib.request

    from tpu_cooccurrence_torch.observability.registry import REGISTRY
    from tpu_cooccurrence_torch.serving.replica import ReplicaServer

    local = ReplicaServer(REGISTRY, rep)
    lat = []
    try:
        for q in range(1000):
            query = f"user={int(users[q * 37 % len(users)])}&n=10"
            t0 = time.perf_counter()
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/recommend?{query}",
                    timeout=10) as r:
                got = json.load(r)
            lat.append(time.perf_counter() - t0)
            code, body = local.recommend(query)
            want = json.loads(body)
            for rec in (got, want):
                rec.pop("snapshot_age_seconds", None)
            if code != 200 or got != want or got["generation"] != \
                    rep.generation:
                _fail(f"phase 17 (c): /recommend?{query}: {got} against "
                      f"{want}")
    finally:
        local.stop()
    try:
        urllib.request.urlopen(
            f"http://127.0.0.1:{port}/recommend?user=1&n=10"
            f"&min_gen={rep.generation + 1}", timeout=10)
        _fail("phase 17 (c): min_gen past the log did not answer 503")
    except urllib.error.HTTPError as exc:
        if exc.code != 503:
            _fail(f"phase 17 (c): min_gen past the log answered {exc.code}")
    p50, p99 = np.percentile(np.asarray(lat) * 1e3, [50, 99])
    print(f"  {card}: (c) replica child: 1,000 /recommend answers equal to "
          f"this process's replica's (generation {rep.generation}); "
          f"min_gen {rep.generation + 1} answered 503; latency p50 "
          f"{p50:.4f} ms p99 {p99:.4f} ms (host clock, one client)",
          flush=True)


def _phase17_sparse(card, tmp, plog, head, users):
    """(b) and (c): the sparse backend killed and resumed on the log, the
    replica tailing the resume. The crashed child runs beside the
    uninterrupted run, and the replica child starts beside the oracle
    gate of (a): four processes' walls overlap, the resumed run's does
    not."""
    import shutil
    import signal

    here = os.path.dirname(os.path.abspath(__file__))
    common = ["-i", plog, "-ws", "100", "-s", "0xC0FFEE", "--backend",
              "sparse", "--source-format", "partitioned",
              "--ingest-partitions", str(PARTS17),
              "--checkpoint-every-windows", "5", "--checkpoint-incremental",
              # A pure delta chain: every resumed generation is a delta
              # the replica tails (no ratio-triggered full base).
              "--checkpoint-compact-ratio", "100"]
    live, journal = os.path.join(tmp, "ck"), os.path.join(tmp, "j.jsonl")
    argv = common + ["--checkpoint-dir", live, "--journal", journal]
    start = time.monotonic()
    crashing = subprocess.Popen(
        [sys.executable, "-m", "tpu_cooccurrence_torch", *argv,
         "--inject-fault", "window_fire:12:crash"],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
        cwd=here)
    try:
        (rc, want, wall_ref, _), counts = _counted(
            "sparse", lambda: _cli_run(
                common + ["--checkpoint-dir", os.path.join(tmp, "ref")]))
        _, err = crashing.communicate(timeout=300)
    finally:
        if crashing.poll() is None:
            crashing.kill()
            crashing.wait()
    crash_wall = time.monotonic() - start
    if rc != 0 or not want:
        _fail(f"phase 17 (b) uninterrupted run: exit {rc}")
    gen, meta = _newest_meta(live)
    committed = sum(p["records"] for p in
                    meta["ingest_offsets"]["partitions"].values())
    if crashing.returncode != -signal.SIGKILL or meta["windows_fired"] != 10:
        _fail(f"phase 17 (b): the child exited {crashing.returncode} at "
              f"window {meta['windows_fired']}: {err[-1500:]}")
    early = os.path.join(tmp, "early")
    shutil.copytree(live, early)
    port_file = os.path.join(tmp, "replica.port")
    rjournal = os.path.join(tmp, "replica.jsonl")
    child = subprocess.Popen(
        [sys.executable, "-m", "tpu_cooccurrence_torch.serving.replica",
         "--state-dir", live, "--port", "0", "--port-file", port_file,
         "--poll-interval-s", "0.05", "--journal", rjournal],
        cwd=here, stderr=subprocess.PIPE, text=True)
    try:
        spawned = time.monotonic()
        _phase17_oracle(card, head)
        _wait_replica(port_file, gen, child)
        serving_s = time.monotonic() - spawned
        (rc, got, wall, _), counts_b = _counted(
            "sparse", lambda: _cli_run(argv))
        if rc != 0 or got != want:
            _fail(f"phase 17 (b) resumed run: exit {rc}, stdout "
                  f"{'equal' if got == want else 'differs'}")
        windows = {}
        with open(journal) as f:
            for rec in map(json.loads, f):
                if "seq" in rec:
                    windows[rec["seq"]] = rec
        events = sum(r["events"] for r in windows.values())
        top, meta = _newest_meta(live)
        final = sum(p["records"] for p in
                    meta["ingest_offsets"]["partitions"].values())
        n = len(users)
        if (sorted(windows) != list(range(1, len(windows) + 1))
                or events != n or final != n):
            _fail(f"phase 17 (b): windows {sorted(windows)}, {events} "
                  f"events journaled, {final} records committed; the "
                  f"stream has {n}")
        print(f"  {card}: (b) sparse, a generation every 5 windows, "
              f"incremental: the child SIGKILLed at window 12 after "
              f"{crash_wall:.2f} s with generation {gen} committed at "
              f"window 10 ({committed} of {n} records); resumed in "
              f"{wall:.4f} s (uninterrupted {wall_ref:.4f} s, beside the "
              f"crashing child), stdout "
              f"({want.count(chr(10))} rows) equal to the uninterrupted "
              f"run's; {len(windows)} windows journaled once, {events} "
              f"events; generation {top} commits {final} records; "
              f"launches {counts_b} (uninterrupted {counts})", flush=True)
        port = _wait_replica(port_file, top, child)
        rep = _phase17_replica_rows(card, early, live, plog)
        _phase17_queries(card, rep, port, users)
    finally:
        child.send_signal(signal.SIGINT)
        try:
            child.wait(timeout=30)
        except subprocess.TimeoutExpired:
            child.kill()
            child.wait()
    if child.returncode != 0:
        _fail(f"the replica child exited {child.returncode}")
    recs = [json.loads(line) for line in open(rjournal)]
    applies = [r["spans"][0][2] for r in recs if "replica" in r]
    if [r["replica"] for r in recs] != list(range(gen + 1, top + 1)):
        _fail(f"phase 17 (c): the child journaled generations "
              f"{[r['replica'] for r in recs]}")
    print(f"    {card}: replica child: serving at generation {gen} at most "
          f"{serving_s:.2f} s after its start (interpreter, imports, "
          f"bootstrap; the oracle gate ran meanwhile); tailed generations {gen + 1}..{top} as the resume "
          f"committed them, delta-apply {np.mean(applies):.4f} s a "
          f"generation (its journal); exit 0 on SIGINT", flush=True)


def phase_partitioned_and_replica(card: str) -> None:
    """Phase 17."""
    import tempfile

    import torch

    from tpu_cooccurrence_torch.io.partitioned import TURN_RECORDS

    print("phase 17: the partitioned log (--source-format partitioned) and "
          "the read replica", flush=True)
    t0 = time.monotonic()
    users, items, ts = _bench_stream()
    with tempfile.TemporaryDirectory() as tmp:
        plog = os.path.join(tmp, "plog")
        _write_partitions(plog, users, items, ts, TURN_RECORDS)
        head = os.path.join(tmp, "plog-head")
        _write_partitions(head, users[:HEAD17], items[:HEAD17],
                          ts[:HEAD17], TURN_RECORDS)
        csv = os.path.join(tmp, "bench.csv")
        _write_csv(csv, users, items, ts)
        _phase17_dense(card, plog, csv)
        torch.cuda.empty_cache()
        _phase17_sparse(card, tmp, plog, head, users)
    print(f"  phase 17 done in {time.monotonic() - t0:.1f} s", flush=True)


# -- phase 18: the sharded sparse backend --------------------------------


#: Events of config 4's prefix that phase 18(c) runs on cuda and cpu, and
#: the window whose checkpoint (d) drops its run after.
PREFIX18 = 50_000
EVERY18 = 25


def _sharded_sparse_job(cfg, mesh):
    """A job on a ``ShardedSparseScorer`` over an explicit ``mesh`` (the
    CLI takes one visible card a shard), as ``_make_scorer`` builds it."""
    from tpu_cooccurrence_torch.job import CooccurrenceJob
    from tpu_cooccurrence_torch.parallel.sharded_sparse import (
        ShardedSparseScorer)

    scorer = ShardedSparseScorer(
        cfg.top_k, mesh=mesh, development_mode=cfg.development_mode,
        score_ladder=cfg.score_ladder, defer_results=not cfg.emit_updates,
        cell_dtype=cfg.resolved_cell_dtype,
        wire_format=cfg.resolved_wire_format)
    job = CooccurrenceJob(cfg, scorer=scorer)
    scorer.counters = job.counters
    return job


def _config4_sharded_cfg(**extra):
    from tpu_cooccurrence_torch.config import Config

    return Config(**{**CONFIG4_JOB, "num_shards": SHARDS, **extra},
                  device="cuda")


def _shard_line(job, wall, counts):
    """Wall, pairs/s, the row imbalance of the last window, each shard's
    live cells (narrow + wide) and slab bytes."""
    from tpu_cooccurrence_torch.metrics import OBSERVED_COOCCURRENCES
    from tpu_cooccurrence_torch.observability.registry import REGISTRY

    sc = job.scorer
    pairs = job.counters.get(OBSERVED_COOCCURRENCES)
    cells = [int(REGISTRY.gauge(f"cooc_slab_live_cells_shard{d}").get())
             for d in range(sc.n_shards)]
    imb = REGISTRY.gauge("cooc_shard_row_imbalance").get()
    return (f"wall {wall:.4f} s, {pairs / wall:.1f} pairs/s, "
            f"cooc_shard_row_imbalance {imb:.4f} (last window), live cells "
            f"by shard {cells}, {sc.promoted_rows} promoted rows, slabs "
            f"{sc.slab_device_bytes} device bytes ({sc.capacity} cells a "
            f"shard), {sc.compactions} shard compactions; launches {counts}")


def _phase18_config4(card, sparse_job):
    """(a), (b): config 4 at D = 4 on one card, int32 raw, then int16 and
    int8 packed (no row of config 4 reaches int16's bound, as phase 11's
    launch counts show; at int8 rows promote), each counted; returns the
    int32 job, its launches and the arguments of its largest per-shard
    launch."""
    import torch

    from tpu_cooccurrence_torch.parallel import sharded_sparse as shs

    users, items, ts = _config4_stream()
    mesh = [sparse_job.scorer.device] * SHARDS
    largest = {"s": -1}
    launch = shs.rect_topk

    def recording(*args):
        if args[3].shape[0] > largest["s"]:
            largest.update(s=args[3].shape[0], args=tuple(
                a.clone() if torch.is_tensor(a) else a for a in args))
        return launch(*args)

    jobs, launches = {}, {}
    for cell, fmt in (("int32", "raw"), ("int16", "packed"),
                      ("int8", "packed")):
        def run():
            job = _sharded_sparse_job(_config4_sharded_cfg(
                cell_dtype=cell, wire_format=fmt), mesh)
            start = time.monotonic()
            job.add_batch(users, items, ts)
            job.finish()
            torch.cuda.synchronize()
            return job, time.monotonic() - start

        shs.rect_topk = recording if cell == "int32" else launch
        try:
            (job, wall), counts = _counted("sparse", run)
        finally:
            shs.rect_topk = launch
        if cell == "int32":
            rows, _ = _sparse_equal(job, sparse_job, "config 4 D=4 int32 raw")
            what = (f"counters, blob and {rows} rows (ids included) exactly "
                    f"equal to phase 7's single-device run")
        else:
            rows, swapped = _sparse_equal(job, jobs["int32"],
                                          f"config 4 D=4 {cell} packed",
                                          ties_may_swap=True)
            if cell == "int8" and job.scorer.promoted_rows <= 0:
                _fail("config 4 D=4 int8: no row promoted")
            what = (f"counters, blob and {rows} rows' scores exactly equal "
                    f"to (a), ids equal but on {swapped} lanes of exactly "
                    f"tied scores")
        print(f"  {card}: config 4 D={SHARDS} on one card, {cell} {fmt}: "
              f"{_shard_line(job, wall, counts)}; {what}", flush=True)
        launches[cell] = counts["rect_topk"]
        if cell == "int32":
            jobs[cell] = job
        del job
    return jobs["int32"], launches["int32"], largest


def _phase18_cpu(card, mesh):
    """(c) cuda against cpu at D = 4 on config 4's prefix, streamed."""
    from tpu_cooccurrence_torch.job import CooccurrenceJob
    from tpu_cooccurrence_torch.ops.score_topk import topk_parity

    users, items, ts = (a[:PREFIX18] for a in _config4_stream())
    outs, jobs = {}, {}
    for device in ("cuda", "cpu"):
        cfg = dataclasses.replace(_config4_sharded_cfg(emit_updates=True),
                                  device=device)
        job = (_sharded_sparse_job(cfg, mesh) if device == "cuda"
               else CooccurrenceJob(cfg))
        sink = []
        job.on_update = sink.append
        job.add_batch(users, items, ts)
        job.finish()
        outs[device], jobs[device] = sink, job
    if jobs["cuda"].counters.as_dict() != jobs["cpu"].counters.as_dict():
        _fail("D=4 cuda vs cpu: counters differ")
    a, b = (jobs[d].scorer.checkpoint_state() for d in ("cuda", "cpu"))
    if not all(np.array_equal(a[k], b[k]) for k in a):
        _fail("D=4 cuda vs cpu: the canonical blobs differ")
    if len(outs["cuda"]) != len(outs["cpu"]) or len(outs["cuda"]) < 2:
        _fail("D=4 cuda vs cpu: different handovers")
    for a, b in zip(outs["cuda"], outs["cpu"]):
        ok, mism = topk_parity(a.vals, a.idx, b.vals, b.idx, rtol=RTOL,
                               atol=ATOL)
        if not np.array_equal(a.rows, b.rows) or not ok or mism:
            _fail("D=4 cuda vs cpu: a handover's rows differ")
    print(f"  {card}: config 4's first {PREFIX18} events at D={SHARDS}, "
          f"--emit-updates, cuda against cpu: counters and blob exactly "
          f"equal; {len(outs['cuda'])} handovers of "
          f"{sum(len(b) for b in outs['cuda'])} rows in the same order and "
          f"in topk_parity", flush=True)


def phase_sharded_sparse(card: str, parity: Parity, sparse_job) -> dict:
    """Phase 18. Returns the D = 4 int32 run's launches and the kernel's
    times at that run's largest per-shard launch."""
    import tempfile

    import torch

    from tpu_cooccurrence_torch.ops import rect_topk as rt

    print("phase 18: the sharded sparse backend (--backend sparse "
          f"--num-shards {SHARDS}, four shards on one card)", flush=True)
    t0 = time.monotonic()
    users, items, ts = _config4_stream()
    mesh = [sparse_job.scorer.device] * SHARDS
    job_a, launches, largest = _phase18_config4(card, sparse_job)
    _phase18_cpu(card, mesh)
    torch.cuda.empty_cache()

    print(f"  (d) config 4 from a CSV at D={SHARDS}, depth 2, dropped "
          f"after the window-{EVERY18} checkpoint, restored at D=1",
          flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        csv = os.path.join(tmp, "config4.csv")
        _write_csv(csv, users, items, ts)
        cfg = _config4_sharded_cfg(
            pipeline_depth=2, checkpoint_dir=os.path.join(tmp, "ck"),
            checkpoint_every_windows=EVERY18)

        def check(job, what):
            rows, swapped = _sparse_equal(job, job_a, what,
                                          ties_may_swap=True)
            return (f"counters, blob and {rows} rows' scores exactly equal "
                    f"to (a), ids equal but on {swapped} lanes of exactly "
                    f"tied scores")

        dropped, _, info = _resume(
            card, "sparse", cfg, csv, EVERY18, check,
            make_first=lambda c: _sharded_sparse_job(c, mesh),
            resumed_cfg=dataclasses.replace(cfg, num_shards=1,
                                            checkpoint_every_windows=0))
        print(f"    save {info['save_bytes']} bytes in "
              f"{info['save_s']:.4f} s at D={SHARDS}; restore of those "
              f"{info['save_bytes']} bytes at D=1 {info['restore_s']:.4f} s",
              flush=True)
        del dropped

    print("  (e) rect_topk on the largest per-shard launch of (a)",
          flush=True)
    args = largest["args"]
    name = f"sharded_D{SHARDS}_largest_shard_launch_S{largest['s']}"
    parity.compare(name, rt.rect_topk(*args),
                   rt.rect_topk_reference(*args[:8]), exact=True)
    m = _measure_rect(name, args)
    del job_a
    print(f"  phase 18 done in {time.monotonic() - t0:.1f} s", flush=True)
    return dict(launches=launches, **m)


#: Phase 19: config 4's events the sparse gang runs (the budget's cut),
#: the collective watchdog's seconds, and the checkpoint cadence and the
#: collective at which (c) kills process 1.
GANG_EVENTS19 = 300_000
GANG_TIMEOUT19 = 30
EVERY19 = 5
CRASH19 = "barrier_enter:16:crash"
CRASH_AT19 = int(CRASH19.split(":")[1])


def _render(job) -> str:
    """The CLI's final dump of ``job``'s rows (``cli._render_row`` in
    item order)."""
    from tpu_cooccurrence_torch.cli import _render_row

    snap = job.latest.snapshot()
    return "".join(_render_row(item, snap[item]) + "\n"
                   for item in sorted(snap))


def _gang_child(spec_path: str) -> int:
    """One process of a phase-19 gang (``chip_smoke.py --gang-child
    SPEC``): the CLI in this process with ``spec["argv"]``, the kernels'
    counts set to 0 just before and read just after, stdout into
    ``spec["stdout"]``; with ``spec["measure"]``, the arguments of this
    process's largest ``score_topk_local`` or ``rect_topk`` launch saved
    to ``spec["replay"]`` (:func:`_gang_replay` times them once every
    gang has ended). Writes ``spec["result"]``."""
    import torch

    from tpu_cooccurrence_torch.ops import rect_topk as rt
    from tpu_cooccurrence_torch.ops import score_topk as st
    from tpu_cooccurrence_torch.parallel import sharded
    from tpu_cooccurrence_torch.parallel import sharded_sparse as shs

    with open(spec_path) as f:
        spec = json.load(f)
    largest = {"s": -1}

    def recorder(module, name, rows_at):
        launch = getattr(module, name)

        def recording(*args):
            if args[rows_at].shape[0] > largest["s"]:
                largest.update(s=args[rows_at].shape[0], args=tuple(
                    a.clone() if torch.is_tensor(a) else a for a in args))
            return launch(*args)

        setattr(module, name, recording)

    recorder(sharded, "score_topk_local", 2)
    recorder(shs, "rect_topk", 3)
    st.LAUNCHES = rt.LAUNCHES = 0
    rc, out, wall, _ = _cli_run(spec["argv"])
    res = {"rc": rc, "wall": wall, "launches": {
        "score_topk": st.LAUNCHES, "rect_topk": rt.LAUNCHES}}
    with open(spec["stdout"], "w") as f:
        f.write(out)
    if rc == 0 and spec["measure"]:
        torch.save(largest["args"], spec["replay"])
        res.update(measure=spec["measure"], replay=spec["replay"],
                   s=largest["s"])
    with open(spec["result"], "w") as f:
        json.dump(res, f)
    return 0 if rc == 0 else int(rc or 1)


def _gang_replay(res) -> None:
    """Process 0's largest launch of a gang (:func:`_gang_child`'s
    ``res``), replayed in this process once every gang has ended, the
    card otherwise idle: held bit for bit to its plain version and timed.
    Adds ``measure`` and ``max_abs_err`` to ``res``."""
    import torch

    from tpu_cooccurrence_torch.ops import rect_topk as rt
    from tpu_cooccurrence_torch.ops import score_topk as st

    args = torch.load(res["replay"], map_location="cuda",
                      weights_only=False)
    kind, parity = res["measure"], Parity()
    name = f"gang_p0_largest_{kind}_S{res['s']}"
    if kind == "score_topk_local":
        C, rs, rows, lo, observed, k = args
        parity.compare(name, st.score_topk_local(*args),
                       _reference_chunked(C, rs, rows, observed, k,
                                          row_lo=lo), exact=True)
        m = _measure(name, C, rs, rows, observed, k, row_lo=lo)
    else:
        parity.compare(name, rt.rect_topk(*args),
                       rt.rect_topk_reference(*args[:8]), exact=True)
        m = _measure_rect(name, args)
    del args
    torch.cuda.empty_cache()
    res.update(measure=m, max_abs_err=parity.max_abs_err)


def _gang(tmp, tag, argv, extra=None, measure=None):
    """Start both processes of a gang on the one card (``extra[pid]``:
    per-process flags; ``measure``: the kernel whose largest launch
    process 0 saves for :func:`_gang_replay`); returns their handles and
    file names."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = []
    for pid in range(2):
        files = {k: os.path.join(tmp, f"{tag}.{pid}.{k}")
                 for k in ("spec", "stdout", "result", "stderr", "replay")}
        spec = {"pid": pid, "measure": measure if pid == 0 else None,
                **files, "argv": [
            *argv, "--collective-timeout-s", str(GANG_TIMEOUT19),
            "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
            "--process-id", str(pid), *((extra or {}).get(pid, []))]}
        with open(files["spec"], "w") as f:
            json.dump(spec, f)
        err = open(files["stderr"], "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--gang-child",
             files["spec"]], stdout=subprocess.DEVNULL, stderr=err,
            cwd=os.path.dirname(os.path.abspath(__file__))), files, err))
    return procs


def _gang_wait(procs, what, timeout=300):
    """Both processes' exit codes, exit times and results (``None`` for a
    process that wrote none)."""
    out = []
    for p, files, err in procs:
        try:
            p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q, _f, _e in procs:
                q.kill()
            _fail(f"{what}: a gang process did not end in {timeout} s")
        err.close()
        res = None
        if os.path.exists(files["result"]):
            with open(files["result"]) as f:
                res = json.load(f)
        out.append((p.returncode, res, files))
    return out


def _gang_ok(procs, what):
    """A gang that must succeed: both exit 0; returns the results and the
    merged stdout (the processes' rows are disjoint; merged in item
    order, as one process's dump prints them)."""
    done = _gang_wait(procs, what)
    rows = {}
    for pid, (rc, res, files) in enumerate(done):
        if rc != 0 or res is None:
            with open(files["stderr"]) as f:
                tail = f.read()[-3000:]
            _fail(f"{what}: process {pid} exited {rc}:\n{tail}")
        with open(files["stdout"]) as f:
            for line in f:
                item = int(line.partition("\t")[0])
                if item in rows:
                    _fail(f"{what}: row {item} printed by both processes")
                rows[item] = line
    return ([res for _rc, res, _f in done],
            "".join(rows[i] for i in sorted(rows)))


def _gang_launched(res, name, what):
    """Every process launched kernel ``name`` on its own shards."""
    counts = [r["launches"][name] for r in res]
    if min(counts) <= 0:
        _fail(f"{what}: {name} launched no time in a process {counts}")


def _gang_equal(merged, ref, what):
    if merged != ref or not ref:
        _fail(f"{what}: the gang's merged rows differ from the "
              f"single-process run's ({len(merged.splitlines())} vs "
              f"{len(ref.splitlines())} rows)")
    return len(ref.splitlines())


def _stamp_exits(procs) -> dict:
    """Host-clock exit time of each process of a gang, stamped by a
    waiting thread as each exits (the parent may be busy meanwhile)."""
    import threading

    stamps = {}

    def wait(pid, p):
        p.wait()
        stamps[pid] = time.monotonic()

    threads = [threading.Thread(target=wait, args=(pid, p), daemon=True)
               for pid, (p, _f, _e) in enumerate(procs)]
    for t in threads:
        t.start()
    stamps["threads"] = threads
    return stamps


def _ref_rows(job, users, items, ts):
    """``job`` over the stream in this process; its rendered rows and
    wall."""
    import torch

    start = time.monotonic()
    job.add_batch(users, items, ts)
    job.finish()
    torch.cuda.synchronize()
    return _render(job), time.monotonic() - start


def phase_gang(card: str) -> dict:
    """Phase 19. Returns each kernel's per-process launches and times at
    process 0's largest launch. Two gangs share the card at a time ((a)
    beside (c), (b) beside (c)'s resume), to fit the phase's budget; the
    timed replays (e) come after both rounds, alone."""
    import tempfile

    import torch

    from tpu_cooccurrence_torch.config import Config

    print("phase 19: the multi-process runtime, two processes on one card "
          f"(gloo, --collective-timeout-s {GANG_TIMEOUT19}), two gangs at "
          "a time", flush=True)
    t0 = time.monotonic()
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh2 = [dev] * 2
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        bench = _bench_stream()
        c4 = tuple(a[:GANG_EVENTS19] for a in _config4_stream())
        par = _parity_stream()
        csvs = {}
        for name, stream in (("bench", bench), ("config4", c4),
                             ("parity", par)):
            csvs[name] = os.path.join(tmp, f"{name}.csv")
            _write_csv(csvs[name], *stream)
        ck = os.path.join(tmp, "ck")
        argv_a = ["-i", csvs["bench"], "-ws", "100", "-s", "0xC0FFEE",
                  "-ic", "500", "-uc", "500", "--backend", "sharded",
                  "--num-items", "20000"]
        argv_b = ["-i", csvs["config4"], "-ws", "100", "-s", "4", "-ic",
                  "500", "-uc", "500", "--backend", "sparse",
                  "--num-shards", "2", "--wire-format", "packed"]
        # (c), (d): phase 3's stream at 10 ms windows, a generation every
        # EVERY19 windows; process 1 dies at its CRASH_AT19-th collective
        # (a barrier_enter crash), process 0 must leave with 75; then
        # both resume.
        argv_c = ["-i", csvs["parity"], "-ws", "10", "-s", "0xC0FFEE",
                  "-ic", "500", "-uc", "500", "--backend", "sharded",
                  "--num-items", "5000", "--checkpoint-dir", ck,
                  "--checkpoint-every-windows", str(EVERY19)]

        # Round 1: (a) beside (c).
        gang_a = _gang(tmp, "a", argv_a, measure="score_topk_local")
        gang_c = _gang(tmp, "c", argv_c, extra={1: [
            "--inject-fault", CRASH19]})
        exits = _stamp_exits(gang_c)
        ref_a, wall_a = _ref_rows(_sharded_job(
            _sharded_cfg("int32", 20_000, 2), mesh2), *bench)
        ref_c, _ = _ref_rows(_sharded_job(Config(
            window_size=10, seed=0xC0FFEE, item_cut=500, user_cut=500,
            num_items=5_000, device="cuda", backend="sharded",
            num_shards=2), mesh2), *par)
        for t in exits.pop("threads"):
            t.join(timeout=300)
        for p, _f, e in gang_c:
            if p.poll() is None:
                p.kill()
            e.close()
        (p0, _f0, _e0), (p1, _f1, _e1) = gang_c
        if p1.returncode != -9:
            _fail(f"(c) process 1 was not killed at its collective "
                  f"{CRASH_AT19} (exit {p1.returncode})")
        late = exits.get(0, float("inf")) - exits.get(1, 0.0)
        if p0.returncode != 75 or late > GANG_TIMEOUT19 + 10:
            _fail(f"(d) process 0 exited {p0.returncode} {late:.2f} s "
                  f"after its peer died (want 75 within "
                  f"{GANG_TIMEOUT19 + 10} s)")
        marks = sorted(n for n in os.listdir(ck) if n.startswith("EPOCH"))
        if not marks:
            _fail("(c) no generation committed before the kill")
        res, merged = _gang_ok(gang_a, "(a) bench gang")
        n = _gang_equal(merged, ref_a, "(a) bench gang")
        _gang_launched(res, "score_topk", "(a) bench gang")
        out["score_topk"] = res
        print(f"  {card}: (a) the bench workload, --backend sharded "
              f"--num-items 20000, 2 processes x 1 shard: walls "
              f"{[round(r['wall'], 4) for r in res]} s (the CLI's, the "
              f"CSV's parse included); score_topk launches by process "
              f"{[r['launches']['score_topk'] for r in res]}; {n} rows "
              f"byte-identical to one process over a two-entry mesh "
              f"({wall_a:.4f} s beside the gangs)", flush=True)
        print(f"  {card}: (c)/(d) phase 3's stream at 10 ms windows, a "
              f"generation every {EVERY19} windows: process 1 killed at "
              f"its collective {CRASH_AT19} (barrier_enter crash) after "
              f"the markers {marks}; process 0 exited 75 {late:.2f} s "
              f"later", flush=True)

        # Round 2: (b) beside (c)'s resume.
        gang_b = _gang(tmp, "b", argv_b, measure="rect_topk")
        gang_d = _gang(tmp, "d", argv_c)
        ref_b, wall_b = _ref_rows(_sharded_sparse_job(_config4_sharded_cfg(
            num_shards=2, wire_format="packed"), mesh2), *c4)
        res, merged = _gang_ok(gang_d, "(c) resume")
        n = _gang_equal(merged, ref_c, "(c) resume")
        _gang_launched(res, "score_topk", "(c) resume")
        print(f"  {card}: (c) both resumed from the committed epoch: "
              f"walls {[round(r['wall'], 4) for r in res]} s; {n} rows "
              f"byte-identical to one uninterrupted process over a "
              f"two-entry mesh", flush=True)
        res, merged = _gang_ok(gang_b, "(b) config 4 gang")
        n = _gang_equal(merged, ref_b, "(b) config 4 gang")
        _gang_launched(res, "rect_topk", "(b) config 4 gang")
        out["rect_topk"] = res
        print(f"  {card}: (b) config 4 cut to its first {GANG_EVENTS19} "
              f"of 1,000,000 events (the phase's budget), --backend "
              f"sparse --num-shards 2 (int32 cells: narrow cells stay "
              f"single-controller, as in the JAX package), packed uplink: "
              f"walls {[round(r['wall'], 4) for r in res]} s; rect_topk "
              f"launches by process "
              f"{[r['launches']['rect_topk'] for r in res]}; {n} rows "
              f"byte-identical to one process over a two-entry mesh "
              f"({wall_b:.4f} s beside the gangs)", flush=True)
        # (e) Every gang has ended: process 0's largest launches of (a)
        # and (b), replayed one at a time on the otherwise idle card.
        print("  (e) process 0's largest launches of (a) and (b), replayed "
              "after both rounds, the card otherwise idle", flush=True)
        for name in ("score_topk", "rect_topk"):
            _gang_replay(out[name][0])
    print(f"  phase 19 done in {time.monotonic() - t0:.1f} s", flush=True)
    # Phase 20 runs (c)'s and (b)'s gangs again under the supervisor.
    out["ref"] = {"parity": ref_c, "config4": ref_b}
    return out

# -- phase 20: the gang supervisor and the replica fleet ----------------

#: Phase 20(b): worker 1's heartbeat frozen at its third beat, a beat a
#: second, stale after 3 s.
FREEZE20 = "peer_heartbeat@1:3:delay_ms:600000"
#: Phase 20(c): the fleet's bound, and the users whose answers are held.
FLEET_SECONDS20 = 60
FLEET_USERS20 = 200


def _gang_supervised(tmp, tag, argv, results=None):
    """``python -m tpu_cooccurrence_torch.cli --gang-workers 2 ARGV`` as an
    operator starts it (with ``results``, phase 21's
    :func:`_autoscale_supervisor`, its workers' results into that
    directory): stdout and stderr into files. Returns (process, its files,
    start wall clock)."""
    files = {k: os.path.join(tmp, f"{tag}.{k}") for k in ("out", "err")}
    handles = [open(files["out"], "w"), open(files["err"], "w")]
    env = dict(os.environ)
    cmd = ["-m", "tpu_cooccurrence_torch.cli"]
    if results is not None:
        env[RESULTS_ENV21] = results
        cmd = [os.path.abspath(__file__), "--autoscale-supervisor"]
    proc = subprocess.Popen(
        [sys.executable, *cmd, *argv, "--gang-workers", "2",
         "--restart-delay-ms", "0"],
        stdout=handles[0], stderr=handles[1], env=env,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    return proc, files, handles, time.time()


def _gang_supervised_done(run, what, timeout=400):
    """A supervised gang's (stdout, stderr); fails unless it exited 0 and
    each worker's last ``Kernel launches`` line (its own stderr) says it
    ran on cuda."""
    import re

    proc, files, handles, _start = run
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        _fail(f"{what}: the gang supervisor did not end in {timeout} s")
    for h in handles:
        h.close()
    with open(files["out"]) as f:
        out = f.read()
    with open(files["err"]) as f:
        err = f.read()
    if proc.returncode != 0 or not out:
        _fail(f"{what}: the supervisor exited {proc.returncode}:\n"
              f"{err[-3000:]}")
    launches = {}
    for device, pid, counts in re.findall(
            r"Kernel launches \(--device (\w+), process (\d+)\): (\{.*\})",
            err):
        launches[int(pid)] = (device, json.loads(counts))
    if sorted(launches) != [0, 1] or any(
            d != "cuda" for d, _c in launches.values()):
        _fail(f"{what}: the workers' launch lines {launches}")
    return out, err, [launches[p][1] for p in (0, 1)]


def _merged_rows(out):
    rows = {}
    for line in out.splitlines(keepends=True):
        item = int(line.partition("\t")[0])
        if item in rows:
            _fail(f"row {item} printed by both workers")
        rows[item] = line
    return "".join(rows[i] for i in sorted(rows))


def _log_unix(err, needle):
    """Wall clock (Unix seconds) of the first log line holding
    ``needle`` (the logger's local ``asctime``, to the millisecond)."""
    for line in err.splitlines():
        if needle in line:
            return time.mktime(time.strptime(line[:19], "%Y-%m-%d %H:%M:%S"
                                             )) + int(line[20:23]) / 1000
    _fail(f"no log line holds {needle!r}")


def _journal_records(path, windows=True):
    """The records of every worker's journal (``path.p<i>``); with
    ``windows``, the window records only."""
    recs = []
    pid = 0
    while os.path.exists(f"{path}.p{pid}"):
        with open(f"{path}.p{pid}") as f:
            recs += [json.loads(line) for line in f if line.strip()]
        pid += 1
    return [r for r in recs if "seq" in r or not windows]


def _fleet_answers(port, users):
    import urllib.request

    out = []
    for user in users:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/recommend?user={user}&n=10",
                timeout=10) as r:
            rec = json.load(r)
        rec.pop("snapshot_age_seconds")
        out.append(rec)
    return out


def _fleet_serving(fleet_dir, slot, gen, not_pid=None):
    """Slot ``slot``'s port file if its replica (with ``not_pid``: a
    relaunched one) serves generation ``gen``, else None."""
    import urllib.request

    try:
        with open(os.path.join(fleet_dir, f"replica.p{slot}.port")) as f:
            info = json.load(f)
        if info["pid"] != not_pid:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{info['port']}/healthz",
                    timeout=5) as r:
                if json.load(r)["replica"]["generation"] == gen:
                    return info
    except (OSError, ValueError, KeyError):
        pass
    return None


def _fleet_port(fleet_dir, slot, gen, timeout=90):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        info = _fleet_serving(fleet_dir, slot, gen)
        if info is not None:
            return info
        time.sleep(0.02)
    _fail(f"phase 20 (c): replica {slot} did not serve generation {gen} "
          f"in {timeout} s")


def _phase20_fleet(card, tmp, parity_csv):
    """(c): a writer's directory, the fleet over it, replica 1 killed."""
    import signal
    import urllib.request

    from tpu_cooccurrence_torch.state import checkpoint as ckpt

    state = os.path.join(tmp, "writer")
    rc, _out, wall, _ = _cli_run(
        ["-i", parity_csv, "-ws", "10", "-s", "0xC0FFEE", "--backend",
         "sparse", "--checkpoint-dir", state, "--checkpoint-every-windows",
         "5", "--checkpoint-incremental", "--checkpoint-compact-ratio",
         "100"])
    if rc != 0:
        _fail(f"phase 20 (c): the writer exited {rc}")
    live = ckpt.generations(state)[0][0]
    fleet_dir = os.path.join(tmp, "fleet")
    err = open(os.path.join(tmp, "fleet.err"), "w")
    fleet = subprocess.Popen(
        [sys.executable, "-m", "tpu_cooccurrence_torch.serving.replica",
         "--state-dir", state, "--fleet", "2", "--fleet-dir", fleet_dir,
         "--poll-interval-s", "0.05", "--run-seconds",
         str(FLEET_SECONDS20), "--gang-stale-after-s", "0"],
        stderr=err, cwd=os.path.dirname(os.path.abspath(__file__)))
    offset = time.time() - time.monotonic()  # Unix minus monotonic
    try:
        spawned = time.monotonic()
        r0, r1 = (_fleet_port(fleet_dir, s, live) for s in (0, 1))
        up_s = time.monotonic() - spawned
        users = list(range(FLEET_USERS20))
        want = _fleet_answers(r0["port"], users)
        os.kill(r1["pid"], signal.SIGKILL)
        killed = time.monotonic()
        # Replica 0 answers until the relaunched replica serves the
        # writer's generation.
        queries = failed = 0
        r1b = None
        while r1b is None:
            if time.monotonic() - killed > 90:
                _fail("phase 20 (c): slot 1 did not serve again in 90 s")
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{r0['port']}/recommend?user="
                        f"{users[queries % len(users)]}&n=10",
                        timeout=10) as r:
                    failed += r.status != 200
            except OSError:
                failed += 1
            queries += 1
            r1b = _fleet_serving(fleet_dir, 1, live, not_pid=r1["pid"])
        serving = time.monotonic()
        got = _fleet_answers(r1b["port"], users)
        if failed or got != want or want[0]["generation"] != live:
            _fail(f"phase 20 (c): {failed} of {queries} queries to replica "
                  f"0 failed; the relaunched replica's answers "
                  f"{'equal' if got == want else 'differ'}")
        fleet.send_signal(signal.SIGTERM)
        rc = fleet.wait(timeout=60)
    finally:
        if fleet.poll() is None:
            fleet.kill()
            fleet.wait()
        err.close()
    with open(os.path.join(tmp, "fleet.err")) as f:
        log = f.read()
    relaunch = _log_unix(log, "relaunching slot 1") - offset
    alive = [pid for pid in (r0["pid"], r1b["pid"])
             if os.path.exists(f"/proc/{pid}")]
    if rc != 0 or "relaunching slot 0" in log or alive:
        _fail(f"phase 20 (c): fleet exit {rc} on SIGTERM, replicas still "
              f"alive {alive}:\n{log[-2000:]}")
    print(f"  {card}: (c) a sparse writer on phase 3's stream (10 ms "
          f"windows, a generation every 5, incremental) in {wall:.4f} s, "
          f"generation {live}; --fleet 2 serving it in {up_s:.2f} s; "
          f"replica 1 SIGKILLed, slot 1 alone relaunched "
          f"{relaunch - killed:.3f} s after the kill (the fleet's log) and "
          f"serving generation {live} {serving - relaunch:.3f} s after its "
          f"relaunch ({serving - killed:.3f} s after the kill); replica 0 "
          f"answered {queries} of "
          f"{queries} /recommend meanwhile (0 failed); {len(users)} "
          f"users' answers of the relaunched replica equal replica 0's; "
          f"the fleet exited 0 on SIGTERM with both replicas gone",
          flush=True)


def phase_supervised(card: str, refs: dict) -> dict:
    """Phase 20. Returns each kernel's launches by process in the
    supervised chaos gangs. The four gangs run at once, beside (c)."""
    import tempfile

    print("phase 20: the gang supervisor (--gang-workers 2) and the replica "
          "fleet (--fleet 2)", flush=True)
    t0 = time.monotonic()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        par = _parity_stream()
        csvs = {"parity": os.path.join(tmp, "parity.csv"),
                "config4": os.path.join(tmp, "config4.csv")}
        _write_csv(csvs["parity"], *par)
        _write_csv(csvs["config4"],
                   *(a[:GANG_EVENTS19] for a in _config4_stream()))
        faults = {k: os.path.join(tmp, f"faults-{k}") for k in "ab"}
        journal = os.path.join(tmp, "b.jsonl")

        def argv_a(tag, chaos):
            return (["-i", csvs["parity"], "-ws", "10", "-s", "0xC0FFEE",
                     "-ic", "500", "-uc", "500", "--backend", "sharded",
                     "--num-items", "5000", "--collective-timeout-s",
                     str(GANG_TIMEOUT19), "--restart-on-failure", "2",
                     "--checkpoint-dir", os.path.join(tmp, f"ck-{tag}"),
                     "--checkpoint-every-windows", str(EVERY19),
                     # Retention would prune the quarantined generation.
                     "--checkpoint-retain", "10"]
                    + (["--inject-fault", "ckpt_commit@1:2:crash",
                        "--fault-state-dir", faults["a"]] if chaos else []))

        def argv_b(tag, chaos):
            return (["-i", csvs["config4"], "-ws", "100", "-s", "4", "-ic",
                     "500", "-uc", "500", "--backend", "sparse",
                     "--num-shards", "2", "--wire-format", "packed",
                     "--collective-timeout-s", str(GANG_TIMEOUT19),
                     "--restart-on-failure", "2", "--journal",
                     f"{journal}.{tag}"]
                    + (["--gang-heartbeat-s", "1", "--gang-stale-after-s",
                        "3", "--inject-fault", FREEZE20, "--fault-state-dir",
                        faults["b"]] if chaos else []))

        # The chaos gangs, the uninterrupted gangs they are held to and
        # (c), all at once: a supervised start is two interpreters deep.
        runs = {k: _gang_supervised(tmp, k, argv(k, k in ("a", "b")))
                for k, argv in (("a", argv_a), ("b", argv_b),
                                ("a0", argv_a), ("b0", argv_b))}
        try:
            _phase20_fleet(card, tmp, csvs["parity"])
            done = {k: _gang_supervised_done(r, f"(a)/(b) gang {k}")
                    for k, r in runs.items()}
        finally:
            for proc, _f, handles, _s in runs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                for h in handles:
                    h.close()
        walls = {k: round(os.path.getmtime(r[1]["err"]) - r[3], 2)
                 for k, r in runs.items()}
        # (a): the dense gang, worker 1 killed at the generation-2 commit.
        (a_out, a_err, a_counts), (a0_out, _e, a0_counts) = (
            done["a"], done["a0"])
        # Worker 1 crashes after renaming its generation 2 into place;
        # worker 0's is quarantined too if it was renamed before the
        # supervisor killed worker 0 (it lags by its save's deflate).
        partials = sorted(n for n in os.listdir(os.path.join(tmp, "ck-a"))
                          if n.endswith(".partial"))
        if (a_out != a0_out or _merged_rows(a_out) != refs["parity"]
                or "state.p1.2.npz.partial" not in partials
                or not set(partials) <= {"state.p0.2.npz.partial",
                                         "state.p1.2.npz.partial"}
                or os.listdir(faults["a"]) != ["fault0.p1.fired"]
                or a_err.count("gang restore vote: committed epoch 1") != 2
                or "gang-restarting" not in a_err):
            _fail(f"phase 20 (a): stdout "
                  f"{'equal' if a_out == a0_out else 'differs'}, partials "
                  f"{partials}, fault markers {os.listdir(faults['a'])}")
        # (b): the sparse gang, worker 1's heartbeat frozen.
        (b_out, b_err, b_counts), (b0_out, _e, b0_counts) = (
            done["b"], done["b0"])
        if (b_out != b0_out or _merged_rows(b_out) != refs["config4"]
                or os.listdir(faults["b"]) != ["fault0.p1.fired"]
                or "gang worker 1 heartbeat stale past 3.0s" not in b_err):
            _fail(f"phase 20 (b): stdout "
                  f"{'equal' if b_out == b0_out else 'differs'}, fault "
                  f"markers {os.listdir(faults['b'])}")
        frozen = os.path.getmtime(os.path.join(faults["b"],
                                               "fault0.p1.fired"))
        kill = _log_unix(b_err, "heartbeat stale past")
        recs = _journal_records(f"{journal}.b")
        first = min(r["wall_unix"] for r in recs if r["attempt"] >= 1)
        # The uninterrupted sparse gang's start-up, from its supervisor's
        # start: the supervisor's config echo (its interpreter and the
        # CLI's imports), the workers' (theirs), both joined (the job
        # path's imports, torch's among them, CUDA, the kernels, the
        # rendezvous), the first window scored (the CSV and one window).
        b0_err, t = done["b0"][1], runs["b0"][3]
        echoes = [line for line in b0_err.splitlines()
                  if "INFO tpu_cooccurrence_torch - input\t" in line]
        steps = [_log_unix(echoes[0], "input"),
                 max(_log_unix(e, "input") for e in echoes[1:3]),
                 max(_log_unix(line, "joined") for line in
                     b0_err.splitlines() if "joined the gloo" in line),
                 min(r["wall_unix"] for r in _journal_records(
                     f"{journal}.b0"))]
        starts = [round(x - t, 3) for x in steps]
        for name, counts in (("score_topk", (a_counts, a0_counts)),
                             ("rect_topk", (b_counts, b0_counts))):
            if min(c[name] for pair in counts for c in pair) <= 0:
                _fail(f"phase 20: a worker launched {name} no time "
                      f"{counts}")
        out["score_topk"] = a_counts = [c["score_topk"] for c in a_counts]
        out["rect_topk"] = b_counts = [c["rect_topk"] for c in b_counts]
        a0_counts = [c["score_topk"] for c in a0_counts]
        b0_counts = [c["rect_topk"] for c in b0_counts]
        print(f"  {card}: (a) phase 3's stream at 10 ms windows, --backend "
              f"sharded, a generation every {EVERY19} windows, "
              f"ckpt_commit@1:2:crash: exit 0 after one gang restart, "
              f"both workers voting epoch 1, quarantined {partials}, "
              f"stdout ({a_out.count(chr(10))} rows) byte-identical to the "
              f"uninterrupted supervised gang's and to one process over a "
              f"two-entry mesh; score_topk launches by worker {a_counts} "
              f"(uninterrupted {a0_counts}, from each worker's stderr, "
              f"--device cuda)", flush=True)
        print(f"  {card}: (b) config 4's first {GANG_EVENTS19} events, "
              f"--backend sparse --num-shards 2 --wire-format packed, "
              f"{FREEZE20}: the supervisor killed the gang "
              f"{kill - frozen:.3f} s after the freeze (beat 2 was "
              f"written 1 s before it; stale past 3 s) and the relaunched "
              f"gang scored its first window {first - kill:.3f} s after the "
              f"kill; stdout ({b_out.count(chr(10))} rows) byte-identical "
              f"to the uninterrupted supervised gang's and to one process "
              f"over a two-entry mesh; rect_topk launches by worker "
              f"{b_counts} (uninterrupted {b0_counts}); the uninterrupted "
              f"gang's start-up, seconds after its supervisor started: "
              f"supervisor's config echo {starts[0]}, both workers' "
              f"{starts[1]}, both joined {starts[2]}, first window scored "
              f"{starts[3]}", flush=True)
        print(f"  supervisors' walls (start to the last stderr line; four "
              f"gangs at once beside the fleet): {walls}", flush=True)
    print(f"  phase 20 done in {time.monotonic() - t0:.1f} s", flush=True)
    return out


# -- phase 21: the autoscaler ---------------------------------------------

#: Phase 21's load: worker 0's windows 2-4 stall 2.5 s each (overloaded
#: under --degrade-window-wall-s 2; the gang-max vote makes them
#: gang-wide), then a crash inside the first rescale's seam.
LOAD21 = ["window_fire@0:" + str(w) + ":delay_ms:2500" for w in (2, 3, 4)]
SEAM21 = "rescale_drain@1:crash"
#: The JAX chaos test's levers (tests/test_autoscale_chaos.py).
AUTOSCALE21 = ["--degrade", "--degrade-window-wall-s", "2.0",
               "--degrade-trip-windows", "3", "--autoscale", "on",
               "--autoscale-min-workers", "2",
               "--autoscale-max-workers", "4",
               "--autoscale-trip-windows", "2",
               "--autoscale-clear-windows", "3",
               "--autoscale-cooldown-windows", "2"]
#: The windows phase 21's gang drains at when the supervisor's poll sees
#: every window: the grow at 4 (windows 2 and 3 trip, window 4 reads the
#: request), the shrink at 10 (windows 5-6 cool down, 7-9 clear, window
#: 10 reads the request).
PREDICTED_DRAINS21 = (4, 10)
#: Where each phase-21 worker writes its result (set by this script for
#: the supervisor, which hands its environment to the workers).
RESULTS_ENV21 = "CHIP_SMOKE_AUTOSCALE_RESULTS"


def _autoscale_worker(argv) -> int:
    """One worker of phase 21's gangs (``chip_smoke.py --autoscale-worker
    ARGV``, spawned by the supervisor of :func:`_autoscale_supervisor`):
    the CLI in this process with the worker's argv, its ``rect_topk``
    count set to 0 just before and read just after, the restore vote and
    the restore timed, and, on a voluntary or clean exit, process 0's
    largest ``rect_topk`` launch saved for :func:`_gang_replay`. Writes a
    result file into ``$CHIP_SMOKE_AUTOSCALE_RESULTS``."""
    import torch

    from tpu_cooccurrence_torch import cli
    from tpu_cooccurrence_torch.job import CooccurrenceJob
    from tpu_cooccurrence_torch.ops import rect_topk as rt
    from tpu_cooccurrence_torch.parallel import sharded_sparse as shs

    largest = {"s": -1}
    launch = shs.rect_topk

    def recording(*args):
        if args[3].shape[0] > largest["s"]:
            largest.update(s=args[3].shape[0], args=tuple(
                a.clone() if torch.is_tensor(a) else a for a in args))
        return launch(*args)

    shs.rect_topk = recording
    took = {}

    def timer(key, fn):
        def timed(*args, **kw):
            start = time.monotonic()
            try:
                return fn(*args, **kw)
            finally:
                took[key] = round(time.monotonic() - start, 4)
        return timed

    cli.agree_restore_topology = timer("vote_s", cli.agree_restore_topology)
    for name in ("restore", "restore_rescaled"):
        setattr(CooccurrenceJob, name,
                timer(f"{name}_s", getattr(CooccurrenceJob, name)))
    pid = int(argv[argv.index("--process-id") + 1])
    workers = int(argv[argv.index("--num-processes") + 1])
    rt.LAUNCHES = 0
    start = time.time()
    rc = cli.main(argv)
    res = {"pid": pid, "workers": workers,
           "attempt": int(os.environ.get("TPU_COOC_ATTEMPT", "0")),
           "rc": rc, "launches": {"rect_topk": rt.LAUNCHES},
           "start_unix": start,
           "end_unix": time.time(), **took}
    base = os.path.join(os.environ[RESULTS_ENV21],
                        f"w{workers}.p{pid}.{os.getpid()}")
    if rc in (0, 86) and pid == 0 and largest["s"] > 0:
        torch.save(largest["args"], base + ".pt")
        res.update(replay=base + ".pt", s=largest["s"],
                   measure="rect_topk")
    with open(base + ".json", "w") as f:
        json.dump(res, f)
    return rc


def _autoscale_supervisor(argv) -> int:
    """Phase 21's gang supervisor (``chip_smoke.py --autoscale-supervisor
    ARGV``): ``tpu_cooccurrence_torch.cli.main(ARGV)`` as an operator
    runs it with ``--gang-workers``, each worker started as
    :func:`_autoscale_worker` instead of ``python -m
    tpu_cooccurrence_torch.cli``."""
    from tpu_cooccurrence_torch import cli
    from tpu_cooccurrence_torch.robustness import gang

    init = gang.GangSupervisor.__init__

    def worker_prefix(self, *args, **kw):
        init(self, *args, **kw)
        self.python = [sys.executable, os.path.abspath(__file__),
                       "--autoscale-worker"]

    gang.GangSupervisor.__init__ = worker_prefix
    return cli.main(argv)


def phase_autoscale(card: str, refs: dict) -> dict:
    """Phase 21. Returns ``rect_topk``'s launches by attempt and process
    in the elastic gang and process 0's largest launch at 4 workers,
    replayed and timed once the gangs have ended."""
    import tempfile

    from tpu_cooccurrence_torch.state import checkpoint as ckpt

    print("phase 21: the autoscaler (--gang-workers 2 --autoscale on), "
          "grown 2 -> 4 and shrunk 4 -> 2 on the one card", flush=True)
    t0 = time.monotonic()
    with tempfile.TemporaryDirectory() as tmp:
        csv = os.path.join(tmp, "config4.csv")
        _write_csv(csv, *(a[:GANG_EVENTS19] for a in _config4_stream()))
        results = os.path.join(tmp, "results")
        os.makedirs(results)
        journal = os.path.join(tmp, "elastic.jsonl")
        ck = os.path.join(tmp, "ck")

        def argv(ck_dir, extra):
            return ["-i", csv, "-ws", "100", "-s", "4", "-ic", "500",
                    "-uc", "500", "--backend", "sparse", "--num-shards",
                    "2", "--checkpoint-dir", ck_dir,
                    "--checkpoint-every-windows", "1",
                    # Retention would prune the markers of the grown
                    # topology's generations.
                    "--checkpoint-retain", "100", "--gang-heartbeat-s",
                    "1", "--collective-timeout-s", "60", *extra]

        chaos = [*AUTOSCALE21, "--restart-on-failure", "1",
                 "--journal", journal,
                 "--fault-state-dir", os.path.join(tmp, "faults")]
        for spec in LOAD21 + [SEAM21]:
            chaos += ["--inject-fault", spec]

        def reference(tag, windows):
            """A fixed 2-worker gang crash-recovered at ``windows``."""
            extra = ["--restart-on-failure", str(len(windows)),
                     "--fault-state-dir", os.path.join(tmp, f"faults-{tag}")]
            for w in windows:
                # Concatenated: the fault-site text scan reads a spec's
                # head.
                extra += ["--inject-fault",
                          "window_fire@0:" + str(w + 1) + ":crash"]
            return _gang_supervised(
                tmp, tag, argv(os.path.join(tmp, f"ck-{tag}"), extra))

        # The reference needs the elastic run's drain windows; it starts
        # beside the elastic gang at the windows the policy gives when
        # every poll sees every window, and runs again after it if the
        # journal shows others.
        elastic = _gang_supervised(tmp, "elastic", argv(ck, chaos),
                                   results=results)
        guess = reference("ref", PREDICTED_DRAINS21)
        try:
            out, err, _c = _gang_supervised_done(elastic,
                                                 "(a) the elastic gang")
            ref_out, ref_err, _c = _gang_supervised_done(
                guess, "(b) the reference")
        finally:
            for proc, _f, handles, _s in (elastic, guess):
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                for h in handles:
                    h.close()
        recs = _journal_records(journal, windows=False)
        # Each drain's record, from whichever worker journaled it (one of
        # the first seam's workers is killed).
        drains = sorted({r["window"]: r for r in recs
                         if "autoscale" in r}.values(),
                        key=lambda r: r["window"])
        windows = [d["window"] for d in drains]
        if len(windows) == 2 and tuple(windows) != PREDICTED_DRAINS21:
            print(f"  (b) drains at windows {windows}, not "
                  f"{list(PREDICTED_DRAINS21)}: the reference again",
                  flush=True)
            ref_out, ref_err, _c = _gang_supervised_done(
                reference("ref2", windows), "(b) the reference")
        scale = [(r["autoscale"], r["from"], r["to"], r["trigger"])
                 for r in drains]
        seqs = [r["seq"] for r in recs if "seq" in r and r["process_id"] == 0]
        last = max(seqs)
        topologies = sorted({w for _g, w in
                             ckpt.topology_committed_generations(ck)})
        levels = {r.get("degradation_level") for r in recs if "seq" in r}
        if (scale != [("grow", 2, 4, "pressure"), ("shrink", 4, 2, "idle")]
                or err.count("gang-restarting") != 1
                or err.count("rescale restore: generation") < 6
                or topologies != [2, 4] or levels != {0}
                or sorted(seqs) != list(range(1, last + 1))):
            _fail(f"phase 21 (a): drains {scale}, "
                  f"{err.count('gang-restarting')} gang restarts, writer "
                  f"topologies {topologies}, ladder levels {levels}, "
                  f"process 0's window seqs {sorted(seqs)}:\n"
                  f"{err[-3000:]}")
        if windows[1] >= last - 1:
            _fail(f"phase 21 (a): the shrink drained at window "
                  f"{windows[1]} of {last}: fewer than two windows after "
                  f"it")
        replay = [w for w in windows if w < last]
        if out != ref_out or ref_err.count("gang-restarting") != len(
                windows):
            _fail(f"phase 21 (b): the elastic gang's stdout "
                  f"{'equals' if out == ref_out else 'differs from'} the "
                  f"fixed gang's recovered at windows {windows}")
        # Tie-aware against phase 19's one process over a two-entry mesh:
        # the same rows and scores, ids equal wherever a score is untied
        # (a restore re-lays each slab in key order).
        mine, theirs = (_table_of(_parse_rows(_merged_rows(out)), 10),
                        _table_of(_parse_rows(refs["config4"]), 10))
        if (mine[0] != theirs[0] or not np.array_equal(mine[1], theirs[1])
                or _tie_aware_mismatches(mine[1], mine[2], theirs[1],
                                         theirs[2])):
            _fail("phase 21 (c): the elastic gang's rows differ from phase "
                  "19's single-process run beyond exactly tied ids")
        tied = int((mine[2] != theirs[2]).sum())
        # Launches by attempt: the worker results, grouped by the gang
        # size in force (a rescale keeps the attempt number).
        res = []
        for name in sorted(os.listdir(results)):
            if name.endswith(".json"):
                with open(os.path.join(results, name)) as f:
                    res.append(json.load(f))
        res.sort(key=lambda r: (r["start_unix"], r["pid"]))
        gangs = []
        for r in res:
            if (not gangs or gangs[-1]["workers"] != r["workers"]
                    or r["pid"] in gangs[-1]["by_process"]):
                gangs.append({"workers": r["workers"],
                              "attempt": r["attempt"], "by_process": {},
                              "rc": {}, "vote_s": [], "restore_s": []})
            g = gangs[-1]
            g["by_process"][r["pid"]] = r["launches"]["rect_topk"]
            g["rc"][r["pid"]] = r["rc"]
            g["vote_s"].append(r.get("vote_s"))
            g["restore_s"].append(r.get("restore_rescaled_s",
                                        r.get("restore_s")))
        grown = [g for g in gangs if g["workers"] == 4]
        if (len(grown) != 1 or sorted(grown[0]["by_process"]) != [0, 1, 2, 3]
                or min(grown[0]["by_process"].values()) <= 0
                or any(min(g["by_process"].values()) <= 0 for g in gangs
                       if g["rc"].get(0) in (0, 86))):
            _fail(f"phase 21: rect_topk launches by gang {gangs}")
        four = next((r for r in res if r["workers"] == 4 and r["pid"] == 0
                     and "replay" in r), None)
        if four is None:
            _fail("phase 21: process 0 of the 4-worker gang saved no launch")
        # Seconds: the decision (the supervisor's log), the drain (the
        # AUTOSCALE record), the relaunched gang's first window (the
        # journals) and the restore vote (each worker's own timer).
        steps = []
        for d, needle in zip(drains, ("decision: grow", "decision: shrink")):
            decided = _log_unix(err, needle)
            first = min(r["wall_unix"] for r in recs if "seq" in r
                        and r["seq"] == d["window"] + 1)
            steps.append((round(d["wall_unix"] - decided, 3),
                          round(first - d["wall_unix"], 3)))
        print(f"  {card}: (a) config 4's first {GANG_EVENTS19} events, "
              f"--backend sparse --num-shards 2, a generation a window, "
              f"--restart-on-failure 1, {', '.join(LOAD21)}, {SEAM21}: "
              f"exit 0; drains {scale} at windows {windows} of {last}; "
              f"one billed restart (the seam crash); writer topologies "
              f"{topologies}; the ladder at NORMAL in all "
              f"{sum('seq' in r for r in recs)} window records; process "
              f"0's window seqs 1..{last} once each", flush=True)
        print(f"  {card}: (a) seconds: grow decision to drain "
              f"{steps[0][0]}, drain to the first window at 4 workers "
              f"{steps[0][1]} (the seam crash's restart included); shrink "
              f"decision to drain {steps[1][0]}, drain to the first window "
              f"at 2 workers {steps[1][1]}; restore vote and restore by "
              f"gang: "
              + "; ".join(f"{g['workers']} workers (attempt "
                          f"{g['attempt']}): vote {g['vote_s']} s, restore "
                          f"{g['restore_s']} s" for g in gangs), flush=True)
        print(f"  {card}: (a) rect_topk launches by gang and process: "
              + "; ".join(f"{g['workers']} workers (attempt "
                          f"{g['attempt']}, exits {g['rc']}): "
                          f"{g['by_process']}" for g in gangs), flush=True)
        print(f"  {card}: (b) stdout ({out.count(chr(10))} rows) "
              f"byte-identical to a fixed 2-worker gang crash-recovered at "
              f"windows {[w + 1 for w in replay]}; (c) merged in item "
              f"order, the same rows and scores as phase 19's one process "
              f"over a two-entry mesh, ids differing on {tied} exactly "
              f"tied lanes", flush=True)
        print("  (d) process 0's largest rect_topk launch at 4 workers, "
              "replayed after the gangs, the card otherwise idle",
              flush=True)
        _gang_replay(four)
    print(f"  phase 21 done in {time.monotonic() - t0:.1f} s", flush=True)
    return {"gangs": gangs, "four": four}


# -- phase 22: benchmark configs 1, 2 and 5 through the CLI -------------


#: Config 1's text (``tpu_cooccurrence/bench/configs.py:33-40``).
TINY_TEXT22 = """the quick brown fox jumps over the lazy dog
pack my box with five dozen liquor jugs
how vexingly quick daft zebras jump
the five boxing wizards jump quickly
sphinx of black quartz judge my vow
the quick onyx goblin jumps over the lazy dwarf
"""
#: Config 5's baskets: the JAX bench's ``BENCH_BASKETS`` default.
BASKETS22 = 20_000
#: Config 5's first events held to the float64 oracle (its wall grows
#: faster than the events: each window rescores whole rows in Python),
#: and half of them, to show the growth.
ORACLE_EVENTS22 = 20_000
CUTS22 = ["-ic", "500", "-uc", "500"]


def _streams22():
    """{name: (stream, CLI flags)} of configs 1, 2 and 5, generated by the
    port's own generators, with the flags of
    ``tpu_cooccurrence/bench/configs.py`` (``--num-items`` from the
    data's largest id, as there)."""
    from tpu_cooccurrence_torch.io.synthetic import (
        instacart_calibrated, ml100k_calibrated, word_cooccurrence_stream)

    def vocab(stream):
        return ["--num-items", str(int(stream[1].max()) + 1)]

    c1 = word_cooccurrence_stream(TINY_TEXT22 * 50)
    c2 = ml100k_calibrated()
    c5 = instacart_calibrated(BASKETS22)
    return {
        "config1": (c1, ["-ws", "1000000", "--skip-cuts", "-s", "1",
                         *vocab(c1)]),
        "config2": (c2, ["-ws", "4000", "-s", "2", *CUTS22, *vocab(c2)]),
        "config5": (c5, ["-ws", "1000", "-s", "5", *CUTS22, "--count-dtype",
                         "int16", *vocab(c5)]),
    }


def _oracle_child22(spec_path: str) -> int:
    """Phase 22's reference, in a child of this script: the port's CLI
    with ``--backend oracle --device cpu`` (float64, on the host) on each
    CSV the spec names; its stdout, counters, row sums by item and wall
    go to ``<csv>.oracle.json``."""
    with open(spec_path) as f:
        spec = json.load(f)
    for path, argv in spec:
        rc, out, wall, job, _ = _cli_job_run(
            ["-i", path, *argv, "--backend", "oracle", "--device", "cpu"])
        to_ext = job.item_vocab.to_external
        with open(path + ".oracle.json", "w") as f:
            json.dump({"rc": rc, "out": out, "wall": wall,
                       "counters": job.counters.as_dict(),
                       "row_sums": {str(to_ext(i)): s for i, s in
                                    job.scorer.global_row_sums.items()
                                    if s}}, f)
    return 0


class _Largest22:
    """While a run lasts: the rows of its largest ``score_topk`` launch
    (a copy) and every host block ``pack_block`` packs (references; the
    largest is picked after the run, off its clock)."""

    def __enter__(self):
        from tpu_cooccurrence_torch.ops import device_scorer as ds

        self._ds, self._score, self._pack = ds, ds.score_topk, ds.pack_block
        self.rows, self.blocks = None, []

        def score(C, rs, rows, observed, k):
            if self.rows is None or rows.shape[0] > self.rows.shape[0]:
                self.rows = rows.clone()
            return self._score(C, rs, rows, observed, k)

        def pack(*args):
            block = self._pack(*args)
            self.blocks.append(block)
            return block

        ds.score_topk, ds.pack_block = score, pack
        return self

    def __exit__(self, *exc):
        self._ds.score_topk, self._ds.pack_block = self._score, self._pack
        return False


def _card_run22(card, what, path, argv, events, fused=False):
    """One counted CLI run of a config on the card (the path's kernel
    counts set to 0 just before and read just after); prints its row.
    Returns the run's record."""
    import torch

    from tpu_cooccurrence_torch.metrics import (OBSERVED_COOCCURRENCES,
                                                ROW_SUM_PROCESS_WINDOW)

    full = ["-i", path, *argv] + (["--fused-window", "on"] if fused else [])
    with _Largest22() as seen:
        (rc, out, wall, job, ingest), counts = _counted(
            "fused" if fused else "chained", lambda: _cli_job_run(full))
    if rc != 0 or not out:
        _fail(f"phase 22 {what}: exit {rc}, {len(out)} bytes of stdout")
    sc = job.scorer
    pairs = job.counters.get(OBSERVED_COOCCURRENCES)
    summed = job.counters.get(ROW_SUM_PROCESS_WINDOW)
    if not (int(sc.row_sums.sum(dtype=torch.int64)) == sc.observed
            == summed > 0):
        _fail(f"phase 22 {what}: row sums, observed {sc.observed} and the "
              f"row-sum counter {summed} disagree")
    largest_cell = max(int(sc.C.max()), -int(sc.C.min()))
    # A cell that wrapped moved C's sum by a multiple of 2^16 off the row
    # sums' (the int16 counts wrap as the reference's Java shorts do).
    wrapped = int(sc.C.sum(dtype=torch.int64)) != summed
    if wrapped and sc.C.dtype != torch.int16:
        _fail(f"phase 22 {what}: C.sum() != the row sums' sum")
    t = job.step_timer
    print(f"  {card}: {what}: {events} events, {pairs} pairs, "
          f"{job.windows_fired} windows; wall {wall:.4f} s, "
          f"{pairs / wall:.1f} pairs/s, sampling "
          f"{t.total_sample_seconds:.4f} s, scorer "
          f"{t.total_score_seconds:.4f} s, ingest {ingest:.4f} s (host "
          f"clock, CLI in this process); launches {counts}, the largest "
          f"score launch {seen.rows.shape[0]} rows; C "
          f"{tuple(sc.C.shape)} {str(sc.C.dtype).split('.')[-1]}, largest "
          f"|cell| {largest_cell} ("
          + ("wrapped: C's sum is off the row sums'" if wrapped else
             "no wraparound: C sums to the row sums' total") + ")",
          flush=True)
    block = max(seen.blocks, key=_valid_pairs) if seen.blocks else None
    return dict(out=out, wall=wall, job=job, counts=counts, rows=seen.rows,
                block=block, argv=full)


def _profiled22(argv):
    """The CLI run again for the profiler, the card drained before it
    stops; returns the run's wall."""
    import torch

    wall = _cli_run(argv)[2]
    torch.cuda.synchronize()
    return wall


def _oracle_gate22(card, what, run, path):
    """The card's run against the oracle child's on the same CSV: the
    counters and every item's row sum exactly equal, every emitted row
    within the oracle comparator."""
    with open(path + ".oracle.json") as f:
        ref = json.load(f)
    if ref["rc"] != 0:
        _fail(f"phase 22 {what}: the oracle exited {ref['rc']}")
    job = run["job"]
    if job.counters.as_dict() != ref["counters"]:
        _fail(f"phase 22 {what}: counters {job.counters.as_dict()} vs the "
              f"oracle's {ref['counters']}")
    sums = job.scorer.row_sums.cpu().numpy()
    dense = np.flatnonzero(sums)
    mine = {str(job.item_vocab.to_external(int(i))): int(sums[i])
            for i in dense}
    if mine != ref["row_sums"]:
        _fail(f"phase 22 {what}: row sums differ from the oracle's on "
              f"{len(set(mine.items()) ^ set(ref['row_sums'].items()))} "
              f"items")
    rows, held = _latest_close(_parse_rows(ref["out"]),
                               _parse_rows(run["out"]))
    print(f"  {card}: {what} against --backend oracle (float64, host, in a "
          f"child of this script): counters and {len(mine)} row sums "
          f"exactly equal; {rows} rows within the oracle comparator (rtol "
          f"1e-4, atol 1e-3; ids held on the {held} rows whose in-row gaps "
          f"all exceed 1e-2); oracle wall {ref['wall']:.4f} s", flush=True)
    return ref["wall"]


def _time_score22(parity: Parity, what, run) -> dict:
    """``score_topk`` at the rows of the run's largest launch, on its
    final state: bit-equal to the plain version, then timed."""
    sc = run["job"].scorer
    rows = run["rows"]
    observed = float(np.float32(sc.observed))
    dtype = str(sc.C.dtype).split(".")[-1]
    parity.check(f"{what}_largest_launch_final_state", sc.C, sc.row_sums,
                 rows, observed, sc.top_k, exact=True)
    m = _measure(f"{what}_largest_launch_S{rows.shape[0]}_I{sc.num_items}_"
                 f"{dtype}", sc.C, sc.row_sums, rows, observed, sc.top_k)
    return {"launches": run["counts"]["score_topk"], **m}


def phase_configs(card: str, parity: Parity,
                  expand_parity: ExpandParity) -> dict:
    import tempfile

    import torch

    print("phase 22: benchmark configs 1, 2 and 5 through the CLI on the "
          "card, held to --backend oracle", flush=True)
    t0 = time.monotonic()
    from tpu_cooccurrence_torch.io.synthetic import write_interactions_csv

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        configs, paths = _streams22(), {}
        for name, (stream, _) in configs.items():
            paths[name] = os.path.join(tmp, f"{name}.csv")
            write_interactions_csv(paths[name], *stream)
        c5_stream, c5_argv = configs["config5"]
        heads = {}
        for n in (ORACLE_EVENTS22 // 2, ORACLE_EVENTS22):
            heads[n] = os.path.join(tmp, f"config5-head{n}.csv")
            write_interactions_csv(heads[n], *(a[:n] for a in c5_stream))
        # The float64 oracle runs beside the card's runs, in two children
        # (configs 1 and 2; config 5's heads) on two other cores.
        children = []
        for i, spec in enumerate((
                [(paths[n], configs[n][1]) for n in ("config1", "config2")],
                [(heads[n], c5_argv) for n in sorted(heads)])):
            path = os.path.join(tmp, f"oracle{i}.json")
            with open(path, "w") as f:
                json.dump(spec, f)
            log = open(os.path.join(tmp, f"oracle{i}.log"), "w+")
            children.append((subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--oracle22",
                 path], stdout=subprocess.DEVNULL, stderr=log), log))
        try:
            runs = {}
            for name, reps in (("config1", 20), ("config2", 1)):
                stream, argv = configs[name]
                runs[name] = _card_run22(card, name, paths[name], argv,
                                         len(stream[0]))
                # Config 1 runs in a few ms: profiled over 20 runs.
                _device_profile(lambda: _profiled22(runs[name]["argv"]),
                                runs[name]["wall"], reps)
            n5 = len(c5_stream[0])
            chained = _card_run22(card, "config5 chained", paths["config5"],
                                  c5_argv, n5)
            _device_profile(lambda: _profiled22(chained["argv"]),
                            chained["wall"])
            fused = _card_run22(card, "config5 --fused-window on",
                                paths["config5"], c5_argv, n5, fused=True)
            _device_profile(lambda: _profiled22(fused["argv"]),
                            fused["wall"])
            if fused["out"] != chained["out"]:
                _fail("phase 22 config5: fused stdout differs from chained")
            _dense_equal(fused["job"], chained["job"],
                         "phase 22 config5 fused vs chained")
            print(f"  {card}: config5 fused and chained: stdout "
                  f"byte-identical ({chained['out'].count(chr(10))} rows), "
                  f"counters, C, row sums and observed exactly equal",
                  flush=True)
            head = _card_run22(card, f"config5's first {ORACLE_EVENTS22} "
                               f"events chained", heads[ORACLE_EVENTS22],
                               c5_argv, ORACLE_EVENTS22)
            del chained["job"]
            torch.cuda.empty_cache()
            print(f"  {card}: the kernels at the largest launches' shapes, "
                  f"on each run's final state (the oracle children beside)",
                  flush=True)
            for name in ("config1", "config2"):
                out[name] = _time_score22(parity, name, runs[name])
            # Fused and chained states are equal: the chained run's
            # largest score launch on the fused run's final state.
            out["config5"] = _time_score22(parity, "config5",
                                           {**chained, "job": fused["job"]})
            sc, block = fused["job"].scorer, fused["block"]
            expand_parity.compare(
                f"config5_largest_launch_N{block.shape[0]}_W"
                f"{block.shape[1] - 4}", sc.C, sc.row_sums,
                torch.from_numpy(block).to("cuda"), reps=5)
            out["config5_expand"] = {
                "launches": fused["counts"]["expand"],
                **_measure_expand(f"config5_largest_launch_N"
                                  f"{block.shape[0]}", sc.C, sc.row_sums,
                                  block)}
            del fused["job"], sc
            torch.cuda.empty_cache()
            for child, log in children:
                try:
                    child.wait(timeout=600)
                except subprocess.TimeoutExpired:
                    _fail("phase 22: an oracle child did not end in 600 s")
                if child.returncode != 0:
                    log.seek(0)
                    _fail(f"phase 22: an oracle child exited "
                          f"{child.returncode}: {log.read()[-2000:]}")
            for name in ("config1", "config2"):
                _oracle_gate22(card, name, runs[name], paths[name])
            _oracle_gate22(card, f"config5's first {ORACLE_EVENTS22} "
                           f"events", head, heads[ORACLE_EVENTS22])
            with open(heads[ORACLE_EVENTS22 // 2] + ".oracle.json") as f:
                half = json.load(f)["wall"]
            print(f"  {card}: the oracle on config5's first "
                  f"{ORACLE_EVENTS22 // 2} events took {half:.4f} s (the "
                  f"whole stream is not run: its wall grows faster than "
                  f"the events)", flush=True)
        finally:
            for child, log in children:
                if child.poll() is None:
                    child.kill()
                    child.wait()
                log.close()
    print(f"  phase 22 done in {time.monotonic() - t0:.1f} s", flush=True)
    return out


def _gang_entry(results, name) -> dict:
    """Kernel ``name``'s phase-19 row: its launches by process, and
    process 0's largest launch, replayed and timed by this script once
    every gang had ended."""
    m = results[0]["measure"]
    return {
        "launches": results[0]["launches"][name],
        "launches_by_process": [r["launches"][name] for r in results],
        "max_abs_err": results[0]["max_abs_err"], "rows": results[0]["s"],
        "ms": m["ms"], "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
        "bound_by": m["bound_by"], "library_ms": None,
    }


def main() -> int:
    try:
        import torch
    except ImportError:
        _fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false: this script needs a "
              "CUDA card")
    # The port must come from this checkout (the directory of this script),
    # never from an installed copy elsewhere.
    import tpu_cooccurrence_torch
    from tpu_cooccurrence_torch.ops import _build

    here = os.path.dirname(os.path.abspath(__file__))
    pkg = os.path.dirname(os.path.abspath(tpu_cooccurrence_torch.__file__))
    if os.path.dirname(pkg) != here:
        _fail(f"tpu_cooccurrence_torch was imported from {pkg}, not from "
              f"the checkout at {here}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("phase 1: card and kernel build", flush=True)
    card = _card_line()
    print(f"  card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    t0 = time.monotonic()
    built = _build.build_all()
    print(f"  built {sorted(built)} in {time.monotonic() - t0:.1f} s",
          flush=True)
    for name, path in built.items():
        with open(path + ".log") as f:
            print(f"  ptxas {name}: " + " | ".join(
                line.strip() for line in f if "registers" in line
                or "spill" in line), flush=True)

    # Wall seconds of each phase (host clock), printed at the end: the
    # script must end within the time limit, so a new phase knows what
    # it may cut.
    took = {1: round(time.monotonic() - t0, 1)}

    def timed(n, fn, *args):
        start = time.monotonic()
        out = fn(*args)
        took[n] = round(time.monotonic() - start, 1)
        return out

    parity, rect_parity, local_parity = Parity(), Parity(), Parity()
    expand_parity = ExpandParity()
    timed(2, phase_kernels, parity)
    timed(3, phase_path_parity)
    main_run = timed(4, phase_main_path, parity, card)
    timed(5, phase_rect_kernel, rect_parity)
    timed(6, phase_sparse_path_parity)
    sparse_run = timed(7, phase_sparse_main_path, rect_parity, card)
    timed(8, phase_expand_kernel, expand_parity)
    fused_run = timed(9, phase_fused_main_path, expand_parity, card,
                      main_run["job"])
    raw_ckpt = timed(10, phase_pipeline_and_resume, card, main_run["job"],
                     sparse_run["job"])
    timed(11, phase_narrow_cells, card, rect_parity, sparse_run["job"],
          raw_ckpt)
    sharded_run = timed(12, phase_sharded, card, local_parity,
                        main_run["job"])
    timed(13, phase_incremental_and_supervised, card)
    sliding_run = timed(14, phase_native_and_sliding, card, parity,
                        main_run["job"])
    large_k = timed(15, phase_large_k_fused_spill, card, parity,
                    rect_parity, local_parity, main_run, sparse_run,
                    sharded_run.pop("block"))
    timed(16, phase_planes, card)
    timed(17, phase_partitioned_and_replica, card)
    sharded_sparse_run = timed(18, phase_sharded_sparse, card, rect_parity,
                               sparse_run["job"])
    gang_run = timed(19, phase_gang, card)
    refs = gang_run.pop("ref")
    supervised = timed(20, phase_supervised, card, refs)
    autoscaled = timed(21, phase_autoscale, card, refs)
    configs = timed(22, phase_configs, card, parity, expand_parity)
    print(f"phase seconds: {took}; all {sum(took.values()):.1f} s",
          flush=True)

    for name, par in (("score_topk", parity),
                      ("score_topk (local block)", local_parity),
                      ("rect_topk", rect_parity),
                      ("expand_scatter", expand_parity)):
        print(f"{name} parity: {par.cases} cases, max_abs_err "
              f"{par.max_abs_err:.3g}", flush=True)
    score = _kernel_entry("score_topk", "pallas_score.py:57", parity,
                          main_run)
    # The same kernel over a local row block, as the sharded backend
    # launches it (the reference's pallas_score_topk_local): launches of
    # phase 12's D = 4 run, timed at the shape that run gave it.
    local = _kernel_entry("score_topk", "pallas_score.py:172", local_parity,
                          sharded_run)
    score["local"] = {k: v for k, v in local.items()
                      if k not in ("name", "route", "source")}
    # Config 3 (phase 14): launches of its full-size sliding run, timed at
    # the shape of that run's largest launch.
    score["sliding"] = {k: v for k, v in _kernel_entry(
        "score_topk", "pallas_score.py:57", parity, sliding_run).items()
        if k not in ("name", "route", "source")}
    # K = 1024 and 4096 (phase 15, the select-and-sort path): launches of
    # the bench runs at that K (score_topk), of config 4 at the defaults at
    # K = 1024 and of the bench stream on the sparse backend at K = 4096
    # (rect_topk); times at the main path's shapes.
    rect = _kernel_entry("rect_topk", "pallas_score.py:214", rect_parity,
                         sparse_run)
    # The same kernel on one shard's slab (phase 18's D = 4 run):
    # launches of that run, timed at its largest per-shard launch.
    rect["sharded"] = {k: v for k, v in _kernel_entry(
        "rect_topk", "pallas_score.py:214", rect_parity,
        sharded_sparse_run).items() if k not in ("name", "route", "source")}
    # Phase 19's two-process gangs: each process's launches, and process
    # 0's largest launch, timed after the gangs (bench: the local block;
    # config 4's cut: one shard's slab).
    score["gang"] = _gang_entry(gang_run["score_topk"], "score_topk")
    rect["gang"] = _gang_entry(gang_run["rect_topk"], "rect_topk")
    # Phase 20's gangs under the supervisor: each worker's launches, from
    # its own stderr (the kernels are timed at phase 19's gang shapes).
    for entry, name in ((score, "score_topk"), (rect, "rect_topk")):
        entry["supervised"] = {"launches": supervised[name][0],
                               "launches_by_process": supervised[name]}
    # Phase 21's elastic gang: launches by gang size and process, and
    # process 0's largest launch at 4 workers, timed after the gangs.
    gangs = autoscaled["gangs"]
    grown = next(g["by_process"] for g in gangs if g["workers"] == 4)
    rect["autoscale"] = {
        **_gang_entry([autoscaled["four"]], "rect_topk"),
        "launches": sum(sum(g["by_process"].values()) for g in gangs),
        "launches_by_process": [grown[p] for p in sorted(grown)],
        "launches_by_gang": [
            {"workers": g["workers"], "attempt": g["attempt"],
             "by_process": dict(sorted(g["by_process"].items()))}
            for g in gangs]}
    for k in TIMED_K:
        score[f"k{k}"] = {**large_k["score"][k],
                          "max_abs_err": parity.max_abs_err}
        rect[f"k{k}"] = {**large_k["rect"][k],
                         "max_abs_err": rect_parity.max_abs_err}
    # Phase 22's configs 1, 2 and 5 through the CLI: each run's launches,
    # and the kernel timed at the rows of its largest launch (config 5:
    # int16 over 49,688 columns; expand_scatter at the fused run's
    # largest block).
    score["configs"] = {name: {"library_ms": None, **configs[name],
                               "max_abs_err": parity.max_abs_err}
                        for name in ("config1", "config2", "config5")}
    expand = _kernel_entry("expand_scatter", "pallas_score.py:442",
                           expand_parity, fused_run)
    expand["config5"] = {**configs["config5_expand"],
                         "max_abs_err": expand_parity.max_abs_err}
    print(card, flush=True)
    print(json.dumps({"kernels": [score, rect, expand]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--gang-child"]:
        # One process of a phase-19 gang, started by phase_gang.
        sys.exit(_gang_child(sys.argv[2]))
    if sys.argv[1:2] == ["--autoscale-supervisor"]:
        # Phase 21's supervisor, started by phase_autoscale.
        sys.exit(_autoscale_supervisor(sys.argv[2:]))
    if sys.argv[1:2] == ["--oracle22"]:
        # Phase 22's float64 reference, started by phase_configs.
        sys.exit(_oracle_child22(sys.argv[2]))
    if sys.argv[1:2] == ["--autoscale-worker"]:
        # One worker of phase 21, spawned by that supervisor.
        sys.exit(_autoscale_worker(sys.argv[2:]))
    sys.exit(main())
