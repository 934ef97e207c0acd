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
   ``--pipeline-depth`` 0, 1, 2, 2, 1, 0 (in turns), the path's kernel
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
   backend; the defaults at depth 2; a packed resume at int16 and int8.
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

The last lines: the card, a ``{"kernels": [...]}`` JSON line naming all
three kernels (``score_topk`` carries its local-block launches of phase
12 under ``local``) and ``{"ok": true, "device": {...}}``.
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
        """Kernel ``(vals, idx)`` against plain ``(vals, idx)``. ``exact``
        (the tie cases, where ``topk_parity`` does not look at ids): every
        finite lane's score bits and id equal too. Returns the kernel's
        ``(vals, idx)`` on the host."""
        import torch

        from tpu_cooccurrence_torch.ops.score_topk import topk_parity

        (kv, ki), (pv, pi) = kernel_out, plain_out
        torch.cuda.synchronize()
        kv, ki, pv, pi = (t.cpu().numpy() for t in (kv, ki, pv, pi))
        ok, mism = topk_parity(kv, ki, pv, pi, rtol=RTOL, atol=ATOL)
        if not ok or mism:
            _fail(f"{name}: kernel vs plain scores_ok={ok} "
                  f"untied_id_mismatches={mism}")
        if not np.array_equal(np.isfinite(kv), np.isfinite(pv)):
            _fail(f"{name}: -inf lanes differ between kernel and plain")
        fin = np.isfinite(pv)
        err = float(np.abs(kv[fin] - pv[fin]).max()) if fin.any() else 0.0
        if exact and (err != 0.0 or not np.array_equal(ki[fin], pi[fin])):
            _fail(f"{name}: tied lanes differ between kernel and plain "
                  f"(max_abs_err {err:.3g}, "
                  f"{int((ki[fin] != pi[fin]).sum())} ids)")
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
    snap = job.latest.snapshot()
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


def _device_profile(run, elapsed: float) -> None:
    """The main path once more (``run()``, returning its seconds) under
    ``torch.profiler``: device time by kernel, and its share of the
    counted run's wall time (the device's busy share; its launches are
    made after the counts were read)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_elapsed = run()
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.device_time_total / 1e3
    busy_ms = sum(by_name.values())
    if busy_ms <= 0:
        print("  device busy share: not measured (the profiler saw no "
              "device time)", flush=True)
        return
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    print(f"  device busy {busy_ms:.3f} ms = "
          f"{100 * busy_ms / (elapsed * 1e3):.2f}% of the counted run's "
          f"{elapsed:.3f} s (profiled run {prof_elapsed:.3f} s)", flush=True)
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


def _rect_class_cases(parity: Parity, rng, narrow=None) -> None:
    """Cases aimed at the size classes (a warp per short row, a block per
    long row): lengths at the class edges L - 1, L, L + 1, rows of 4,095
    to 12,293 cells and a 100,000-cell row in one block, rows whose cells
    all tie (one count, one partner row sum) in every class, so the
    earliest slots must win across warps and blocks, all-cancelled rows,
    and K = 1, 10, 128. Rows go in the scorer's bucket order; ids must
    equal the plain version's on every finite lane. ``narrow``: a cell
    dtype and its largest count, the cases run at that cell dtype
    (:func:`_narrow_case`)."""
    from tpu_cooccurrence_torch.ops.rect_topk import (
        SHORT_MAX, min_rect_width, rect_topk, rect_topk_reference,
        score_buckets, short_rows)

    edges = [SHORT_MAX - 1, SHORT_MAX, SHORT_MAX + 1, 4095, 4096, 4097,
             12_293, 100_000, 1, 0, 40]
    num_items = 8192
    for k in (1, 10, 128):
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
            got = rect_topk(*t, 1e8, k, n_short)
            _, ki = parity.compare(name, got,
                                   rect_topk_reference(*t, 1e8, k),
                                   exact=True)
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
    return dict(launches=launches, job=job, **m)

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
    """(a) Each path at depths 0, 1, 2, 2, 1, 0 (in turns, for the
    timings), every run exactly equal to the depth-0 run of phase 4 (the
    dense paths: phase 9 equals it) or phase 7 (sparse)."""
    users, items, ts = _bench_stream()
    for path, extra in (("fused", dict(fused_window="on")),
                        ("chained", {})):
        for depth in (0, 1, 2, 2, 1, 0):
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

    for depth in (0, 1, 2, 2, 1, 0):
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


def _resume(card, path, cfg, csv, every, check, make_first=None):
    """Run ``cfg`` over ``csv`` through the file source and the batcher,
    checkpointing every ``every`` windows; drop the run right after the
    first checkpoint commits (no finish()); restore a fresh job from the
    directory and finish from the source's restored position; hold it to
    ``check(job, what)``. ``make_first(cfg)`` builds the first job (by
    default, as the resumed one: ``CooccurrenceJob(cfg)``). Returns the
    dropped job (its state is the checkpoint's), the checkpoint directory
    and the first save's bytes and seconds with the restore's seconds."""
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

    b = CooccurrenceJob(cfg)
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
        dropped, _, _ = _resume(
            card, "fused", cfg, csv, 10,
            lambda job, what: f"state, counters and "
            f"{_dense_equal(job, chained_job, what)} rows exactly equal "
            f"to the uninterrupted depth-0 run")
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
                      ("int32", "raw"), ("int8", "packed"),
                      ("int32", "raw"), ("int16", "raw"),
                      ("int16", "packed"), ("int8", "packed")):
        first = (cell, fmt) not in runs
        cfg = Config(**{**CONFIG4_JOB, "cell_dtype": cell,
                        "wire_format": fmt}, device="cuda")
        job, wall, counts, ledger = _sparse_run(
            cfg, users, items, ts,
            recs[cell] if fmt == "packed" and first else None)
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
        if first:
            runs[(cell, fmt)] = job
        else:
            _sparse_equal(job, runs[(cell, fmt)], f"config 4 {cell} {fmt} "
                          f"again")
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
        csv = os.path.join(tmp, "config4.csv")
        _write_csv(csv, users, items, ts)
        for cell in ("int16", "int8"):
            print(f"  (f) resume on config 4 at {cell} packed, depth 2",
                  flush=True)
            directory = os.path.join(tmp, cell)
            cell_ref = ref
            if cell != "int16":
                cell_ref, _, _, _ = _sparse_run(
                    dataclasses.replace(cfg, cell_dtype=cell), users, items,
                    ts)
            run_cfg = dataclasses.replace(
                cfg, cell_dtype=cell, pipeline_depth=2,
                checkpoint_dir=directory, checkpoint_every_windows=25)

            def check(job, what, want=cell_ref):
                rows, swapped = _sparse_equal(job, want, what,
                                              ties_may_swap=True)
                return (f"slab, counters and {rows} rows' scores exactly "
                        f"equal, ids equal but on {swapped} lanes of "
                        f"exactly tied scores")

            dropped, _, info = _resume(card, "sparse", run_cfg, csv, 25,
                                       check)
            codecs = _codec_of(directory)
            if not codecs or not all(
                    c and c["arrays"].get("scorer_rows_key", [""])[0] == "sdv"
                    for _g, c in codecs):
                _fail(f"{cell}: a generation lacks the packed ckpt_codec: "
                      f"{codecs}")
            promoted = dropped.scorer.promoted_rows
            print(f"    {cell}: {promoted} rows promoted at the window-25 "
                  f"checkpoint; generations {[g for g, _ in codecs]} carry "
                  f"ckpt_codec {sorted(codecs[0][1]['arrays'])}; packed "
                  f"save {info['save_bytes']} bytes in "
                  f"{info['save_s']:.4f} s, restore {info['restore_s']:.4f} "
                  f"s; raw (phase 10) {raw_ckpt['save_bytes']} bytes in "
                  f"{raw_ckpt['save_s']:.4f} s, restore "
                  f"{raw_ckpt['restore_s']:.4f} s", flush=True)
            if cell == "int8" and promoted <= 0:
                _fail("int8 resume: no row promoted before the checkpoint")
            del dropped


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
    """Returns the D = 4 int32 run's launches and the kernel's times at
    the shape that run gave it."""
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
            make_first=lambda c: _sharded_job(c, one * SHARDS))
        del dropped
    return dict(launches=launches, **m)



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

    parity = Parity()
    phase_kernels(parity)
    phase_path_parity()
    main_run = phase_main_path(parity, card)
    rect_parity = Parity()
    phase_rect_kernel(rect_parity)
    phase_sparse_path_parity()
    sparse_run = phase_sparse_main_path(rect_parity, card)
    expand_parity = ExpandParity()
    phase_expand_kernel(expand_parity)
    fused_run = phase_fused_main_path(expand_parity, card, main_run["job"])
    raw_ckpt = phase_pipeline_and_resume(card, main_run["job"],
                                         sparse_run["job"])
    phase_narrow_cells(card, rect_parity, sparse_run["job"], raw_ckpt)
    local_parity = Parity()
    sharded_run = phase_sharded(card, local_parity, main_run["job"])

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
    print(card, flush=True)
    print(json.dumps({"kernels": [
        score,
        _kernel_entry("rect_topk", "pallas_score.py:214", rect_parity,
                      sparse_run),
        _kernel_entry("expand_scatter", "pallas_score.py:442",
                      expand_parity, fused_run),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
