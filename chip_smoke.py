"""Quickest proof that the PyTorch/CUDA port builds and runs on the card.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; imports nothing of JAX. Phases, each
fatal on failure:

1. Card: name and power limit; build every kernel from ``csrc/`` (one
   ``nvcc`` per source, started together).
2. Kernel vs plain on the card: ``score_topk`` (kernel) against
   ``score_topk_reference`` under ``topk_parity`` on edge cases and two
   full-width shapes, with times (CUDA events), bounds and the
   ``torch.topk`` selection-only yardstick. Also: the int16
   scatter-add (``index_put_`` with accumulate) wraps on the card as on
   the CPU.
3. Path parity: a seeded Zipf stream through ``CooccurrenceJob`` on cuda
   and on cpu, int32 and int16: counters, ``C``, row sums and
   ``observed`` exactly equal, final rows in ``topk_parity``.
4. Main path at full width: the bench workload (400k events, 20k items)
   through ``CooccurrenceJob`` on cuda, with the kernel launch counter
   reset just before and read just after; invariants checked; the kernel
   then timed at the shapes that run gave it.

The last lines: the card, a ``{"kernels": [...]}`` JSON line and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

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


def _bound(C, rows, k: int):
    """Least time for the same work: bytes (C rows, row sums, rows and
    the outputs, each once) over HBM rate vs 8 ops per nonzero cell of
    the scored rows over the f32 rate."""
    import torch

    s, n = rows.shape[0], C.shape[0]
    nbytes = s * n * C.element_size() + 4 * n + 4 * s + s * k * 8
    nnz = 0
    for lo in range(0, s, 1024):
        nnz += int((C[rows[lo:lo + 1024].long()] != 0).sum(
            dtype=torch.int64))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nnz * OPS_PER_CELL / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _reference_chunked(C, rs, rows, observed, k, chunk=2048):
    """The plain version in row chunks (bounds its [S, I] temporaries)."""
    import torch

    from tpu_cooccurrence_torch.ops.score_topk import score_topk_reference

    parts = [score_topk_reference(C, rs, rows[lo:lo + chunk], observed, k)
             for lo in range(0, rows.shape[0], chunk)]
    return (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]))


class Parity:
    """Kernel-vs-plain comparisons; keeps the worst absolute error."""

    def __init__(self) -> None:
        self.max_abs_err = 0.0
        self.cases = 0

    def check(self, name, C, rs, rows, observed, k):
        from tpu_cooccurrence_torch.ops.score_topk import (score_topk,
                                                           topk_parity)

        kv, ki = score_topk(C, rs, rows, observed, k)
        pv, pi = _reference_chunked(C, rs, rows, observed, k)
        import torch

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
        self.max_abs_err = max(self.max_abs_err, err)
        self.cases += 1
        print(f"  parity {name}: ok (max_abs_err {err:.3g})", flush=True)


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


def _measure(name, C, rs, rows, observed, k, reps=10):
    """Kernel, plain and torch.topk-yardstick times plus the bound."""
    import torch

    from tpu_cooccurrence_torch.ops.score_topk import score_topk

    ms = _time_ms(lambda: score_topk(C, rs, rows, observed, k), reps)
    plain_ms = _time_ms(
        lambda: _reference_chunked(C, rs, rows, observed, k), 3)
    # Yardstick for the selection alone: torch.topk on a materialized
    # [S, I] f32 score matrix (never called by the port).
    scores = torch.rand((rows.shape[0], C.shape[0]), device="cuda")
    topk_ms = _time_ms(lambda: torch.topk(scores, k, dim=1), reps)
    del scores
    bound_ms, bound_by = _bound(C, rows, k)
    print(f"  time {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"torch.topk yardstick {topk_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by})", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, topk_ms=topk_ms,
                bound_ms=bound_ms, bound_by=bound_by)


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


def _run_job(device, count_dtype, users, items, ts, num_items=0):
    from tpu_cooccurrence_torch.config import Config
    from tpu_cooccurrence_torch.job import CooccurrenceJob

    cfg = Config(window_size=100, seed=0xC0FFEE, item_cut=500, user_cut=500,
                 num_items=num_items, count_dtype=count_dtype, device=device)
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


def phase_path_parity() -> None:
    from tpu_cooccurrence_torch.io.synthetic import zipfian_interactions
    from tpu_cooccurrence_torch.ops import score_topk as st
    from tpu_cooccurrence_torch.ops.score_topk import topk_parity

    print("phase 3: path parity, cuda vs cpu", flush=True)
    users, items, ts = zipfian_interactions(
        60_000, n_items=5_000, n_users=2_000, alpha=1.1, seed=3,
        events_per_ms=200)
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


def _device_profile(users, items, ts, elapsed: float) -> None:
    """The main path once more under ``torch.profiler``: device time by
    kernel, and its share of the counted run's wall time (the device's
    busy share; its launches are made after the counts were read)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, prof_elapsed = _run_job("cuda", "int32", users, items, ts,
                                   num_items=20_000)
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

    from tpu_cooccurrence_torch.io.synthetic import zipfian_interactions
    from tpu_cooccurrence_torch.metrics import OBSERVED_COOCCURRENCES
    from tpu_cooccurrence_torch.ops import score_topk as st

    print("phase 4: main path at full width (bench workload)", flush=True)
    users, items, ts = zipfian_interactions(
        400_000, n_items=20_000, n_users=5_000, alpha=1.1, seed=3,
        events_per_ms=200)
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
    _device_profile(users, items, ts, elapsed)

    # The kernel at the shape the main path gave it: the final C, one
    # full score chunk of touched rows.
    touched = torch.nonzero(sc.row_sums).flatten().to(torch.int32)
    rows = touched[:sc.max_score_rows].contiguous()
    parity.check("main_path_final_state", sc.C, sc.row_sums, rows,
                 float(np.float32(obs)), sc.top_k)
    m = _measure(f"main_path_S{rows.shape[0]}_I{sc.num_items}_int32",
                 sc.C, sc.row_sums, rows, float(np.float32(obs)), sc.top_k)
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

    print(f"kernel parity: {parity.cases} cases, max_abs_err "
          f"{parity.max_abs_err:.3g}", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": "score_topk",
        "route": "cuda",
        "source": "tpu_cooccurrence_torch/csrc/score_topk.cu",
        "replaces": "tpu_cooccurrence/ops/pallas_score.py:57",
        "launches": main_run["launches"],
        "max_abs_err": parity.max_abs_err,
        "ms": main_run["ms"],
        "plain_ms": main_run["plain_ms"],
        "bound_ms": main_run["bound_ms"],
        "bound_by": main_run["bound_by"],
        "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
