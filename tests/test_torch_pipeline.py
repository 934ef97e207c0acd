"""The port's pipelined window loop (``--pipeline-depth``, ``pipeline.py``)
on the CPU.

The contract is exact parity: at depth 1 and 2 the pipelined job ends
with the same integer state (``C`` or the slab's cells, row sums,
``observed``), counters and top-K rows as depth 0 on the same seeded Zipf
stream, on the dense chained path, the dense fused window and the sparse
slab, with the feedback edge active and across a checkpoint barrier; and
under ``--emit-updates`` it hands over the same rows window for window.
Plus the lifecycle: an ordered mid-stream close drops nothing, a worker
failure latches and surfaces on the caller, FIFO order, a bounded
staging ring, depth validation. The slice as a whole against the JAX
package: the port at depth 2 against the JAX job at depth 2 (integer
state exact, rows in ``topk_parity``: XLA's and PyTorch's CPU ``log1p``
differ by a few ulps).
"""

import glob

import numpy as np
import pytest

from tpu_cooccurrence.config import Backend, Config as JaxConfig
from tpu_cooccurrence.job import CooccurrenceJob as JaxJob
from tpu_cooccurrence_torch.config import Config
from tpu_cooccurrence_torch.io.synthetic import zipfian_interactions
from tpu_cooccurrence_torch.job import CooccurrenceJob
from tpu_cooccurrence_torch.observability import WindowStats
from tpu_cooccurrence_torch.ops.score_topk import topk_parity
from tpu_cooccurrence_torch.pipeline import (PipelineDriver, PipelineError,
                                             StagedWindow)
from tpu_cooccurrence_torch.state.results import TopKBatch

#: Path name -> the port config fields that select it.
PATHS = {
    "chained": dict(backend="device", fused_window="off"),
    "fused": dict(backend="device", fused_window="on"),
    "sparse": dict(backend="sparse"),
}


def zipf_stream(n=8_000, n_items=300, n_users=120, seed=3):
    return zipfian_interactions(n, n_items=n_items, n_users=n_users,
                                alpha=1.1, seed=seed, events_per_ms=40)


def run_job(path, depth, users, items, ts, chunk=997, collect=False,
            **kw):
    kw.setdefault("item_cut", 50)
    kw.setdefault("user_cut", 30)
    job = CooccurrenceJob(Config(window_size=10, seed=7, device="cpu",
                                 pipeline_depth=depth, **PATHS[path], **kw))
    emitted = []
    if collect:
        # Fires on the worker when pipelined, on the caller when serial:
        # the sequences must be identical all the same (FIFO scoring).
        job.on_update = lambda out: emitted.append(
            (out.rows.copy(), out.idx.copy(), out.vals.copy()))
    for lo in range(0, len(users), chunk):
        job.add_batch(users[lo:lo + chunk], items[lo:lo + chunk],
                      ts[lo:lo + chunk])
    job.finish()
    return job, emitted


def assert_jobs_identical(a, b):
    """Counters, integer scorer state and every top-K row exactly equal."""
    assert a.counters.as_dict() == b.counters.as_dict()
    assert a.windows_fired == b.windows_fired
    sa, sb = a.scorer.checkpoint_state(), b.scorer.checkpoint_state()
    assert sa.keys() == sb.keys()
    for key in sa:
        np.testing.assert_array_equal(sa[key], sb[key], err_msg=key)
    assert set(a.latest) == set(b.latest) and len(a.latest) > 50
    for item in a.latest:
        assert a.latest[item] == b.latest[item], item


# -- exact serial-vs-pipelined parity ----------------------------------


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("depth", [1, 2])
def test_parity_final_state(path, depth):
    users, items, ts = zipf_stream()
    serial, _ = run_job(path, 0, users, items, ts)
    piped, _ = run_job(path, depth, users, items, ts)
    assert_jobs_identical(serial, piped)
    assert piped.pipeline.windows_processed == piped.windows_fired > 10


@pytest.mark.parametrize("path", sorted(PATHS))
def test_parity_every_window(path):
    """Under --emit-updates every window's rows arrive in the serial
    order and are equal, window for window."""
    users, items, ts = zipf_stream()
    _, serial = run_job(path, 0, users, items, ts, collect=True,
                        emit_updates=True)
    _, piped = run_job(path, 2, users, items, ts, collect=True,
                       emit_updates=True)
    assert len(serial) == len(piped) > 10
    for (ra, ia, va), (rb, ib, vb) in zip(serial, piped):
        np.testing.assert_array_equal(ra, rb)
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_array_equal(va, vb)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_parity_with_feedback_edge(path):
    """Tight cuts reject events; the feedback decrement stays on the
    sampling thread and lands before the next window fires."""
    users, items, ts = zipf_stream()
    serial, _ = run_job(path, 0, users, items, ts, item_cut=8, user_cut=4,
                        development_mode=True)
    piped, _ = run_job(path, 2, users, items, ts, item_cut=8, user_cut=4,
                       development_mode=True)
    assert_jobs_identical(serial, piped)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_parity_across_checkpoint_barrier(tmp_path, path):
    """Periodic checkpoints barrier the pipeline; the snapshot, and all
    that follows, equals the serial path's: the newest generations of
    both runs carry the same digest."""
    users, items, ts = zipf_stream()
    serial, _ = run_job(path, 0, users, items, ts, user_cut=6,
                        checkpoint_dir=str(tmp_path / "s"),
                        checkpoint_every_windows=3)
    piped, _ = run_job(path, 2, users, items, ts, user_cut=6,
                       checkpoint_dir=str(tmp_path / "p"),
                       checkpoint_every_windows=3)
    assert_jobs_identical(serial, piped)
    assert piped.pipeline.windows_processed == piped.windows_fired
    digests = []
    for d in ("s", "p"):
        gens = sorted(glob.glob(str(tmp_path / d / "state.*.npz")),
                      key=lambda p: int(p.split(".")[-2]))
        assert len(gens) == 3  # --checkpoint-retain's default
        with np.load(gens[-1]) as f:
            digests.append(bytes(f["digest_sha256"]))
    assert digests[0] == digests[1]


# -- lifecycle: shutdown, drain, failure -------------------------------


@pytest.mark.parametrize("path", ["fused", "sparse"])
def test_mid_stream_close_drops_nothing(path):
    """An ordered close mid-stream scores everything submitted exactly
    once; the driver restarts its worker on the next submit and the run
    still ends equal to serial."""
    users, items, ts = zipf_stream()
    serial, _ = run_job(path, 0, users, items, ts)
    job = CooccurrenceJob(Config(window_size=10, seed=7, item_cut=50,
                                 user_cut=30, device="cpu",
                                 pipeline_depth=2, **PATHS[path]))
    half = len(users) // 2
    job.add_batch(users[:half], items[:half], ts[:half])
    fired_at_close = job.windows_fired
    job.pipeline.close()
    assert job.pipeline.windows_processed == fired_at_close > 0
    assert len(job.step_timer.windows) == fired_at_close
    job.add_batch(users[half:], items[half:], ts[half:])
    job.finish()
    assert job.pipeline.windows_processed == job.windows_fired
    assert_jobs_identical(serial, job)


class _ExplodingScorer:
    accepts_aggregated = False
    defer_results = False

    def process_window(self, ts, pairs):
        raise RuntimeError("boom")

    def flush(self):
        return TopKBatch.empty(10)


class _Recorder:
    accepts_aggregated = False
    defer_results = False
    last_dispatched_rows = 0

    def __init__(self):
        self.seen = []

    def process_window(self, ts, pairs):
        self.seen.append(ts)
        return TopKBatch.empty(10)

    def flush(self):
        return TopKBatch.empty(10)


def test_worker_failure_latches_and_raises():
    """A scorer failure on the worker (a kernel build or launch that fails
    included) surfaces on the caller as PipelineError, and the producer
    never deadlocks against the dead consumer; the raise tears the worker
    down first."""
    job = CooccurrenceJob(Config(window_size=10, seed=7, device="cpu",
                                 pipeline_depth=1),
                          scorer=_ExplodingScorer())
    users, items, ts = zipf_stream(n=4_000)
    with pytest.raises(PipelineError, match="boom"):
        for lo in range(0, len(users), 499):
            job.add_batch(users[lo:lo + 499], items[lo:lo + 499],
                          ts[lo:lo + 499])
        job.finish()
    worker = job.pipeline._worker
    assert worker is None or not worker.is_alive()


def test_worker_failure_surfaces_from_the_cli(tmp_path, monkeypatch):
    """Through the CLI the same failure ends the run with PipelineError,
    never a quiet fall back."""
    from tpu_cooccurrence_torch import cli
    from tpu_cooccurrence_torch.ops import device_scorer

    def broken(*args, **kwargs):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(device_scorer, "score_topk", broken)
    users, items, ts = zipf_stream(n=2_000)
    path = tmp_path / "in.csv"
    path.write_text("".join(f"{u},{i},{t}\n" for u, i, t in
                            zip(users.tolist(), items.tolist(), ts.tolist())))
    with pytest.raises(PipelineError, match="kernel launch failed"):
        cli.main(["-i", str(path), "-ws", "100", "--device", "cpu",
                  "--pipeline-depth", "2"])


def test_submit_order_is_fifo():
    rec = _Recorder()
    job = CooccurrenceJob(Config(window_size=10, seed=7, device="cpu",
                                 pipeline_depth=2), scorer=rec)
    driver = job.pipeline
    for w in range(7):
        driver.submit(StagedWindow(ts=w, payload=None, events=0,
                                   raw_pairs=0, sample_seconds=0.0))
    driver.barrier()
    assert rec.seen == list(range(7))
    driver.close()
    assert driver._worker is None


def test_staging_ring_is_bounded():
    """The sparse scorer takes folded windows through the ring; the ring
    never holds more than depth + 1 slots, and every slot is back by the
    end of the run."""
    users, items, ts = zipf_stream()
    job, _ = run_job("sparse", 2, users, items, ts)
    ring = job.pipeline.ring
    assert ring._free.qsize() == 2 + 1
    dense, _ = run_job("chained", 2, users, items, ts)
    assert dense.pipeline.ring._free.qsize() == 2 + 1


def test_depth_validation():
    with pytest.raises(ValueError, match="pipeline-depth"):
        Config(window_size=100, pipeline_depth=3)
    with pytest.raises(ValueError, match="checkpoint-retain"):
        Config(window_size=100, checkpoint_retain=0)
    with pytest.raises(ValueError):
        PipelineDriver(job=None, depth=0)
    assert Config.from_args(["-i", "x", "-ws", "1", "--pipeline-depth",
                             "2"]).pipeline_depth == 2
    with pytest.raises(SystemExit):  # argparse: not a choice
        Config.from_args(["-i", "x", "-ws", "1", "--pipeline-depth", "3"])


def test_occupancy_reports_both_stages_and_the_queue():
    users, items, ts = zipf_stream(n=6_000)
    job, _ = run_job("sparse", 1, users, items, ts)
    pipe = job.pipeline
    occ = job.step_timer.occupancy(1.0, pipe)
    assert set(occ) == {"host_busy_pct", "score_busy_pct", "wall_seconds",
                        "queue_wait_seconds", "ring_stall_seconds",
                        "scorer_busy_seconds"}
    assert occ["host_busy_pct"] > 0 and occ["score_busy_pct"] > 0
    assert pipe.scorer_busy_seconds == pytest.approx(
        job.step_timer.total_score_seconds)
    assert set(job.step_timer.occupancy(1.0)) == {
        "host_busy_pct", "score_busy_pct", "wall_seconds"}


def test_window_stats_come_from_the_worker():
    """Pipelined, each window's stats are recorded by the worker with the
    producer's sampling seconds and pre-fold pair count."""
    users, items, ts = zipf_stream(n=4_000)
    serial, _ = run_job("sparse", 0, users, items, ts)
    piped, _ = run_job("sparse", 2, users, items, ts)
    key = lambda w: (w.timestamp, w.events, w.pairs, w.rows_scored)  # noqa
    assert ([key(w) for w in serial.step_timer.windows]
            == [key(w) for w in piped.step_timer.windows])
    assert all(isinstance(w, WindowStats) and w.sample_seconds > 0
               for w in piped.step_timer.windows)


# -- the slice as a whole against the JAX package ----------------------


@pytest.mark.parametrize("path", sorted(PATHS))
def test_pipelined_port_matches_pipelined_jax_job(path):
    users, items, ts = zipf_stream()
    kw = dict(window_size=10, seed=7, item_cut=50, user_cut=6,
              pipeline_depth=2)
    port, _ = run_job(path, 2, users, items, ts, user_cut=6)
    jax_kw = dict(backend=Backend.SPARSE) if path == "sparse" else dict(
        backend=Backend.DEVICE, fused_window=PATHS[path]["fused_window"])
    ref = JaxJob(JaxConfig(**kw, **jax_kw))
    for lo in range(0, len(users), 997):
        ref.add_batch(users[lo:lo + 997], items[lo:lo + 997],
                      ts[lo:lo + 997])
    ref.finish()
    assert port.counters.as_dict() == ref.counters.as_dict()
    a, b = port.scorer.checkpoint_state(), ref.scorer.checkpoint_state()
    if path == "sparse":
        for key in ("rows_key", "rows_cnt", "observed"):
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        n = min(len(a["row_sums"]), len(b["row_sums"]))
        np.testing.assert_array_equal(a["row_sums"][:n], b["row_sums"][:n])
    else:
        n = min(a["C"].shape[0], b["C"].shape[0])
        np.testing.assert_array_equal(a["C"][:n, :n], b["C"][:n, :n])
        np.testing.assert_array_equal(a["row_sums"][:n], b["row_sums"][:n])
        np.testing.assert_array_equal(a["observed"], b["observed"])
    assert_tables_in_parity(port.latest, ref.latest)


def assert_tables_in_parity(got, want, k=10):
    """Same items; per row scores in ``topk_parity`` (``rtol=1e-5``,
    ``atol=1e-4``) and untied ids equal."""
    assert set(got) == set(want) and len(want) > 50
    items = sorted(want)
    tables = []
    for table in (got, want):
        vals = np.full((len(items), k), -np.inf, dtype=np.float32)
        ids = np.full((len(items), k), -1, dtype=np.int64)
        for r, item in enumerate(items):
            for c, (other, score) in enumerate(table[item]):
                vals[r, c], ids[r, c] = score, other
        tables.append((vals, ids))
    (gv, gi), (wv, wi) = tables
    np.testing.assert_array_equal(np.isfinite(gv), np.isfinite(wv))
    ok, mism = topk_parity(gv, gi, wv, wi, rtol=1e-5, atol=1e-4)
    assert ok and mism == 0, (ok, mism)
