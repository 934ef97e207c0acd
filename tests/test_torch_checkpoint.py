"""Checkpoint / resume of the port's job (``state/checkpoint.py``) on the
CPU, and checkpoints crossing between the port and the JAX package.

A resumed run must continue exactly: a job checkpointed mid-stream (mid
window, mid file) and restored into a fresh job ends with the integer
state (``C`` or the slab's cells, row sums, ``observed``), counters and
rows of the uninterrupted run, on the dense chained path, the fused
window and the sparse slab, serial and pipelined. Rows are bit-equal on
the dense paths; on the sparse path a restore lays the slab out afresh
(each row's cells in key order, where the uninterrupted run keeps them
in arrival order), and the top-K keeps the earliest slot among equal
scores, so there every score is bit-equal and every id whose score is
unique in its row is equal (exact ties may order differently).

Across packages both ways, dense and sparse (at their defaults both
write the packed ``ckpt_codec`` blobs, the sparse slab at int16 cells):
the continuation's integer state equals the JAX uninterrupted run's
exactly, and its rows are in ``topk_parity`` (``rtol=1e-5``,
``atol=1e-4``: XLA's and PyTorch's CPU ``log1p`` differ by a few ulps).

Also: generations, retention and ``LATEST``; a torn newest generation is
quarantined and the restore falls back one; a digest mismatch; every
generation corrupt; the tmp sweep; a config mismatch refused and not
quarantined; ``--count-dtype`` across a restore; the deferred emission
count; and the checkpoints of planes the port does not carry refused
whole (a delta chain, epoch markers, partitioned offsets, a
partition-sampled reservoir), exit 78 through the CLI.
"""

import json
import logging
import os
import shutil
import time

import numpy as np
import pytest

from tpu_cooccurrence.config import Backend, Config as JaxConfig
from tpu_cooccurrence.job import CooccurrenceJob as JaxJob
from tpu_cooccurrence_torch import cli as port_cli
from tpu_cooccurrence_torch.config import Config
from tpu_cooccurrence_torch.io.parse import batched_lines
from tpu_cooccurrence_torch.io.source import FileMonitorSource
from tpu_cooccurrence_torch.io.synthetic import zipfian_interactions
from tpu_cooccurrence_torch.job import CooccurrenceJob
from tpu_cooccurrence_torch.metrics import RESCORED_ITEMS
from tpu_cooccurrence_torch.observability.registry import REGISTRY
from tpu_cooccurrence_torch.ops.device_scorer import DeviceScorer
from tpu_cooccurrence_torch.ops.score_topk import topk_parity
from tpu_cooccurrence_torch.state import checkpoint as ckpt

PATHS = {
    "chained": dict(backend="device", fused_window="off"),
    "fused": dict(backend="device", fused_window="on"),
    "sparse": dict(backend="sparse"),
}
JOB = dict(window_size=10, seed=0xABCD, item_cut=40, user_cut=6)


def zipf_stream(n=6_000, seed=3):
    return zipfian_interactions(n, n_items=250, n_users=100, alpha=1.1,
                                seed=seed, events_per_ms=40)


def port_cfg(tmp_path, path="chained", **kw):
    return Config(**{**JOB, "device": "cpu",
                     "checkpoint_dir": str(tmp_path / "ckpt"),
                     **PATHS[path], **kw})


def feed(job, users, items, ts, chunk=701):
    for lo in range(0, len(users), chunk):
        job.add_batch(users[lo:lo + chunk], items[lo:lo + chunk],
                      ts[lo:lo + chunk])


def table(latest, k=10):
    items = sorted(latest)
    vals = np.full((len(items), k), -np.inf, dtype=np.float32)
    ids = np.full((len(items), k), -1, dtype=np.int64)
    for r, item in enumerate(items):
        for c, (other, score) in enumerate(latest[item]):
            vals[r, c], ids[r, c] = score, other
    return items, vals, ids


def tie_aware_mismatches(gv, gd, wv, wd, rtol, atol):
    """Finite lanes whose ids differ although their score is untied:
    unique in its row under ``rtol``/``atol``, and, in a row holding K
    finite lanes, not equal to its K-th score (a partner past the K-th
    lane may share that score and take the lane instead)."""
    close = lambda a, b: np.isclose(a, b, rtol=rtol, atol=atol)  # noqa
    untied = close(gv[:, :, None], gv[:, None, :]).sum(-1) == 1
    full = np.isfinite(gv[:, -1:])
    untied &= ~(full & close(gv, gv[:, -1:]))
    return int(((gd != wd) & np.isfinite(gv) & untied).sum())


def assert_rows_equal(got, want, ties_may_swap=False):
    """Rows bit-equal; with ``ties_may_swap`` ids may differ only where
    the score is exactly tied."""
    gi, gv, gd = table(got)
    wi, wv, wd = table(want)
    assert gi == wi and len(wi) > 30
    np.testing.assert_array_equal(gv, wv)
    if ties_may_swap:
        assert tie_aware_mismatches(gv, gd, wv, wd, 0.0, 0.0) == 0
    else:
        np.testing.assert_array_equal(gd, wd)


def assert_rows_in_parity(got, want):
    """Scores in ``topk_parity``; ids equal where untied."""
    gi, gv, gd = table(got)
    wi, wv, wd = table(want)
    assert gi == wi and len(wi) > 30
    np.testing.assert_array_equal(np.isfinite(gv), np.isfinite(wv))
    ok, _ = topk_parity(gv, gd, wv, wd, rtol=1e-5, atol=1e-4)
    assert ok
    assert tie_aware_mismatches(gv, gd, wv, wd, 1e-5, 1e-4) == 0


def assert_state_equal(a, b):
    """Integer scorer state of two jobs (either package), exactly; the
    JAX dense ``C`` may be padded past the port's, with zeros."""
    sa, sb = a.scorer.checkpoint_state(), b.scorer.checkpoint_state()
    if "C" in sa:
        n = min(sa["C"].shape[0], sb["C"].shape[0])
        np.testing.assert_array_equal(sa["C"][:n, :n], sb["C"][:n, :n])
        for s in (sa, sb):
            assert not s["C"][n:].any() and not s["C"][:, n:].any()
    else:
        for key in ("rows_key", "rows_cnt"):
            np.testing.assert_array_equal(sa[key], sb[key], err_msg=key)
    n = min(len(sa["row_sums"]), len(sb["row_sums"]))
    np.testing.assert_array_equal(sa["row_sums"][:n], sb["row_sums"][:n])
    for s in (sa, sb):
        assert not np.asarray(s["row_sums"][n:]).any()
    np.testing.assert_array_equal(sa["observed"], sb["observed"])


# -- resume equals uninterrupted ---------------------------------------


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("depth", [0, 2])
def test_resume_equals_uninterrupted(tmp_path, path, depth):
    users, items, ts = zipf_stream()
    half = 2_777  # mid-stream, mid-window
    ref = CooccurrenceJob(port_cfg(tmp_path, path, pipeline_depth=depth))
    feed(ref, users, items, ts)
    ref.finish()

    a = CooccurrenceJob(port_cfg(tmp_path, path, pipeline_depth=depth))
    feed(a, users[:half], items[:half], ts[:half])
    a.checkpoint()
    a.abort()  # abandoned: no finish()

    b = CooccurrenceJob(port_cfg(tmp_path, path, pipeline_depth=depth))
    b.restore()
    assert b.windows_fired == a.windows_fired > 5
    feed(b, users[half:], items[half:], ts[half:])
    b.finish()
    assert b.counters.as_dict() == ref.counters.as_dict()
    assert b.windows_fired == ref.windows_fired
    assert_state_equal(b, ref)
    assert_rows_equal(b.latest, ref.latest, ties_may_swap=path == "sparse")


def _write_csv(path, users, items, ts):
    with open(path, "w") as f:
        for u, i, t in zip(users.tolist(), items.tolist(), ts.tolist()):
            f.write(f"{u},{i},{t}\n")


@pytest.mark.parametrize("path", ["fused", "sparse"])
def test_midfile_checkpoint_resumes_exactly(tmp_path, path):
    """A periodic checkpoint taken while a file is half read resumes at
    the exact line: the abandoned run's source position and buffered
    windows come back, and the resumed run ends equal to an
    uninterrupted one."""
    users, items, ts = zipf_stream()
    f = tmp_path / "in.csv"
    _write_csv(f, users, items, ts)
    ref = CooccurrenceJob(port_cfg(tmp_path, path))
    ref.run(batched_lines(FileMonitorSource(str(f), ref.counters).lines(),
                          batch_size=500))

    class Abandon(Exception):
        pass

    a = CooccurrenceJob(port_cfg(tmp_path, path, pipeline_depth=2,
                                 checkpoint_every_windows=7))
    save = a.checkpoint

    def checkpoint_then_crash(source=None):
        save(source=source)
        raise Abandon

    a.checkpoint = checkpoint_then_crash
    src_a = a.source = FileMonitorSource(str(f), a.counters)
    with pytest.raises(Abandon):
        a.run(batched_lines(src_a.lines(), batch_size=500))
    meta = json.loads((tmp_path / "ckpt" / "meta.json").read_text())
    assert meta["windows_fired"] == 7
    assert meta["source"]["current_file"] == str(f)
    assert 0 < meta["source"]["current_line"] < len(users)
    assert meta["ingest_offsets"]["in_flight"]["path"] == str(f)

    b = CooccurrenceJob(port_cfg(tmp_path, path, pipeline_depth=2,
                                 checkpoint_every_windows=7))
    src_b = b.source = FileMonitorSource(str(f), b.counters)
    b.restore(source=src_b)
    b.run(batched_lines(src_b.lines(), batch_size=500))
    # The resumed run opens the in-flight file once more (a split).
    want = {**ref.counters.as_dict(), "SplitReaderNumSplits": 2}
    assert b.counters.as_dict() == want
    assert_state_equal(b, ref)
    assert_rows_equal(b.latest, ref.latest, ties_may_swap=path == "sparse")


def test_consumed_file_is_not_read_again(tmp_path):
    f = tmp_path / "in.csv"
    f.write_text("1,10,1\n1,11,2\n")
    job = CooccurrenceJob(port_cfg(tmp_path))
    src = FileMonitorSource(str(f), job.counters)
    assert len(list(src.lines())) == 2
    job.checkpoint(source=src)
    job2 = CooccurrenceJob(port_cfg(tmp_path))
    src2 = FileMonitorSource(str(f), job2.counters)
    job2.restore(source=src2)
    assert list(src2.lines()) == []


def test_rewritten_in_flight_file_is_skipped(tmp_path):
    """The in-flight guard: a file rewritten under a mid-file checkpoint
    is skipped, never re-read whole; one grown by appends resumes at the
    checkpointed line."""
    f = tmp_path / "in.csv"
    f.write_text("".join(f"{u},{10 + u},{u}\n" for u in range(20)))
    job = CooccurrenceJob(port_cfg(tmp_path))
    src = FileMonitorSource(str(f), job.counters)
    lines = src.lines()
    for _ in range(5):
        next(lines)
    job.checkpoint(source=src)
    with open(f, "a") as fh:
        fh.write("99,99,99\n")
    grown = FileMonitorSource(str(f), job.counters)
    CooccurrenceJob(port_cfg(tmp_path)).restore(source=grown)
    assert list(grown.lines())[0] == "5,15,5"
    f.write_text("0,0,0\n" * 30)  # rewritten: head-prefix hash differs
    rewritten = FileMonitorSource(str(f), job.counters)
    CooccurrenceJob(port_cfg(tmp_path)).restore(source=rewritten)
    assert list(rewritten.lines()) == []


# -- generations, retention, integrity ---------------------------------


def _gens(tmp_path):
    return sorted(int(p.name.split(".")[1])
                  for p in (tmp_path / "ckpt").glob("state.*.npz"))


def test_periodic_checkpoints_generations_retain_and_latest(tmp_path):
    users, items, ts = zipf_stream(n=3_000)
    job = CooccurrenceJob(port_cfg(tmp_path, checkpoint_every_windows=2,
                                   checkpoint_retain=2))
    feed(job, users, items, ts)
    job.finish()
    ck = tmp_path / "ckpt"
    gens = _gens(tmp_path)
    assert len(gens) == 2 and gens[1] == gens[0] + 1 > 2
    assert (ck / "LATEST").read_text().strip() == f"state.{gens[1]}.npz"
    assert json.loads((ck / "meta.json").read_text())["windows_fired"] == \
        2 * gens[1]
    assert REGISTRY.gauge(ckpt.GENERATION_GAUGE).get() == gens[1]
    assert REGISTRY.gauge(ckpt.COMMIT_BYTES_GAUGE).get() == \
        os.path.getsize(ck / f"state.{gens[1]}.npz")
    b = CooccurrenceJob(port_cfg(tmp_path))
    b.restore()
    assert b.windows_fired == 2 * gens[1]
    b.checkpoint()
    assert _gens(tmp_path) == gens + [gens[1] + 1]


def test_exists(tmp_path):
    ck = tmp_path / "ckpt"
    assert not ckpt.exists(str(ck))
    job = CooccurrenceJob(port_cfg(tmp_path))
    feed(job, *zipf_stream(n=500))
    job.checkpoint()
    assert ckpt.exists(str(ck))
    for p in ck.glob("state.*.npz"):
        p.rename(str(p) + ".corrupt")
    assert not ckpt.exists(str(ck))
    (ck / "state.npz").write_bytes(b"legacy")
    assert ckpt.exists(str(ck))


def test_corrupt_newest_falls_back_a_generation(tmp_path, caplog):
    users, items, ts = zipf_stream(n=3_000)
    job = CooccurrenceJob(port_cfg(tmp_path))
    feed(job, users[:1500], items[:1500], ts[:1500])
    job.checkpoint()
    fired_at_gen1 = job.windows_fired
    feed(job, users[1500:], items[1500:], ts[1500:])
    job.checkpoint()
    newest = tmp_path / "ckpt" / "state.2.npz"
    with open(newest, "r+b") as f:  # one byte flipped mid-file
        f.seek(newest.stat().st_size // 2)
        byte = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([byte[0] ^ 0xFF]))
    before = REGISTRY.gauge(ckpt.QUARANTINE_GAUGE).get()
    b = CooccurrenceJob(port_cfg(tmp_path))
    with caplog.at_level(logging.ERROR, "tpu_cooccurrence_torch.checkpoint"):
        b.restore()
    assert b.windows_fired == fired_at_gen1
    assert (tmp_path / "ckpt" / "state.2.npz.corrupt").exists()
    assert not newest.exists()
    assert (tmp_path / "ckpt" / "LATEST").read_text().strip() == \
        "state.1.npz"
    assert REGISTRY.gauge(ckpt.QUARANTINE_GAUGE).get() == before + 1
    assert any("quarantined" in r.message for r in caplog.records)


def test_digest_mismatch_detected_without_truncation(tmp_path):
    good = {"a": np.arange(10), "b": np.ones(3)}
    path = tmp_path / "state.1.npz"
    digest = np.frombuffer(ckpt.compute_digest(good).encode(), np.uint8)
    np.savez(path, **good, digest_sha256=digest)
    assert ckpt._load_verified(str(path))
    np.savez(path, a=np.arange(10) + 1, b=np.ones(3), digest_sha256=digest)
    with pytest.raises(ckpt.CheckpointCorrupt, match="digest mismatch"):
        ckpt._load_verified(str(path))


def test_digest_matches_the_reference_package(tmp_path):
    from tpu_cooccurrence.state.checkpoint import compute_digest

    arrays = {"C": np.arange(12, dtype=np.int16).reshape(3, 4),
              "observed": np.asarray([5], np.int64),
              "meta_json": np.frombuffer(b"{}", np.uint8)}
    assert ckpt.compute_digest(arrays) == compute_digest(arrays)


def test_all_generations_corrupt_raises(tmp_path):
    job = CooccurrenceJob(port_cfg(tmp_path))
    feed(job, *zipf_stream(n=1_000))
    job.checkpoint()
    for p in (tmp_path / "ckpt").glob("state.*.npz"):
        with open(p, "r+b") as f:
            f.truncate(16)
    with pytest.raises(ckpt.CheckpointCorrupt,
                       match="no checkpoint generation"):
        CooccurrenceJob(port_cfg(tmp_path)).restore()


def test_save_sweeps_orphaned_tmps(tmp_path):
    users, items, ts = zipf_stream(n=1_000)
    job = CooccurrenceJob(port_cfg(tmp_path))
    feed(job, users[:500], items[:500], ts[:500])
    job.checkpoint()
    ck = tmp_path / "ckpt"
    stale, fresh = ck / "deadbeef.tmp", ck / "cafef00d.tmp"
    stale.write_bytes(b"orphan")
    old = time.time() - 3600
    os.utime(stale, (old, old))
    fresh.write_bytes(b"live writer")
    feed(job, users[500:], items[500:], ts[500:])
    job.checkpoint()
    assert not stale.exists() and fresh.exists()


def test_restore_missing_and_legacy_formats(tmp_path):
    job = CooccurrenceJob(port_cfg(tmp_path))
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        job.restore()
    ck = tmp_path / "ckpt"
    ck.mkdir()
    np.savez(ck / "state.npz", item_vocab=np.arange(3))
    with pytest.raises(ValueError, match="no embedded meta_json"):
        job.restore()
    assert (ck / "state.npz").exists()


def test_config_mismatch_refused_and_not_quarantined(tmp_path):
    job = CooccurrenceJob(port_cfg(tmp_path))
    feed(job, *zipf_stream(n=1_000))
    job.checkpoint()
    for bad in (dict(item_cut=99), dict(window_size=20), dict(seed=1)):
        other = CooccurrenceJob(port_cfg(tmp_path, **bad))
        with pytest.raises(ValueError, match="config mismatch"):
            other.restore()
        assert other.windows_fired == 0
    assert _gens(tmp_path) == [1]
    assert not list((tmp_path / "ckpt").glob("*.corrupt"))


def test_restore_ignores_stale_meta_sidecar(tmp_path):
    job = CooccurrenceJob(port_cfg(tmp_path))
    feed(job, *zipf_stream(n=1_000))
    job.checkpoint()
    (tmp_path / "ckpt" / "meta.json").write_text('{"seed": 999}')
    b = CooccurrenceJob(port_cfg(tmp_path))
    b.restore()
    assert b.windows_fired == job.windows_fired


def test_restore_across_count_dtype(tmp_path):
    """int16 counts widen to int32 freely; narrowing is bounds-checked."""
    users, items, ts = zipf_stream(n=2_000)
    a = CooccurrenceJob(port_cfg(tmp_path, count_dtype="int16"))
    feed(a, users, items, ts)
    a.checkpoint()
    b = CooccurrenceJob(port_cfg(tmp_path))
    b.restore()
    assert b.scorer.C.element_size() == 4
    np.testing.assert_array_equal(b.scorer.checkpoint_state()["C"],
                                  a.scorer.checkpoint_state()["C"])
    big = DeviceScorer(32, 5, device="cpu")
    st = big.checkpoint_state()
    st["C"][1, 1] = 70_000
    with pytest.raises(ValueError, match="int16"):
        DeviceScorer(32, 5, count_dtype="int16",
                     device="cpu").restore_state(st)


def test_deferred_resume_keeps_real_emission_count(tmp_path):
    users, items, ts = zipf_stream(n=2_000)
    a = CooccurrenceJob(port_cfg(tmp_path, "sparse"))
    assert a.scorer.defer_results
    feed(a, users, items, ts)
    a.checkpoint()
    rescored, real = a.counters.get(RESCORED_ITEMS), a.emissions
    assert rescored > real
    b = CooccurrenceJob(port_cfg(tmp_path, "sparse"))
    b.restore()
    assert b.emissions == real
    c = CooccurrenceJob(port_cfg(tmp_path, "sparse", emit_updates=True))
    c.restore()
    assert c.emissions == rescored


# -- what the port refuses ---------------------------------------------


def _rewrite_newest(tmp_path, meta_update=None, extra=None):
    """Re-commit the newest generation with meta or arrays changed (the
    digest recomputed, so only the refusal can stop it)."""
    path = tmp_path / "ckpt" / f"state.{_gens(tmp_path)[-1]}.npz"
    with np.load(path) as f:
        arrays = {k: f[k] for k in f.files if k != "digest_sha256"}
    meta = json.loads(bytes(arrays["meta_json"]).decode())
    meta.update(meta_update or {})
    arrays["meta_json"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    arrays.update(extra or {})
    arrays["digest_sha256"] = np.frombuffer(
        ckpt.compute_digest(arrays).encode(), np.uint8)
    np.savez_compressed(path, **arrays)


def _jax_incremental_dir(tmp_path):
    users, items, ts = zipf_stream(n=2_000)
    job = JaxJob(JaxConfig(**JOB, backend=Backend.SPARSE,
                           checkpoint_dir=str(tmp_path / "ckpt"),
                           checkpoint_incremental=True))
    job.add_batch(users[:1000], items[:1000], ts[:1000])
    job.checkpoint()
    job.add_batch(users[1000:], items[1000:], ts[1000:])
    job.checkpoint()
    assert list((tmp_path / "ckpt").glob("delta.*.bin"))


def _epoch_marked_dir(tmp_path):
    job = CooccurrenceJob(port_cfg(tmp_path, "sparse"))
    feed(job, *zipf_stream(n=1_000))
    job.checkpoint()
    ck = tmp_path / "ckpt"
    shutil.copy(ck / "state.1.npz", ck / "state.p0.1.npz")
    (ck / "EPOCH.p0.1").write_text("1 2\n")


def _port_dir(tmp_path, **rewrite):
    job = CooccurrenceJob(port_cfg(tmp_path, "sparse"))
    feed(job, *zipf_stream(n=1_000))
    job.checkpoint()
    _rewrite_newest(tmp_path, **rewrite)


REFUSED = {
    "delta_chain": (_jax_incremental_dir, "incremental|plane"),
    "delta_meta": (lambda p: _port_dir(p, meta_update={"ckpt_delta": {
        "v": 1, "base": 0, "prev": 0}}), "incremental"),
    "epoch_markers": (_epoch_marked_dir, "epochs"),
    "partitioned_offsets": (lambda p: _port_dir(p, meta_update={
        "ingest_offsets": {"v": 1, "format": "partitioned"}}),
        "partitioned"),
    "sampler_part": (lambda p: _port_dir(p, extra={
        "sampler_part": np.zeros(2, np.int64)}), "partition-sampling"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_unported_planes_are_refused_whole(tmp_path, case, caplog):
    make, match = REFUSED[case]
    make(tmp_path)
    job = CooccurrenceJob(port_cfg(tmp_path, "sparse"))
    with pytest.raises(ValueError, match=match):
        job.restore()
    assert job.windows_fired == 0 and len(job.latest) == 0
    assert job.counters.get(RESCORED_ITEMS) == 0
    f = tmp_path / "in.csv"
    f.write_text("1,10,1\n")
    rc = port_cli.main(["-i", str(f), "-ws", "10", "-s", str(JOB["seed"]),
                        "-ic", "40", "-uc", "6", "--device", "cpu",
                        "--backend", "sparse",
                        "--checkpoint-dir", str(tmp_path / "ckpt")])
    assert rc == port_cli.EX_CONFIG
    assert "restore refused" in caplog.text


# -- across packages ---------------------------------------------------


def _jax_cfg(tmp_path, path, **kw):
    backend = dict(backend=Backend.SPARSE) if path == "sparse" else dict(
        backend=Backend.DEVICE)
    return JaxConfig(**JOB, checkpoint_dir=str(tmp_path / "ckpt"),
                     **backend, **kw)


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("path", ["chained", "sparse"])
def test_checkpoint_crosses_packages(tmp_path, path, writer):
    """One package checkpoints mid-stream, the other restores and
    finishes; the continuation equals the JAX uninterrupted run."""
    users, items, ts = zipf_stream()
    half = 3_001
    ref = JaxJob(_jax_cfg(tmp_path, path))
    feed(ref, users, items, ts)
    ref.finish()

    make_port = lambda: CooccurrenceJob(port_cfg(tmp_path, path))  # noqa
    make_jax = lambda: JaxJob(_jax_cfg(tmp_path, path))  # noqa
    a, b = ((make_jax(), make_port) if writer == "jax"
            else (make_port(), make_jax))
    feed(a, users[:half], items[:half], ts[:half])
    a.checkpoint()
    if writer == "jax" and path == "sparse":
        with np.load(tmp_path / "ckpt" / "state.1.npz") as f:
            assert "scorer_rows_key__packed" in f.files  # the codec
    b = b()
    b.restore()
    feed(b, users[half:], items[half:], ts[half:])
    b.finish()
    assert b.counters.as_dict() == ref.counters.as_dict()
    assert b.windows_fired == ref.windows_fired
    assert_state_equal(b, ref)
    assert_rows_in_parity(b.latest, ref.latest)


def test_fused_port_checkpoint_restores_in_the_jax_fused_job(tmp_path):
    users, items, ts = zipf_stream()
    ref = JaxJob(_jax_cfg(tmp_path, "fused", fused_window="on"))
    feed(ref, users, items, ts)
    ref.finish()
    a = CooccurrenceJob(port_cfg(tmp_path, "fused", pipeline_depth=2))
    feed(a, users[:2_500], items[:2_500], ts[:2_500])
    a.checkpoint()
    a.abort()
    b = JaxJob(_jax_cfg(tmp_path, "fused", fused_window="on"))
    b.restore()
    feed(b, users[2_500:], items[2_500:], ts[2_500:])
    b.finish()
    assert b.counters.as_dict() == ref.counters.as_dict()
    assert_state_equal(b, ref)
    assert_rows_in_parity(b.latest, ref.latest)
