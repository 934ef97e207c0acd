"""The port's sharded dense backend
(``tpu_cooccurrence_torch.parallel.sharded.ShardedScorer``, ``device="cpu"``)
against the JAX package's ``ShardedScorer`` (``use_pallas="off"``, on the
8-device virtual CPU mesh of ``tests/conftest.py``) and against the port's
own ``DeviceScorer``, over the same seeded windows of ``PairDeltaBatch``es.

- Integer state (``C``, row sums, ``observed``, the two cross-backend
  counters, the capacity) must be EXACTLY equal to the JAX scorer's after
  every window, at 1, 2, 4 and 8 shards, int32, int16 (wrapping) and with
  derive-from-data growth. The rows each window returns (the previous
  window's: both keep the one-window-deep pipeline) come in the same order
  and are held to ``topk_parity`` (``rtol=1e-5, atol=1e-4``: XLA's and
  PyTorch's CPU ``log1p`` differ by a few ulps; a score of ~1e3 has an
  ulp of ~6e-5).
- Against the port's ``DeviceScorer`` the rows are bit-identical: the
  same plain version on the same counts.
- Checkpoints restore in both directions and under another shard count
  or capacity; a multi-host ``C_local`` checkpoint is refused.
- The CLI: ``--backend sharded --num-shards 4 --device cpu`` against the
  JAX CLI under ``test_cli_matches_jax_on_a_zipf_stream``'s comparator,
  and byte-identical to the port's dense backend.
"""

import numpy as np
import pytest
import torch

from tpu_cooccurrence import cli as jax_cli
from tpu_cooccurrence.config import Backend, Config as JaxConfig
from tpu_cooccurrence.io.synthetic import zipfian_interactions
from tpu_cooccurrence.metrics import RESCORED_ITEMS, ROW_SUM_PROCESS_WINDOW
from tpu_cooccurrence.parallel.sharded import ShardedScorer as JaxSharded
from tpu_cooccurrence.sampling.reservoir import PairDeltaBatch as JaxPairs
from tpu_cooccurrence_torch import cli as port_cli
from tpu_cooccurrence_torch.ops import device_scorer as ds
from tpu_cooccurrence_torch.ops.score_topk import topk_parity
from tpu_cooccurrence_torch.parallel import mesh as port_mesh
from tpu_cooccurrence_torch.parallel.sharded import ShardedScorer
from tpu_cooccurrence_torch.sampling.reservoir import PairDeltaBatch

from test_torch_cli import (STREAM, _assert_latest_close, _emitted_lines,
                            _fixture_csv, _parse, _run)

RTOL, ATOL = 1e-5, 1e-4
TOP_K = 10
#: A small score chunk, so a window's rows span several chunks per shard
#: and the order rows come back in is exercised.
CHUNK = 64


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One torch intra-op thread while a test runs: these tensors are
    small, and under a parallel test run the default thread pool's
    workers wait on each other for most of the wall time."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _windows(seed, hi_ids, n_pairs=2500, big=0):
    """Seeded window pair deltas, window w over ids ``[0, hi_ids[w])``:
    mostly +1 with some -1, and ``big`` cells a window whose delta drives
    int16 counts past the short range."""
    rng = np.random.default_rng(seed)
    out = []
    for hi in hi_ids:
        src = rng.integers(0, hi, n_pairs).astype(np.int64)
        dst = rng.integers(0, hi, n_pairs).astype(np.int64)
        delta = np.where(rng.random(n_pairs) < 0.9, 1, -1).astype(np.int32)
        if big:
            src[:big] = np.arange(big) % hi
            dst[:big] = (np.arange(big) * 7 + 1) % hi
            delta[:big] = 20_000
        out.append((src, dst, delta))
    return out


def _port_pairs(w):
    return PairDeltaBatch(*(a.copy() for a in w))


def _jax_pairs(w):
    return JaxPairs(*(a.copy() for a in w))


def _assert_state_equal(got, want):
    """Integer state exactly equal on the common capacity, and zero past
    it on the larger side (a restore may pad to another shard count)."""
    n = min(len(got["row_sums"]), len(want["row_sums"]))
    for st in (got, want):
        assert not st["C"][n:].any() and not st["C"][:, n:].any()
        assert not st["row_sums"][n:].any()
    assert got["C"].dtype == want["C"].dtype
    np.testing.assert_array_equal(got["C"][:n, :n], want["C"][:n, :n])
    np.testing.assert_array_equal(got["row_sums"][:n], want["row_sums"][:n])
    np.testing.assert_array_equal(got["observed"], want["observed"])


def _assert_rows_parity(got, want):
    np.testing.assert_array_equal(got.rows, want.rows)
    np.testing.assert_array_equal(np.isfinite(got.vals),
                                  np.isfinite(want.vals))
    ok, mism = topk_parity(got.vals, got.idx, want.vals, want.idx,
                           rtol=RTOL, atol=ATOL)
    assert ok and mism == 0, (ok, mism)


MODES = {
    "int32": dict(num_items=300, count_dtype="int32", big=0,
                  hi=[300, 300, 300, 300]),
    "int16": dict(num_items=300, count_dtype="int16", big=40,
                  hi=[300, 300, 300, 300]),
    # Derive from data: the capacity starts at 64 rows a shard and grows,
    # resharding, as the ids climb.
    "growth": dict(num_items=0, count_dtype="int32", big=0,
                   hi=[100, 700, 700, 1500]),
}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("num_shards", [1, 2, 4, 8])
def test_state_exact_and_rows_in_parity_with_jax(num_shards, mode):
    m = MODES[mode]
    port = ShardedScorer(m["num_items"], TOP_K, num_shards=num_shards,
                         max_score_rows_per_call=CHUNK,
                         count_dtype=m["count_dtype"], device="cpu")
    ref = JaxSharded(m["num_items"], TOP_K, num_shards=num_shards,
                     max_score_rows_per_call=CHUNK,
                     count_dtype=m["count_dtype"], use_pallas="off")
    assert port.num_items == ref.num_items
    for w in _windows(num_shards, m["hi"], big=m["big"]):
        got = port.process_window(0, _port_pairs(w))
        want = ref.process_window(0, _jax_pairs(w))
        assert (port.num_items, port.rows_per_shard) == (
            ref.num_items, ref.rows_per_shard)
        assert port.last_dispatched_rows == ref.last_dispatched_rows > 0
        _assert_state_equal(port.checkpoint_state(), ref.checkpoint_state())
        _assert_rows_parity(got, want)
    _assert_rows_parity(port.flush(), ref.flush())
    for name in (RESCORED_ITEMS, ROW_SUM_PROCESS_WINDOW):
        assert port.counters.get(name) == ref.counters.get(name) > 0
    if mode == "int16":
        assert (port.checkpoint_state()["C"] < 0).any(), "no wraparound"
    if mode == "growth":
        assert port.num_items >= 1500


@pytest.mark.parametrize("num_shards", [1, 3, 4])
@pytest.mark.parametrize("count_dtype", ["int32", "int16"])
def test_rows_bit_identical_to_the_dense_scorer(num_shards, count_dtype):
    """The sharded scorer one window late equals the dense scorer's
    window, row for row, bit for bit; the integer state is equal."""
    sharded = ShardedScorer(0, TOP_K, num_shards=num_shards,
                            max_score_rows_per_call=CHUNK,
                            count_dtype=count_dtype, device="cpu")
    dense = ds.DeviceScorer(0, TOP_K, count_dtype=count_dtype, device="cpu")
    wins = _windows(7, [200, 900, 900, 900],
                    big=30 if count_dtype == "int16" else 0)
    outs = [sharded.process_window(0, _port_pairs(w)) for w in wins]
    outs.append(sharded.flush())
    assert len(outs[0]) == 0
    for w, got in zip(wins, outs[1:]):
        want = dense.process_window(0, _port_pairs(w))
        order = np.argsort(got.rows, kind="stable")
        np.testing.assert_array_equal(got.rows[order], want.rows)
        np.testing.assert_array_equal(got.vals[order], want.vals)
        np.testing.assert_array_equal(got.idx[order], want.idx)
    _assert_state_equal(sharded.checkpoint_state(), dense.checkpoint_state())


def test_empty_window_drains_the_pipeline():
    port = ShardedScorer(64, TOP_K, num_shards=2, device="cpu")
    first = port.process_window(0, _port_pairs(_windows(1, [64])[0]))
    assert len(first) == 0
    out = port.process_window(1, PairDeltaBatch.concat([]))
    assert len(out) > 0 and port.last_dispatched_rows == 0
    assert len(port.flush()) == 0


def test_fixed_capacity_rejects_overflow():
    port = ShardedScorer(100, TOP_K, num_shards=2, device="cpu")
    w = (np.array([5, 150]), np.array([150, 5]), np.ones(2, dtype=np.int32))
    with pytest.raises(ValueError, match="capacity"):
        port.process_window(0, PairDeltaBatch(*w))


def _run_both(port, ref, wins):
    for w in wins:
        port.process_window(0, _port_pairs(w))
        ref.process_window(0, _jax_pairs(w))


@pytest.mark.parametrize("count_dtype", ["int32", "int16"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_restores_across_packages_and_shard_counts(direction,
                                                              count_dtype):
    """A JAX ``ShardedScorer`` at 2 shards restores into the port at 4
    (through ``state_from_jax``), and the port's at 4 into the JAX one at
    2; capacity 202 pads to 202 and 204. Both then run on, equal."""
    wins = _windows(9, [202] * 4, big=20 if count_dtype == "int16" else 0)
    port = ShardedScorer(202, TOP_K, num_shards=4, count_dtype=count_dtype,
                         device="cpu")
    ref = JaxSharded(202, TOP_K, num_shards=2, count_dtype=count_dtype,
                     use_pallas="off")
    assert (port.num_items, ref.num_items) == (204, 202)
    writer = ref if direction == "jax_to_port" else port
    cls_pairs = _jax_pairs if writer is ref else _port_pairs
    for w in wins[:2]:
        writer.process_window(0, cls_pairs(w))
    writer.flush()
    st = writer.checkpoint_state()
    if direction == "jax_to_port":
        port.restore_state(ds.state_from_jax(st))
    else:
        ref.restore_state(st)
    _assert_state_equal(port.checkpoint_state(), ref.checkpoint_state())
    _run_both(port, ref, wins[2:])
    _assert_state_equal(port.checkpoint_state(), ref.checkpoint_state())
    _assert_rows_parity(port.flush(), ref.flush())


def test_restore_under_other_shard_counts_and_backends():
    """The port's sharded checkpoint at 4 shards restores at 1 and 3
    shards and into the dense scorer, and the dense scorer's into the
    sharded one; every copy then runs on bit-identical."""
    wins = _windows(11, [250, 250, 250, 250])
    four = ShardedScorer(250, TOP_K, num_shards=4, device="cpu")
    for w in wins[:2]:
        four.process_window(0, _port_pairs(w))
    four.flush()
    st = four.checkpoint_state()
    copies = [ShardedScorer(0, TOP_K, num_shards=1, device="cpu"),
              ShardedScorer(250, TOP_K, num_shards=3, device="cpu"),
              ds.DeviceScorer(250, TOP_K, device="cpu")]
    for c in copies:
        c.restore_state(st)
    assert copies[1].num_items == 252
    back = ShardedScorer(0, TOP_K, num_shards=2, device="cpu")
    back.restore_state(copies[2].checkpoint_state())
    for sc in [four, *copies, back]:
        for w in wins[2:]:
            sc.process_window(0, _port_pairs(w))
    finals = [sc.checkpoint_state() for sc in copies + [back]]
    for got in finals:
        _assert_state_equal(got, four.checkpoint_state())
    want = four.flush()
    for sc in (copies[0], copies[1], back):
        got = sc.flush()
        order = np.argsort(got.rows, kind="stable")
        want_order = np.argsort(want.rows, kind="stable")
        np.testing.assert_array_equal(got.rows[order], want.rows[want_order])
        np.testing.assert_array_equal(got.vals[order], want.vals[want_order])
        np.testing.assert_array_equal(got.idx[order], want.idx[want_order])


def test_multi_host_checkpoint_is_refused():
    st = {"C_local": np.zeros((8, 16), np.int32),
          "row_lo": np.array([8]), "row_sums": np.zeros(16, np.int32),
          "observed": np.array([0])}
    with pytest.raises(ValueError, match="multi-host"):
        ShardedScorer(16, TOP_K, num_shards=2, device="cpu").restore_state(st)
    with pytest.raises(ValueError, match="multi-host"):
        ds.state_from_jax(st)


def test_make_mesh():
    assert port_mesh.make_mesh(3, device="cpu") == [torch.device("cpu")] * 3
    twice = port_mesh.make_mesh(2, devices=["cpu", "cpu"])
    assert twice == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="requested 3 shards but only 2"):
        port_mesh.make_mesh(3, devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="--num-shards must be >= 1"):
        port_mesh.make_mesh(0, device="cpu")
    assert port_mesh.pad_to_multiple(202, 4) == 204


def test_mesh_on_cuda_takes_the_visible_cards(monkeypatch, caplog,
                                             tmp_path):
    """No card: a clear ``DeviceUnavailable`` (the CLI exits 69); with the
    card count faked, more shards than cards is refused as the JAX
    ``make_mesh`` refuses (the CLI exits 78)."""
    from tpu_cooccurrence_torch.device import DeviceUnavailable

    path, _ = _fixture_csv(tmp_path, "u.data")
    argv = ["-i", path, "-ws", "100", "--backend", "sharded",
            "--num-shards", "3"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailable):
        port_mesh.make_mesh(1)
    assert port_cli.main(argv) == port_cli.EX_UNAVAILABLE
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(ValueError, match="requested 3 shards but only 2"):
        port_mesh.make_mesh(3)
    assert port_cli.main(argv) == port_cli.EX_CONFIG
    assert "requested 3 shards but only 2 devices" in caplog.text


# -- the CLI -------------------------------------------------------------


def _zipf_csv(tmp_path):
    users, items, ts = zipfian_interactions(**STREAM)
    path = tmp_path / "zipf.csv"
    with open(path, "w") as f:
        for u, i, t in zip(users.tolist(), items.tolist(), ts.tolist()):
            f.write(f"{u},{i},{t}\n")
    return str(path)


def test_cli_sharded_matches_jax_on_a_zipf_stream(capsys, tmp_path):
    """``--backend sharded --num-shards 4``: every line the port emits
    stands where the JAX CLI's does, for the same item, in
    ``topk_parity`` (``rtol=1e-5, atol=1e-4``: one unit in the rendered
    4th decimal), and the latest rows pass ``_assert_latest_close``."""
    base = ["-i", _zipf_csv(tmp_path), "-s", "0xC0FFEE", "-ws", "100",
            "-uc", "30", "-ic", "200", "--emit-updates", "--backend",
            "sharded", "--num-shards", "4"]
    port = _run(capsys, port_cli.main, base + ["--device", "cpu"])
    ref = _run(capsys, jax_cli.main, base)
    p_items, p_vals, p_ids = _emitted_lines(port, 10)
    j_items, j_vals, j_ids = _emitted_lines(ref, 10)
    assert len(p_items) > 2000, "the stream emitted too few rows"
    assert p_items == j_items
    np.testing.assert_array_equal(np.isfinite(p_vals), np.isfinite(j_vals))
    ok, mism = topk_parity(p_vals, p_ids, j_vals, j_ids, rtol=1e-5,
                           atol=1e-4)
    assert ok and mism == 0, (ok, mism)
    _assert_latest_close(_parse(ref), _parse(port))


@pytest.mark.parametrize("shards,extra", [
    ("1", []), ("3", ["--count-dtype", "int16"]),
    ("4", ["--pipeline-depth", "2"])])
def test_cli_sharded_equals_the_dense_backend(capsys, tmp_path, shards,
                                              extra):
    """The sharded CLI's stdout equals the dense backend's byte for byte
    (with --emit-updates too, window for window), at any shard count and
    depth."""
    path, _ = _fixture_csv(tmp_path, "ratings.csv")
    for emit in ([], ["--emit-updates"]):
        base = ["-i", path, "-s", "0xC0FFEE", "-ws", "1", "-wu", "DAYS",
                "-ic", "4", "-uc", "3", "--device", "cpu", *extra, *emit]
        dense = _run(capsys, port_cli.main, base)
        sharded = _run(capsys, port_cli.main,
                       base + ["--backend", "sharded", "--num-shards", shards])
        assert dense.strip() and sharded == dense


def test_cli_sharded_resumes_under_another_shard_count(capsys, tmp_path):
    """A sharded run checkpointed at 4 shards resumes at 1 and prints what
    an uninterrupted run prints."""
    path = _zipf_csv(tmp_path)
    base = ["-i", path, "-s", "0xC0FFEE", "-ws", "10", "-uc", "30",
            "-ic", "200", "--device", "cpu", "--backend", "sharded"]
    whole = _run(capsys, port_cli.main, base + ["--num-shards", "4"])
    ck = ["--checkpoint-dir", str(tmp_path / "ck")]
    first = _run(capsys, port_cli.main,
                 base + ["--num-shards", "4", *ck,
                         "--checkpoint-every-windows", "3"])
    assert first == whole and list((tmp_path / "ck").glob("state.*.npz"))
    second = _run(capsys, port_cli.main, base + ["--num-shards", "1", *ck])
    assert second == whole


def test_cli_sharded_config_echo_and_errors(capsys, caplog, tmp_path):
    path, _ = _fixture_csv(tmp_path, "u.data")
    caplog.set_level("INFO", logger="tpu_cooccurrence_torch")
    base = ["-i", path, "-ws", "1000000000", "--device", "cpu"]
    assert port_cli.main(base + ["--backend", "sharded",
                                 "--num-shards", "2"]) == 0
    assert "numShards\t2" in caplog.text
    caplog.clear()
    # As in the JAX package: the fused window is not the sharded backend's.
    msg = "--fused-window on is --backend device or sparse only"
    assert port_cli.main(base + ["--backend", "sharded", "--fused-window",
                                 "on"]) == port_cli.EX_CONFIG
    assert msg in caplog.text
    with pytest.raises(ValueError, match=msg):
        JaxConfig(window_size=100, seed=1, backend=Backend.SHARDED,
                  fused_window="on")
    assert port_cli.main(base + ["--backend", "sharded",
                                 "--num-shards", "0"]) == port_cli.EX_CONFIG
    assert "--num-shards must be >= 1" in caplog.text
    # A multi-process sharded run is not ported.
    caplog.clear()
    assert port_cli.main(base + ["--backend", "sharded", "--coordinator",
                                 "localhost:1"]) == port_cli.EX_CONFIG
    assert "not yet ported" in caplog.text
