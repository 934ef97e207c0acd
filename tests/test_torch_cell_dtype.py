"""The port's sparse backend at narrow cells (``--cell-dtype int16|int8``,
promotion to the wide int32 side-table) and with the packed uplink,
against the JAX package on the CPU.

- Scorers: the port's ``SparseDeviceScorer(device="cpu")`` against the
  JAX ``SparseDeviceScorer`` at int16 and int8, raw and packed, over a
  stream whose hot pair crosses 32,767 (so also 127) beside Zipf pairs
  and retractions that relocate rows and compact both heaps. After every
  window: ``wide_rows``, both indices (keys, slots, registry, heap end,
  garbage), the live cells of both slabs (``cnt`` and ``dst`` at every
  indexed slot) and the canonical state exactly equal; emitted rows in
  the same order, scores in ``topk_parity`` (``rtol=atol=1e-5``: torch's
  and XLA's CPU ``log1p`` may differ by ulps) and ids equal.
- Promotion before a row's first cell, at both packages.
- The port at int16 against the port at int32: state and every score
  equal; ids equal except on exactly tied lanes (a promoted row's cells
  are re-laid in key order); rows compared per window as sets (narrow
  rows are emitted before wide ones).
- The plain rect kernel at int16 and int8 cells equals its int32 result
  bit for bit.
- The pipelined job (``--pipeline-depth 2``) at narrow cells and packed
  equals depth 0, stream and state.
- Checkpoints: a generation the port writes at int16 or int8, packed,
  restores in the JAX package and the reverse, onto another cell dtype,
  with promoted rows; the continuation's state equals the JAX
  uninterrupted run's. Scorer snapshots taken after int16 promotion
  cross both ways too.
"""

import numpy as np
import pytest
import torch

from tpu_cooccurrence.config import Backend, Config as JaxConfig
from tpu_cooccurrence.job import CooccurrenceJob as JaxJob
from tpu_cooccurrence.observability import LEDGER as JAX_LEDGER
from tpu_cooccurrence.sampling.reservoir import PairDeltaBatch as JaxPairs
from tpu_cooccurrence.state.sparse_scorer import (
    SparseDeviceScorer as JaxSparse)
from tpu_cooccurrence_torch.config import Config
from tpu_cooccurrence_torch.job import CooccurrenceJob
from tpu_cooccurrence_torch.observability import LEDGER
from tpu_cooccurrence_torch.ops.rect_topk import rect_topk_reference
from tpu_cooccurrence_torch.ops.score_topk import topk_parity
from tpu_cooccurrence_torch.sampling.reservoir import PairDeltaBatch
from tpu_cooccurrence_torch.state import sparse_scorer as sp
from tpu_cooccurrence_torch.state.results import TopKBatch

from test_torch_checkpoint import (assert_rows_in_parity, assert_state_equal,
                                   feed, zipf_stream)

RTOL = ATOL = 1e-5
TOP_K = 10
#: A small slab, compaction floor and item capacity, so a short stream
#: relocates rows, grows both heaps and the row space, and compacts.
SMALL = dict(capacity=1024, compact_min_heap=256, items_capacity=64)


def _hot_stream(seed=1, n_windows=7, hot=5_500, n_items=300, n_pairs=600):
    """Seeded window pair deltas (numpy): Zipf +1 pairs, -1 retractions of
    live cells (some cancel to zero), and a hot pair (rows 0 and 1) of
    ``hot`` a window, whose row sums cross 32,767 in the 6th window."""
    rng = np.random.default_rng(seed)
    p = np.arange(1, n_items + 1, dtype=np.float64) ** -1.1
    p /= p.sum()
    live = {}
    out = []
    for _ in range(n_windows):
        src = rng.choice(n_items, n_pairs, p=p)
        dst = rng.choice(n_items, n_pairs, p=p)
        keys = sorted(k for k, v in live.items() if v > 0)
        n_ret = min(len(keys), n_pairs // 8)
        pick = rng.choice(len(keys), n_ret, replace=False) if n_ret else []
        src = np.r_[src, [keys[i][0] for i in pick], 0, 1]
        dst = np.r_[dst, [keys[i][1] for i in pick], 1, 0]
        delta = np.r_[np.ones(n_pairs), -np.ones(n_ret), hot, hot]
        keep = src != dst
        src, dst, delta = src[keep], dst[keep], delta[keep]
        for a, b, d in zip(src.tolist(), dst.tolist(), delta.tolist()):
            live[(a, b)] = live.get((a, b), 0) + d
        out.append((src.astype(np.int64), dst.astype(np.int64),
                    delta.astype(np.int32)))
    return out


def _pairs(cls, w):
    return cls(w[0].copy(), w[1].copy(), w[2].copy())


def _port(cell, wire, **kw):
    return sp.SparseDeviceScorer(TOP_K, device="cpu", cell_dtype=cell,
                                 wire_format=wire, **{**SMALL, **kw})


def _jax(cell, wire, **kw):
    return JaxSparse(TOP_K, use_pallas="off", cell_dtype=cell,
                     wire_format=wire, **{**SMALL, **kw})


def _live_cells(index, cnt, dst):
    keys, slots = index.keys_and_slots()
    s = np.asarray(slots, dtype=np.int64)
    return keys, slots, np.asarray(cnt)[s], np.asarray(dst)[s]


def _assert_slabs_equal(port, ref):
    """Both indices and the live cells of both slabs, exactly."""
    np.testing.assert_array_equal(port.wide_rows, ref.wide_rows)
    pairs = [(port.index, ref.index, port.cnt, ref.cnt, port.dst, ref.dst),
             (port.index_w, ref.index_w, port.cnt_w, ref.cnt_w, port.dst_w,
              ref.dst_w)]
    for pi, ri, pc, rc, pd, rd in pairs:
        assert (pi.heap_end, pi.garbage, pi.compactions) == (
            ri.heap_end, ri.garbage, ri.compactions)
        assert str(pc.dtype).endswith(str(np.asarray(rc).dtype))
        got = _live_cells(pi, pc.numpy(), pd.numpy())
        want = _live_cells(ri, rc, rd)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        rows = np.arange(max(pi.rows_cap, ri.rows_cap))
        for g, w in zip(pi.rows.get(rows), ri.rows.get(rows)):
            np.testing.assert_array_equal(g, w)
    assert (port.capacity, port.capacity_w) == (ref.capacity, ref.capacity_w)


def _assert_state_equal(a, b):
    sa, sb = a.checkpoint_state(), b.checkpoint_state()
    for key in ("rows_key", "rows_cnt", "row_sums", "observed"):
        assert sa[key].dtype == sb[key].dtype, key
        np.testing.assert_array_equal(sa[key], sb[key], err_msg=key)


def _cat(batches):
    batches = [b for b in batches if len(b)]
    if not batches:
        return TopKBatch.empty(TOP_K)
    return TopKBatch(np.concatenate([b.rows for b in batches]),
                     np.concatenate([b.idx for b in batches]),
                     np.concatenate([b.vals for b in batches]))


@pytest.mark.parametrize("wire", ["raw", "packed"])
@pytest.mark.parametrize("cell", ["int16", "int8"])
def test_narrow_scorer_matches_jax(cell, wire):
    port, ref = _port(cell, wire), _jax(cell, wire)
    LEDGER.reset()
    JAX_LEDGER.reset()
    got, want = [], []
    for w in _hot_stream():
        got.append(port.process_window(0, _pairs(PairDeltaBatch, w)))
        want.append(ref.process_window(0, _pairs(JaxPairs, w)))
        _assert_slabs_equal(port, ref)
        _assert_state_equal(port, ref)
    got.append(port.flush())
    want.append(ref.flush())
    assert port.promoted_rows >= 2 and port.index_w.heap_end > 0
    assert port.compactions >= 1
    assert port.index_w.compactions >= (cell == "int8")
    g, r = _cat(got), _cat(want)
    np.testing.assert_array_equal(g.rows, r.rows)
    np.testing.assert_array_equal(np.isfinite(g.vals), np.isfinite(r.vals))
    ok, mism = topk_parity(g.vals, g.idx, r.vals, r.idx, rtol=RTOL,
                           atol=ATOL)
    assert ok and mism == 0, (ok, mism)
    np.testing.assert_array_equal(g.idx, r.idx)
    snap = LEDGER.snapshot()
    if wire == "packed":
        assert 0 < snap["uplink_enc_bytes"] < snap["uplink_raw_bytes"]
    else:
        assert snap["uplink_enc_bytes"] == snap["uplink_raw_bytes"] == 0


def test_promotion_before_the_first_cell():
    """A row whose first window already reaches the bound: promoted with
    no narrow cells to move."""
    batch = ([0, 1, 2], [1, 0, 0], [40_000, 40_000, 3])
    port, ref = _port("int16", "packed"), _jax("int16", "packed")
    wide = _port("int32", "raw")
    outs = []
    for sc, cls in ((port, PairDeltaBatch), (ref, JaxPairs),
                    (wide, PairDeltaBatch)):
        b = cls(np.asarray(batch[0], np.int64), np.asarray(batch[1],
                                                           np.int64),
                np.asarray(batch[2], np.int32))
        outs.append([sc.process_window(0, b), sc.flush()])
    assert port.wide_rows[:2].all() and not port.wide_rows[2]
    _assert_slabs_equal(port, ref)
    _assert_state_equal(port, ref)
    _assert_state_equal(port, wide)
    # Narrow row 2 first, then the wide rows 0 and 1.
    assert outs[0][1].rows.tolist() == outs[1][1].rows.tolist() == [2, 0, 1]
    for a, b in zip(outs[0], outs[1]):
        np.testing.assert_array_equal(a.idx, b.idx)
        assert topk_parity(a.vals, a.idx, b.vals, b.idx)[0]


def _by_row(batch):
    o = np.argsort(batch.rows, kind="stable")
    return batch.rows[o], batch.vals[o], batch.idx[o]


def _tie_aware_mismatches(va, ia, vb, ib):
    """Ids that differ on a finite lane whose score is untied (unique in
    its row, and in a full row not equal to the K-th score)."""
    untied = (va[:, :, None] == va[:, None, :]).sum(-1) == 1
    untied &= ~(np.isfinite(va[:, -1:]) & (va == va[:, -1:]))
    return int(((ia != ib) & np.isfinite(va) & untied).sum())


@pytest.mark.parametrize("cell", ["int16", "int8"])
def test_narrow_port_equals_int32_port(cell):
    nar, wide = _port(cell, "packed"), _port("int32", "raw")
    swapped = 0
    for w in _hot_stream(seed=2):
        a = nar.process_window(0, _pairs(PairDeltaBatch, w))
        b = wide.process_window(0, _pairs(PairDeltaBatch, w))
        _assert_state_equal(nar, wide)
        (ra, va, ia), (rb, vb, ib) = _by_row(a), _by_row(b)
        np.testing.assert_array_equal(ra, rb)
        np.testing.assert_array_equal(va, vb)
        assert _tie_aware_mismatches(va, ia, vb, ib) == 0
        swapped += int((ia != ib).sum())
    assert nar.promoted_rows >= 2 and wide.promoted_rows == 0
    assert nar.slab_device_bytes < wide.slab_device_bytes + 16 * 1024


@pytest.mark.parametrize("cell,dtype", [("int16", torch.int16),
                                        ("int8", torch.int8)])
def test_plain_rect_kernel_is_exact_at_narrow_cells(cell, dtype):
    rng = np.random.default_rng(5)
    lens = rng.integers(0, 300, 120)
    lens[:3] = [0, 1, 5000]
    starts = 7 + np.concatenate([[0], np.cumsum(lens)[:-1]])
    cap = int(starts[-1] + lens[-1] + 9)
    cnt = rng.integers(0, 128, cap)
    cnt[rng.random(cap) < 0.2] = 0
    dst = rng.integers(0, 4096, cap)
    rs = rng.integers(1, 1 << 20, 4096)
    rows = rng.choice(4096, len(lens), replace=False)
    t = [torch.from_numpy(np.asarray(a, np.int32))
         for a in (cnt, dst, rs, rows, starts, lens)]
    want = rect_topk_reference(*t, 5e8, TOP_K)
    got = rect_topk_reference(t[0].to(dtype), *t[1:], 5e8, TOP_K)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.isfinite(want[0]).any()


def _run_job(cfg, users, items, ts):
    job = CooccurrenceJob(cfg)
    out = []
    job.on_update = out.append
    feed(job, users, items, ts)
    job.finish()
    return job, out


@pytest.mark.parametrize("cell", ["int16", "int8"])
def test_pipelined_narrow_packed_equals_serial(cell):
    users, items, ts = zipf_stream(n=4_000, seed=5)
    kw = dict(window_size=10, seed=0xABCD, item_cut=40, user_cut=6,
              backend="sparse", device="cpu", cell_dtype=cell,
              wire_format="packed", emit_updates=True)
    serial, s_out = _run_job(Config(**kw), users, items, ts)
    piped, p_out = _run_job(Config(**kw, pipeline_depth=2), users, items,
                            ts)
    assert serial.scorer.cell_dtype == cell and serial.scorer.wire_packed
    if cell == "int8":
        assert serial.scorer.promoted_rows > 0
    _assert_state_equal(piped.scorer, serial.scorer)
    assert piped.counters.as_dict() == serial.counters.as_dict()
    got, want = _cat(p_out), _cat(s_out)
    assert len(want) > 100
    for a, b in ((got.rows, want.rows), (got.idx, want.idx),
                 (got.vals, want.vals)):
        np.testing.assert_array_equal(a, b)


JOB = dict(window_size=10, seed=0xABCD, item_cut=40, user_cut=6)


@pytest.mark.parametrize("writer,cells", [
    ("port", ("int16", "int8")), ("port", ("int8", "int32")),
    ("jax", ("int16", "int8")), ("jax", ("int8", "int16")),
])
def test_checkpoints_cross_packages_and_cell_dtypes(tmp_path, writer,
                                                    cells):
    """A packed generation written by one package at one cell dtype
    restores in the other at another cell dtype, with promoted rows (an
    int8 writer's, or an int8 reader's, which routes rows past 127 to its
    wide side-table); the continuation's state equals the JAX
    uninterrupted run at the restoring cell dtype, its rows in
    ``topk_parity``."""
    users, items, ts = zipf_stream(n=3_000)
    half = 1_501
    w_cell, r_cell = cells
    ckpt = str(tmp_path / "ckpt")
    jax_cfg = lambda cell: JaxConfig(  # noqa: E731
        **JOB, backend=Backend.SPARSE, checkpoint_dir=ckpt, cell_dtype=cell,
        wire_format="packed")
    port_cfg = lambda cell: Config(  # noqa: E731
        **JOB, backend="sparse", device="cpu", checkpoint_dir=ckpt,
        cell_dtype=cell)
    ref = JaxJob(jax_cfg(r_cell))
    feed(ref, users, items, ts)
    ref.finish()
    if writer == "port":
        a, b = CooccurrenceJob(port_cfg(w_cell)), JaxJob(jax_cfg(r_cell))
    else:
        a, b = JaxJob(jax_cfg(w_cell)), CooccurrenceJob(port_cfg(r_cell))
    feed(a, users[:half], items[:half], ts[:half])
    if w_cell == "int8":
        assert int(a.scorer.wide_rows.sum()) > 0, "nothing promoted"
    if r_cell == "int8":
        assert int(b.scorer.wide_rows.sum()) == 0
    a.checkpoint()
    with np.load(tmp_path / "ckpt" / "state.1.npz") as f:
        assert "scorer_rows_key__packed" in f.files  # the codec
        assert "scorer_rows_cnt__packed" in f.files
    b.restore()
    if r_cell == "int8":
        assert int(b.scorer.wide_rows.sum()) > 0, "nothing restored wide"
    feed(b, users[half:], items[half:], ts[half:])
    b.finish()
    assert b.counters.as_dict() == ref.counters.as_dict()
    assert_state_equal(b, ref)
    assert_rows_in_parity(b.latest, ref.latest)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_promoted_int16_snapshot_crosses_packages(writer):
    """A scorer snapshot taken after int16 promotion restores in the other
    package; both continue with equal slabs, state and ids."""
    wins = _hot_stream(seed=3, n_windows=9)
    src = (_port if writer == "port" else _jax)("int16", "packed")
    cls = PairDeltaBatch if writer == "port" else JaxPairs
    for w in wins[:7]:
        src.process_window(0, _pairs(cls, w))
    assert src.wide_rows.sum() >= 2
    st = src.checkpoint_state()
    port, ref = _port("int16", "packed"), _jax("int16", "packed")
    port.restore_state(st)
    ref.restore_state(st)
    assert port.promoted_rows >= 2
    _assert_slabs_equal(port, ref)
    for w in wins[7:]:
        a = port.process_window(0, _pairs(PairDeltaBatch, w))
        b = ref.process_window(0, _pairs(JaxPairs, w))
        _assert_slabs_equal(port, ref)
        _assert_state_equal(port, ref)
    a, b = port.flush(), ref.flush()
    np.testing.assert_array_equal(a.rows, b.rows)
    np.testing.assert_array_equal(a.idx, b.idx)
    assert topk_parity(a.vals, a.idx, b.vals, b.idx, rtol=RTOL,
                       atol=ATOL)[0]
