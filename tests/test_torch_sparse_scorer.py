"""The port's sparse slab backend (``tpu_cooccurrence_torch.state.sparse_scorer``,
``device="cpu"``) against the JAX package's on the same seeded numpy
streams.

- The host index: the port's ``SlabIndex`` and row registries against the
  JAX package's sorted ``SlabIndex``, window by window: identical slots,
  new-cell masks, moves, registry fields and compaction maps.
- The scorer: the port's ``SparseDeviceScorer`` against the JAX
  ``SparseDeviceScorer`` (CPU; XLA rectangles and, with ``use_pallas="on"``,
  the Pallas kernel in interpret mode for wide rows) over a stream that
  relocates rows and compacts the heap. The canonical checkpoint
  (``rows_key``, ``rows_cnt``, ``row_sums``, ``observed``) is integer
  state and must be EXACTLY equal after every window; the top-K rows
  must come out in the same order with scores in ``topk_parity``
  (``rtol=atol=1e-5``: both sides are float32 in the same operation
  order; the CPU ``log1p``s may differ by ulps).
- State transfer: a checkpoint of either package restores into the
  other, and the next windows agree with the JAX scorer restored from
  the same checkpoint.
"""

import numpy as np
import pytest
import torch

from tpu_cooccurrence.sampling.reservoir import PairDeltaBatch as JaxPairs
from tpu_cooccurrence.state.sparse_scorer import (
    SlabIndex as JaxSlabIndex, SparseDeviceScorer as JaxSparse)
from tpu_cooccurrence_torch.ops.score_topk import topk_parity
from tpu_cooccurrence_torch.sampling.reservoir import PairDeltaBatch
from tpu_cooccurrence_torch.state import sparse_scorer as sp
from tpu_cooccurrence_torch.state.results import TopKBatch

RTOL = ATOL = 1e-5
TOP_K = 10
#: Small slab and compaction floor, so a short stream relocates rows,
#: grows the heap and compacts it.
SMALL = dict(capacity=1024, compact_min_heap=256)


def _stream(seed, n_items=300, n_windows=6, n_pairs=2500):
    """Seeded window pair deltas (numpy): Zipf-distributed +1 pairs (hot
    rows grow past one 256-wide bucket and relocate) and -1 retractions
    of live cells, some of which cancel cells to zero. Counts never go
    negative, as in a real stream."""
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
        if n_ret:
            pick = rng.choice(len(keys), n_ret, replace=False)
            src = np.concatenate([src, [keys[i][0] for i in pick]])
            dst = np.concatenate([dst, [keys[i][1] for i in pick]])
        delta = np.ones(len(src), dtype=np.int32)
        delta[n_pairs:] = -1
        for a, b, d in zip(src.tolist(), dst.tolist(), delta.tolist()):
            live[(a, b)] = live.get((a, b), 0) + d
        out.append((src.astype(np.int64), dst.astype(np.int64), delta))
    return out


def _pairs(cls, w):
    return cls(w[0].copy(), w[1].copy(), w[2].copy())


def _port(**kw):
    return sp.SparseDeviceScorer(TOP_K, device="cpu", **{**SMALL, **kw})


def _jax(use_pallas="off", **kw):
    return JaxSparse(TOP_K, use_pallas=use_pallas, **{**SMALL, **kw})


def _step(port, ref, w):
    return (port.process_window(0, _pairs(PairDeltaBatch, w)),
            ref.process_window(0, _pairs(JaxPairs, w)))


def _assert_state_equal(port, ref):
    a, b = port.checkpoint_state(), ref.checkpoint_state()
    assert set(a) == set(b) == {"rows_key", "rows_cnt", "row_sums",
                                "observed"}
    for key in a:
        assert a[key].dtype == b[key].dtype, key
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def _cat(batches):
    batches = [b for b in batches if len(b)]
    if not batches:
        return TopKBatch.empty(TOP_K)
    return TopKBatch(np.concatenate([b.rows for b in batches]),
                     np.concatenate([b.idx for b in batches]),
                     np.concatenate([b.vals for b in batches]))


def _assert_topk_parity(got, want):
    np.testing.assert_array_equal(got.rows, want.rows)
    np.testing.assert_array_equal(np.isfinite(got.vals),
                                  np.isfinite(want.vals))
    ok, mism = topk_parity(got.vals, got.idx, want.vals, want.idx,
                           rtol=RTOL, atol=ATOL)
    assert ok and mism == 0, (ok, mism)


# -- the host index ---------------------------------------------------------


def _key_windows(seed, n_windows=12, n_rows=400, per=600):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_windows):
        r = (rng.pareto(1.2, per) * 3).astype(np.int64) % n_rows
        d = rng.integers(0, 5000, per).astype(np.int64)
        out.append(np.unique((r << 32) | d))
    return out


@pytest.mark.parametrize("row_index", ["bitmap", "dense"])
def test_slab_index_matches_jax(row_index):
    port = sp.SlabIndex(rows_capacity=64, row_index=row_index)
    ref = JaxSlabIndex(rows_capacity=64, row_index=row_index)
    moved = compacted = 0
    for keys in _key_windows(11):
        if ref.needs_compaction(512):
            assert port.needs_compaction(512)
            np.testing.assert_array_equal(port.compact(), ref.compact())
            compacted += 1
        a, b = port.apply(keys), ref.apply(keys)
        np.testing.assert_array_equal(a.slots, b.slots)
        np.testing.assert_array_equal(a.new_sel, b.new_sel)
        if b.mv is None:
            assert a.mv is None
        else:
            # The reference pads its moves to a pow-4 bucket (len 0).
            n = a.mv.shape[1]
            np.testing.assert_array_equal(a.mv, b.mv[:, :n])
            assert not b.mv[2, n:].any()
            moved += n
        assert (port.heap_end, port.garbage) == (ref.heap_end, ref.garbage)
        rows = np.arange(port.rows_cap)
        for x, y in zip(port.rows.get(rows), ref.rows.get(rows)):
            np.testing.assert_array_equal(x, y)
        for x, y in zip(port.keys_and_slots(), ref.keys_and_slots()):
            np.testing.assert_array_equal(x, y)
    assert moved and compacted, (moved, compacted)
    keys = port.keys_and_slots()[0]
    np.testing.assert_array_equal(port.rebuild_from_keys(keys),
                                  ref.rebuild_from_keys(keys))
    np.testing.assert_array_equal(port.rows.occupied(), ref.rows.occupied())


def test_registry_layouts_agree():
    dense = sp.make_row_registry(64, "dense")
    bitmap = sp.make_row_registry(64, "bitmap")
    rng = np.random.default_rng(3)
    for _ in range(5):
        rows = np.unique(rng.integers(0, 3000, 50))
        vals = rng.integers(0, 1000, (3, len(rows)))
        for reg in (dense, bitmap):
            reg.update(rows, *vals)
        cleared = rows[::4]
        for reg in (dense, bitmap):
            reg.clear(cleared)
    probe = np.arange(4100)
    for x, y in zip(dense.get(probe), bitmap.get(probe)):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(dense.occupied(), bitmap.occupied())
    with pytest.raises(ValueError):
        sp.make_row_registry(64, "hash")


def test_capacity_past_int32_raises_slab_capacity_error():
    with pytest.raises(sp.SlabCapacityError):
        sp._pow2ceil(np.asarray([2**31 - 5]), 4)


# -- the scorer -------------------------------------------------------------


@pytest.mark.parametrize("use_pallas", ["off", "on"])
@pytest.mark.parametrize("defer", [True, False])
def test_state_exact_and_topk_in_parity(use_pallas, defer):
    port = _port(defer_results=defer)
    ref = _jax(use_pallas, defer_results=defer)
    got, want = [], []
    max_len = 0
    for w in _stream(1):
        g, r = _step(port, ref, w)
        got.append(g)
        want.append(r)
        _assert_state_equal(port, ref)
        max_len = max(max_len, int(port.index.rows.length.max()))
    got.append(port.flush())
    want.append(ref.flush())
    assert port.compactions >= 1 and port.compactions == ref.compactions
    assert port.capacity > SMALL["capacity"]
    assert max_len > 64, "no row reached a 256-wide rectangle"
    if defer:
        assert all(len(b) == 0 for b in got[:-1] + want[:-1])
    else:
        # One window late: the first window hands over nothing.
        assert len(got[0]) == len(want[0]) == 0 and len(got[1])
    _assert_topk_parity(_cat(got), _cat(want))


@pytest.mark.parametrize("ladder", [2, 16])
def test_score_ladder_keeps_the_reference_row_order(ladder):
    """The ladder decides the buckets, hence the emitted row order."""
    port = _port(score_ladder=ladder)
    ref = _jax(score_ladder=ladder)
    got, want = zip(*(_step(port, ref, w) for w in _stream(2, n_windows=3)))
    _assert_topk_parity(_cat(list(got) + [port.flush()]),
                        _cat(list(want) + [ref.flush()]))


def test_development_mode_checks_row_sums():
    port = _port(development_mode=True)
    for w in _stream(3, n_windows=3):
        port.process_window(0, _pairs(PairDeltaBatch, w))
    nxt = _stream(3, n_windows=1)[0]
    port.row_sums_host[int(nxt[0][0])] += 1
    with pytest.raises(AssertionError, match="does not match"):
        port.process_window(0, _pairs(PairDeltaBatch, nxt))


def test_empty_window_hands_over_the_pending_rows():
    port = _port()
    w = _stream(4, n_windows=1)[0]
    assert len(port.process_window(0, _pairs(PairDeltaBatch, w))) == 0
    out = port.process_window(0, PairDeltaBatch.concat([]))
    assert len(out) > 0 and port.last_dispatched_rows == 0
    assert len(port.flush()) == 0


def test_bad_score_ladder_is_refused():
    with pytest.raises(ValueError, match="power of two"):
        _port(score_ladder=3)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_restores_across_packages(writer):
    wins = _stream(5, n_windows=6)
    src = _jax(defer_results=True) if writer == "jax" else _port(
        defer_results=True)
    cls = JaxPairs if writer == "jax" else PairDeltaBatch
    for w in wins[:3]:
        src.process_window(0, _pairs(cls, w))
    st = src.checkpoint_state()
    port, ref = _port(defer_results=True), _jax(defer_results=True)
    port.restore_state(st)
    ref.restore_state(st)
    _assert_state_equal(port, ref)
    for w in wins[3:]:
        _step(port, ref, w)
        _assert_state_equal(port, ref)
    _assert_topk_parity(port.flush(), ref.flush())


def test_restore_refuses_row_sums_past_the_cells():
    st = _port().checkpoint_state()
    st["row_sums"] = np.zeros(4096, dtype=np.int64)
    st["row_sums"][3000] = 1
    with pytest.raises(ValueError, match="row sums"):
        _port().restore_state(st)


def test_moves_read_before_they_write():
    """A relocation whose new region starts inside the block it moves
    (never made by the allocator, but the body must not depend on it)."""
    cnt = torch.arange(10, dtype=torch.int32)
    dst = torch.arange(10, dtype=torch.int32) + 100
    mv = torch.tensor([[0], [2], [5]], dtype=torch.int32)
    sp._moves_body(cnt, dst, mv, 5)
    assert cnt.tolist() == [0, 1, 0, 1, 2, 3, 4, 7, 8, 9]
    assert dst.tolist()[2:7] == [100, 101, 102, 103, 104]


def test_wire_helpers_match_jax_and_auto_resolves_to_int32_raw():
    from tpu_cooccurrence.state import wire as jax_wire
    from tpu_cooccurrence_torch.state import wire

    assert wire.CELL_DTYPES == jax_wire.CELL_DTYPES
    for dtype in wire.CELL_DTYPES:
        assert (wire.cell_promote_threshold(dtype)
                == jax_wire.cell_promote_threshold(dtype))
    ok = np.asarray([0, 32_767, -32_768])
    np.testing.assert_array_equal(wire.checked_narrow(ok, np.int16),
                                  jax_wire.checked_narrow(ok, np.int16))
    for mod in (wire, jax_wire):
        with pytest.raises(OverflowError):
            mod.checked_narrow(np.asarray([40_000]), np.int16)
    # The JAX package's auto rule: int32 cells and the raw uplink off the
    # sparse backend, int16 and packed on it; explicit values pass through.
    for sparse in (False, True):
        for flag in ("auto", "int32", "int16", "int8"):
            assert wire.resolve_cell_dtype(flag, sparse) == (
                jax_wire.resolve_cell_dtype(flag, sparse))
        for flag in ("auto", "raw", "packed"):
            assert wire.resolve_wire_format(flag, sparse) == (
                jax_wire.resolve_wire_format(flag, sparse))
    assert wire.resolve_cell_dtype("auto", False) == "int32"
    assert wire.resolve_wire_format("auto", False) == "raw"
    assert wire.resolve_cell_dtype("auto", True) == "int16"
    assert wire.resolve_wire_format("auto", True) == "packed"
