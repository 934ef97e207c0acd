"""The port's ``DeviceScorer`` (``device="cpu"``) against the JAX package's
``DeviceScorer`` over the same sequence of ``PairDeltaBatch``es.

Counts are integers, so ``C``, the row sums and ``observed`` must be
EXACTLY equal after every window, int16 wraparound included. Scores are
float32 on both sides; the drained top-K is held to ``topk_parity`` with
``rtol=1e-5, atol=1e-4`` (XLA's and PyTorch's CPU ``log1p`` differ by a
few ulps; a score of ~1e3 has an ulp of ~6e-5).
"""

import numpy as np
import pytest
import torch

from tpu_cooccurrence.ops.device_scorer import (
    DeviceScorer as JaxDeviceScorer, fit_count_dtype as jax_fit,
    score_row_budget as jax_budget)
from tpu_cooccurrence.sampling.reservoir import (
    PairDeltaBatch as JaxPairs)
from tpu_cooccurrence_torch.ops import device_scorer as ds
from tpu_cooccurrence_torch.ops.score_topk import topk_parity
from tpu_cooccurrence_torch.sampling.reservoir import PairDeltaBatch
from tpu_cooccurrence_torch.state.results import TopKBatch

RTOL, ATOL = 1e-5, 1e-4
TOP_K = 10


def _windows(seed, n_items, n_windows=4, n_pairs=3000, big=0):
    """Seeded window pair deltas (numpy): mostly +1 with some -1, and
    ``big`` cells per window carrying a delta that pushes int16 counts
    past the short range."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_windows):
        src = rng.integers(0, n_items, n_pairs).astype(np.int64)
        dst = rng.integers(0, n_items, n_pairs).astype(np.int64)
        delta = np.where(rng.random(n_pairs) < 0.9, 1, -1).astype(np.int32)
        if big:
            src[:big] = np.arange(big) % n_items
            dst[:big] = (np.arange(big) * 7 + 1) % n_items
            delta[:big] = 20_000
        out.append((src, dst, delta))
    return out


def _pair(scorer_cls, w):
    cls = JaxPairs if scorer_cls is JaxDeviceScorer else PairDeltaBatch
    return cls(w[0].copy(), w[1].copy(), w[2].copy())


def _assert_state_equal(port, jax_scorer):
    a, b = port.checkpoint_state(), jax_scorer.checkpoint_state()
    for key in ("C", "row_sums", "observed"):
        assert a[key].dtype == b[key].dtype, key
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def _cat(batches):
    batches = [b for b in batches if len(b)]
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


@pytest.mark.parametrize("count_dtype,big", [("int32", 0), ("int16", 40)])
@pytest.mark.parametrize("defer", [True, False])
def test_state_exact_and_topk_in_parity(count_dtype, big, defer):
    n = 200
    port = ds.DeviceScorer(n, TOP_K, count_dtype=count_dtype, device="cpu",
                           defer_results=defer)
    ref = JaxDeviceScorer(n, TOP_K, count_dtype=count_dtype,
                          use_pallas="off", defer_results=defer)
    got, want = [], []
    for w in _windows(1, n, big=big):
        got.append(port.process_window(0, _pair(ds.DeviceScorer, w)))
        want.append(ref.process_window(0, _pair(JaxDeviceScorer, w)))
        _assert_state_equal(port, ref)
    got.append(port.flush())
    want.append(ref.flush())
    if count_dtype == "int16":
        assert (port.checkpoint_state()["C"] < 0).any(), "no wraparound"
    if defer:
        assert all(len(b) == 0 for b in got[:-1] + want[:-1])
    _assert_topk_parity(_cat(got), _cat(want))


def test_empty_window_dispatches_nothing():
    port = ds.DeviceScorer(64, TOP_K, device="cpu")
    out = port.process_window(0, PairDeltaBatch.concat([]))
    assert len(out) == 0 and port.last_dispatched_rows == 0
    assert port.observed == 0


def test_auto_capacity_growth_matches():
    port = ds.DeviceScorer(0, TOP_K, device="cpu", defer_results=True)
    ref = JaxDeviceScorer(0, TOP_K, use_pallas="off", defer_results=True)
    assert port.num_items == ref.num_items == 1024
    wins = _windows(2, 600, n_windows=1) + _windows(3, 2500, n_windows=2)
    for w in wins:
        port.process_window(0, _pair(ds.DeviceScorer, w))
        ref.process_window(0, _pair(JaxDeviceScorer, w))
        assert port.num_items == ref.num_items
        _assert_state_equal(port, ref)
    assert port.num_items == 4096
    assert port.max_score_rows == ref.max_score_rows
    _assert_topk_parity(port.flush(), ref.flush())


def test_fixed_capacity_rejects_overflow():
    port = ds.DeviceScorer(100, TOP_K, device="cpu")
    w = (np.array([5, 150]), np.array([150, 5]),
         np.ones(2, dtype=np.int32))
    with pytest.raises(ValueError, match="capacity"):
        port.process_window(0, PairDeltaBatch(*w))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("count_dtype", ["int32", "int16"])
def test_checkpoint_restores_across_packages(direction, count_dtype):
    n = 150
    wins = _windows(4, n, n_windows=4, big=20 if count_dtype == "int16"
                    else 0)
    port = ds.DeviceScorer(0, TOP_K, count_dtype=count_dtype, device="cpu",
                           defer_results=True)
    ref = JaxDeviceScorer(0, TOP_K, count_dtype=count_dtype,
                          use_pallas="off", defer_results=True)
    src_scorer = ref if direction == "jax_to_port" else port
    cls = JaxDeviceScorer if direction == "jax_to_port" else ds.DeviceScorer
    for w in wins[:2]:
        src_scorer.process_window(0, _pair(cls, w))
    st = src_scorer.checkpoint_state()
    if direction == "jax_to_port":
        port.restore_state(ds.state_from_jax(st))
        # The writer keeps going as the other side's reference.
        ref_cont = ref
        ref_cont.flush()
    else:
        ref.restore_state(st)
        ref_cont = ref
        port = src_scorer
        port.flush()
    _assert_state_equal(port, ref_cont)
    for w in wins[2:]:
        port.process_window(0, _pair(ds.DeviceScorer, w))
        ref_cont.process_window(0, _pair(JaxDeviceScorer, w))
        _assert_state_equal(port, ref_cont)
    _assert_topk_parity(port.flush(), ref_cont.flush())


def test_restore_translates_padded_vocab():
    """The JAX scorer pads its vocab to the Pallas column tile; a padded
    checkpoint restores into the port's exact capacity when the padding
    is empty, and is refused when counts live there."""
    rng = np.random.default_rng(5)
    C = np.zeros((2048, 2048), dtype=np.int32)
    C[:300, :300] = rng.integers(0, 3, (300, 300))
    st = {"C": C, "row_sums": C.sum(1).astype(np.int32),
          "observed": np.array([int(C.sum())], dtype=np.int64)}
    port = ds.DeviceScorer(300, TOP_K, device="cpu")
    port.restore_state(ds.state_from_jax(st))
    assert tuple(port.C.shape) == (300, 300)
    np.testing.assert_array_equal(port.C.numpy(), C[:300, :300])
    assert port.observed == int(C.sum())
    C[5, 1000] = 1
    with pytest.raises(ValueError, match="capacity"):
        ds.DeviceScorer(300, TOP_K, device="cpu").restore_state(st)


def test_state_from_jax_layout_and_validation():
    ref = JaxDeviceScorer(64, TOP_K, count_dtype="int16", use_pallas="off")
    ref.process_window(0, _pair(JaxDeviceScorer, _windows(6, 64, 1)[0]))
    st = ds.state_from_jax(ref.checkpoint_state())
    assert st["C"].dtype == np.int16 and st["C"].flags.c_contiguous
    assert st["row_sums"].dtype == np.int32
    assert st["observed"].dtype == np.int64 and st["observed"].shape == (1,)
    with pytest.raises(ValueError):
        ds.state_from_jax(dict(st, C=st["C"][:, :10]))
    with pytest.raises(ValueError):
        ds.state_from_jax(dict(st, C=st["C"].astype(np.float32)))
    with pytest.raises(ValueError):
        ds.state_from_jax(dict(st, row_sums=st["row_sums"][:5]))


def test_helpers_match_jax():
    for n in (100, 1024, 20_000, 61_440, 1 << 20):
        for cap in (64, 8192):
            assert ds.score_row_budget(n, cap) == jax_budget(n, cap)
    wide = np.array([[1, 40_000]], dtype=np.int32)
    with pytest.raises(ValueError):
        ds.fit_count_dtype(wide, np.dtype(np.int16))
    with pytest.raises(ValueError):
        jax_fit(wide, np.dtype(np.int16))
    ok = np.array([[1, -5]], dtype=np.int32)
    np.testing.assert_array_equal(ds.fit_count_dtype(ok, np.dtype(np.int16)),
                                  jax_fit(ok, np.dtype(np.int16)))


def test_apply_coo_int16_wraps_like_jax():
    """The scatter-add wraps int16 cells the way XLA's does."""
    import jax.numpy as jnp

    from tpu_cooccurrence.ops.device_scorer import _apply_coo as jax_apply

    C = np.array([[32_767, -32_768], [5, 0]], dtype=np.int16)
    src = np.array([0, 0, 1], dtype=np.int32)
    dst = np.array([0, 1, 1], dtype=np.int32)
    delta = np.array([1, -1, 70_000], dtype=np.int32)
    jc, jrs = jax_apply(jnp.asarray(C), jnp.zeros(2, jnp.int32),
                        jnp.asarray(src), jnp.asarray(dst),
                        jnp.asarray(delta), 2)
    tc = torch.from_numpy(C.copy())
    trs = torch.zeros(2, dtype=torch.int32)
    ds._apply_coo(tc, trs, torch.from_numpy(src).long(),
                  torch.from_numpy(dst).long(), torch.from_numpy(delta))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(trs.numpy(), np.asarray(jrs))
