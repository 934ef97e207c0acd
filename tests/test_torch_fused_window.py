"""The port's dense fused window (``--fused-window on``) on the CPU: the
sampler's basket mode, the fused ``DeviceScorer`` path and the job,
against the port's own chained path and against the JAX package's fused
window.

Counts are integers: ``C``, the row sums, ``observed`` and the counters
must be exactly equal. Port fused against port chained: the same score
launches on the same state, so the tables are bit-identical. Port against
the JAX package: tables in ``topk_parity`` with ``rtol=1e-5, atol=1e-4``
(XLA's and PyTorch's CPU ``log1p`` differ by a few ulps).
"""

import numpy as np
import pytest

from tpu_cooccurrence.config import Backend, Config as JaxConfig
from tpu_cooccurrence.job import CooccurrenceJob as JaxJob
from tpu_cooccurrence.sampling.reservoir import (
    UserReservoirSampler as JaxSampler)
from tpu_cooccurrence_torch.config import Config as PortConfig, NotPorted
from tpu_cooccurrence_torch.io.synthetic import zipfian_interactions
from tpu_cooccurrence_torch.job import CooccurrenceJob as PortJob
from tpu_cooccurrence_torch.observability.registry import REGISTRY
from tpu_cooccurrence_torch.ops import device_scorer as ds
from tpu_cooccurrence_torch.ops.aggregate import aggregate_window_coo
from tpu_cooccurrence_torch.ops.score_topk import topk_parity
from tpu_cooccurrence_torch.sampling.reservoir import (BasketBatch,
                                                       UserReservoirSampler)

from test_pipeline import relabel_first_appearance

RTOL, ATOL = 1e-5, 1e-4


def _ladder_edge_stream():
    """``tests/test_fused_window.py``'s stream. Window 1 (ts 5): first-ever
    items only, events but ZERO pairs. Window 2 (ts 15): one op of len 1.
    Window 3 (ts 25): exactly 64 append ops. Window 4 (ts 35): 65 ops.
    Window 5 (ts 45): draws against full reservoirs (user_cut=4), the
    replacement two-op +-1 form."""
    users, items, ts = [], [], []

    def ev(u, i, t):
        users.append(u)
        items.append(i)
        ts.append(t)

    for u in range(70):                      # window 1: all first items
        ev(u, 1000 + u, 5)
    ev(0, 100, 15)                           # window 2: one len-1 op
    for u in range(64):                      # window 3: exactly 64 ops
        ev(u, 200 + u, 25)
    for u in range(65):                      # window 4: 65 ops
        ev(u, 300 + u, 35)
    for k in range(30):                      # window 5: replacements
        ev(k % 4, 400 + k, 45)
    ev(0, 999, 65)                           # flush window 5
    users = relabel_first_appearance(np.asarray(users))
    items = relabel_first_appearance(np.asarray(items))
    return users, np.asarray(items), np.asarray(ts, dtype=np.int64)


_JOB = dict(window_size=10, seed=0xBEEF, development_mode=True,
            user_cut=4, item_cut=500)


def _run(job, users, items, ts, chunk=97):
    for lo in range(0, len(users), chunk):
        job.add_batch(users[lo:lo + chunk], items[lo:lo + chunk],
                      ts[lo:lo + chunk])
    job.finish()
    return job


def _port(stream, **kw):
    return _run(PortJob(PortConfig(**{**_JOB, **kw}, device="cpu")), *stream)


def _table(job):
    return {k: job.latest[k] for k in job.latest}


def _fold(p):
    s, d, v = aggregate_window_coo(np.asarray(p.src, dtype=np.int64),
                                   np.asarray(p.dst, dtype=np.int64),
                                   np.asarray(p.delta, dtype=np.int64))
    keep = v != 0
    return list(zip(s[keep].tolist(), d[keep].tolist(), v[keep].tolist()))


def _assert_state_equal(a, b):
    a, b = a.scorer.checkpoint_state(), b.scorer.checkpoint_state()
    for key in ("C", "row_sums", "observed"):
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def _windows(seed, n_windows=12):
    rng = np.random.default_rng(seed)
    for _ in range(n_windows):
        n = int(rng.integers(5, 40))
        yield (rng.integers(0, 6, n), rng.integers(0, 30, n),
               rng.random(n) < 0.9)


# -- the sampler's basket mode ------------------------------------------


def test_basket_sampler_folds_like_coo_sampler():
    """Twin port samplers: the basket encoding's pair multiset equals the
    COO path's window by window (replacement windows included), with
    the same feedback and the same reservoir state."""
    a = UserReservoirSampler(user_cut=4, seed=123, skip_cuts=False)
    b = UserReservoirSampler(user_cut=4, seed=123, skip_cuts=False)
    b.emit_baskets = True
    replaced = 0
    for users, items, sampled in _windows(7):
        pa, fa = a.fire(users, items, sampled)
        pb, fb = b.fire(users, items, sampled)
        assert isinstance(pb, BasketBatch)
        assert len(pa) == len(pb)
        assert _fold(pa) == _fold(pb.to_pairs())
        np.testing.assert_array_equal(fa, fb)
        replaced += int((pb.signs < 0).sum())
    assert replaced > 0, "no replacement ops were exercised"
    np.testing.assert_array_equal(a.hist_len, b.hist_len)
    cols = np.arange(a.hist.shape[1])[None, :]
    live = cols < a.hist_len[:, None]
    np.testing.assert_array_equal(a.hist[live], b.hist[live])
    np.testing.assert_array_equal(a.total, b.total)
    np.testing.assert_array_equal(a.draws, b.draws)


def test_basket_batch_equals_jax_sampler_field_by_field():
    """The port's BasketBatch equals the JAX sampler's on the same stream:
    ops, lens, skips, signs exactly, basket cells on ``j < len`` (the
    rest are unspecified on both sides)."""
    port = UserReservoirSampler(user_cut=4, seed=99, skip_cuts=False)
    ref = JaxSampler(user_cut=4, seed=99, skip_cuts=False)
    port.emit_baskets = ref.emit_baskets = True
    replaced = 0
    for users, items, sampled in _windows(8, 15):
        pb, fp = port.fire(users, items, sampled)
        rb, fr = ref.fire(users, items, sampled)
        np.testing.assert_array_equal(fp, fr)
        for field in ("new_items", "lens", "skips", "signs"):
            np.testing.assert_array_equal(getattr(pb, field),
                                          getattr(rb, field), err_msg=field)
        assert pb.baskets.shape == rb.baskets.shape
        j = np.arange(pb.baskets.shape[1])[None, :]
        spec = j < pb.lens[:, None]
        np.testing.assert_array_equal(pb.baskets[spec], rb.baskets[spec])
        assert len(pb) == len(rb)
        replaced += int((pb.skips >= 0).sum())
    assert replaced > 0, "no replacement ops were exercised"


# -- the fused window against the chained path --------------------------


@pytest.mark.parametrize("extra", [{}, {"count_dtype": "int16"},
                                   {"emit_updates": True}],
                         ids=["int32", "int16", "emit_updates"])
def test_fused_bit_identical_to_chained_at_ladder_edges(extra):
    stream = _ladder_edge_stream()
    chained = _port(stream, fused_window="off", **extra)
    fused = _port(stream, fused_window="on", **extra)
    assert fused.sampler.emit_baskets and not chained.sampler.emit_baskets
    assert _table(chained) == _table(fused) and _table(fused)
    assert chained.counters.as_dict() == fused.counters.as_dict()
    assert chained.windows_fired == fused.windows_fired >= 5
    assert chained.emissions == fused.emissions
    _assert_state_equal(fused, chained)


@pytest.mark.parametrize("extra", [{}, {"count_dtype": "int16"},
                                   {"emit_updates": True}],
                         ids=["int32", "int16", "emit_updates"])
def test_fused_matches_jax_fused_job(extra):
    stream = _ladder_edge_stream()
    port = _port(stream, fused_window="on", **extra)
    ref = _run(JaxJob(JaxConfig(**_JOB, **extra, backend=Backend.DEVICE,
                                fused_window="on")), *stream)
    assert port.counters.as_dict() == ref.counters.as_dict()
    _assert_state_equal(port, ref)
    _assert_tables_in_parity(_table(port), _table(ref))


def _assert_tables_in_parity(got, want, k=10):
    assert set(got) == set(want) and got

    def arrays(table):
        vals = np.full((len(table), k), -np.inf, dtype=np.float32)
        ids = np.full((len(table), k), -1, dtype=np.int64)
        for r, item in enumerate(sorted(table)):
            for c, (other, score) in enumerate(table[item]):
                vals[r, c], ids[r, c] = score, other
        return vals, ids

    (gv, gi), (wv, wi) = arrays(got), arrays(want)
    np.testing.assert_array_equal(np.isfinite(gv), np.isfinite(wv))
    ok, mism = topk_parity(gv, gi, wv, wi, rtol=RTOL, atol=ATOL)
    assert ok and mism == 0, (ok, mism)


def test_fused_zipf_slice_matches_jax_fused_job():
    """The slice as a whole on the bench generator (cut to a few hundred
    items), tight cuts so replacements and feedback engage."""
    users, items, ts = zipfian_interactions(
        6000, n_items=300, n_users=120, alpha=1.1, seed=3, events_per_ms=50)
    kw = dict(window_size=10, seed=0xC0FFEE, item_cut=20, user_cut=8,
              development_mode=True, fused_window="on")
    port = _run(PortJob(PortConfig(**kw, device="cpu")), users, items, ts,
                chunk=1000)
    ref = _run(JaxJob(JaxConfig(**kw, backend=Backend.DEVICE)), users,
               items, ts, chunk=1000)
    assert port.windows_fired == ref.windows_fired > 5
    assert port.counters.as_dict() == ref.counters.as_dict()
    _assert_state_equal(port, ref)
    _assert_tables_in_parity(_table(port), _table(ref))


# -- routing and launch counts ------------------------------------------


class _Calls:
    """Counting shims around the scorer's scatter entry points."""

    def __init__(self, monkeypatch):
        self.counts = {"apply_baskets": 0, "_apply_coo": 0}
        for name in self.counts:
            monkeypatch.setattr(ds, name, self._wrap(name,
                                                     getattr(ds, name)))

    def _wrap(self, name, fn):
        def counted(*args, **kwargs):
            self.counts[name] += 1
            return fn(*args, **kwargs)
        return counted


def _reset_dispatch_gauges():
    for name in ("cooc_fused_dispatches_total",
                 "cooc_chained_dispatches_total"):
        REGISTRY.gauge(name).set(0)


def test_fused_window_is_one_expand_launch_per_window(monkeypatch):
    """Every pair-carrying window (windows 2-5; window 1 has no pairs) is
    one apply_baskets call, and no chained scatter runs."""
    calls = _Calls(monkeypatch)
    _reset_dispatch_gauges()
    job = _port(_ladder_edge_stream(), fused_window="on")
    assert calls.counts == {"apply_baskets": 4, "_apply_coo": 0}
    assert REGISTRY.gauge("cooc_fused_dispatches_total").get() == 4
    assert REGISTRY.gauge("cooc_chained_dispatches_total").get() == 0
    assert job.windows_fired >= 5


def test_fused_off_keeps_the_chained_path(monkeypatch):
    calls = _Calls(monkeypatch)
    _reset_dispatch_gauges()
    _port(_ladder_edge_stream(), fused_window="off")
    assert calls.counts["apply_baskets"] == 0
    assert calls.counts["_apply_coo"] == 4
    assert REGISTRY.gauge("cooc_fused_dispatches_total").get() == 0
    assert REGISTRY.gauge("cooc_chained_dispatches_total").get() == 4


def test_fused_oversize_window_runs_fused_in_chunks(monkeypatch):
    """A window whose block exceeds max_pairs_per_step still runs fused,
    cut into several launches, with identical results (the reference
    package would route it chained)."""
    stream = _ladder_edge_stream()
    chained = _port(stream, fused_window="off", max_pairs_per_step=64)
    calls = _Calls(monkeypatch)
    _reset_dispatch_gauges()
    fused = _port(stream, fused_window="on", max_pairs_per_step=64)
    assert calls.counts["_apply_coo"] == 0
    assert calls.counts["apply_baskets"] > 4
    assert REGISTRY.gauge("cooc_fused_dispatches_total").get() == 4
    assert REGISTRY.gauge("cooc_chained_dispatches_total").get() == 0
    assert _table(chained) == _table(fused)
    _assert_state_equal(fused, chained)


def test_process_window_records_the_path_it_took():
    sc = ds.DeviceScorer(64, 5, device="cpu", fused_window="on")
    b = BasketBatch(np.array([1, 2], np.int32),
                    np.array([[3, 4], [5, 0]], np.int32),
                    np.array([2, 1], np.int32), np.array([-1, -1], np.int32),
                    np.array([1, 1], np.int32))
    out = sc.process_window(0, b)
    assert sc.last_dispatch_fused and sc.last_dispatched_rows == 5
    np.testing.assert_array_equal(out.rows, [1, 2, 3, 4, 5])
    assert sc.observed == len(b) == 6
    out = sc.process_window(1, BasketBatch.empty())
    assert not sc.last_dispatch_fused and len(out) == 0


# -- configuration ------------------------------------------------------


def test_fused_flag_resolution_and_config():
    cpu = ds.resolve_device("cpu")
    assert ds.resolve_fused_flag("auto", cpu) is False
    assert ds.resolve_fused_flag("on", cpu) is True
    assert ds.resolve_fused_flag("off", cpu) is False
    with pytest.raises(ValueError, match="auto"):
        ds.resolve_fused_flag("sometimes", cpu)
    sc = ds.DeviceScorer(0, 10, device="cpu", fused_window="auto")
    assert not sc.wants_baskets
    assert PortConfig(window_size=10, fused_window="on").fused_window == "on"
    with pytest.raises(ValueError, match="auto"):
        PortConfig(window_size=10, fused_window="sometimes")
    with pytest.raises(NotPorted, match="--fused-window on"):
        PortConfig(window_size=10, backend="sparse", fused_window="on")
