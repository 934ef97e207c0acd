"""Benchmark configs 1, 2 and 5 (``tpu_cooccurrence/bench/configs.py``)
through the port's CLI (``--device cpu``) and the JAX CLI (``--backend
device``) on the CPU, at a small size, with the flags of those configs.

- Config 1: ``word_cooccurrence_stream(TINY_TEXT * 50)`` whole, one
  window, ``--skip-cuts``.
- Config 2: the first 40,000 events of ``ml100k_calibrated()`` (two
  4,000 ms windows), cuts 500/500, ``--num-items 1682``.
- Config 5: ``instacart_calibrated(400)`` at ``--count-dtype int16``,
  cuts 500/500, the vocabulary derived from the data (``C`` a few MB),
  chained and with ``--fused-window on``.
- Config 5's shape with one user buying the two head products 250 times
  (500 interactions, within both cuts): their cell reaches 62,680, so
  int16 ``C`` wraps, on both sides alike.

Each stream is written by the port's ``write_interactions_csv``. With
``--emit-updates`` every emitted line must stand where the JAX line
does, for the same item, in ``topk_parity`` (``rtol=1e-5, atol=1e-4``,
untied ids equal); the latest rows then pass ``tests/test_torch_cli.py``'s
``_assert_latest_close``. The wrapped case also holds the integer state of
the jobs both CLIs built (``C``, row sums, ``observed``, counters)
exactly equal.
"""

import numpy as np
import pytest

from tpu_cooccurrence import cli as jax_cli
from tpu_cooccurrence.bench.configs import TINY_TEXT
from tpu_cooccurrence.job import CooccurrenceJob as JaxJob
from tpu_cooccurrence_torch import cli as port_cli
from tpu_cooccurrence_torch.config import Config as PortConfig
from tpu_cooccurrence_torch.io.synthetic import (instacart_calibrated,
                                                 ml100k_calibrated,
                                                 word_cooccurrence_stream,
                                                 write_interactions_csv)
from tpu_cooccurrence_torch.job import CooccurrenceJob as PortJob
from tpu_cooccurrence_torch.ops.score_topk import topk_parity

from test_torch_cli import (_assert_latest_close, _emitted_lines, _parse,
                            _run)

CUTS = ["-ic", "500", "-uc", "500"]


def _config1():
    users, items, ts = word_cooccurrence_stream(TINY_TEXT * 50)
    return (users, items, ts), ["-ws", "1000000", "--skip-cuts", "-s", "1",
                                "--num-items", str(int(items.max()) + 1)]


def _config2():
    stream = tuple(a[:40_000] for a in ml100k_calibrated())
    return stream, ["-ws", "4000", "-s", "2", *CUTS, "--num-items", "1682"]


def _config5(*extra):
    return instacart_calibrated(400), ["-ws", "1000", "-s", "5", *CUTS,
                                       "--count-dtype", "int16", *extra]


def _wrapping():
    """Config 5's stream at 400 baskets plus one user who buys products 0
    and 1 (the law's head) together every 16 ms, 250 times."""
    users, items, ts = instacart_calibrated(400)
    n = 250
    hot_u = np.full(2 * n, users.max() + 1)
    hot_i = np.tile(np.array([0, 1], dtype=np.int64), n)
    hot_t = np.repeat(np.arange(n, dtype=np.int64) * 16 + 3, 2)
    order = np.argsort(np.concatenate([ts, hot_t]), kind="stable")
    return tuple(np.concatenate(pair)[order] for pair in
                 ((users, hot_u), (items, hot_i), (ts, hot_t)))


CONFIGS = {
    "config1": _config1,
    "config2-40k": _config2,
    "config5-400": _config5,
    "config5-400-fused": lambda: _config5("--fused-window", "on"),
}


def _both_clis(capsys, tmp_path, name, stream, flags):
    """The stream through the port's CLI on the CPU and the JAX CLI's
    ``--backend device``, with ``--emit-updates``: their rows in parity."""
    path = str(tmp_path / "in" / f"{name}.csv")
    write_interactions_csv(path, *stream)
    base = ["-i", path, *flags, "--emit-updates"]
    port = _run(capsys, port_cli.main, base + ["--device", "cpu"])
    want = _run(capsys, jax_cli.main, base + ["--backend", "device"])
    p_items, p_vals, p_ids = _emitted_lines(port, 10)
    j_items, j_vals, j_ids = _emitted_lines(want, 10)
    assert len(p_items) > 30, "the config emitted too few rows"
    assert p_items == j_items
    np.testing.assert_array_equal(np.isfinite(p_vals), np.isfinite(j_vals))
    ok, mism = topk_parity(p_vals, p_ids, j_vals, j_ids, rtol=1e-5,
                           atol=1e-4)
    assert ok and mism == 0, (ok, mism)
    _assert_latest_close(_parse(want), _parse(port))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_cli_matches_jax(capsys, tmp_path, name):
    _both_clis(capsys, tmp_path, name, *CONFIGS[name]())


def test_int16_wraparound_matches_jax(capsys, tmp_path, monkeypatch):
    """The wrapped stream through both CLIs at config 5's flags: rows in
    parity, and the jobs the CLIs built hold ``C``, row sums,
    ``observed`` and the counters exactly equal; ``C`` is a port int32
    run's ``C`` wrapped to 16 bits, and a cell did pass 32,767."""
    jobs = {}
    for name, cls in (("port", PortJob), ("jax", JaxJob)):
        def grab(self, *args, _name=name, _init=cls.__init__, **kw):
            _init(self, *args, **kw)
            jobs[_name] = self

        monkeypatch.setattr(cls, "__init__", grab)
    users, items, ts = _wrapping()
    _both_clis(capsys, tmp_path, "config5-int16-wraps", (users, items, ts),
               _config5()[1])
    port, ref = jobs["port"], jobs["jax"]
    assert port.counters.as_dict() == ref.counters.as_dict()
    a, b = port.scorer.checkpoint_state(), ref.scorer.checkpoint_state()
    n = min(a["C"].shape[0], b["C"].shape[0])
    assert a["C"].dtype == b["C"].dtype == np.int16
    np.testing.assert_array_equal(a["C"][:n, :n], b["C"][:n, :n])
    assert not a["C"][n:].any() and not b["C"][n:].any()
    np.testing.assert_array_equal(a["row_sums"][:n], b["row_sums"][:n])
    np.testing.assert_array_equal(a["observed"], b["observed"])
    monkeypatch.undo()
    wide = PortJob(PortConfig(window_size=1000, seed=5, item_cut=500,
                              user_cut=500, device="cpu"))
    wide.add_batch(users, items, ts)
    wide.finish()
    c32 = wide.scorer.checkpoint_state()["C"]
    assert int(c32.max()) > 32_767
    np.testing.assert_array_equal(a["C"], c32.astype(np.int16))
    assert int(a["C"].min()) < 0
