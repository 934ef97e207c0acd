"""The port's ``io/synthetic.py`` against the JAX package's: the calibrated
stand-ins of benchmark configs 2 and 5, the word stream of config 1, the
MovieLens and Instacart readers on the checked-in fixtures, and the CSV
writer.

Every generator and reader must return arrays ``np.array_equal`` to the
JAX function's, with the same dtypes, for the same arguments (the draws
come from one ``default_rng`` in one order, so a reordered draw changes
every stream). The writer must write the same bytes.
"""

import os

import numpy as np
import pytest

from tpu_cooccurrence.bench.configs import TINY_TEXT
from tpu_cooccurrence.io import synthetic as ref
from tpu_cooccurrence_torch.io import synthetic as port

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")


def _assert_same(got, want):
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _one_chunk(reader, *args, **kw):
    chunks = list(reader(*args, **kw))
    assert len(chunks) == 1
    return chunks[0]


@pytest.mark.parametrize("name,args,kw", [
    ("ml100k_calibrated", (), {}),
    ("ml100k_calibrated", (5_000,), dict(seed=7, events_per_ms=3)),
    ("instacart_calibrated", (200,), {}),
    ("instacart_calibrated", (2_000,), {}),
    ("instacart_calibrated", (20_000,), {}),
    ("instacart_calibrated", (2_000,), dict(seed=9, ms_per_basket=4)),
    ("word_cooccurrence_stream", (TINY_TEXT * 50,), {}),
    ("word_cooccurrence_stream", ("",), {}),
], ids=["ml100k", "ml100k-short", "instacart-200", "instacart-2000",
        "instacart-20000", "instacart-seed9", "tiny-text-x50", "empty-text"])
def test_generator_equals_jax(name, args, kw):
    got = getattr(port, name)(*args, **kw)
    _assert_same(got, getattr(ref, name)(*args, **kw))
    if name != "word_cooccurrence_stream":
        assert len(got[0]) > 0 and (np.diff(got[2]) >= 0).all()


def test_calibrations_are_the_jax_constants():
    assert port.ML100K_CALIBRATION == ref.ML100K_CALIBRATION
    assert port.ML100K_EVENTS == ref.ML100K_EVENTS
    assert port.INSTACART_CALIBRATION == ref.INSTACART_CALIBRATION
    # Config 5's bench size, as sized for the card: 201,638 events from
    # 1,206 users over 200 one-second windows.
    users, items, ts = port.instacart_calibrated(20_000)
    assert (len(users), len(np.unique(users)), int(ts.max()) // 1000) == (
        201_638, 1_206, 199)
    assert int(items.max()) < ref.INSTACART_CALIBRATION["n_products"]


@pytest.mark.parametrize("fixture,kw", [
    ("ratings.csv", {}),
    ("ratings.csv", dict(min_rating=4.0)),
    ("u.data", {}),
    ("u.data", dict(min_rating=3.0)),
])
def test_movielens_reader_equals_jax(fixture, kw):
    path = os.path.join(FIXTURES, fixture)
    got = _one_chunk(port.movielens_interactions, path, **kw)
    _assert_same(got, _one_chunk(ref.movielens_interactions, path, **kw))
    assert len(got[0]) > 0 and (np.diff(got[2]) >= 0).all()


def test_min_rating_filters_the_udata_fixture():
    path = os.path.join(FIXTURES, "u.data")
    everything = _one_chunk(port.movielens_interactions, path)
    kept = _one_chunk(port.movielens_interactions, path, min_rating=3.0)
    assert 0 < len(kept[0]) < len(everything[0])


def test_instacart_reader_equals_jax():
    args = (os.path.join(FIXTURES, "orders.csv"),
            os.path.join(FIXTURES, "order_products.csv"))
    got = _one_chunk(port.instacart_interactions, *args)
    _assert_same(got, _one_chunk(ref.instacart_interactions, *args))
    assert len(got[0]) == 26


@pytest.mark.parametrize("stream", ["instacart", "tiny-text"])
def test_writer_writes_the_jax_bytes(tmp_path, stream):
    if stream == "instacart":
        users, items, ts = port.instacart_calibrated(300)
    else:
        users, items, ts = port.word_cooccurrence_stream(TINY_TEXT)
    mine = tmp_path / "port" / "deep" / "x.csv"
    theirs = tmp_path / "jax" / "deep" / "x.csv"
    port.write_interactions_csv(str(mine), users, items, ts)
    ref.write_interactions_csv(str(theirs), users, items, ts)
    assert mine.read_bytes() == theirs.read_bytes()
    back = np.loadtxt(mine, delimiter=",", dtype=np.int64)
    np.testing.assert_array_equal(back, np.stack([users, items, ts], 1))
