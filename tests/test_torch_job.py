"""The slice as a whole: the port's ``CooccurrenceJob`` (``device="cpu"``)
against the JAX package's ``CooccurrenceJob`` on ``--backend device``,
over the same seeded Zipf stream (the bench workload's generator, cut to a
few hundred items).

The port's synthetic stream must equal the JAX package's bit for bit.
Counters and the scorer state (``C``, row sums, ``observed``) are integers
and must be exactly equal. Final rows: scores ``rtol=1e-5, atol=1e-4``
(both float32 with the same operation order; XLA's and PyTorch's CPU
``log1p`` differ by a few ulps), ids exact wherever every in-row gap
exceeds ``1e-3`` (a near-tie may order differently).
"""

import numpy as np
import pytest

from tpu_cooccurrence.config import Backend, Config as JaxConfig
from tpu_cooccurrence.io.synthetic import (
    zipfian_interactions as jax_zipfian)
from tpu_cooccurrence.job import CooccurrenceJob as JaxJob
from tpu_cooccurrence_torch.config import Config as PortConfig
from tpu_cooccurrence_torch.io.synthetic import zipfian_interactions
from tpu_cooccurrence_torch.job import CooccurrenceJob as PortJob

STREAM = dict(n_items=300, n_users=120, alpha=1.1, seed=3, events_per_ms=50)


def _stream(n):
    port = zipfian_interactions(n, **STREAM)
    ref = jax_zipfian(n, **STREAM)
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(a, b)
    return port


def _run(job, users, items, ts, chunk=1000):
    for lo in range(0, len(users), chunk):
        job.add_batch(users[lo:lo + chunk], items[lo:lo + chunk],
                      ts[lo:lo + chunk])
    job.finish()
    return job


@pytest.mark.parametrize("count_dtype,emit", [("int32", False),
                                              ("int16", False),
                                              ("int32", True)])
@pytest.mark.parametrize("cuts", [(500, 500), (20, 8)])
def test_job_matches_jax_device_job(count_dtype, emit, cuts):
    users, items, ts = _stream(6000)
    kw = dict(window_size=10, seed=0xC0FFEE, item_cut=cuts[0],
              user_cut=cuts[1], count_dtype=count_dtype, emit_updates=emit,
              development_mode=True)
    port = _run(PortJob(PortConfig(**kw, device="cpu")), users, items, ts)
    ref = _run(JaxJob(JaxConfig(**kw, backend=Backend.DEVICE)), users,
               items, ts)
    assert port.windows_fired == ref.windows_fired > 5
    assert port.counters.as_dict() == ref.counters.as_dict()
    a, b = port.scorer.checkpoint_state(), ref.scorer.checkpoint_state()
    n = min(a["C"].shape[0], b["C"].shape[0])
    np.testing.assert_array_equal(a["C"][:n, :n], b["C"][:n, :n])
    assert not a["C"][n:].any() and not b["C"][n:].any()
    np.testing.assert_array_equal(a["row_sums"][:n], b["row_sums"][:n])
    np.testing.assert_array_equal(a["observed"], b["observed"])
    assert set(port.latest) == set(ref.latest) and len(port.latest) > 50
    for item in ref.latest:
        want, got = ref.latest[item], port.latest[item]
        assert len(want) == len(got), item
        w_scores = np.array([s for _, s in want])
        np.testing.assert_allclose([s for _, s in got], w_scores,
                                   rtol=1e-5, atol=1e-4)
        if len(w_scores) > 1 and np.min(np.abs(np.diff(w_scores))) > 1e-3:
            assert [j for j, _ in got] == [j for j, _ in want], item
