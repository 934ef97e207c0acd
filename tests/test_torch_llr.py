"""The port's LLR (``tpu_cooccurrence_torch.ops.llr``) against the JAX
package's, on the same seeded numpy inputs.

Tolerances: both sides are float32 with the same operation order; they
differ only in the ``log1p`` implementation (XLA's CPU expansion vs
PyTorch's), which moves a score by a few float32 ulps. ``rtol=1e-5`` is
~80 ulps of headroom; ``atol=1e-4`` covers scores near zero, where the
four terms cancel to O(ulp of the largest term).
"""

import numpy as np
import pytest
import torch

from tpu_cooccurrence.ops import llr as jax_llr
from tpu_cooccurrence_torch.ops import llr as torch_llr

GOLDEN = [
    ((110, 2442, 111, 29114), 270.72),
    ((29, 13, 123, 31612), 263.90),
    ((9, 12, 429, 31327), 48.94),
]

RTOL, ATOL = 1e-5, 1e-4


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


@pytest.mark.parametrize("cells,expected", GOLDEN)
def test_golden_stable_f32(cells, expected):
    """Dunning's vectors (LogLikelihoodTest.java:13-16), tolerance 0.1 as
    in the reference test."""
    out = float(torch_llr.llr_stable(*(_t(np.float32(c)) for c in cells)))
    assert out == pytest.approx(expected, abs=0.1)


@pytest.mark.parametrize("cells,expected", GOLDEN)
def test_golden_entropy_f64_and_numpy(cells, expected):
    ent = float(torch_llr.llr_entropy(*(_t(c, torch.float64)
                                        for c in cells)))
    assert ent == pytest.approx(expected, abs=0.1)
    assert torch_llr.llr_np(*cells) == pytest.approx(expected, abs=0.1)
    # The numpy oracle is a verbatim copy: bit-identical to the JAX one.
    assert torch_llr.llr_np(*cells) == jax_llr.llr_np(*cells)


def _tables(seed, n, observed):
    rng = np.random.default_rng(seed)
    k11 = rng.integers(0, 500, n)
    k11[rng.random(n) < 0.1] = 0
    r1 = k11 + rng.integers(0, 500_000, n)
    r2 = rng.integers(0, 1_000_000, n)
    k21 = np.minimum(rng.integers(0, 500_000, n), r2)
    k12 = r1 - k11
    k22 = observed + k11 - k12 - k21
    return [a.astype(np.float32) for a in (k11, k12, k21, k22)]


@pytest.mark.parametrize("seed,observed", [
    (0, 3_000_000),            # small counts
    (1, 300_000_000),          # ~1e8
    (2, 30_000_000_000),       # the N ~ 3e10 regime of tests/test_llr.py
])
def test_stable_matches_jax_stable(seed, observed):
    cells = _tables(seed, 4000, observed)
    want = np.asarray(jax_llr.llr_stable_jit(*cells))
    got = torch_llr.llr_stable(*(_t(c) for c in cells)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # And both track the float64 oracle (the reason llr_stable exists).
    ref = torch_llr.llr_np(*(c.astype(np.float64) for c in cells))
    np.testing.assert_allclose(got, ref, rtol=5e-4, atol=5e-3)


def test_zero_and_degenerate_cells_match_jax():
    cases = np.array([(0, 1, 2, 3), (1, 0, 2, 3), (1, 2, 0, 3),
                      (1, 2, 3, 0), (0, 0, 0, 0), (5, 0, 0, 0),
                      (0, 5, 0, 0), (10, 20, 100, 200)],
                     dtype=np.float32).T
    want = np.asarray(jax_llr.llr_stable_jit(*cases))
    got = torch_llr.llr_stable(*(_t(c) for c in cases)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_score_contingency_matches_jax():
    rng = np.random.default_rng(7)
    n = 1000
    k11 = rng.integers(1, 50, n).astype(np.float32)
    rsi = (k11 + rng.integers(0, 5000, n)).astype(np.float32)
    rsj = (k11 + rng.integers(0, 5000, n)).astype(np.float32)
    observed = np.float32(2_000_000)
    want = np.asarray(jax_llr.score_contingency(k11, rsi, rsj, observed))
    got = torch_llr.score_contingency(_t(k11), _t(rsi), _t(rsj),
                                      _t(observed)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
