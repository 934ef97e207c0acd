"""The port's fused LLR + top-K (``tpu_cooccurrence_torch.ops.score_topk``)
against the JAX package's Pallas kernel (run in interpret mode, as
``tests/test_pallas_score.py`` runs it on the CPU) and its XLA body
``_score``, on the same seeded numpy inputs.

On the CPU the wrapper ``score_topk`` runs the plain PyTorch version; the
CUDA kernel itself is held against that plain version on the card
(``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``).

Tolerance (``topk_parity``): scores ``rtol=1e-5, atol=1e-4``. Both sides
are float32 with the same operation order; XLA's and PyTorch's CPU
``log1p`` differ by a few ulps, and a top-K score of ~1e3 has an ulp of
~6e-5. Ids must agree on every untied finite lane; tied lanes may order
differently only within the tie, and ``lax.top_k`` and the port's stable
sort both put the lowest column first.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_cooccurrence.ops.device_scorer import _score
from tpu_cooccurrence.ops.pallas_score import pallas_score_topk
from tpu_cooccurrence_torch.ops import score_topk as st

RTOL, ATOL = 1e-5, 1e-4


def _case(seed, n, s, dtype, wrap=False, empty_rows=0):
    """Seeded counts/row sums/rows; ``wrap`` puts int16 counts past the
    short range (they wrap, as the reference's Java shorts do)."""
    rng = np.random.default_rng(seed)
    C = np.zeros((n, n), dtype=np.int64)
    nnz = 6 * n
    np.add.at(C, (rng.integers(0, n, nnz), rng.integers(0, n, nnz)),
              rng.integers(1, 4, nnz))
    if wrap:
        C[rng.random((n, n)) < 0.01] = 40_000
    rows = rng.choice(n, size=s, replace=False).astype(np.int32)
    if empty_rows:
        C[rows[:empty_rows]] = 0
    rs = np.minimum(np.abs(C).sum(1), 2**31 - 1).astype(np.int32)
    C = C.astype(dtype)
    observed = np.float32(rs.astype(np.int64).sum())
    return C, rs, rows, observed


def _port(C, rs, rows, observed, k):
    vals, idx = st.score_topk(torch.from_numpy(C), torch.from_numpy(rs),
                              torch.from_numpy(rows), float(observed), k)
    assert vals.dtype == torch.float32 and idx.dtype == torch.int32
    return vals.numpy(), idx.numpy()


def _assert_parity(got, want):
    gv, gi = got
    wv, wi = (np.asarray(a) for a in want)
    assert gv.shape == wv.shape and gi.shape == wi.shape
    np.testing.assert_array_equal(np.isfinite(gv), np.isfinite(wv))
    ok, mism = st.topk_parity(gv, gi, wv, wi, rtol=RTOL, atol=ATOL)
    assert ok and mism == 0, (ok, mism)


@pytest.mark.parametrize("seed,n,s,k,dtype,wrap", [
    (0, 256, 8, 5, np.int32, False),
    (1, 512, 16, 10, np.int32, False),
    (2, 256, 16, 16, np.int16, True),
    (3, 256, 8, 128, np.int16, True),
])
def test_reference_matches_pallas_interpret(seed, n, s, k, dtype, wrap):
    C, rs, rows, observed = _case(seed, n, s, dtype, wrap=wrap,
                                  empty_rows=1)
    want = pallas_score_topk(jnp.asarray(C), jnp.asarray(rs),
                             jnp.asarray(rows), observed, top_k=k,
                             tile=128, interpret=True)
    _assert_parity(_port(C, rs, rows, observed, k), want)


@pytest.mark.parametrize("seed,n,s,k,dtype,wrap", [
    (4, 300, 9, 5, np.int32, False),
    (5, 257, 33, 10, np.int16, True),
    (6, 500, 64, 16, np.int32, False),
    (7, 200, 12, 128, np.int32, False),
    (8, 100, 7, 128, np.int16, True),      # K > I: pads with (-inf, 0)
    (9, 40, 5, 64, np.int32, False),       # K > I
])
def test_reference_matches_xla_score(seed, n, s, k, dtype, wrap):
    C, rs, rows, observed = _case(seed, n, s, dtype, wrap=wrap,
                                  empty_rows=2)
    want = _score(jnp.asarray(C), jnp.asarray(rs), jnp.asarray(rows),
                  observed, top_k=k)
    got = _port(C, rs, rows, observed, k)
    _assert_parity(got, want)
    if k > n:
        assert np.isneginf(got[0][:, n:]).all()
        assert (got[1][:, n:] == 0).all()


def test_empty_rows_are_all_neg_inf():
    n = 128
    C = np.zeros((n, n), dtype=np.int32)
    rs = np.zeros(n, dtype=np.int32)
    rows = np.arange(4, dtype=np.int32)
    vals, _ = _port(C, rs, rows, 0.0, 10)
    assert np.isneginf(vals).all()
    want, _ = pallas_score_topk(jnp.asarray(C), jnp.asarray(rs),
                                jnp.asarray(rows), np.float32(0.0),
                                top_k=10, tile=128, interpret=True)
    assert np.isneginf(np.asarray(want)).all()


def test_ties_take_the_lowest_column():
    """Equal scores order by column ascending, like lax.top_k."""
    n = 16
    C = np.zeros((n, n), dtype=np.int32)
    C[0, [9, 3, 12, 5]] = 2          # four identical cells in row 0
    rs = np.full(n, 2, dtype=np.int32)
    rs[0] = 8
    rows = np.array([0], dtype=np.int32)
    vals, idx = _port(C, rs, rows, 40.0, 4)
    assert len(set(vals[0].tolist())) == 1
    assert idx[0].tolist() == [3, 5, 9, 12]
    want_vals, want_idx = _score(jnp.asarray(C), jnp.asarray(rs),
                                 jnp.asarray(rows), np.float32(40.0),
                                 top_k=4)
    assert np.asarray(want_idx)[0].tolist() == [3, 5, 9, 12]


def test_cpu_wrapper_is_the_plain_version_and_counts_no_launch():
    C, rs, rows, observed = _case(10, 64, 6, np.int32)
    before = st.LAUNCHES
    a = _port(C, rs, rows, observed, 5)
    b = st.score_topk_reference(torch.from_numpy(C), torch.from_numpy(rs),
                                torch.from_numpy(rows), float(observed), 5)
    assert st.LAUNCHES == before
    np.testing.assert_array_equal(a[0], b[0].numpy())
    np.testing.assert_array_equal(a[1], b[1].numpy())


@pytest.mark.parametrize("bad", ["dtype", "rows_dtype", "shape", "k"])
def test_wrapper_rejects_bad_inputs(bad):
    C = torch.zeros((8, 8), dtype=torch.int32)
    rs = torch.zeros(8, dtype=torch.int32)
    rows = torch.zeros(2, dtype=torch.int32)
    k = 3
    if bad == "dtype":
        C = C.to(torch.int64)
    elif bad == "rows_dtype":
        rows = rows.to(torch.int64)
    elif bad == "shape":
        C = torch.zeros((8, 9), dtype=torch.int32)
    else:
        k = 0
    with pytest.raises(ValueError):
        st.score_topk(C, rs, rows, 0.0, k)
