"""The port's local-block LLR + top-K
(``tpu_cooccurrence_torch.ops.score_topk.score_topk_local``, the sharded
backend's scorer) against the JAX package's ``pallas_score_topk_local``
(run in interpret mode, as the JAX package's tests run Pallas on the CPU)
on the same seeded numpy inputs: a row block ``C_loc [R, I]`` at offset
``lo > 0``, global row ids, the global row sums.

On the CPU the wrapper runs the plain version; the CUDA kernel is held
against it on the card (``tests/test_torch_kernels_cuda.py`` and
``chip_smoke.py`` phase 12).

Tolerance (``topk_parity``): scores ``rtol=1e-5, atol=1e-5``, ids equal on
every untied finite lane. Both sides are float32 in the same operation
order; at these counts a score is below ~30 and XLA's and PyTorch's CPU
``log1p`` differ by an ulp or two (~2e-6 there). The JAX side carries ids
as float values (decoded with ``astype``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_cooccurrence.ops.pallas_score import pallas_score_topk_local
from tpu_cooccurrence_torch.ops import score_topk as st

RTOL = ATOL = 1e-5
I, R = 256, 64


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One torch intra-op thread while a test runs: these tensors are
    small, and under a parallel test run the default thread pool's
    workers wait on each other for most of the wall time."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(seed, lo, s, dtype, wrap=False):
    """The block of rows ``[lo, lo + R)`` of a seeded ``I x I`` matrix,
    the global row sums and ``s`` global rows of the block: its first and
    last row, one all-zero row, the rest random."""
    rng = np.random.default_rng(seed)
    C = np.zeros((I, I), dtype=np.int64)
    nnz = 6 * I
    np.add.at(C, (rng.integers(0, I, nnz), rng.integers(0, I, nnz)),
              rng.integers(1, 4, nnz))
    if wrap:  # int16 counts past the short range wrap, as Java shorts do
        C[rng.random((I, I)) < 0.01] = 40_000
    inner = rng.choice(np.arange(lo + 1, lo + R - 1), s - 2, replace=False)
    rows = np.r_[lo, inner, lo + R - 1].astype(np.int32)
    C[rows[1]] = 0
    rs = np.minimum(np.abs(C).sum(1), 2**31 - 1).astype(np.int32)
    C = C.astype(dtype)
    observed = np.float32(rs.astype(np.int64).sum())
    return C, rs, rows, observed


def _local(C, rs, rows, lo, observed, k):
    vals, idx = st.score_topk_local(
        torch.from_numpy(np.ascontiguousarray(C[lo:lo + R])),
        torch.from_numpy(rs), torch.from_numpy(rows), lo, float(observed),
        k)
    assert vals.dtype == torch.float32 and idx.dtype == torch.int32
    return vals.numpy(), idx.numpy()


@pytest.mark.parametrize("seed,lo,k,dtype,wrap", [
    (0, 64, 10, np.int32, False),
    (1, 192, 5, np.int32, False),
    (2, 64, 16, np.int16, True),
    (3, 128, 128, np.int16, True),
])
def test_reference_matches_pallas_local_interpret(seed, lo, k, dtype, wrap):
    C, rs, rows, observed = _case(seed, lo, 12, dtype, wrap)
    packed = np.asarray(pallas_score_topk_local(
        jnp.asarray(C[lo:lo + R]), jnp.asarray(rs), jnp.asarray(rows), lo,
        observed, top_k=k, tile=128, interpret=True))
    want_v, want_i = packed[0], packed[1].astype(np.int32)
    got_v, got_i = _local(C, rs, rows, lo, observed, k)
    assert got_v.shape == want_v.shape == (len(rows), k)
    np.testing.assert_array_equal(np.isfinite(got_v), np.isfinite(want_v))
    ok, mism = st.topk_parity(got_v, got_i, want_v, want_i, rtol=RTOL,
                              atol=ATOL)
    assert ok and mism == 0, (ok, mism)
    assert np.isneginf(got_v[1]).all()  # the all-zero row


@pytest.mark.parametrize("lo,dtype", [(0, np.int32), (64, np.int16),
                                      (192, np.int32)])
def test_local_equals_dense_reference_bit_for_bit(lo, dtype):
    """A block of C scored locally equals the dense plain version on the
    whole C, scores and ids, every lane of every row."""
    C, rs, rows, observed = _case(4, lo, 20, dtype)
    got = _local(C, rs, rows, lo, observed, 10)
    want = st.score_topk_reference(torch.from_numpy(C), torch.from_numpy(rs),
                                   torch.from_numpy(rows), float(observed),
                                   10)
    np.testing.assert_array_equal(got[0], want[0].numpy())
    np.testing.assert_array_equal(got[1], want[1].numpy())


def test_rows_outside_the_block_are_empty():
    lo = 64
    C, rs, rows, observed = _case(5, lo, 8, np.int32)
    outside = np.array([0, lo - 1, lo + R, I - 1, rows[0]], dtype=np.int32)
    vals, _ = _local(C, rs, outside, lo, observed, 10)
    assert np.isneginf(vals[:4]).all()
    assert np.isfinite(vals[4]).any()


def test_cpu_wrapper_is_the_plain_version_and_counts_no_launch():
    lo = 128
    C, rs, rows, observed = _case(6, lo, 10, np.int16)
    before = st.LAUNCHES
    a = _local(C, rs, rows, lo, observed, 7)
    b = st.score_topk_local_reference(
        torch.from_numpy(np.ascontiguousarray(C[lo:lo + R])),
        torch.from_numpy(rs), torch.from_numpy(rows), lo, float(observed), 7)
    assert st.LAUNCHES == before
    np.testing.assert_array_equal(a[0], b[0].numpy())
    np.testing.assert_array_equal(a[1], b[1].numpy())


@pytest.mark.parametrize("bad", ["lo_negative", "block_past_end",
                                 "row_sums_length", "dtype", "k"])
def test_wrapper_rejects_bad_inputs(bad):
    C = torch.zeros((R, I), dtype=torch.int32)
    rs = torch.zeros(I, dtype=torch.int32)
    rows = torch.zeros(2, dtype=torch.int32)
    lo, k = 64, 3
    if bad == "lo_negative":
        lo = -1
    elif bad == "block_past_end":
        lo = I - R + 1
    elif bad == "row_sums_length":
        rs = torch.zeros(R, dtype=torch.int32)
    elif bad == "dtype":
        C = C.to(torch.int64)
    else:
        k = 0
    with pytest.raises(ValueError):
        st.score_topk_local(C, rs, rows, lo, 0.0, k)
