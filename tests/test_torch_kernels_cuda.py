"""The port's hand-written CUDA kernels against their plain PyTorch
versions, both on the card. Every test here is marked ``cuda`` and skips
without a card: a CUDA kernel has no CPU mode.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch (the repository's ``tests/conftest.py``
imports JAX; skip it there):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerance (``topk_parity``): scores ``rtol=1e-5, atol=1e-5``. Kernel and
plain version are both IEEE float32 in the same operation order (no fast
math, no FMA contraction), so they agree to the rounding of ``log1pf``.
"""

import numpy as np
import pytest
import torch

from tpu_cooccurrence_torch.ops import score_topk as st
from tpu_cooccurrence_torch.ops.device_scorer import DeviceScorer
from tpu_cooccurrence_torch.sampling.reservoir import PairDeltaBatch

RTOL = ATOL = 1e-5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _case(seed, n, s, dtype, wrap=False, empty_rows=1):
    rng = np.random.default_rng(seed)
    C = np.zeros((n, n), dtype=np.int64)
    nnz = 6 * n
    np.add.at(C, (rng.integers(0, n, nnz), rng.integers(0, n, nnz)),
              rng.integers(1, 4, nnz))
    if wrap:  # int16 counts past the short range wrap negative
        C[rng.random((n, n)) < 0.01] = 40_000
    rows = rng.choice(n, size=s, replace=False).astype(np.int32)
    C[rows[:empty_rows]] = 0
    rs = np.minimum(np.abs(C).sum(1), 2**31 - 1).astype(np.int32)
    observed = float(np.float32(rs.astype(np.int64).sum()))
    return C.astype(dtype), rs, rows, observed


def _assert_parity(got, want):
    gv, gi, wv, wi = (t.cpu().numpy() for t in (*got, *want))
    np.testing.assert_array_equal(np.isfinite(gv), np.isfinite(wv))
    ok, mism = st.topk_parity(gv, gi, wv, wi, rtol=RTOL, atol=ATOL)
    assert ok and mism == 0, (ok, mism)


@pytest.mark.cuda
@pytest.mark.parametrize("seed,n,s,k,dtype,wrap", [
    (0, 1007, 7, 10, np.int32, False),
    (1, 2053, 65, 128, np.int16, True),
    (2, 50, 1, 128, np.int32, False),      # K > I
    (3, 3001, 65, 1, np.int32, False),
])
def test_kernel_matches_plain_on_card(card, seed, n, s, k, dtype, wrap):
    C, rs, rows, observed = _case(seed, n, s, dtype, wrap=wrap)
    dev = [torch.from_numpy(a).to(card) for a in (C, rs, rows)]
    before = st.LAUNCHES
    got = st.score_topk(*dev, observed, k)
    assert st.LAUNCHES == before + 1
    want = st.score_topk_reference(*dev, observed, k)
    torch.cuda.synchronize()
    _assert_parity(got, want)


@pytest.mark.cuda
def test_kernel_rejects_top_k_above_its_cap(card):
    C, rs, rows, observed = _case(4, 64, 4, np.int32)
    dev = [torch.from_numpy(a).to(card) for a in (C, rs, rows)]
    with pytest.raises(ValueError, match="exceeds"):
        st.score_topk(*dev, observed, st.MAX_TOP_K + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("count_dtype", ["int32", "int16"])
def test_device_scorer_on_card_matches_cpu(card, count_dtype):
    """The scorer on the card keeps the same integer state as on the CPU
    and launches the kernel once per scored chunk."""
    rng = np.random.default_rng(5)
    on_card = DeviceScorer(300, 10, count_dtype=count_dtype, device=card,
                           defer_results=True)
    on_cpu = DeviceScorer(300, 10, count_dtype=count_dtype, device="cpu",
                          defer_results=True)
    before = st.LAUNCHES
    for _ in range(3):
        src = rng.integers(0, 300, 2000)
        dst = rng.integers(0, 300, 2000)
        delta = np.where(rng.random(2000) < 0.9, 1, -1).astype(np.int32)
        delta[:20] = 20_000  # int16 counts wrap
        for sc in (on_card, on_cpu):
            sc.process_window(0, PairDeltaBatch(src.copy(), dst.copy(),
                                                delta.copy()))
    assert st.LAUNCHES - before == 3
    a, b = on_card.checkpoint_state(), on_cpu.checkpoint_state()
    for key in ("C", "row_sums", "observed"):
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    x, y = on_card.flush(), on_cpu.flush()
    np.testing.assert_array_equal(x.rows, y.rows)
    ok, mism = st.topk_parity(x.vals, x.idx, y.vals, y.idx, rtol=RTOL,
                              atol=ATOL)
    assert ok and mism == 0, (ok, mism)
