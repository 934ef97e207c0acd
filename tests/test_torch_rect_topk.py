"""The port's sparse-row LLR + top-K (``tpu_cooccurrence_torch.ops.rect_topk``)
against the JAX package's XLA body ``_score_rect`` (jitted, CPU) and its
Pallas kernel ``pallas_score_rect`` (interpret mode, as
``tests/test_pallas_rect.py`` runs it), on the same seeded numpy slabs.

On the CPU the wrapper ``rect_topk`` runs the plain PyTorch version; the
CUDA kernel itself is held against that plain version on the card
(``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``).

Tolerance (``topk_parity``): scores ``rtol=atol=1e-5``. Both sides are
float32 with the same operation order; XLA's and PyTorch's CPU ``log1p``
may differ by a few ulps, far inside the relative bound. Ids must agree
on every untied finite lane; among tied scores both sides put the
earliest slab slot first.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_cooccurrence.ops.pallas_score import pallas_score_rect
from tpu_cooccurrence.state.sparse_scorer import _score_slab
from tpu_cooccurrence.state.sparse_scorer import (
    score_buckets as jax_score_buckets)
from tpu_cooccurrence_torch.ops import rect_topk as rt
from tpu_cooccurrence_torch.ops.score_topk import topk_parity

RTOL = ATOL = 1e-5


def _slab(seed, n_rows, num_items, max_len, zero_frac=0.1, big=False,
          short_rows=0):
    """Seeded slab: ``n_rows`` rows with random lens in [0, max_len]
    (``short_rows`` of them under 4 cells), contiguous starts behind a
    stale prefix, random partner ids and counts (some zero = cancelled),
    plus two all-padding rows (len 0). ``big`` takes counts and row sums
    into the observed ~ 3e10 regime."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, max_len + 1, n_rows).astype(np.int32)
    lens[:short_rows] = rng.integers(1, 4, short_rows)
    lens = np.concatenate([lens, [0, 0]]).astype(np.int32)
    starts = (5 + np.concatenate([[0], np.cumsum(lens)[:-1]])).astype(
        np.int32)
    cap = int(starts[-1] + 8)
    hi = 100_000 if big else 50
    cnt = rng.integers(1, hi, cap).astype(np.int32)
    cnt[rng.random(cap) < zero_frac] = 0
    dst = rng.integers(0, num_items, cap).astype(np.int32)
    rows = rng.choice(num_items, n_rows + 2, replace=False).astype(np.int32)
    if big:
        row_sums = rng.integers(500_000_000, 2_000_000_000, num_items)
        observed = np.float32(3e10)
    else:
        row_sums = rng.integers(1, 1 << 16, num_items)
        observed = np.float32(1e7)
    return (cnt, dst, row_sums.astype(np.int32), rows, starts, lens,
            observed)


def _port(case, k):
    cnt, dst, rs, rows, starts, lens, observed = case
    vals, ids = rt.rect_topk(*(torch.from_numpy(a) for a in
                               (cnt, dst, rs, rows, starts, lens)),
                             float(observed), k)
    assert vals.dtype == torch.float32 and ids.dtype == torch.int32
    return vals.numpy(), ids.numpy()


def _jax(case, k, R, pallas=False):
    cnt, dst, rs, rows, starts, lens, observed = case
    meta = jnp.asarray(np.stack([rows, starts, lens]))
    args = (jnp.asarray(cnt), jnp.asarray(dst), jnp.asarray(rs), meta,
            observed)
    if pallas:
        packed = pallas_score_rect(*args, top_k=k, R=R, interpret=True)
    else:
        packed = _score_slab(*args, top_k=k, R=R)
    host = np.asarray(packed)
    return host[0], host[1].view(np.int32)


def _assert_parity(got, want):
    gv, gi = got
    wv, wi = want
    assert gv.shape == wv.shape and gi.shape == wi.shape
    np.testing.assert_array_equal(np.isfinite(gv), np.isfinite(wv))
    ok, mism = topk_parity(gv, gi, wv, wi, rtol=RTOL, atol=ATOL)
    assert ok and mism == 0, (ok, mism)
    # Lanes past a row's live cells: (-inf, 0) on both sides.
    np.testing.assert_array_equal(gi[~np.isfinite(gv)], 0)
    np.testing.assert_array_equal(wi[~np.isfinite(wv)], 0)


def _width(lens, k):
    """The smallest bucket width holding every row (one rectangle)."""
    return max(rt.min_rect_width(k), 1 << int(np.ceil(np.log2(
        max(int(lens.max()), 1)))))


@pytest.mark.parametrize("seed,n_rows,max_len,k,kw", [
    (0, 13, 40, 10, {}),
    (1, 24, 300, 10, dict(short_rows=6)),              # rows shorter than K
    (2, 9, 5000, 16, dict(zero_frac=0.5)),             # > one 2048 tile
    (3, 12, 200, 10, dict(big=True)),                  # observed ~ 3e10
    (4, 30, 20, 128, dict(short_rows=10)),             # K = 128 > lens
    (5, 7, 100, 1, dict(zero_frac=0.9)),               # mostly cancelled
])
def test_reference_matches_xla_score_rect(seed, n_rows, max_len, k, kw):
    case = _slab(seed, n_rows, 4096, max_len, **kw)
    got = _port(case, k)
    _assert_parity(got, _jax(case, k, _width(case[5], k)))


@pytest.mark.parametrize("seed,n_rows,R,kw", [
    (6, 13, 256, dict(short_rows=4)),    # one column tile, ragged rows
    (7, 9, 4096, dict(zero_frac=0.3)),   # two column tiles: the merge
    (8, 8, 512, dict(big=True)),         # observed ~ 3e10
])
def test_reference_matches_pallas_interpret(seed, n_rows, R, kw):
    case = _slab(seed, n_rows, 2048, R, **kw)
    _assert_parity(_port(case, 10), _jax(case, 10, R, pallas=True))


def test_ties_take_the_earliest_slot():
    """Six cells with identical counts and partner sums tie exactly; the
    earliest slots win, in slot order, on both sides."""
    num_items, R, k = 512, 256, 4
    cnt = np.zeros(R, dtype=np.int32)
    cnt[:6] = 5
    dst = np.zeros(R, dtype=np.int32)
    partners = np.asarray([40, 30, 20, 10, 50, 60], dtype=np.int32)
    dst[:6] = partners
    rs = np.full(num_items, 1000, dtype=np.int32)
    case = (cnt, dst, rs, np.asarray([7], np.int32),
            np.asarray([0], np.int32), np.asarray([6], np.int32),
            np.float32(1e6))
    vals, ids = _port(case, k)
    assert len(set(vals[0].tolist())) == 1
    np.testing.assert_array_equal(ids[0], partners[:k])
    for pallas in (False, True):
        _, want = _jax(case, k, R, pallas=pallas)
        np.testing.assert_array_equal(want[0], partners[:k])


def test_zero_cells_and_empty_rows_score_neg_inf():
    cnt = np.asarray([0, 0, 3, 0], dtype=np.int32)
    dst = np.asarray([1, 2, 3, 4], dtype=np.int32)
    rs = np.full(8, 6, dtype=np.int32)
    case = (cnt, dst, rs, np.asarray([0, 5], np.int32),
            np.asarray([0, 0], np.int32), np.asarray([4, 0], np.int32),
            np.float32(40.0))
    vals, ids = _port(case, 3)
    assert np.isfinite(vals[0, 0]) and ids[0, 0] == 3
    assert np.isneginf(vals[0, 1:]).all() and (ids[0, 1:] == 0).all()
    assert np.isneginf(vals[1]).all() and (ids[1] == 0).all()
    _assert_parity((vals, ids), _jax(case, 3, 16))


def test_buckets_match_jax():
    lens = np.random.default_rng(9).integers(0, 70_000, 500)
    for ladder in (2, 4, 16):
        for min_r in (16, 128):
            got = rt.score_buckets(lens, min_r, ladder)
            want = jax_score_buckets(lens, min_r, ladder)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
            widths = [rt.bucket_r(int(b), min_r, ladder) for b in got[0]]
            assert (np.asarray(widths) >= np.maximum(lens, 1)).all()
    with pytest.raises(ValueError, match="power of two"):
        rt.ladder_bits(6)


def test_cpu_wrapper_is_the_plain_version_and_counts_no_launch():
    case = _slab(10, 11, 256, 300)
    t = [torch.from_numpy(a) for a in case[:6]]
    before = rt.LAUNCHES
    a = _port(case, 10)
    b = rt.rect_topk_reference(*t, float(case[6]), 10)
    assert rt.LAUNCHES == before
    np.testing.assert_array_equal(a[0], b[0].numpy())
    np.testing.assert_array_equal(a[1], b[1].numpy())


@pytest.mark.parametrize("bad", ["cnt_dtype", "meta_len", "dst_len", "k",
                                 "dst_dtype"])
def test_wrapper_rejects_bad_inputs(bad):
    cnt = torch.zeros(8, dtype=torch.int32)
    dst = torch.zeros(8, dtype=torch.int32)
    rs = torch.zeros(4, dtype=torch.int32)
    rows = torch.zeros(2, dtype=torch.int32)
    starts, lens = rows.clone(), rows.clone()
    k = 3
    if bad == "cnt_dtype":
        cnt = cnt.to(torch.int64)
    elif bad == "meta_len":
        lens = torch.zeros(3, dtype=torch.int32)
    elif bad == "dst_len":
        dst = torch.zeros(9, dtype=torch.int32)
    elif bad == "dst_dtype":  # only cnt takes a narrow cell dtype
        dst = dst.to(torch.int16)
    else:
        k = 0
    with pytest.raises(ValueError):
        rt.rect_topk(cnt, dst, rs, rows, starts, lens, 0.0, k)
