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
The expand + scatter kernel's results are integers: exactly equal.
"""

import numpy as np
import pytest
import torch

from tpu_cooccurrence_torch.ops import expand as ex
from tpu_cooccurrence_torch.ops import rect_topk as rt
from tpu_cooccurrence_torch.ops import score_topk as st
from tpu_cooccurrence_torch.ops.device_scorer import DeviceScorer
from tpu_cooccurrence_torch.sampling.reservoir import (BasketBatch,
                                                       PairDeltaBatch)
from tpu_cooccurrence_torch.state.sparse_scorer import SparseDeviceScorer

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


def _slab(seed, n_rows, num_items, max_len, zero_frac=0.1):
    """Seeded slab rows: random lens in [0, max_len], contiguous regions,
    random counts (some zero) and partner ids."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, max_len + 1, n_rows).astype(np.int32)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int32)
    cap = int(lens.sum()) + 4
    cnt = rng.integers(1, 50, cap).astype(np.int32)
    cnt[rng.random(cap) < zero_frac] = 0
    dst = rng.integers(0, num_items, cap).astype(np.int32)
    rows = rng.choice(num_items, n_rows, replace=False).astype(np.int32)
    rs = rng.integers(1, 1 << 16, num_items).astype(np.int32)
    return cnt, dst, rs, rows, starts, lens, 1e7


@pytest.mark.cuda
@pytest.mark.parametrize("seed,n_rows,max_len,k", [
    (10, 300, 12, 10),       # most rows shorter than K
    (11, 40, 5000, 10),      # rows across several 2048-cell tiles
    (12, 64, 300, 128),
    (13, 9, 100, 1),
])
def test_rect_kernel_matches_plain_on_card(card, seed, n_rows, max_len, k):
    *arrays, observed = _slab(seed, n_rows, 4096, max_len)
    dev = [torch.from_numpy(a).to(card) for a in arrays]
    before = rt.LAUNCHES
    got = rt.rect_topk(*dev, observed, k)
    assert rt.LAUNCHES == before + 1
    want = rt.rect_topk_reference(*dev, observed, k)
    torch.cuda.synchronize()
    _assert_parity(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n_short,k", [
    (77, 10),       # rows of every length in both classes
    (0, 128),       # no short class; K above most rows' cells
    (200, 1),       # every row one warp
])
def test_rect_kernel_under_any_plan_is_exact(card, n_short, k):
    """Any plan gives the plain version's lanes: scores bit for bit and
    ids on every finite lane, ties included (few distinct counts, one
    partner row sum), with one counted launch per call."""
    cnt, dst, rs, rows, starts, lens, observed = _slab(14, 200, 4096, 700)
    rng = np.random.default_rng(15)
    cnt = np.where(cnt != 0, rng.integers(1, 3, len(cnt)), 0).astype(np.int32)
    rs[:] = 1 << 14
    dev = [torch.from_numpy(a).to(card) for a in
           (cnt, dst, rs, rows, starts, lens)]
    before = rt.LAUNCHES
    got = rt.rect_topk(*dev, observed, k, n_short)
    assert rt.LAUNCHES == before + 1
    want = rt.rect_topk_reference(*dev, observed, k)
    gv, gi, wv, wi = (t.cpu().numpy() for t in (*got, *want))
    fin = np.isfinite(wv)
    np.testing.assert_array_equal(np.isfinite(gv), fin)
    np.testing.assert_array_equal(gv[fin], wv[fin])
    np.testing.assert_array_equal(gi[fin], wi[fin])


@pytest.mark.cuda
def test_score_kernel_ties_take_the_lowest_column_on_card(card):
    n = 4099  # odd: every int16 row starts at another alignment
    C = np.ones((n, n), dtype=np.int16)
    rs = np.full(n, 3 * n, dtype=np.int32)
    rows = np.arange(0, n, 97, dtype=np.int32)
    dev = [torch.from_numpy(a).to(card) for a in (C, rs, rows)]
    vals, idx = st.score_topk(*dev, float(n * n), 128)
    assert (idx.cpu().numpy() == np.arange(128)).all()
    assert torch.isfinite(vals).all()


@pytest.mark.cuda
@pytest.mark.parametrize("block", [1, 3])
@pytest.mark.parametrize("dtype,k", [(np.int32, 10), (np.int16, 128)])
def test_local_kernel_matches_plain_on_card(card, block, dtype, k):
    """``score_topk_local`` over block ``block`` of four (513 rows of an
    I = 2052 matrix: odd, so int16 rows start at every alignment): the
    block's first and last rows, an all-zero row and rows outside the
    block (empty rows), ids exact on every finite lane."""
    n, r = 2052, 513
    C, rs, _, observed = _case(20 + block, n, 1, dtype, wrap=dtype == np.int16)
    lo = block * r
    rng = np.random.default_rng(block)
    rows = np.r_[lo, lo + r - 1, rng.choice(np.arange(lo + 1, lo + r - 1),
                                           60, replace=False),
                 0, lo - 2, lo - 1, (lo + r) % n].astype(np.int32)
    C[rows[2]] = 0
    c_loc = torch.from_numpy(C[lo:lo + r].copy()).to(card)
    dev = [torch.from_numpy(a).to(card) for a in (rs, rows)]
    before = st.LAUNCHES
    got = st.score_topk_local(c_loc, *dev, lo, observed, k)
    assert st.LAUNCHES == before + 1
    want = st.score_topk_local_reference(c_loc, *dev, lo, observed, k)
    torch.cuda.synchronize()
    gv, gi, wv, wi = (t.cpu().numpy() for t in (*got, *want))
    fin = np.isfinite(wv)
    assert np.array_equal(np.isfinite(gv), fin)
    assert np.array_equal(gv[fin], wv[fin]) and np.array_equal(gi[fin],
                                                                wi[fin])
    assert np.isneginf(gv[2]).all() and np.isneginf(gv[-4:]).all()
    assert np.isfinite(gv[:2, 0]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("count_dtype", ["int32", "int16"])
def test_sharded_scorer_on_one_card_matches_dense(card, count_dtype):
    """Two shards on one card keep the dense scorer's integer state, and
    their rows (one window late) equal the dense scorer's bit for bit."""
    from tpu_cooccurrence_torch.parallel.sharded import ShardedScorer

    rng = np.random.default_rng(9)
    sharded = ShardedScorer(0, 10, count_dtype=count_dtype,
                            mesh=[card, card])
    dense = DeviceScorer(0, 10, count_dtype=count_dtype, device=card)
    before = st.LAUNCHES
    outs, wants = [], []
    for hi in (300, 1500, 1500):
        src = rng.integers(0, hi, 3000)
        dst = rng.integers(0, hi, 3000)
        delta = np.where(rng.random(3000) < 0.9, 1, -1).astype(np.int32)
        delta[:20] = 20_000  # int16 counts wrap
        batch = (src, dst, delta)
        outs.append(sharded.process_window(0, PairDeltaBatch(
            *(a.copy() for a in batch))))
        wants.append(dense.process_window(0, PairDeltaBatch(
            *(a.copy() for a in batch))))
    outs.append(sharded.flush())
    assert st.LAUNCHES - before >= 3 + 2 * 3
    a, b = sharded.checkpoint_state(), dense.checkpoint_state()
    n = min(len(a["row_sums"]), len(b["row_sums"]))
    np.testing.assert_array_equal(a["C"][:n, :n], b["C"][:n, :n])
    np.testing.assert_array_equal(a["row_sums"][:n], b["row_sums"][:n])
    assert a["observed"] == b["observed"]
    for got, want in zip(outs[1:], wants):
        order = np.argsort(got.rows, kind="stable")
        np.testing.assert_array_equal(got.rows[order], want.rows)
        np.testing.assert_array_equal(got.vals[order], want.vals)
        np.testing.assert_array_equal(got.idx[order], want.idx)


@pytest.mark.cuda
def test_sparse_scorer_on_card_matches_cpu(card):
    """The sparse scorer on the card keeps the same canonical state as on
    the CPU and launches the rect kernel once per window."""
    rng = np.random.default_rng(6)
    on_card = SparseDeviceScorer(10, device=card, defer_results=True,
                                 capacity=1024, compact_min_heap=256)
    on_cpu = SparseDeviceScorer(10, device="cpu", defer_results=True,
                                capacity=1024, compact_min_heap=256)
    before = rt.LAUNCHES
    for _ in range(4):
        src = (rng.pareto(1.1, 3000) * 5).astype(np.int64) % 400
        dst = rng.integers(0, 400, 3000)
        delta = np.ones(3000, dtype=np.int32)
        for sc in (on_card, on_cpu):
            sc.process_window(0, PairDeltaBatch(src.copy(), dst.copy(),
                                                delta.copy()))
    assert rt.LAUNCHES - before == 4
    a, b = on_card.checkpoint_state(), on_cpu.checkpoint_state()
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    x, y = on_card.flush(), on_cpu.flush()
    np.testing.assert_array_equal(x.rows, y.rows)
    ok, mism = st.topk_parity(x.vals, x.idx, y.vals, y.idx, rtol=RTOL,
                              atol=ATOL)
    assert ok and mism == 0, (ok, mism)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,top", [(torch.int16, 32_767),
                                       (torch.int8, 127)])
@pytest.mark.parametrize("k", [1, 10, 128])
def test_rect_kernel_narrow_cells_exact_on_card(card, dtype, top, k):
    """At int16 and int8 cells (counts up to the dtype's maximum, rows in
    both size classes, ties from few distinct counts) the kernel gives
    the plain version's lanes bit for bit, and the plain version its
    int32 result."""
    cnt, dst, rs, rows, starts, lens, observed = _slab(16, 300, 4096, 3000)
    rng = np.random.default_rng(17)
    cnt = np.where(cnt != 0, rng.choice([1, 2, top - 1, top], len(cnt)),
                   0).astype(np.int32)
    dev = [torch.from_numpy(a).to(card) for a in
           (cnt, dst, rs, rows, starts, lens)]
    narrow = [dev[0].to(dtype), *dev[1:]]
    before = rt.LAUNCHES
    got = rt.rect_topk(*narrow, observed, k, rt.short_rows(lens))
    assert rt.LAUNCHES == before + 1
    want = rt.rect_topk_reference(*narrow, observed, k)
    wide = rt.rect_topk_reference(*dev, observed, k)
    for g, w, w32 in zip(got, want, wide):
        assert torch.equal(g, w) and torch.equal(w, w32)


@pytest.mark.cuda
def test_decode_update_on_card_equals_host(card):
    from tpu_cooccurrence_torch.state import wire

    rng = np.random.default_rng(18)
    n_new, n_d, n_rs = 700, 30_000, 900
    upd = np.empty((2, n_new + n_d + n_rs), dtype=np.int32)
    slots = rng.choice(1 << 24, n_new + n_d, replace=False)
    upd[0, :n_new + n_d] = slots
    upd[1, :n_new] = rng.integers(0, 1 << 30, n_new)
    upd[1, n_new:n_new + n_d] = rng.integers(-(2**31), 2**31, n_d)
    upd[0, n_new + n_d:] = rng.choice(1 << 20, n_rs, replace=False)
    upd[1, n_new + n_d:] = rng.integers(-30000, 30000, n_rs)
    words_i, words_v, header = wire.encode_update(upd, (n_new, n_new + n_d),
                                                  upd.shape[1])
    got, bounds = wire.decode_update(wire.words_tensor(words_i, card),
                                     wire.words_tensor(words_v, card),
                                     header, upd.shape[1] + 5)
    want, want_b = wire.decode_update_host(words_i, words_v, header,
                                           upd.shape[1] + 5)
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    assert list(bounds) == want_b.tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["int16", "int8"])
def test_narrow_packed_scorer_on_card_matches_cpu(card, cell):
    """Narrow cells with promotion and the packed uplink: the same
    canonical state and promoted rows as on the CPU, rows in the same
    order and in ``topk_parity``; one rect launch a window and one more
    in each window that scores wide rows."""
    rng = np.random.default_rng(19)
    kw = dict(device=card, defer_results=False, capacity=1024,
              compact_min_heap=256, cell_dtype=cell, wire_format="packed")
    on_card = SparseDeviceScorer(10, **kw)
    on_cpu = SparseDeviceScorer(10, **{**kw, "device": "cpu"})
    before, wide_windows, outs = rt.LAUNCHES, 0, ([], [])
    for _ in range(8):
        src = (rng.pareto(1.1, 3000) * 5).astype(np.int64) % 400
        dst = rng.integers(0, 400, 3000)
        delta = np.ones(3000, dtype=np.int32)
        src[0], dst[0], delta[0] = 0, 1, 12_000  # past 32,767 in window 3
        for sc, out in zip((on_card, on_cpu), outs):
            out.append(sc.process_window(0, PairDeltaBatch(
                src.copy(), dst.copy(), delta.copy())))
        wide_windows += int(on_cpu.wide_rows[np.unique(src)].any())
    outs[0].append(on_card.flush())
    outs[1].append(on_cpu.flush())
    assert rt.LAUNCHES - before == 8 + wide_windows
    assert on_card.promoted_rows == on_cpu.promoted_rows > 0
    np.testing.assert_array_equal(on_card.wide_rows, on_cpu.wide_rows)
    a, b = on_card.checkpoint_state(), on_cpu.checkpoint_state()
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    for x, y in zip(*outs):
        np.testing.assert_array_equal(x.rows, y.rows)
        ok, mism = st.topk_parity(x.vals, x.idx, y.vals, y.idx, rtol=RTOL,
                                  atol=ATOL)
        assert ok and mism == 0, (ok, mism)


def _basket_ops(seed, n, w, num_items, hot_new=None):
    """Seeded star ops as a :class:`BasketBatch`: len 0 and len W ops,
    skips in range and past len, signs +-1, garbage past each len, and
    (``hot_new``) every op on the same new item. ``hot_new="zipf"``:
    new items and partners drawn Zipf 1.1, so a few partners recur in
    nearly every op, as on the bench stream. ``hot_new="wrap"``: half
    the ops add +1 to the cells (3, 5)/(5, 3), half -1 to (7, 11)/(11, 7),
    one cell each (W = 1)."""
    rng = np.random.default_rng(seed)
    if hot_new == "wrap":
        half = n // 2
        return BasketBatch(*(a.astype(np.int32) for a in (
            np.r_[np.full(half, 3), np.full(n - half, 7)],
            np.r_[np.full((half, 1), 5), np.full((n - half, 1), 11)],
            np.ones(n), np.full(n, -1),
            np.r_[np.ones(half), -np.ones(n - half)])))
    lens = rng.integers(0, w + 1, n)
    lens[0], lens[1] = 0, w
    j = np.arange(w)[None, :]
    if hot_new == "zipf":
        draw = (rng.zipf(1.1, (n, w + 1)) - 1) % num_items
        partners, hot_new = draw[:, :w], draw[:, w]
    else:
        partners = rng.integers(0, num_items, (n, w))
    baskets = np.where(j < lens[:, None], partners,
                       rng.integers(-2**31, 2**31 - 1, (n, w)))
    skips = np.where(rng.random(n) < 0.4, rng.integers(0, w + 2, n), -1)
    signs = np.where(rng.random(n) < 0.7, 1, -1)
    new = (np.broadcast_to(hot_new, n) if hot_new is not None
           else rng.integers(0, num_items, n))
    return BasketBatch(*(a.astype(np.int32) for a in
                         (new, baskets, lens, skips, signs)))


@pytest.mark.cuda
@pytest.mark.parametrize("seed,n,w,n_items,dtype,hot", [
    (20, 500, 40, 300, torch.int32, None),
    (21, 500, 40, 1001, torch.int16, None),     # odd I: the last cell
    (22, 3000, 3, 64, torch.int16, 7),          # contention, wraparound
    (23, 65, 700, 4096, torch.int32, None),     # rows wider than a warp
    (24, 100_000, 1, 2000, torch.int16, None),  # W = 1: one cell an op
    (25, 8000, 71, 5000, torch.int32, "zipf"),  # Zipf-hot partners
    (26, 8000, 71, 5000, torch.int16, "zipf"),
    (27, 80_000, 1, 64, torch.int16, "wrap"),   # int16 wraparound
])
def test_expand_kernel_matches_plain_on_card(card, seed, n, w, n_items, dtype,
                                             hot):
    b = _basket_ops(seed, n, w, n_items, hot)
    block = torch.from_numpy(ex.pack_block(b.new_items, b.baskets, b.lens,
                                           b.skips, b.signs)).to(card)
    rng = np.random.default_rng(seed)
    c0 = torch.from_numpy(rng.integers(-30_000, 30_000, (n_items, n_items))
                          ).to(dtype).to(card)
    rs0 = torch.from_numpy(rng.integers(0, 1 << 20, n_items).astype(
        np.int32)).to(card)
    got_c, got_rs = c0.clone(), rs0.clone()
    want_c, want_rs = c0.clone(), rs0.clone()
    before = ex.LAUNCHES
    for _ in range(3):  # repeated: counts keep adding (and wrapping)
        ex.apply_baskets(got_c, got_rs, block)
        ex.apply_baskets_reference(want_c, want_rs, block)
    assert ex.LAUNCHES == before + 3
    torch.cuda.synchronize()
    assert torch.equal(got_c, want_c)
    assert torch.equal(got_rs, want_rs)
    assert not torch.equal(got_c, c0)


@pytest.mark.cuda
@pytest.mark.parametrize("start", [0, 1])
def test_expand_kernel_int16_C_off_a_word_boundary_on_card(card, start):
    """An odd-sized int16 ``C`` at cell 0 or 1 of a buffer with a guard
    cell on each side: its last (start 0) or first (start 1) cell shares
    a 32-bit word with a guard. Kernel and plain version agree exactly,
    and the guards stay as they were."""
    n_items = 1001
    b = _basket_ops(28 + start, 2000, 16, n_items)
    edge = np.resize([0, n_items - 1], 200)  # ops on the first/last cell
    b.new_items[:200], b.baskets[:200, 0] = edge, edge
    b.lens[:200], b.skips[:200] = np.maximum(b.lens[:200], 1), -1
    block = torch.from_numpy(ex.pack_block(b.new_items, b.baskets, b.lens,
                                           b.skips, b.signs)).to(card)
    rng = np.random.default_rng(start)
    cells = n_items * n_items
    buf = torch.full((cells + 2,), 77, dtype=torch.int16, device=card)
    got_c = buf[start:start + cells].view(n_items, n_items)
    got_c.copy_(torch.from_numpy(
        rng.integers(-30_000, 30_000, (n_items, n_items))).to(torch.int16))
    rs0 = torch.from_numpy(rng.integers(0, 1 << 20, n_items).astype(
        np.int32)).to(card)
    want_c, got_rs, want_rs = got_c.clone(), rs0.clone(), rs0.clone()
    for _ in range(3):
        ex.apply_baskets(got_c, got_rs, block)
        ex.apply_baskets_reference(want_c, want_rs, block)
    torch.cuda.synchronize()
    assert torch.equal(got_c, want_c)
    assert torch.equal(got_rs, want_rs)
    guards = torch.cat([buf[:start], buf[start + cells:]]).tolist()
    assert guards == [77, 77]


@pytest.mark.cuda
@pytest.mark.parametrize("count_dtype", ["int32", "int16"])
def test_fused_scorer_on_card_matches_cpu(card, count_dtype):
    """The fused window on the card keeps the same integer state as on
    the CPU, one expand launch per window."""
    on_card = DeviceScorer(0, 10, count_dtype=count_dtype, device=card,
                           defer_results=True, fused_window="on")
    on_cpu = DeviceScorer(0, 10, count_dtype=count_dtype, device="cpu",
                          defer_results=True, fused_window="on")
    before = ex.LAUNCHES
    for seed in range(4):
        b = _basket_ops(30 + seed, 400, 12, 1500)
        for sc in (on_card, on_cpu):
            sc.process_window(0, BasketBatch(*(a.copy() for a in (
                b.new_items, b.baskets, b.lens, b.skips, b.signs))))
            assert sc.last_dispatch_fused
    assert ex.LAUNCHES - before == 4
    a, b = on_card.checkpoint_state(), on_cpu.checkpoint_state()
    for key in ("C", "row_sums", "observed"):
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    x, y = on_card.flush(), on_cpu.flush()
    np.testing.assert_array_equal(x.rows, y.rows)
    ok, mism = st.topk_parity(x.vals, x.idx, y.vals, y.idx, rtol=RTOL,
                              atol=ATOL)
    assert ok and mism == 0, (ok, mism)


def _zipf_job(device, path, depth, users, items, ts, **kw):
    from tpu_cooccurrence_torch.config import Config
    from tpu_cooccurrence_torch.job import CooccurrenceJob

    backend = (dict(backend="sparse") if path == "sparse" else
               dict(fused_window="on" if path == "fused" else "off"))
    job = CooccurrenceJob(Config(window_size=10, seed=7, item_cut=60,
                                 user_cut=5, device=device,
                                 pipeline_depth=depth, **backend, **kw))
    for lo in range(0, len(users), 997):
        job.add_batch(users[lo:lo + 997], items[lo:lo + 997],
                      ts[lo:lo + 997])
    return job


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["chained", "fused", "sparse"])
def test_pipelined_and_resumed_runs_on_card_equal_serial(card, tmp_path,
                                                         path):
    """Depth 2 on the card (every launch from the worker thread) equals
    depth 0 exactly; a depth-2 run checkpointed mid-stream and restored
    into a fresh job ends with the same integer state and scores."""
    from tpu_cooccurrence_torch.io.synthetic import zipfian_interactions

    users, items, ts = zipfian_interactions(8_000, n_items=400, n_users=150,
                                            alpha=1.1, seed=3,
                                            events_per_ms=40)
    serial = _zipf_job("cuda", path, 0, users, items, ts)
    serial.finish()
    piped = _zipf_job("cuda", path, 2, users, items, ts)
    piped.finish()
    half = 3_001
    ck = dict(checkpoint_dir=str(tmp_path / "ck"))
    a = _zipf_job("cuda", path, 2, users[:half], items[:half], ts[:half],
                  **ck)
    a.checkpoint()
    a.abort()
    resumed = _zipf_job("cuda", path, 2, users[:0], items[:0], ts[:0], **ck)
    resumed.restore()
    for lo in range(half, len(users), 997):
        hi = min(lo + 997, len(users))
        resumed.add_batch(users[lo:hi], items[lo:hi], ts[lo:hi])
    resumed.finish()
    for job in (piped, resumed):
        assert job.counters.as_dict() == serial.counters.as_dict()
        got, want = job.scorer.checkpoint_state(), \
            serial.scorer.checkpoint_state()
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert set(job.latest) == set(serial.latest)
        for item in serial.latest:
            got_row, want_row = job.latest[item], serial.latest[item]
            assert [s for _, s in got_row] == [s for _, s in want_row]
            if job is piped or path != "sparse":
                assert got_row == want_row, item
