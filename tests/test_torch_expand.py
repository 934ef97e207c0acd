"""The port's basket expansion + scatter (``ops/expand.py``) against the
JAX package's ``pallas_expand_baskets`` and ``_fused_apply_baskets``.

Inputs are seeded numpy and go to both sides. Every quantity is an
integer, so the tolerance is exact: the lanes of
``expand_baskets_reference`` equal the Pallas kernel's (run in interpret
mode, on inputs padded to its ``N % 8``, ``W % 128`` shape) lane for lane,
and ``C``/``row_sums`` after ``apply_baskets`` (the plain version, on CPU
tensors) equal the JAX fused window's after its expansion and scatter,
int16 wraparound included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_cooccurrence.ops.device_scorer import _fused_window_emit
from tpu_cooccurrence.ops.pallas_score import pallas_expand_baskets
from tpu_cooccurrence_torch.ops import expand as ex
from tpu_cooccurrence_torch.ops.aggregate import aggregate_window_coo
from tpu_cooccurrence_torch.ops.device_scorer import _apply_coo
from tpu_cooccurrence_torch.sampling.reservoir import BasketBatch


def _ops(seed, n, w, num_items):
    """Seeded star ops: ``len`` 0 (op 0), ``len = W`` (op 1), ``skip >= len``
    (op 2), skips in range, signs +-1, and garbage (any int32, negative
    included) in every cell at ``j >= len``. Returns
    ``(new, baskets, lens, skips, signs)``, all int32."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, w + 1, n)
    lens[0], lens[1] = 0, w
    baskets = rng.integers(0, num_items, (n, w))
    j = np.arange(w)[None, :]
    junk = rng.integers(-2**31, 2**31 - 1, (n, w))
    baskets = np.where(j < lens[:, None], baskets, junk)
    skips = np.full(n, -1)
    pick = rng.random(n) < 0.4
    skips[pick] = rng.integers(0, w, int(pick.sum()))
    skips[2] = lens[2] + 1
    signs = np.where(rng.random(n) < 0.7, 1, -1)
    new = rng.integers(0, num_items, n)
    return tuple(a.astype(np.int32) for a in (new, baskets, lens, skips,
                                              signs))


def _pad_for_pallas(new, baskets, lens, skips, signs):
    """The TPU kernel's shape: ops to a multiple of 8, width to one of 128;
    pad ops carry (len 0, skip -1, sign 0)."""
    n, w = baskets.shape
    n_pad = -(-n // 8) * 8
    w_pad = max(128, -(-w // 128) * 128)
    pb = np.zeros((n_pad, w_pad), np.int32)
    pb[:n, :w] = baskets
    meta = np.zeros((4, n_pad), np.int32)
    meta[2] = -1
    for r, a in enumerate((new, lens, skips, signs)):
        meta[r, :n] = a
    return pb, meta, w_pad


@pytest.mark.parametrize("seed,n,w", [(0, 13, 5), (1, 20, 37), (2, 9, 130)])
def test_expand_reference_matches_pallas_lanes(seed, n, w):
    ops = _ops(seed, n, w, 500)
    new, baskets, lens, skips, signs = ops
    got = ex.expand_baskets_reference(
        torch.from_numpy(baskets), *(torch.from_numpy(a) for a in
                                     (new, lens, skips, signs)))
    pb, meta, w_pad = _pad_for_pallas(*ops)
    want = pallas_expand_baskets(pb, *(m.reshape(-1, 1) for m in meta),
                                 interpret=True)
    for g, jx in zip(got, want):
        g, jx = g.numpy(), np.asarray(jx)
        assert g.shape == (n, 2 * w) and g.dtype == np.int32
        np.testing.assert_array_equal(g[:, :w], jx[:n, :w])
        np.testing.assert_array_equal(g[:, w:], jx[:n, w_pad:w_pad + w])
        # Everything the padding added is the (0, 0, 0) no-op triple.
        assert not jx[:n, w:w_pad].any() and not jx[:n, w_pad + w:].any()
        assert not jx[n:].any()
    # Lanes used = logical pairs; an idle lane is the full no-op triple.
    src, dst, delta = (t.numpy() for t in got)
    assert (delta != 0).sum() == len(BasketBatch(*ops))
    assert not src[delta == 0].any() and not dst[delta == 0].any()


def _wrap_ops(seed, n_items, dtype):
    """Ops over a random ``C`` whose int16 cells sit near the short range,
    with 40 ops that drive one cell past +32,767 and another past
    -32,768 (on int32 the same ops simply count)."""
    new, baskets, lens, skips, signs = _ops(seed, 30, 9, n_items)
    hot = np.zeros((40, 9), np.int32)
    hot[:20, 0], hot[20:, 0] = 5, 11
    ops = (np.r_[new, np.full(20, 3), np.full(20, 7)],
           np.r_[baskets, hot], np.r_[lens, np.ones(40)],
           np.r_[skips, np.full(40, -1)],
           np.r_[signs, np.ones(20), -np.ones(20)])
    rng = np.random.default_rng(seed + 100)
    c0 = rng.integers(-50, 50, (n_items, n_items))
    if dtype == np.int16:
        c0[3, 5] = c0[5, 3] = 32_760
        c0[7, 11] = c0[11, 7] = -32_760
    rs0 = rng.integers(0, 10_000, n_items).astype(np.int32)
    return tuple(a.astype(np.int32) for a in ops), c0.astype(dtype), rs0


@pytest.mark.parametrize("dtype", [np.int32, np.int16])
def test_apply_reference_matches_jax_fused_apply(dtype):
    n_items = 64
    ops, c0, rs0 = _wrap_ops(3, n_items, dtype)
    C = torch.from_numpy(c0.copy())
    rs = torch.from_numpy(rs0.copy())
    before = ex.LAUNCHES
    ex.apply_baskets(C, rs, torch.from_numpy(ex.pack_block(*ops)))
    assert ex.LAUNCHES == before  # a CPU tensor runs the plain version

    pb, meta, w_pad = _pad_for_pallas(*ops)
    block = np.concatenate([pb, meta.T], axis=1)
    rows = np.arange(8, dtype=np.int32)
    cj, rsj, _ = _fused_window_emit(
        jnp.asarray(c0), jnp.asarray(rs0), jnp.asarray(block),
        jnp.asarray(rows), np.float32(1e6), num_items=n_items,
        basket_width=w_pad, top_k=4, use_pallas=False, tile=128,
        interpret=True)
    np.testing.assert_array_equal(C.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(rs.numpy(), np.asarray(rsj))
    if dtype == np.int16:  # the wrapped cells, as Java shorts wrap
        assert C[3, 5] < 0 and C[5, 3] < 0
        assert C[7, 11] > 0 and C[11, 7] > 0


def test_apply_equals_chained_scatter_of_host_expansion():
    """Expansion + scatter equals the chained path's fold and scatter of
    ``BasketBatch.to_pairs()`` on the same state."""
    ops, c0, rs0 = _wrap_ops(4, 80, np.int32)
    a_c, a_rs = torch.from_numpy(c0.copy()), torch.from_numpy(rs0.copy())
    ex.apply_baskets_reference(a_c, a_rs,
                               torch.from_numpy(ex.pack_block(*ops)))
    pairs = BasketBatch(*ops).to_pairs()
    src, dst, delta = aggregate_window_coo(pairs.src, pairs.dst, pairs.delta)
    b_c, b_rs = torch.from_numpy(c0.copy()), torch.from_numpy(rs0.copy())
    _apply_coo(b_c, b_rs, torch.from_numpy(src).long(),
               torch.from_numpy(dst).long(),
               torch.from_numpy(delta.astype(np.int32)))
    assert torch.equal(a_c, b_c) and torch.equal(a_rs, b_rs)


def test_pack_block_cuts_to_the_widest_op_and_splits_back():
    new, baskets, lens, skips, signs = _ops(5, 12, 20, 100)
    lens = np.minimum(lens, 7).astype(np.int32)
    block = ex.pack_block(new, baskets, lens, skips, signs)
    assert block.shape == (12, 7 + ex.META_COLS) and block.dtype == np.int32
    b, *meta = ex.split_block(torch.from_numpy(block))
    np.testing.assert_array_equal(b.numpy(), baskets[:, :7])
    for got, want in zip(meta, (new, lens, skips, signs)):
        np.testing.assert_array_equal(got.numpy(), want)
    empty = ex.pack_block(*(a[:0] for a in (new, baskets, lens, skips,
                                            signs)))
    assert empty.shape == (0, ex.META_COLS)


@pytest.mark.parametrize("bad", ["c_dtype", "rs_shape", "block_dtype",
                                 "block_narrow", "device"])
def test_apply_baskets_rejects_what_the_kernel_does_not_take(bad):
    C = torch.zeros((8, 8), dtype=torch.int32)
    rs = torch.zeros(8, dtype=torch.int32)
    block = torch.zeros((3, 6), dtype=torch.int32)
    if bad == "c_dtype":
        C = C.to(torch.int64)
    elif bad == "rs_shape":
        rs = rs[:7]
    elif bad == "block_dtype":
        block = block.long()
    elif bad == "block_narrow":
        block = block[:, :3]
    else:
        C, rs, block = (t.to("meta") for t in (C, rs, block))
    with pytest.raises(ValueError):
        ex.apply_baskets(C, rs, block)
