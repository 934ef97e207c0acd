"""The expand + scatter kernel's design (``csrc/expand_scatter.cu``) as
plain models on the CPU.

The kernel puts threads on valid cells, not on ops: a block takes a tile
of ops, counts each op's valid cells (``min(len, W)``, less one where
``0 <= skip < min(len, W)``, none for a new item outside ``[0, I)``),
takes their exclusive prefix sum, and its threads walk the flattened
cell list, cell ``f`` at op ``o`` with ``pre[o] <= f < pre[o + 1]``,
``k = f - pre[o]``, column ``j = k + (k >= skip)``. The model below does
the same arithmetic in numpy and must visit every valid cell of every op
exactly once and no other.

int16 cells are added with a 32-bit add on the aligned word that holds
them: ``v << 16`` for the high half; ``(uint16)v`` for the low half, with
``1 << 16`` subtracted again when the old low half carried out of bit
15. The model plays every add and correction as one atomic step, in any
interleaving (a correction always after its own add), and each half must
end at its 16-bit modular sum. Cells whose word would leave ``C`` keep a
16-bit compare-and-swap (run on the card only:
``tests/test_torch_kernels_cuda.py``).

All quantities are integers: the tolerance is exact.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as hs

from tpu_cooccurrence_torch.ops import expand as ex
from tpu_cooccurrence_torch.sampling.reservoir import BasketBatch

_SETTINGS = settings(max_examples=60, deadline=None, derandomize=True,
                     database=None)


def _counts(block, num_items):
    """Per op: valid count and the skip the kernel uses (the skipped
    column, or ``min(len, W)`` when none is skipped)."""
    w = block.shape[1] - ex.META_COLS
    new, lens, skips = (block[:, w + i] for i in range(3))
    end = np.clip(lens, 0, w)
    skipped = (skips >= 0) & (skips < end)
    in_range = (new >= 0) & (new < num_items)
    count = np.where(in_range, end - skipped, 0)
    return count, np.where(skipped, skips, end)


def _walk(block, tile_ops, num_items):
    """The cells the kernel visits, as ``(op, j)`` pairs in its order:
    per tile the exclusive prefix of the valid counts, then one flat
    index per cell mapped back by a binary search over the prefix."""
    count, skip = _counts(block, num_items)
    cells = []
    for op0 in range(0, block.shape[0], tile_ops):
        c = count[op0:op0 + tile_ops]
        pre = np.concatenate([[0], np.cumsum(c)])
        for f in range(int(pre[-1])):
            o = int(np.searchsorted(pre, f, side="right")) - 1
            k = f - pre[o]
            cells.append((op0 + o, int(k + (k >= skip[op0 + o]))))
    return cells


def _valid_cells(block, num_items):
    """The cells the semantics name, by brute force."""
    w = block.shape[1] - ex.META_COLS
    out = []
    for i, row in enumerate(block):
        new, ln, skip = row[w], row[w + 1], row[w + 2]
        if not 0 <= new < num_items:
            continue
        out += [(i, j) for j in range(min(ln, w)) if j != skip]
    return out


def _edge_block(w, num_items=50, seed=0):
    """Ops with len 0, len W, len > W (a wider basket cut to W), skip -1,
    skip in range, skip = len, skip >= len, skip past W, a new item out of
    range, and random ones."""
    rng = np.random.default_rng(seed)
    specs = [(0, -1), (w, -1), (w + 5, -1), (w, 0), (w, w - 1), (1, 0),
             (w, w), (max(w - 1, 0), w + 3), (2 * w + 1, 2)]
    lens = [ln for ln, _ in specs] + list(rng.integers(0, w + 3, 20))
    skips = [sk for _, sk in specs] + list(
        np.where(rng.random(20) < 0.5, rng.integers(-1, w + 2, 20), -1))
    n = len(lens)
    wide = max(lens + [w])
    baskets = rng.integers(0, num_items, (n, wide))
    new = rng.integers(0, num_items, n)
    new[3] = num_items          # out of range: adds nothing
    signs = np.where(rng.random(n) < 0.7, 1, -1)
    block = np.empty((n, w + ex.META_COLS), np.int32)
    block[:, :w] = baskets[:, :w]
    block[:, w:] = np.stack([new, lens, skips, signs], 1)
    return block


@pytest.mark.parametrize("w", [1, 2, 7, 32, 71, 300])
@pytest.mark.parametrize("tile_ops", [1, 3, 115, 256, 512])
def test_flattened_walk_covers_each_valid_cell_once(w, tile_ops):
    block = _edge_block(w, seed=w)
    got = _walk(block, tile_ops, 50)
    assert len(got) == len(set(got))
    assert sorted(got) == sorted(_valid_cells(block, 50))


@_SETTINGS
@given(hs.integers(1, 40), hs.integers(1, 30), hs.integers(1, 300),
       hs.integers(0, 2**31 - 1))
def test_flattened_walk_matches_the_host_expansion(n, w, tile_ops, seed):
    """Over random ops the visited cells, as ``(new, p, sign)``, are the
    host expansion's forward pairs (``BasketBatch.to_pairs``)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, w + 2, n)
    skips = np.where(rng.random(n) < 0.5, rng.integers(-1, w + 2, n), -1)
    baskets = rng.integers(0, 64, (n, w))
    new = rng.integers(0, 64, n)
    signs = rng.choice([-1, 1], n)
    b = BasketBatch(*(a.astype(np.int32) for a in
                      (new, baskets, np.minimum(lens, w), skips, signs)))
    block = ex.pack_block(b.new_items, b.baskets, b.lens, b.skips, b.signs)
    cells = _walk(block, min(tile_ops, 256), 64)
    got = sorted((int(b.new_items[o]), int(b.baskets[o, j]),
                  int(b.signs[o])) for o, j in cells)
    pairs = b.to_pairs()
    half = len(pairs.src) // 2
    want = sorted(zip(pairs.src[:half].tolist(), pairs.dst[:half].tolist(),
                      pairs.delta[:half].tolist()))
    assert got == want


def _play_int16_adds(init, adds, rng):
    """Plays 16-bit adds on 32-bit words as the kernel issues them, in a
    random interleaving. ``init``: the cells' starting values (uint16,
    two a word, low half first); ``adds``: ``(cell, v)``. Returns the
    cells."""
    words = [int(init[2 * i]) | (int(init[2 * i + 1]) << 16)
             for i in range(len(init) // 2)]
    pending = []
    for cell, v in adds:
        a = v & 0xFFFF
        if a:
            pending.append(("hi" if cell & 1 else "lo", cell // 2, a))
    while pending:
        kind, w, a = pending.pop(int(rng.integers(len(pending))))
        if kind == "hi":
            words[w] = (words[w] + (a << 16)) & 0xFFFFFFFF
        elif kind == "lo":
            old = words[w]
            words[w] = (old + a) & 0xFFFFFFFF
            if (old & 0xFFFF) + a > 0xFFFF:   # carried into the high half
                pending.append(("fix", w, 0))
        else:
            words[w] = (words[w] - (1 << 16)) & 0xFFFFFFFF
    return [(words[c // 2] >> (16 * (c & 1))) & 0xFFFF
            for c in range(len(init))]


@_SETTINGS
@given(hs.lists(hs.integers(0, 0xFFFF), min_size=6, max_size=6),
       hs.lists(hs.tuples(hs.integers(0, 5),
                          hs.integers(-2**31, 2**31 - 1)), max_size=60),
       hs.integers(0, 2**31 - 1))
def test_int16_word_adds_are_modular_in_any_order(init, adds, seed):
    got = _play_int16_adds(init, adds, np.random.default_rng(seed))
    want = list(init)
    for cell, v in adds:
        want[cell] = (want[cell] + v) & 0xFFFF
    assert got == want


@pytest.mark.parametrize("seed", range(4))
def test_int16_word_adds_wrap_both_halves(seed):
    """Both halves of one word driven across the short range in both
    directions, 2,000 adds each, shuffled: phase 8's wraparound case in
    miniature, with the neighbour of each cell busy too."""
    rng = np.random.default_rng(seed)
    init = [32_760, (-32_760) & 0xFFFF, 65_535, 0]
    adds = ([(0, 1)] * 2000 + [(1, -1)] * 2000 + [(2, 1)] * 2000
            + [(3, -1)] * 2000 + [(0, 70_000), (2, -70_001)])
    adds = [adds[i] for i in rng.permutation(len(adds))]
    got = _play_int16_adds(init, adds, rng)
    want = [(32_760 + 2000 + 70_000) & 0xFFFF, (-32_760 - 2000) & 0xFFFF,
            (65_535 + 2000 - 70_001) & 0xFFFF, (-2000) & 0xFFFF]
    assert got == want


@pytest.mark.parametrize("dtype", [torch.int32, torch.int16])
def test_plain_apply_equals_a_loop_over_the_ops(dtype):
    """The plain version, with its zero lanes dropped, against the
    semantics written as a loop: len 0 ops, a diagonal cell (new = p),
    sign 0 ops, and int16 counts wrapped past the short range."""
    block = _edge_block(9, num_items=12, seed=5)
    block = block[block[:, 9] < 12]               # ids in range only
    block[0, 0], block[0, 9], block[0, 10] = 4, 4, 3   # new = p = 4
    block[1, 12] = 0                              # sign 0
    rng = np.random.default_rng(6)
    c0 = rng.integers(-32_000, 32_000, (12, 12))
    c0[4, 4] = 32_767
    rs0 = rng.integers(0, 1000, 12).astype(np.int32)
    C = torch.from_numpy(c0).to(dtype)
    rs = torch.from_numpy(rs0.copy())
    ex.apply_baskets_reference(C, rs, torch.from_numpy(block))
    want_c, want_rs = c0.astype(np.int64), rs0.astype(np.int64)
    for o, j in _valid_cells(block, 12):
        new, p, sign = block[o, 9], block[o, j], block[o, 12]
        want_c[new, p] += sign
        want_c[p, new] += sign
        want_rs[p] += sign
        want_rs[new] += sign
    bits = 16 if dtype == torch.int16 else 32
    want_c = ((want_c + 2**(bits - 1)) % 2**bits) - 2**(bits - 1)
    np.testing.assert_array_equal(C.numpy(), want_c)
    np.testing.assert_array_equal(rs.numpy(), want_rs)
