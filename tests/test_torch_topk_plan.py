"""The rect kernel's launch plan (``ops/rect_topk.short_rows``) and a plain
model of the kernels' split-and-merge, on the CPU.

The rect kernel (``csrc/rect_topk.cu``) scores a prefix of short rows
with one warp each and every later row with one block. The plan is host
arithmetic on the lengths the scorer already holds: the length of the
prefix. Both classes take any length, so every row lies in exactly one
class and any prefix is exact.

Within a block both top-K kernels split a row's cells over eight warps,
each keeping its own top K, and merge the eight lists at the end. That
is exact because the selection order (score desc, key asc) is total: the
model below splits rows into parts (contiguous segments, or the warps'
interleaved cells of either kernel), takes ``topk_padded`` per part,
merges the partial lists in reverse part order under that order, and
must equal the unsplit top K bit for bit.
"""

import numpy as np
import pytest
import torch

from tpu_cooccurrence_torch.ops import rect_topk as rt
from tpu_cooccurrence_torch.ops.score_topk import topk_padded
from tpu_cooccurrence_torch.state import sparse_scorer as ss

L = rt.SHORT_MAX
THREADS, WARP = 256, 32


def _bucket_ordered(lens, ladder=4, top_k=10):
    """``lens`` in the order the sparse scorer passes rows."""
    lens = np.asarray(lens, dtype=np.int64)
    _, order = rt.score_buckets(lens, rt.min_rect_width(top_k), ladder)
    return lens[order]


@pytest.mark.parametrize("ladder", [2, 4, 16])
def test_plan_classes_follow_the_bucket_order(ladder):
    rng = np.random.default_rng(ladder)
    lens = np.concatenate([rng.integers(0, 4 * L, 300),
                           [L - 1, L, L + 1, 0, 1, 100_000]])
    lens = _bucket_ordered(lens, ladder)
    n_short = rt.short_rows(lens)
    # The prefix is short and the row after it is not.
    assert 0 <= n_short < len(lens)
    assert (lens[:n_short] <= L).all() and lens[n_short] > L
    # Every row up to the last bucket boundary at or below L is short;
    # where L is a boundary (ladders 2 and 4), every row of <= L cells.
    b = 0
    while rt.bucket_r(b + 1, 16, ladder) <= L:
        b += 1
    edge = rt.bucket_r(b, 16, ladder)
    assert (lens[n_short:] > edge).all()
    assert (edge == L) == (ladder in (2, 4))
    if edge == L:
        assert n_short == int((lens <= L).sum())


@pytest.mark.parametrize("length,short", [
    (L - 1, True), (L, True), (L + 1, False), (100_000, False)])
def test_plan_boundary_lengths(length, short):
    assert rt.short_rows(np.array([length])) == int(short)
    assert rt.short_rows(np.array([length]), short_max=length) == 1
    assert rt.short_rows(np.array([length]), short_max=length - 1) == 0


def test_plan_of_an_empty_launch():
    assert rt.short_rows(np.zeros(0, dtype=np.int64)) == 0


def test_plan_with_short_rows_after_a_long_one():
    # Out of bucket order (a caller's own order): rows after the first
    # long one take a block each, whatever their length.
    assert rt.short_rows(np.array([5, L + 1, 0, 9000, 2])) == 1


@pytest.mark.parametrize("n_short", [-1, 4])
def test_wrapper_rejects_a_plan_outside_the_launch(n_short):
    cnt = torch.tensor([1, 2, 0, 3], dtype=torch.int32)
    rs = torch.tensor([3, 3, 3, 3], dtype=torch.int32)
    meta = [torch.tensor(a, dtype=torch.int32) for a in
            ([0, 1, 2], [0, 1, 2], [1, 1, 2])]
    with pytest.raises(ValueError, match="n_short"):
        rt.rect_topk(cnt, cnt, rs, *meta, 9.0, 2, n_short)
    v, i = rt.rect_topk(cnt, cnt, rs, *meta, 9.0, 2, 3)
    assert v.shape == i.shape == (3, 2)


def _segments(n):
    """Four contiguous segments of a row of n cells."""
    return np.arange(n) * 4 // n


def _rect_warps(n):
    """The warp of a long row's cell in the rect kernel: thread t walks
    cells t, t + 256, ...; its warp is t / 32."""
    return (np.arange(n) % THREADS) // WARP


def _dense_warps(n, vec=8):
    """The warp of a column in the dense kernel at int16 (8 cells an
    int4): thread t reads vectors t, t + 256, ...; its warp is t / 32."""
    return ((np.arange(n) // vec) % THREADS) // WARP


PARTITIONS = {"segments": _segments, "rect_warps": _rect_warps,
              "dense_warps": _dense_warps}


def _partition_model(scores, part_of, top_k, reverse=True):
    """Split-and-merge in plain PyTorch: the cells of each row of
    ``scores`` ([S, n], -inf for a zero cell) go to parts by
    ``part_of(n)``; ``topk_padded`` per part, then the partial lists'
    finite entries merged under (score desc, key asc), the parts offered
    last first so a lower key is seen later."""
    n = scores.shape[1]
    part = part_of(n)
    out_v = torch.full((scores.shape[0], top_k), -torch.inf)
    out_i = torch.zeros((scores.shape[0], top_k), dtype=torch.int32)
    parts = np.unique(part)
    for p in range(scores.shape[0]):
        got = []
        for q in (parts[::-1] if reverse else parts):
            keys = torch.from_numpy(np.flatnonzero(part == q))
            v, i = topk_padded(scores[p:p + 1, keys], top_k)
            keep = torch.isfinite(v[0])
            got.append((v[0][keep], keys[i[0][keep].long()]))
        v = torch.cat([a for a, _ in got]).numpy()
        k = torch.cat([b for _, b in got]).numpy()
        order = np.lexsort((k, -v))[:top_k]
        out_v[p, :len(order)] = torch.from_numpy(v[order])
        out_i[p, :len(order)] = torch.from_numpy(k[order].astype(np.int32))
    return out_v, out_i


def _assert_model_exact(scores, top_k, part_of=_segments):
    got_v, got_i = _partition_model(scores, part_of, top_k)
    want_v, want_i = topk_padded(scores, top_k)
    fin = torch.isfinite(want_v)
    assert torch.equal(torch.isfinite(got_v), fin)
    assert torch.equal(got_v[fin], want_v[fin])       # bit for bit
    assert torch.equal(got_i[fin], want_i[fin])


@pytest.mark.parametrize("partition", sorted(PARTITIONS))
@pytest.mark.parametrize("top_k", [1, 10, 128])
def test_split_and_merge_model_equals_the_unsplit_top_k(top_k, partition):
    rng = np.random.default_rng(top_k)
    n = 3 * 4096 + 77
    # Few distinct scores: ties everywhere, across every part boundary.
    scores = torch.from_numpy(rng.integers(0, 4, (6, n)).astype(np.float32))
    scores[rng.random((6, n)) < 0.3] = -torch.inf
    _assert_model_exact(scores, top_k, PARTITIONS[partition])


def test_ties_across_a_segment_boundary_take_the_lower_key():
    # Equal scores at the last cell of segment 0 and the first of segment
    # 1; segment 1 is merged first, so the lower key is seen later.
    n = 8192
    seg = n // 4
    scores = torch.full((1, n), -torch.inf)
    scores[0, seg - 1] = scores[0, seg] = scores[0, seg + 5] = 7.0
    scores[0, 3] = 1.0
    _assert_model_exact(scores, 2)
    v, i = _partition_model(scores, _segments, 2)
    assert i[0].tolist() == [seg - 1, seg] and v[0].tolist() == [7.0, 7.0]


def test_live_cells_only_in_the_last_segment():
    n = 3 * 4096 + 10
    scores = torch.full((1, n), -torch.inf)
    scores[0, -10:] = torch.arange(10, dtype=torch.float32) % 3
    _assert_model_exact(scores, 10)
    _assert_model_exact(scores, 128)                   # K above live cells


def test_k_above_every_rows_length():
    rng = np.random.default_rng(5)
    scores = torch.from_numpy(rng.random((4, 40)).astype(np.float32))
    scores[1] = -torch.inf                              # an all-zero row
    v, i = _partition_model(scores, _segments, 128)
    assert torch.isinf(v[:, 40:]).all() and (i[:, 40:] == 0).all()
    assert torch.isinf(v[1]).all()
    _assert_model_exact(scores, 128)


def test_scorer_hands_the_kernel_its_plan(monkeypatch):
    calls = []
    real = ss.rect_topk

    def spy(*args):
        calls.append(args)
        return real(*args)

    monkeypatch.setattr(ss, "rect_topk", spy)
    from tpu_cooccurrence_torch.config import Config
    from tpu_cooccurrence_torch.io.synthetic import zipfian_interactions
    from tpu_cooccurrence_torch.job import CooccurrenceJob

    users, items, ts = zipfian_interactions(4000, n_items=300, n_users=60,
                                            alpha=1.1, seed=2,
                                            events_per_ms=20)
    job = CooccurrenceJob(Config(window_size=100, seed=7, backend="sparse",
                                 device="cpu"))
    job.add_batch(users, items, ts)
    job.finish()
    assert calls
    for args in calls:
        rows, starts, lens, n_short = args[3], args[4], args[5], args[8]
        assert n_short == rt.short_rows(lens.numpy())
        assert rows.shape == starts.shape == lens.shape
