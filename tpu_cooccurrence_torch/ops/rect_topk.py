"""Fused LLR scoring + top-K over the slab cells of sparse rows.

Port of ``tpu_cooccurrence/ops/pallas_score.py`` (``_rect_topk_kernel`` as
called by ``pallas_score_rect``) and of the XLA body it replaces,
``tpu_cooccurrence/state/sparse_scorer._score_rect``. Each scored row owns
the slab region ``[start, start + len)``; for every cell ``c`` there

    k11 = cnt[c], rsj = row_sums[dst[c]], rsi = row_sums[row],
    k12 = rsi - k11, k21 = rsj - k11, k22 = observed + k11 - k12 - k21

is scored with :func:`~.llr.llr_stable`, a zero (cancelled) cell scores
``-inf``, and the row keeps its top K, scores descending, the earliest
slab position winning among equal scores (``lax.top_k``'s rule on the
slot-ordered rectangle). Lanes past a row's live cells are ``(-inf, 0)``.
``cnt`` holds the slab's cell dtype (int32, int16 or int8, the sparse
backend's ``--cell-dtype``); a count becomes float32 as it is scored.

:func:`rect_topk` is the wrapper: on a CUDA tensor it launches the
hand-written kernel (``csrc/rect_topk.cu``), which takes every row length
as it is, or raises; on a CPU tensor it runs :func:`rect_topk_reference`,
the plain PyTorch version. :data:`LAUNCHES` counts wrapper calls that
launched. :func:`short_rows` splits a launch's rows into the kernel's two
size classes (a warp per short row, a block per long row) on the host.

The plain version keeps the reference package's length buckets: rows are
scored in ``[S, R]`` rectangles, ``R = min_r * 4^b`` the smallest width
that holds the row (:func:`score_buckets` at the default ladder), as
``_score_rect`` runs them; the widths change the work, never the result.
The bucket order is also the order the sparse scorer emits rows in (at
its ``--score-ladder``), so the bucket helpers live here.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from .llr import llr_stable
from .score_topk import MAX_TOP_K, topk_padded

#: Kernel launches made by :func:`rect_topk` in this process.
LAUNCHES = 0

#: Padded cells per plain-version rectangle (bounds its [S, R] working
#: set; the reference package's ``SCORE_BUDGET``).
SCORE_BUDGET = 1 << 24
#: Bucket ladder of the plain version's rectangles (the reference
#: package's default).
PLAIN_LADDER = 4
#: Longest row the kernel scores with one warp; longer rows take a block.
#: A bucket boundary at ladders 2 and 4 (the default) when the narrowest
#: rectangle is 16 lanes, so in bucket order the short rows are a prefix.
#: Chosen by ``tune_topk.py`` on config 4's largest launch (PERF.md).
SHORT_MAX = 1024


def ladder_bits(ladder: int) -> int:
    """Validate a score-bucket ladder base (power of two >= 2) and return
    its log2."""
    k = ladder.bit_length() - 1
    if k < 1 or ladder != (1 << k):
        raise ValueError(
            f"score ladder must be a power of two >= 2, got {ladder} "
            f"(--score-ladder)")
    return k


def bucket_r(b: int, min_r: int, ladder: int) -> int:
    """Rectangle width of bucket ``b``: ``min_r * ladder^b``."""
    return min_r << (ladder_bits(ladder) * b)


def score_buckets(lens: np.ndarray, min_r: int, ladder: int = 4):
    """Length buckets: bucket b scores rows at ``R = bucket_r(b)`` (the
    smallest b with R >= len). Returns (bucket per row, order sorted by
    bucket, stable). Integer math, exact at powers:
    ``shift = ceil(len / 2^floor(log2 min_r)) - 1``;
    ``b = ceil(log2(shift+1) / k)`` for ``ladder = 2^k`` via frexp's
    exponent."""
    k = ladder_bits(ladder)
    shift = (np.maximum(lens, 1) - 1) >> (min_r.bit_length() - 1)
    bucket = (np.frexp(shift.astype(np.float64))[1] + k - 1) // k
    return bucket, np.argsort(bucket, kind="stable")


def min_rect_width(top_k: int) -> int:
    """Narrowest rectangle: 16 lanes, and never fewer than K."""
    return max(16, top_k)


def gather_rect(cnt, dst, row_sums, rows, starts, lens, R: int):
    """The ``[S, R]`` rectangle of the rows' slab cells.

    Returns ``(k11i, valid, ds, rsj, rsi)``: counts at the slab's cell
    dtype (as the reference package's ``gather_rect`` keeps them), the
    live-cell mask (zero cells are not scored), partner ids (0 where
    invalid), partner row sums f32 (0 where invalid) and the rows' own
    sums as an f32 column. Lanes past a row's length gather slot 0 and
    are masked.
    """
    col = torch.arange(R, device=cnt.device)[None, :]
    in_row = col < lens.long()[:, None]
    idx = torch.where(in_row, starts.long()[:, None] + col, 0)
    k11i = torch.where(in_row, cnt[idx], 0)
    valid = k11i != 0
    ds = torch.where(valid, dst[idx], 0)
    rsj = torch.where(valid, row_sums[ds.long()], 0).to(torch.float32)
    rsi = row_sums[rows.long()].to(torch.float32)[:, None]
    return k11i, valid, ds, rsj, rsi


def score_rect(cnt, dst, row_sums, rows, starts, lens, observed,
               top_k: int, R: int):
    """LLR + top-K over one ``[S, R]`` rectangle (``R >= K`` and ``R`` at
    least every row's length). Returns ``(vals [S, K] f32, ids [S, K]
    int32)``."""
    k11i, valid, ds, rsj, rsi = gather_rect(cnt, dst, row_sums, rows,
                                            starts, lens, R)
    k11 = k11i.to(torch.float32)
    obs = torch.tensor(np.float32(observed), device=cnt.device)
    k12 = rsi - k11
    k21 = rsj - k11
    k22 = obs + k11 - k12 - k21
    scores = llr_stable(k11, k12, k21, k22)
    scores = torch.where(valid, scores, torch.full_like(scores, -torch.inf))
    vals, pos = topk_padded(scores, top_k)
    return vals, torch.gather(ds, 1, pos.long())


def short_rows(lens: np.ndarray, short_max: int = SHORT_MAX) -> int:
    """The kernel's launch plan for rows of ``lens`` cells, in the order
    given (the bucket order): the length of the longest prefix of rows of
    at most ``short_max`` cells, which the kernel scores one warp a row;
    every later row takes a block. Host arithmetic only, no device sync.
    Any count in ``[0, len(lens)]`` is exact: both classes take any
    length, so the split changes the work, never the result."""
    over = np.flatnonzero(np.asarray(lens) > short_max)
    return int(over[0]) if len(over) else len(lens)


#: Cell dtypes of the slab ``cnt`` (``--cell-dtype``); everything else
#: the kernel reads is int32.
_CELL_DTYPES = (torch.int32, torch.int16, torch.int8)


def _check(cnt, dst, row_sums, rows, starts, lens, top_k: int) -> None:
    if cnt.dtype not in _CELL_DTYPES or cnt.dim() != 1:
        raise ValueError(f"cnt must be 1-D int32, int16 or int8, got "
                         f"{cnt.dtype} {tuple(cnt.shape)}")
    for name, t in (("cnt", cnt), ("dst", dst), ("row_sums", row_sums),
                    ("rows", rows), ("starts", starts), ("lens", lens)):
        if name != "cnt" and (t.dtype != torch.int32 or t.dim() != 1):
            raise ValueError(f"{name} must be 1-D int32, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != cnt.device:
            raise ValueError("all rect_topk inputs must share one device")
    if dst.shape != cnt.shape:
        raise ValueError(f"cnt {tuple(cnt.shape)} and dst "
                         f"{tuple(dst.shape)} must match")
    if not rows.shape == starts.shape == lens.shape:
        raise ValueError("rows, starts and lens must have one length")
    if top_k < 1:
        raise ValueError(f"top_k must be >= 1, got {top_k}")


def rect_topk_reference(cnt, dst, row_sums, rows, starts, lens, observed,
                        top_k: int):
    """The plain PyTorch version: rows bucketed by length as the
    reference package scores them, each bucket gathered into ``[S, R]``
    rectangles (at most :data:`SCORE_BUDGET` cells each), LLR, then a
    stable descending sort. Returns ``(vals [S, K] f32, ids [S, K]
    int32)`` in the input row order."""
    _check(cnt, dst, row_sums, rows, starts, lens, top_k)
    s = rows.shape[0]
    vals = torch.full((s, top_k), -torch.inf, dtype=torch.float32,
                      device=cnt.device)
    ids = torch.zeros((s, top_k), dtype=torch.int32, device=cnt.device)
    min_r = min_rect_width(top_k)
    bucket, order = score_buckets(lens.cpu().numpy(), min_r, PLAIN_LADDER)
    b_sorted = bucket[order]
    pos = 0
    while pos < s:
        b = int(b_sorted[pos])
        end = int(np.searchsorted(b_sorted, b, side="right"))
        R = bucket_r(b, min_r, PLAIN_LADDER)
        s_block = max(SCORE_BUDGET // R, 16)
        for lo in range(pos, end, s_block):
            sel = torch.from_numpy(order[lo:min(lo + s_block, end)]).to(
                cnt.device)
            v, i = score_rect(cnt, dst, row_sums, rows[sel], starts[sel],
                              lens[sel], observed, top_k, R)
            vals[sel] = v
            ids[sel] = i
        pos = end
    return vals, ids


def rect_topk(cnt, dst, row_sums, rows, starts, lens, observed,
              top_k: int, n_short: Optional[int] = None):
    """Top-K LLR scores of sparse rows: the CUDA kernel on a card,
    :func:`rect_topk_reference` for CPU tensors (and only there).

    cnt       [cap] int32, int16 or int8 slab counts (the cell dtype)
    dst       [cap] int32 partner ids
    row_sums  [I]   int32
    rows      [S]   int32 row ids; starts, lens [S] int32 slab regions
    observed        total observed co-occurrences (fed as float32)
    n_short         :func:`short_rows` of ``lens``, the rows the kernel
                    scores one warp each (the plain version ignores it);
                    without it the kernel's wrapper reads ``lens`` back
                    from the card to count them
    Returns ``(vals [S, K] float32, ids [S, K] int32)``. One call counts
    one launch in :data:`LAUNCHES`.
    """
    global LAUNCHES
    _check(cnt, dst, row_sums, rows, starts, lens, top_k)
    if n_short is not None and not 0 <= n_short <= rows.shape[0]:
        raise ValueError(f"rect_topk n_short {n_short} outside "
                         f"[0, {rows.shape[0]}]")
    if cnt.device.type == "cpu":
        return rect_topk_reference(cnt, dst, row_sums, rows, starts, lens,
                                   observed, top_k)
    if cnt.device.type != "cuda":
        raise ValueError(f"rect_topk runs on cuda or cpu, got {cnt.device}")
    if top_k > MAX_TOP_K:
        raise ValueError(f"top_k {top_k} exceeds the kernel's {MAX_TOP_K}")
    tensors = (cnt, dst, row_sums, rows, starts, lens)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("rect_topk needs contiguous inputs")
    s = rows.shape[0]
    if n_short is None:
        n_short = short_rows(lens.cpu().numpy())
    from ._build import load

    lib = load("rect_topk")
    vals = torch.empty((s, top_k), dtype=torch.float32, device=cnt.device)
    ids = torch.empty((s, top_k), dtype=torch.int32, device=cnt.device)
    with torch.cuda.device(cnt.device):
        stream = torch.cuda.current_stream(cnt.device).cuda_stream
        err = lib.rect_topk_launch(
            cnt.data_ptr(), cnt.element_size(),
            *(t.data_ptr() for t in tensors[1:]), s, row_sums.shape[0],
            cnt.shape[0], ctypes.c_float(np.float32(observed)), top_k,
            n_short, vals.data_ptr(), ids.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(
            f"rect_topk kernel launch failed: "
            f"{lib.rect_topk_error_string(err).decode()} (code {err})")
    LAUNCHES += 1
    return vals, ids
