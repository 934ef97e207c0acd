"""Fused LLR scoring + top-K over dense count rows.

Port of ``tpu_cooccurrence/ops/pallas_score.py`` (``_score_topk_kernel`` as
called by ``pallas_score_topk`` and, over a local row block of the sharded
backend, by ``pallas_score_topk_local``). For each scored row ``r`` and
every column ``j`` the f32 contingency

    k11 = C[r, j], k12 = rs[r] - k11, k21 = rs[j] - k11,
    k22 = observed + k11 - k12 - k21

is scored with :func:`~.llr.llr_stable`, zero counts are masked to ``-inf``,
and the row's top K is kept, scores descending, the lowest column winning
among equal scores (``lax.top_k``'s rule).

:func:`score_topk` is the wrapper: on a CUDA tensor it launches the
hand-written kernel (``csrc/score_topk.cu``) or raises; on a CPU tensor it
runs :func:`score_topk_reference`, the plain PyTorch version.
:func:`score_topk_local` (plain version :func:`score_topk_local_reference`)
scores global rows out of the block ``C_loc`` of rows ``[lo, lo + R)``
against the global row sums, on the same kernel. :data:`LAUNCHES` counts
kernel launches of both.

The TPU kernel's workarounds are not carried over: the kernel reads row
``rows[s]`` of ``C`` itself (no pre-gathered ``[S, I]`` copy), carries
column ids as int32 (no 2^24 vocabulary cap) and takes any ``I`` (no
padding of the vocabulary to the column tile).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .llr import llr_stable

#: Largest ``top_k`` the kernel carries (its running top-K lives in
#: shared memory; ``csrc/score_topk.cu`` ``kMaxK``).
MAX_TOP_K = 128

#: Kernel launches made by :func:`score_topk` in this process.
LAUNCHES = 0


def _check(C, row_sums, rows, top_k: int, lo=None) -> None:
    """``lo`` None: ``C`` is the square ``[I, I]``; else the local block
    ``[R, I]`` of rows ``[lo, lo + R)``."""
    if lo is None:
        if C.dim() != 2 or C.shape[0] != C.shape[1]:
            raise ValueError(
                f"C must be square [I, I], got {tuple(C.shape)}")
    elif C.dim() != 2 or not 0 <= lo <= C.shape[1] - C.shape[0]:
        raise ValueError(f"C_loc must be a row block [R, I] with "
                         f"0 <= lo <= I - R, got {tuple(C.shape)} at lo={lo}")
    if C.dtype not in (torch.int32, torch.int16):
        raise ValueError(f"C must be int32 or int16, got {C.dtype}")
    if row_sums.dtype != torch.int32 or row_sums.shape != (C.shape[1],):
        raise ValueError(
            f"row_sums must be int32 [{C.shape[1]}], got {row_sums.dtype} "
            f"{tuple(row_sums.shape)}")
    if rows.dtype != torch.int32 or rows.dim() != 1:
        raise ValueError(f"rows must be int32 [S], got {rows.dtype} "
                         f"{tuple(rows.shape)}")
    if not (C.device == row_sums.device == rows.device):
        raise ValueError("C, row_sums and rows must share one device")
    if top_k < 1:
        raise ValueError(f"top_k must be >= 1, got {top_k}")


def topk_padded(scores: torch.Tensor, top_k: int):
    """Top-K of ``scores`` rows, scores descending and the lowest column
    first among ties (``lax.top_k``'s rule, hence a stable sort), for any
    width: with fewer than K columns the missing lanes pad with
    ``(-inf, 0)``."""
    vals, order = torch.sort(scores, dim=-1, descending=True, stable=True)
    k_eff = min(top_k, scores.shape[-1])
    vals, idx = vals[..., :k_eff], order[..., :k_eff].to(torch.int32)
    if k_eff < top_k:
        pad = top_k - k_eff
        vals = torch.cat(
            [vals, vals.new_full(vals.shape[:-1] + (pad,), -torch.inf)], -1)
        idx = torch.cat([idx, idx.new_zeros(idx.shape[:-1] + (pad,))], -1)
    return vals, idx


def _score_counts(counts, rsi, row_sums, observed: float, top_k: int):
    """LLR + top-K of gathered count rows ``counts [S, I]`` whose own sums
    are ``rsi [S]`` (int32), against the column sums ``row_sums``."""
    k11 = counts.to(torch.float32)
    rs = row_sums.to(torch.float32)
    obs = torch.tensor(np.float32(observed), device=counts.device)
    k12 = rsi.to(torch.float32)[:, None] - k11
    k21 = rs[None, :] - k11
    k22 = obs + k11 - k12 - k21
    scores = llr_stable(k11, k12, k21, k22)
    scores = torch.where(counts != 0, scores,
                         torch.full_like(scores, -torch.inf))
    return topk_padded(scores, top_k)


def score_topk_reference(C: torch.Tensor, row_sums: torch.Tensor,
                         rows: torch.Tensor, observed: float, top_k: int):
    """The plain PyTorch version: gather, f32 contingency, ``llr_stable``,
    then a stable descending sort (``torch.topk`` does not promise the
    tie order). Returns ``(vals [S, K] f32, idx [S, K] int32)``; lanes past
    a row's nonzero count are ``-inf`` and, when ``K > I``, pad with
    ``(-inf, 0)`` like the reference package's ``topk_padded``."""
    _check(C, row_sums, rows, top_k)
    r = rows.long()
    return _score_counts(C[r], row_sums[r], row_sums, observed, top_k)


def score_topk_local_reference(C_loc: torch.Tensor, row_sums: torch.Tensor,
                               rows: torch.Tensor, lo: int, observed: float,
                               top_k: int):
    """The plain version of :func:`score_topk_local`: gathers
    ``C_loc[rows - lo]`` and takes each row's own sum from the global
    ``row_sums[rows]``; a row outside ``[lo, lo + R)`` is an empty row
    (every lane ``-inf``), as in the kernel."""
    _check(C_loc, row_sums, rows, top_k, lo)
    r = rows.long()
    local = r - lo
    inside = (local >= 0) & (local < C_loc.shape[0])
    counts = C_loc[torch.where(inside, local, 0)]
    counts = torch.where(inside[:, None], counts, torch.zeros_like(counts))
    rsi = row_sums[torch.where(inside, r, 0)]
    return _score_counts(counts, rsi, row_sums, observed, top_k)


def score_topk(C: torch.Tensor, row_sums: torch.Tensor, rows: torch.Tensor,
               observed: float, top_k: int):
    """Top-K LLR scores of ``rows`` of ``C``: the CUDA kernel on a card,
    :func:`score_topk_reference` for CPU tensors (and only there).

    C        [I, I] int32|int16, contiguous
    row_sums [I]    int32
    rows     [S]    int32 row ids
    observed        total observed co-occurrences (fed as float32)
    Returns ``(vals [S, K] float32, idx [S, K] int32)``.
    """
    _check(C, row_sums, rows, top_k)
    if C.device.type == "cpu":
        return score_topk_reference(C, row_sums, rows, observed, top_k)
    return _launch(C, row_sums, rows, 0, observed, top_k)


def score_topk_local(C_loc: torch.Tensor, row_sums: torch.Tensor,
                     rows: torch.Tensor, lo: int, observed: float,
                     top_k: int):
    """Top-K LLR scores of global ``rows`` out of the local row block
    ``C_loc`` (rows ``[lo, lo + R)`` of the ``I x I`` matrix) against the
    global ``row_sums``: the sharded backend's call (the reference
    package's ``pallas_score_topk_local``). The CUDA kernel on a card,
    :func:`score_topk_local_reference` for CPU tensors (and only there).

    C_loc    [R, I] int32|int16, contiguous
    row_sums [I]    int32, global
    rows     [S]    int32 global row ids; one outside the block scores as
                    an empty row
    Returns ``(vals [S, K] float32, idx [S, K] int32)``.
    """
    _check(C_loc, row_sums, rows, top_k, lo)
    if C_loc.device.type == "cpu":
        return score_topk_local_reference(C_loc, row_sums, rows, lo,
                                          observed, top_k)
    return _launch(C_loc, row_sums, rows, lo, observed, top_k)


def _launch(C, row_sums, rows, lo: int, observed: float, top_k: int):
    """One launch of ``csrc/score_topk.cu`` over the rows of ``C`` that
    start at global row ``lo``."""
    global LAUNCHES
    if C.device.type != "cuda":
        raise ValueError(f"score_topk runs on cuda or cpu, got {C.device}")
    if top_k > MAX_TOP_K:
        raise ValueError(f"top_k {top_k} exceeds the kernel's {MAX_TOP_K}")
    if not (C.is_contiguous() and row_sums.is_contiguous()
            and rows.is_contiguous()):
        raise ValueError("score_topk needs contiguous C, row_sums and rows")
    from ._build import load

    lib = load("score_topk")
    s, (local_rows, n) = rows.shape[0], C.shape
    vals = torch.empty((s, top_k), dtype=torch.float32, device=C.device)
    idx = torch.empty((s, top_k), dtype=torch.int32, device=C.device)
    with torch.cuda.device(C.device):
        stream = torch.cuda.current_stream(C.device).cuda_stream
        err = lib.score_topk_launch(
            C.data_ptr(), C.element_size(), row_sums.data_ptr(),
            rows.data_ptr(), s, n, int(lo), local_rows,
            ctypes.c_float(np.float32(observed)), top_k, vals.data_ptr(),
            idx.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(
            f"score_topk kernel launch failed: "
            f"{lib.score_topk_error_string(err).decode()} (code {err})")
    LAUNCHES += 1
    return vals, idx


def topk_parity(vals_a, idx_a, vals_b, idx_b, rtol=1e-5, atol=1e-5):
    """The kernel-vs-plain parity contract (the reference package's
    ``topk_parity``): scores allclose, and every untied finite lane (score
    unique within its row under the same tolerance) carries the same id.

    Returns ``(scores_allclose: bool, untied_id_mismatches: int)``.
    """
    vals_a, vals_b = np.asarray(vals_a), np.asarray(vals_b)
    idx_a, idx_b = np.asarray(idx_a), np.asarray(idx_b)
    scores_ok = bool(np.allclose(vals_a, vals_b, rtol=rtol, atol=atol))
    untied = np.isclose(vals_a[:, :, None], vals_a[:, None, :],
                        rtol=rtol, atol=atol).sum(-1) == 1
    mism = int(((idx_a != idx_b) & np.isfinite(vals_a) & untied).sum())
    return scores_ok, mism
