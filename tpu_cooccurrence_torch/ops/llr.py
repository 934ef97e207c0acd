"""Log-likelihood ratio, in PyTorch (port of ``tpu_cooccurrence/ops/llr.py``).

The reference implements Dunning's LLR as ``2*(row + col - matrix)``
unnormalized entropies with 9 ``x*log(x)`` calls and a round-off clamp
(``LogLikelihood.java:41-57``). That form is fine in float64 but cancels
catastrophically in float32 once counts reach ~1e9. The device path
therefore uses the algebraically identical mutual-information form

    LLR = 2 * sum_ij k_ij * log(k_ij * N / (r_i * c_j))

with ``k_ij*N - r_i*c_j = +/-D``, ``D = k11*k22 - k12*k21``, giving four
``k * log1p(+/-D / (r*c))`` terms — cancellation-free, so float32 keeps
absolute error ~1e-4 even at ``N ~ 3e10``. :func:`llr_stable` evaluates
these terms in the reference package's order, operation for operation;
the CUDA kernel (``csrc/score_topk.cu``) does the same.

Both forms satisfy Dunning's golden vectors (270.72, 263.90, 48.94 —
``LogLikelihoodTest.java:13-16``).
"""

from __future__ import annotations

import numpy as np
import torch


# ---------------------------------------------------------------------------
# NumPy float64 oracle (entropy form, mirrors the reference's math exactly)
# ---------------------------------------------------------------------------

def xlogx_np(x: np.ndarray) -> np.ndarray:
    """``x*log(x)`` with ``0*log(0) = 0`` (``LogLikelihood.java:59-61``)."""
    x = np.asarray(x, dtype=np.float64)
    out = np.zeros_like(x)
    nz = x > 0
    out[nz] = x[nz] * np.log(x[nz])
    return out


def llr_np(k11, k12, k21, k22) -> np.ndarray:
    """Float64 entropy-form LLR with the reference's round-off clamp."""
    k11 = np.asarray(k11, dtype=np.float64)
    k12 = np.asarray(k12, dtype=np.float64)
    k21 = np.asarray(k21, dtype=np.float64)
    k22 = np.asarray(k22, dtype=np.float64)
    row1 = k11 + k12
    row2 = k21 + k22
    all_ = xlogx_np(row1 + row2)
    row = all_ - xlogx_np(row1) - xlogx_np(row2)
    col = all_ - xlogx_np(k11 + k21) - xlogx_np(k12 + k22)
    matrix = all_ - xlogx_np(k11) - xlogx_np(k12) - xlogx_np(k21) - xlogx_np(k22)
    out = 2.0 * (row + col - matrix)
    return np.where(row + col < matrix, 0.0, out)


# ---------------------------------------------------------------------------
# Tensor forms
# ---------------------------------------------------------------------------

def _xlogx(x: torch.Tensor) -> torch.Tensor:
    pos = x > 0
    return torch.where(pos, x * torch.log(torch.where(pos, x, torch.ones_like(x))),
                       torch.zeros_like(x))


def llr_entropy(k11, k12, k21, k22) -> torch.Tensor:
    """Entropy-form LLR (reference formula verbatim). Use only in float64."""
    row1 = k11 + k12
    row2 = k21 + k22
    all_ = _xlogx(row1 + row2)
    row = all_ - _xlogx(row1) - _xlogx(row2)
    col = all_ - _xlogx(k11 + k21) - _xlogx(k12 + k22)
    matrix = all_ - _xlogx(k11) - _xlogx(k12) - _xlogx(k21) - _xlogx(k22)
    return torch.where(row + col < matrix, torch.zeros_like(row),
                       2.0 * (row + col - matrix))


def _term(k, rc, det, sign: float) -> torch.Tensor:
    # k * log1p(sign*det / rc) where k > 0 and rc > 0, else 0. The floor
    # -1 + 1e-38 rounds to -1.0 in float32, exactly as in the reference.
    safe_rc = torch.where(rc > 0, rc, torch.ones_like(rc))
    x = (sign * det) / safe_rc
    lg = torch.log1p(torch.clamp_min(x, -1.0 + 1e-38))
    return torch.where((k > 0) & (rc > 0), k * lg, torch.zeros_like(k))


def llr_stable(k11, k12, k21, k22) -> torch.Tensor:
    """Float32-stable LLR via the mutual-information / log1p form, clamped
    at zero like the reference (``LogLikelihood.java:51-53``)."""
    r1 = k11 + k12
    r2 = k21 + k22
    c1 = k11 + k21
    c2 = k12 + k22
    det = k11 * k22 - k12 * k21
    out = 2.0 * (
        _term(k11, r1 * c1, det, 1.0)
        + _term(k12, r1 * c2, det, -1.0)
        + _term(k21, r2 * c1, det, -1.0)
        + _term(k22, r2 * c2, det, 1.0)
    )
    return torch.clamp_min(out, 0.0)


def score_contingency(k11, item_row_sum, other_row_sum, observed,
                      llr_fn=llr_stable) -> torch.Tensor:
    """Build the 2x2 table from co-occurrence counts and score it.

    Mirrors ``ItemRowRescorerTwoInputStreamOperator.scoreItem`` (:230-241):
    k12 = rowSum(i) - k11, k21 = rowSum(j) - k11,
    k22 = observed + k11 - k12 - k21. All inputs are float tensors.
    """
    k12 = item_row_sum - k11
    k21 = other_row_sum - k11
    k22 = observed + k11 - k12 - k21
    return llr_fn(k11, k12, k21, k22)
