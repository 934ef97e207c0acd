"""Basket expansion + count scatter for the dense fused window.

Port of ``tpu_cooccurrence/ops/pallas_score.py``'s ``_expand_kernel`` (as
called by ``pallas_expand_baskets``) together with the scatter-add that
the reference leaves to XLA after it (``ops/device_scorer.py``
``_fused_apply_baskets``). One star op ``i`` is a new item, a basket of
partners, a valid length, an excluded column and a sign; for every
``j < len[i]`` with ``j != skip[i]`` and ``p = basket[i, j]``:

    C[new[i], p] += sign[i]    C[p, new[i]] += sign[i]
    row_sums[new[i]] += sign[i]    row_sums[p] += sign[i]

Basket cells at ``j >= len[i]`` are unspecified bytes and are never read
as an address. int16 ``C`` wraps like the reference's Java shorts.

The ops arrive as one packed ``[n, W + 4]`` int32 block: the basket
rectangle, then the columns new, len, skip, sign (:func:`pack_block`).

:func:`apply_baskets` is the wrapper: on a CUDA tensor it launches the
hand-written kernel (``csrc/expand_scatter.cu``) or raises; on a CPU
tensor it runs :func:`apply_baskets_reference`, the plain PyTorch version
(:func:`expand_baskets_reference`'s lanes, less those that add nothing,
then the chained path's ``index_put_``/``index_add_``). :data:`LAUNCHES`
counts kernel launches.
"""

from __future__ import annotations

import numpy as np
import torch

#: Meta columns after the basket rectangle: new item, len, skip, sign.
META_COLS = 4

#: Kernel launches made by :func:`apply_baskets` in this process.
LAUNCHES = 0


def pack_block(new_items, baskets, lens, skips, signs) -> np.ndarray:
    """The packed ``[n, W + 4]`` int32 block of ``n`` ops of width ``W``
    (``baskets`` may be wider: its first ``W`` columns ride up, with
    ``W = baskets.shape[1]`` cut to the ops' longest ``len``)."""
    n = len(new_items)
    w = min(baskets.shape[1], int(lens.max()) if n else 0)
    block = np.empty((n, w + META_COLS), dtype=np.int32)
    block[:, :w] = baskets[:, :w]
    block[:, w] = new_items
    block[:, w + 1] = lens
    block[:, w + 2] = skips
    block[:, w + 3] = signs
    return block


def split_block(block: torch.Tensor):
    """``(basket [n, W], new, lens, skips, signs [n])`` views of a block."""
    w = block.shape[1] - META_COLS
    return (block[:, :w], block[:, w], block[:, w + 1], block[:, w + 2],
            block[:, w + 3])


def expand_baskets_reference(basket, new, lens, skips, signs):
    """The TPU kernel's lanes, lane for lane: ``(src, dst, delta)`` each
    ``[n, 2W]`` int32, ``[new -> basket[j] | j] ++ [basket[j] -> new | j]``
    with ``delta = sign`` on the valid lanes (``j < len``, ``j != skip``)
    and the ``(0, 0, 0)`` scatter no-op triple everywhere else."""
    n, w = basket.shape
    j = torch.arange(w, device=basket.device)[None, :]
    valid = (j < lens[:, None]) & (j != skips[:, None])
    zero = torch.zeros((n, w), dtype=torch.int32, device=basket.device)
    fwd_src = torch.where(valid, new[:, None].expand(n, w), zero)
    fwd_dst = torch.where(valid, basket, zero)
    d = torch.where(valid, signs[:, None].expand(n, w), zero)
    return (torch.cat([fwd_src, fwd_dst], 1), torch.cat([fwd_dst, fwd_src], 1),
            torch.cat([d, d], 1))


def _check(C, row_sums, block) -> None:
    if C.dim() != 2 or C.shape[0] != C.shape[1]:
        raise ValueError(f"C must be square [I, I], got {tuple(C.shape)}")
    if C.dtype not in (torch.int32, torch.int16):
        raise ValueError(f"C must be int32 or int16, got {C.dtype}")
    if row_sums.dtype != torch.int32 or row_sums.shape != (C.shape[0],):
        raise ValueError(
            f"row_sums must be int32 [{C.shape[0]}], got {row_sums.dtype} "
            f"{tuple(row_sums.shape)}")
    if (block.dtype != torch.int32 or block.dim() != 2
            or block.shape[1] < META_COLS):
        raise ValueError(f"block must be int32 [n, W + {META_COLS}], got "
                         f"{block.dtype} {tuple(block.shape)}")
    if not (C.device == row_sums.device == block.device):
        raise ValueError("C, row_sums and block must share one device")


def apply_baskets_reference(C: torch.Tensor, row_sums: torch.Tensor,
                            block: torch.Tensor) -> None:
    """The plain PyTorch version, in place: the reference lanes, then
    ``C[src, dst] += delta`` (``index_put_`` accumulates duplicate
    cells) and ``row_sums[src] += delta``. Lanes with ``delta == 0`` (the
    ``(0, 0, 0)`` no-op lanes, and valid lanes of sign 0) add nothing and
    are dropped first, so they do not all queue on ``C[0, 0]``."""
    _check(C, row_sums, block)
    src, dst, delta = (t.reshape(-1) for t in
                       expand_baskets_reference(*split_block(block)))
    keep = delta != 0
    src, dst, delta = src[keep].long(), dst[keep].long(), delta[keep]
    C.index_put_((src, dst), delta.to(C.dtype), accumulate=True)
    row_sums.index_add_(0, src, delta)


def apply_baskets(C: torch.Tensor, row_sums: torch.Tensor,
                  block: torch.Tensor) -> None:
    """Expand the ops of ``block`` and scatter them into ``C`` and
    ``row_sums``, in place: the CUDA kernel on a card,
    :func:`apply_baskets_reference` for CPU tensors (and only there).

    C        [I, I] int32|int16, contiguous
    row_sums [I]    int32
    block    [n, W + 4] int32 (:func:`pack_block`); ids must lie in
             ``[0, I)`` on the valid cells (the kernel skips any other)
    """
    global LAUNCHES
    _check(C, row_sums, block)
    if C.device.type == "cpu":
        apply_baskets_reference(C, row_sums, block)
        return
    if C.device.type != "cuda":
        raise ValueError(f"apply_baskets runs on cuda or cpu, got {C.device}")
    if not (C.is_contiguous() and row_sums.is_contiguous()
            and block.is_contiguous()):
        raise ValueError("apply_baskets needs contiguous C, row_sums and "
                         "block")
    from ._build import load

    lib = load("expand_scatter")
    n, width = block.shape[0], block.shape[1] - META_COLS
    with torch.cuda.device(C.device):
        stream = torch.cuda.current_stream(C.device).cuda_stream
        err = lib.expand_scatter_launch(
            block.data_ptr(), n, width, C.data_ptr(), C.element_size(),
            row_sums.data_ptr(), C.shape[0], stream)
    if err != 0:
        raise RuntimeError(
            f"expand_scatter kernel launch failed: "
            f"{lib.expand_scatter_error_string(err).decode()} (code {err})")
    LAUNCHES += 1
