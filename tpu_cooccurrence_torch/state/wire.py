"""Sparse slab cell dtypes and the uplink format, trimmed to the port.

Copy of the cell-dtype half of ``tpu_cooccurrence/state/wire.py``: the
dtype table, the promotion bound, the guarded narrowing cast and the two
``auto`` resolvers; and the decoders of the checkpoint blob codec
(delta + LEB128 varint), so that a checkpoint the reference package
wrote with its default ``ckpt_codec`` restores here. The packed uplink
codec is not ported yet: the port's sparse backend ships the raw update
buffer, keeps int32 cells and writes its checkpoints raw.

The port's ``auto`` rules differ from the reference package's in one
place: ``--cell-dtype auto`` resolves to int32, not int16. That is exact
either way (narrow cells with promotion give scores bit-identical to an
int32 slab), and the narrow-cell scatter and its promotion side-table
wait for a later slice.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

#: ``--cell-dtype`` values -> numpy dtype of the slab ``cnt`` cells.
CELL_DTYPES = {"int32": np.int32, "int16": np.int16, "int8": np.int8}


def cell_promote_threshold(cell_dtype: str) -> Optional[int]:
    """Row-sum bound below which every cell of a row provably fits the
    narrow dtype (cells are non-negative and sum to the row sum). Returns
    ``None`` for int32 (nothing ever promotes)."""
    if cell_dtype == "int32":
        return None
    bits = np.iinfo(CELL_DTYPES[cell_dtype]).bits
    return 1 << (bits - 1)


def checked_narrow(arr: np.ndarray, dtype) -> np.ndarray:
    """The guarded narrowing cast: raises instead of wrapping."""
    info = np.iinfo(dtype)
    if len(arr) and (int(arr.min()) < info.min or int(arr.max()) > info.max):
        raise OverflowError(
            f"value range [{arr.min()}, {arr.max()}] does not fit "
            f"{np.dtype(dtype).name} [{info.min}, {info.max}]")
    return arr.astype(dtype)


def resolve_cell_dtype(flag: str) -> str:
    """``--cell-dtype`` resolution: ``auto`` is int32 in the port."""
    return "int32" if flag == "auto" else flag


def resolve_wire_format(flag: str) -> str:
    """``--wire-format`` resolution: ``auto`` is the raw uplink."""
    return "raw" if flag == "auto" else flag


# -- varint (LEB128) checkpoint blobs ----------------------------------


def decode_varint(buf: np.ndarray, count: int) -> np.ndarray:
    """LEB128 stream (``uint8``) -> ``uint64`` array of ``count`` values;
    the inverse of the reference package's ``encode_varint``."""
    buf = np.asarray(buf, dtype=np.uint8)
    if count == 0:
        if len(buf):
            raise ValueError("varint blob has trailing bytes")
        return np.zeros(0, dtype=np.uint64)
    term = buf < 128
    if int(term.sum()) != count or not term[-1]:
        raise ValueError(
            f"varint blob holds {int(term.sum())} values, expected {count}")
    gid = np.concatenate([[0], np.cumsum(term)[:-1]]).astype(np.int64)
    starts = np.concatenate([[0], np.flatnonzero(term)[:-1] + 1])
    pos = np.arange(len(buf), dtype=np.int64) - starts[gid]
    if int(pos.max()) > 9:
        raise ValueError("varint run exceeds 10 bytes")
    out = np.zeros(count, dtype=np.uint64)
    np.bitwise_or.at(
        out, gid,
        (buf & np.uint8(0x7F)).astype(np.uint64) << (np.uint64(7) *
                                                     pos.astype(np.uint64)))
    return out


def decode_sorted_u64(buf: np.ndarray, count: int) -> np.ndarray:
    """Delta + varint blob -> the sorted nonnegative ``int64`` array it
    encodes (sorted cell keys)."""
    d = decode_varint(buf, count)
    return np.cumsum(d.astype(np.uint64)).astype(np.int64)
