"""Sparse slab cell dtypes, the packed uplink and the checkpoint blobs.

Copy of ``tpu_cooccurrence/state/wire.py`` (the port imports nothing of
the reference package), with the device decode in PyTorch:

* **Narrow cell dtypes**: slab ``cnt`` cells stored as int16 (or int8),
  exact because a row moves to the wide int32 side-table BEFORE any of
  its cells could saturate (:func:`cell_promote_threshold`: cells are
  non-negative and sum to the row sum, so a row whose sum stays under
  ``2^(w-1)`` holds no cell past the dtype's maximum).
  :func:`checked_narrow` is the guarded narrowing cast.
* **Packed uplink** (:func:`encode_update` on the host,
  :func:`decode_update` on the update's device): a window's update buffer
  (``[2, n] int32``: new cells | cell deltas | row sums) as per-section
  sorted delta + zigzag + fixed-width bit-pack. The decode is gathers,
  shifts and prefix sums in int64 tensor ops, feeding the scorer's
  ``_update_body`` unchanged. Sorting inside a section is free: each
  section's indices are unique and its scatters commute.
* **Checkpoint blobs** (:func:`encode_varint`, :func:`encode_sorted_u64`
  and their decoders): delta + LEB128 varint for the sorted cell keys,
  plain varint for the counts, host-decoded on restore.

``auto`` resolves as in the reference package: int16 cells and the
packed uplink on the single-process sparse backend, int32 and raw
elsewhere; :func:`checkpoint_codec` writes packed checkpoints unless the
flag says ``raw``. Every encoder gives words and bytes equal to the
reference package's.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

#: Index of a padding entry of a decoded update buffer (the reference
#: package's scatter sentinel, dropped there by ``mode="drop"``).
SENT = np.int32(2**31 - 1)

# -- narrow cell dtypes ------------------------------------------------

#: ``--cell-dtype`` values -> numpy dtype of the slab ``cnt`` cells.
CELL_DTYPES = {"int32": np.int32, "int16": np.int16, "int8": np.int8}


def cell_promote_threshold(cell_dtype: str) -> Optional[int]:
    """Row-sum bound below which every cell of a row provably fits the
    narrow dtype (cells are non-negative and sum to the row sum). A row
    whose running sum reaches it is promoted to the wide side-table
    before the window's deltas apply. ``None`` for int32 (nothing ever
    promotes)."""
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


def resolve_cell_dtype(flag: str, sparse_single_device: bool) -> str:
    """``--cell-dtype``: ``auto`` is int16 on the single-process sparse
    backend (the promotion side-table lives there), int32 elsewhere."""
    if flag == "auto":
        return "int16" if sparse_single_device else "int32"
    return flag


def resolve_wire_format(flag: str, sparse_single_device: bool) -> str:
    """``--wire-format``: ``auto`` is the packed uplink on the
    single-process sparse backend, raw elsewhere."""
    if flag == "auto":
        return "packed" if sparse_single_device else "raw"
    return flag


def checkpoint_codec(flag: str) -> str:
    """Checkpoint blob codec from ``--wire-format``: ``auto`` and
    ``packed`` write delta + varint blobs, ``raw`` the plain arrays (on
    every backend). Restore reads the codec from the embedded meta."""
    return "raw" if flag == "raw" else "packed"


# -- fixed-width bit packing -------------------------------------------


def pack_bits(values: np.ndarray, width: int) -> np.ndarray:
    """Pack ``values`` (< 2^width each) at ``width`` bits into a
    little-endian uint32 word stream. ``1 <= width <= 32``.

    A value's bits land in its word and the next; word indices rise with
    the value index, so one ``bitwise_or.reduceat`` per half folds each
    word's values (the reference's ``bitwise_or.at`` gives the same
    words, element by element)."""
    if not (1 <= width <= 32):
        raise ValueError(f"pack width must be in [1, 32], got {width}")
    n = len(values)
    if n == 0:
        return np.zeros(0, dtype=np.uint32)
    vals = values.astype(np.uint64)
    if int(vals.max()) >> width:
        raise ValueError(f"value {vals.max()} does not fit {width} bits")
    bit0 = np.arange(n, dtype=np.int64) * width
    word = bit0 >> 5
    n_words = int((n * width + 31) // 32)
    out = np.zeros(n_words + 1, dtype=np.uint32)  # +1: spill slot
    # A value shifted to its offset (< 32) fits 63 bits: the low half goes
    # to its word, the high half to the next.
    shifted = vals << (bit0 & 31).astype(np.uint64)
    first = np.flatnonzero(np.r_[True, word[1:] != word[:-1]])
    words = word[first]
    out[words] |= np.bitwise_or.reduceat(shifted.astype(np.uint32), first)
    out[words + 1] |= np.bitwise_or.reduceat(
        (shifted >> np.uint64(32)).astype(np.uint32), first)
    return out[:n_words]


def unpack_bits(words: np.ndarray, width: int, n: int) -> np.ndarray:
    """Host inverse of :func:`pack_bits` -> uint64 array of length ``n``."""
    if n == 0:
        return np.zeros(0, dtype=np.uint64)
    w64 = np.append(words.astype(np.uint64), np.uint64(0))
    bit0 = np.arange(n, dtype=np.uint64) * np.uint64(width)
    word = (bit0 >> np.uint64(5)).astype(np.int64)
    off = bit0 & np.uint64(31)
    combined = w64[word] | (w64[word + 1] << np.uint64(32))
    mask = (np.uint64(1) << np.uint64(width)) - np.uint64(1)
    return (combined >> off) & mask


# -- the packed update buffer --------------------------------------------
#
#   header   int32[5]   n, w_idx, w_val, b0, b1
#   words_i  uint32[.]  index column: per-section delta of the section-
#                       sorted indices, w_idx bits each
#   words_v  uint32[.]  value column: zigzag(v) at w_val bits each; the
#                       new-cell section's partner ids delta-coded too


def _section_starts(n: int, b0: int, b1: int):
    return (0, b0), (b0, b1), (b1, n)


def encode_update(upd: np.ndarray, bounds, n: int
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Encode the live prefix ``upd[:, :n]`` of a raw update buffer split
    at ``bounds`` (b0, b1). Returns ``(words_i, words_v, header)``,
    unpadded. Each section is sorted by index first (its scatters are
    order-independent), which makes the index column delta-friendly."""
    b0, b1 = int(bounds[0]), int(bounds[1])
    idx = upd[0, :n].astype(np.int64)
    val = upd[1, :n].astype(np.int64)
    order = np.concatenate([
        lo + np.argsort(idx[lo:hi], kind="stable")
        for lo, hi in _section_starts(n, b0, b1)]) if n else \
        np.zeros(0, dtype=np.int64)
    idx_s = idx[order]
    val_s = val[order]
    d = np.diff(idx_s, prepend=np.int64(0))
    for s, _e in _section_starts(n, b0, b1)[1:]:
        if s < n:
            d[s] = idx_s[s]  # each section restarts from an absolute index
    # New-cell partner ids ride as deltas too: slots are sorted and a
    # row's slots are dst-ordered, so the ids are near-sorted.
    v_enc = val_s.copy()
    if b0:
        v_enc[:b0] = np.diff(val_s[:b0], prepend=np.int64(0))
    zz = ((v_enc << np.int64(1)) ^ (v_enc >> np.int64(63))).astype(np.uint64)
    w_i = max(int(d.max()).bit_length(), 1) if n else 1
    w_v = max(int(zz.max()).bit_length(), 1) if n else 1
    header = np.asarray([n, w_i, w_v, b0, b1], dtype=np.int32)
    return (pack_bits(d.astype(np.uint64), w_i),
            pack_bits(zz, w_v), header)


def decode_update_host(words_i: np.ndarray, words_v: np.ndarray,
                       header: np.ndarray, n_pad: int):
    """Host inverse of :func:`encode_update`: ``(upd [2, n_pad] int32,
    bounds int32[2])``, padding entries ``(SENT, 0)``. Equal to the raw
    buffer up to the order inside each section."""
    n, w_i, w_v, b0, b1 = (int(x) for x in header)
    d = unpack_bits(words_i, w_i, n).astype(np.int64)
    zz = unpack_bits(words_v, w_v, n)
    v = ((zz >> np.uint64(1)).astype(np.int64)
         ^ -(zz & np.uint64(1)).astype(np.int64))
    idx = np.zeros(n, dtype=np.int64)
    val = np.zeros(n, dtype=np.int64)
    for lo, hi in _section_starts(n, b0, b1):
        idx[lo:hi] = np.cumsum(d[lo:hi])
        val[lo:hi] = v[lo:hi]
    if b0:
        val[:b0] = np.cumsum(v[:b0])
    upd = np.full((2, n_pad), SENT, dtype=np.int32)
    upd[1] = 0
    upd[0, :n] = idx.astype(np.int32)
    upd[1, :n] = val.astype(np.int32)
    return upd, np.asarray([b0, b1], dtype=np.int32)


def words_tensor(words: np.ndarray, device) -> torch.Tensor:
    """A uint32 word stream as the int32 tensor :func:`decode_update`
    reads, with one trailing guard word (the decode reads ``word + 1``
    of the last value)."""
    out = np.zeros(len(words) + 1, dtype=np.uint32)
    out[: len(words)] = words
    return torch.from_numpy(out.view(np.int32)).to(device)


def _unpack(words: torch.Tensor, width: int, n: int) -> torch.Tensor:
    """Values ``[0, n)`` of a guarded word stream (int32 bit patterns),
    as int64. A value's bits start at ``off`` of its word and run into
    the next; int64 holds both halves with no sign bit reached."""
    w = words.long() & 0xFFFFFFFF
    bit0 = torch.arange(n, dtype=torch.int64, device=words.device) * width
    word = bit0 >> 5
    off = bit0 & 31
    hi = torch.where(off > 0, w[word + 1], 0) << (32 - off)
    return ((w[word] >> off) | hi) & ((1 << width) - 1)


def decode_update(words_i: torch.Tensor, words_v: torch.Tensor,
                  header: np.ndarray, n_pad: int):
    """Decode on the words' device: ``(upd [2, n_pad] int32 tensor,
    (b0, b1))``, equal to :func:`decode_update_host`. ``words_*`` come
    from :func:`words_tensor`; ``header`` stays on the host (its widths
    and bounds are the decode's shapes). Gathers, shifts and per-section
    prefix sums, in int64 (true values fit int32, so nothing wraps)."""
    n, w_i, w_v, b0, b1 = (int(x) for x in header)
    d = _unpack(words_i, w_i, n)
    zz = _unpack(words_v, w_v, n)
    v = (zz >> 1) ^ -(zz & 1)
    idx = torch.cat([torch.cumsum(d[lo:hi], 0)
                     for lo, hi in _section_starts(n, b0, b1)])
    val = torch.cat([torch.cumsum(v[:b0], 0), v[b0:]])
    upd = torch.empty((2, n_pad), dtype=torch.int32, device=words_i.device)
    upd[0, :n] = idx.to(torch.int32)
    upd[1, :n] = val.to(torch.int32)
    upd[0, n:] = int(SENT)
    upd[1, n:] = 0
    return upd, (b0, b1)


def packed_nbytes(words_i: np.ndarray, words_v: np.ndarray,
                  header: np.ndarray) -> int:
    return int(words_i.nbytes + words_v.nbytes + header.nbytes)


# -- varint (LEB128) checkpoint blobs ----------------------------------


def encode_varint(values: np.ndarray) -> np.ndarray:
    """LEB128-encode nonnegative int64/uint64 values -> uint8 stream."""
    vals = np.asarray(values)
    if len(vals) and vals.dtype != np.uint64 and int(vals.min()) < 0:
        raise ValueError("varint encodes nonnegative values only")
    vals = vals.astype(np.uint64)
    n = len(vals)
    if n == 0:
        return np.zeros(0, dtype=np.uint8)
    nb = np.ones(n, dtype=np.int64)
    for k in range(1, 10):
        nb += (vals >> np.uint64(7 * k)) != 0
    offsets = np.concatenate([[0], np.cumsum(nb)[:-1]])
    out = np.zeros(int(nb.sum()), dtype=np.uint8)
    for k in range(10):
        sel = nb > k
        if not sel.any():
            break
        byte = ((vals[sel] >> np.uint64(7 * k)) & np.uint64(0x7F)
                ).astype(np.uint8)
        cont = (nb[sel] - 1 > k).astype(np.uint8) << 7
        out[offsets[sel] + k] = byte | cont
    return out


def decode_varint(buf: np.ndarray, count: int) -> np.ndarray:
    """Inverse of :func:`encode_varint` -> uint64 array of ``count``."""
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


def encode_zigzag_varint(values: np.ndarray) -> np.ndarray:
    """Zigzag + LEB128 for signed int64 values, exact over the domain."""
    v = np.asarray(values, dtype=np.int64)
    zz = ((v << np.int64(1)) ^ (v >> np.int64(63))).astype(np.uint64)
    return encode_varint(zz)


def decode_zigzag_varint(buf: np.ndarray, count: int) -> np.ndarray:
    """Inverse of :func:`encode_zigzag_varint` -> int64 array."""
    zz = decode_varint(buf, count)
    return ((zz >> np.uint64(1)).astype(np.int64)
            ^ -(zz & np.uint64(1)).astype(np.int64))


def encode_sorted_u64(keys: np.ndarray) -> np.ndarray:
    """Delta + varint for a sorted nonnegative int64 array (cell keys).
    Raises on unsorted or negative input; the caller keeps that array
    raw."""
    keys = np.asarray(keys, dtype=np.int64)
    if len(keys):
        if int(keys.min()) < 0:
            raise ValueError("sorted-u64 codec needs nonnegative keys")
        d = np.diff(keys.astype(np.uint64), prepend=np.uint64(0))
        if len(keys) > 1 and (np.diff(keys) < 0).any():
            raise ValueError("sorted-u64 codec needs sorted keys")
    else:
        d = np.zeros(0, dtype=np.uint64)
    return encode_varint(d)


def decode_sorted_u64(buf: np.ndarray, count: int) -> np.ndarray:
    """Inverse of :func:`encode_sorted_u64` -> sorted int64 array."""
    d = decode_varint(buf, count)
    return np.cumsum(d.astype(np.uint64)).astype(np.int64)
