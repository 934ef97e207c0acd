"""Sparse slab cell dtypes and the uplink format, trimmed to the port.

Copy of the cell-dtype half of ``tpu_cooccurrence/state/wire.py``: the
dtype table, the promotion bound, the guarded narrowing cast and the two
``auto`` resolvers. The packed uplink codec and the checkpoint blob codec
are not ported yet: the port's sparse backend ships the raw update
buffer and keeps int32 cells.

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
