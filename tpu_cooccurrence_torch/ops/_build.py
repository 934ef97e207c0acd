"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds),
at first use, into ``build/kernels/`` beside the package (git-ignored).
Libraries are keyed by a hash of their source and flags, so an edited
source rebuilds and an unchanged one is reused. :func:`build_all` starts
one ``nvcc`` per source at once; :func:`load` returns the ``ctypes``
handle with its argument types declared. Headers (``csrc/*.cuh``) enter
every library's hash, so an edited header rebuilds its users.

Nothing here runs at import: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")

#: nvcc flags. sm_90a keeps Hopper's wgmma/setmaxnreg available; no fast
#: math and no FMA contraction, so log1pf, the divisions and every
#: product round as IEEE float32 does in the plain PyTorch versions.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas", "-v"]

_c_void_p, _c_int, _c_float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_c_longlong = ctypes.c_longlong

#: Library name -> {C function: argtypes}. One entry per ``csrc/<name>.cu``.
SIGNATURES: Dict[str, Dict[str, list]] = {
    "score_topk": {
        # C, count_bytes, row_sums, rows, num_rows, num_items, row_lo,
        # local_rows, observed, top_k, out_vals, out_idx, stream
        "score_topk_launch": [_c_void_p, _c_int, _c_void_p, _c_void_p,
                              _c_int, _c_int, _c_int, _c_int, _c_float,
                              _c_int, _c_void_p, _c_void_p, _c_void_p],
        "score_topk_error_string": [_c_int],
    },
    "rect_topk": {
        # cnt, cell_bytes, dst, row_sums, rows, starts, lens, num_rows,
        # num_items, cap, observed, top_k, n_short, out_vals, out_idx,
        # stream
        "rect_topk_launch": [_c_void_p, _c_int, _c_void_p, _c_void_p,
                             _c_void_p, _c_void_p, _c_void_p, _c_int,
                             _c_int, _c_longlong, _c_float, _c_int, _c_int,
                             _c_void_p, _c_void_p, _c_void_p],
        "rect_topk_error_string": [_c_int],
    },
    "expand_scatter": {
        # block, n_ops, width, C, count_bytes, row_sums, num_items, stream
        "expand_scatter_launch": [_c_void_p, _c_int, _c_int, _c_void_p,
                                  _c_int, _c_void_p, _c_int, _c_void_p],
        "expand_scatter_error_string": [_c_int],
    },
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the port's CUDA "
            "kernels are built on the machine with the card")
    return found


def _target(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for src in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC_DIR, src), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def _start(name: str):
    """Start nvcc for ``name`` unless its library is built; returns the
    process (or None) and the target path."""
    target = _target(name)
    if os.path.exists(target):
        return None, target
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{target}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC_DIR, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, target


def _finish(name: str, proc, target: str) -> None:
    if proc is None:
        return
    out, _ = proc.communicate()
    tmp = f"{target}.{os.getpid()}.tmp"
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{out}")
    with open(target + ".log", "w") as f:  # ptxas register/smem report
        f.write(out)
    os.replace(tmp, target)


def build_all(names: Optional[List[str]] = None) -> Dict[str, str]:
    """Build every kernel library (one nvcc each, all started together);
    returns name -> library path."""
    names = list(SIGNATURES) if names is None else names
    started = [(n, *_start(n)) for n in names]
    for name, proc, target in started:
        _finish(name, proc, target)
    return {name: target for name, _, target in started}


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(build_all([name])[name])
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = (
                    ctypes.c_char_p if fn.endswith("error_string")
                    else ctypes.c_int)
            _loaded[name] = lib
        return lib
