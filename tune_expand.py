"""Tuning probe for the expand + scatter kernel on the card.

Times ``csrc/expand_scatter.cu`` at the fused main path's largest
launches (the bench workload at int32 and at int16, on each run's final
state) and at chip_smoke.py's contention cases, for source variants of
the kernel: threads a block, the row-sum table's size or none, cells a
tile, blocks an SM, and C adds summed over a warp's equal cells first. A
variant is a copy of ``tpu_cooccurrence_torch/csrc`` with its edits,
built into ``build/variants/<name>/``. Every variant must leave ``C`` and
the row sums exactly as the plain version does before it is timed, on
every case; variants are timed in interleaved rounds, so a drift of the
card shows in all of them alike. Ablations (a part of the kernel's work
left out: the C adds, the row sums, both) are not exact; they are timed
to show where the time goes and never chosen.

    python3 tune_expand.py [--rounds 5] [--parent DIR]

``--parent DIR`` also builds ``DIR``'s ``expand_scatter.cu`` (another
checkout, such as an unpacked ``git archive`` of the parent commit) and
times it on the same cases in the same rounds. Every build, the parent's
too, is launched by one direct call of its ``expand_scatter_launch``, so
all are timed by one method: chip_smoke.py's ``_time_ms``, the median of
CUDA events around the call (launch overhead included).

Needs one CUDA card and ``nvcc``. Prints the card's name and power limit
first.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

import numpy as np

_ROOT = os.path.dirname(os.path.abspath(__file__))

#: The C adds of a cell, as the kernel issues them.
_C_ADDS = ("        add_count(C, static_cast<size_t>(nw) * num_items + p, "
           "n_cells, v);\n"
           "        add_count(C, static_cast<size_t>(p) * num_items + nw, "
           "n_cells, v);\n")

#: name -> [(old text, new text)]: the edits of expand_scatter.cu.
VARIANTS = {
    "base": [],
    # Every row-sum add goes to device memory: no table in shared memory.
    "no_row_sum_table": [(
        "  if (v == 0) return;\n  const int slot",
        "  if (v == 0) return;\n"
        "  atomicAdd(reinterpret_cast<unsigned*>(row_sums) + item, v);\n"
        "  return;\n  const int slot")],
    "table_1024": [("kTableBits = 12;", "kTableBits = 10;")],
    "table_2048": [("kTableBits = 12;", "kTableBits = 11;")],
    # 256 or 512 threads a block (and as many ops a tile at most).
    "threads_256": [("kThreads = 1024;", "kThreads = 256;"),
                    ("kMaxTileOps = 512;", "kMaxTileOps = 256;")],
    "threads_512": [("kThreads = 1024;", "kThreads = 512;")],
    **{f"tile_cells_{t}": [("kTileCells = 8192;", f"kTileCells = {t};")]
       for t in (1024, 2048, 4096, 16384)},
    **{f"blocks_per_sm_{b}": [("kBlocksPerSm = 2;", f"kBlocksPerSm = {b};")]
       for b in (1, 4)},
    # The first geometry tried: 256 threads, 1,024-cell tiles, 4 an SM.
    "first_geometry": [("kThreads = 1024;", "kThreads = 256;"),
                       ("kMaxTileOps = 512;", "kMaxTileOps = 256;"),
                       ("kTileCells = 8192;", "kTileCells = 1024;"),
                       ("kBlocksPerSm = 2;", "kBlocksPerSm = 4;")],
    # Each C add summed over the warp's lanes with the same cell
    # (__match_any_sync on the cell's offset), one add by the group's
    # first lane.
    "combine_C_adds": [(_C_ADDS, ""), (
        "        add_row_sum(s, row_sums, p, v);\n      }\n",
        "        add_row_sum(s, row_sums, p, v);\n      }\n"
        "#pragma unroll\n"
        "      for (int d = 0; d < 2; ++d) {\n"
        "        const unsigned long long off = p < 0 ? ~0ull\n"
        "            : d == 0 ? static_cast<unsigned long long>(nw) * num_items + p\n"
        "                     : static_cast<unsigned long long>(p) * num_items + nw;\n"
        "        const unsigned g = __match_any_sync(kFull, off);\n"
        "        const unsigned sum = __reduce_add_sync(g, v);\n"
        "        if (p >= 0 && lane == __ffs(g) - 1) add_count(C, off, n_cells, sum);\n"
        "      }\n")],
}

_ROW_SUM_ADDS = [("        add_row_sum(s, row_sums, p, v);\n", ""),
                 ("        add_row_sum(s, row_sums, nw, new_sum);\n", "")]
#: Ablations: a part of the kernel's work left out, to see where the
#: time goes. They are not exact and are timed, never chosen.
ABLATIONS = {
    "without_C_adds": [(_C_ADDS, "")],
    "without_row_sums": _ROW_SUM_ADDS,
    "walk_only": [(_C_ADDS, ""), *_ROW_SUM_ADDS],
}


def _build_variant(name, edits, csrc=None):
    """Copy the sources (of ``csrc``, default this checkout's), apply
    ``edits`` to expand_scatter.cu and start its build; returns the
    library's path and the nvcc process."""
    from tpu_cooccurrence_torch.ops import _build

    csrc = csrc or _build.CSRC_DIR
    out_dir = os.path.join(_ROOT, "build", "variants", f"expand_{name}")
    os.makedirs(out_dir, exist_ok=True)
    for f in os.listdir(csrc):
        with open(os.path.join(csrc, f)) as fh:
            src = fh.read()
        if f == "expand_scatter.cu":
            for old, new in edits:
                if old not in src:
                    raise SystemExit(f"variant {name}: edit not found")
                src = src.replace(old, new)
        with open(os.path.join(out_dir, f), "w") as fh:
            fh.write(src)
    target = os.path.join(out_dir, "expand_scatter.so")
    return target, subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", target,
         os.path.join(out_dir, "expand_scatter.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _load(name, target, proc):
    """Waits for the build, prints ptxas's register, shared-memory and
    spill lines and returns the loaded library."""
    from tpu_cooccurrence_torch.ops import _build

    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise SystemExit(f"variant {name}: nvcc failed:\n{log}")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas {name}: {line.strip()}", flush=True)
    handle = ctypes.CDLL(target)
    for fn, argtypes in _build.SIGNATURES["expand_scatter"].items():
        getattr(handle, fn).argtypes = argtypes
        getattr(handle, fn).restype = (
            ctypes.c_char_p if fn.endswith("error_string") else ctypes.c_int)
    return handle


def _launch(name, lib, C, rs, block):
    """One launch of a build's kernel on the current stream."""
    import torch

    err = lib.expand_scatter_launch(
        block.data_ptr(), block.shape[0], block.shape[1] - 4, C.data_ptr(),
        C.element_size(), rs.data_ptr(), C.shape[0],
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise SystemExit(f"{name}: kernel launch failed (code {err})")


def _main_path_launch(cs, dtype):
    """The fused bench run's largest launch at ``dtype`` and the run's
    final ``C`` and row sums."""
    import torch

    users, items, ts = cs._bench_stream()
    blocks: list = []
    restore = cs._recording_blocks(blocks)
    try:
        job, _ = cs._run_job("cuda", dtype, users, items, ts,
                             num_items=20_000, fused_window="on")
    finally:
        restore()
    largest = max(blocks, key=cs._valid_pairs)
    return (job.scorer.C, job.scorer.row_sums,
            torch.from_numpy(largest).to("cuda"))


def _cases(cs):
    """name -> (C, row_sums, block) on the card."""
    import torch

    rng = np.random.default_rng(20261018)
    dev = torch.device("cuda")

    def state(n, dtype):
        c = torch.from_numpy(rng.integers(-1000, 1000, (n, n))).to(dtype)
        rs = rng.integers(0, 1 << 24, n).astype(np.int32)
        return c.to(dev), torch.from_numpy(rs).to(dev)

    from tpu_cooccurrence_torch.ops.expand import pack_block

    n = 40_000
    ops = (np.r_[np.full(n, 3), np.full(n, 7)],
           np.r_[np.full((n, 1), 5), np.full((n, 1), 11)],
           np.ones(2 * n), np.full(2 * n, -1), np.r_[np.ones(n), -np.ones(n)])
    wrap = torch.from_numpy(pack_block(*(a.astype(np.int32) for a in ops)))
    c64 = torch.zeros((64, 64), dtype=torch.int16)
    c64[3, 5] = c64[5, 3] = 32_760
    c64[7, 11] = c64[11, 7] = -32_760
    return {
        "main_int32": _main_path_launch(cs, "int32"),
        "main_int16": _main_path_launch(cs, "int16"),
        "contention_int32": (*state(4096, torch.int32), cs._basket_block(
            rng, 10_000, 32, 4096, hot_new=17)),
        "contention_int16": (*state(4096, torch.int16), cs._basket_block(
            rng, 10_000, 32, 4096, hot_new=17)),
        "zipf_int32": (*state(5000, torch.int32), cs._basket_block(
            rng, 8131, 71, 5000, zipf=True)),
        "W1_int16": (*state(4096, torch.int16), cs._basket_block(
            rng, 200_000, 1, 4096)),
        "wrap_int16": (c64.to(dev), torch.zeros(64, dtype=torch.int32,
                                                device=dev), wrap.to(dev)),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--parent", default=None,
                    help="another checkout whose expand kernel to time")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("tune_expand.py needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, _ROOT)
    import chip_smoke as cs
    from tpu_cooccurrence_torch.ops import expand as ex

    print(cs._card_line(), flush=True)
    started = {name: _build_variant(name, edits)
               for name, edits in {**VARIANTS, **ABLATIONS}.items()}
    if args.parent:
        started["parent"] = _build_variant("parent", [], os.path.join(
            args.parent, "tpu_cooccurrence_torch", "csrc"))
    libs = {name: _load(name, *tp) for name, tp in started.items()}
    cases = _cases(cs)
    want = {}
    for case, (C, rs, block) in cases.items():
        pc, prs = C.clone(), rs.clone()
        ex.apply_baskets_reference(pc, prs, block)
        want[case] = (pc, prs)
        print(f"case {case}: {block.shape[0]} ops, W={block.shape[1] - 4}, "
              f"I={C.shape[0]}, {C.dtype}, "
              f"{cs._valid_pairs(block.cpu().numpy())} valid cells",
              flush=True)
    labels = {name: f"{'ablation' if name in ABLATIONS else 'variant'} "
                    f"{name}" for name in libs}
    times = {name: {case: [] for case in cases} for name in libs}
    for rnd in range(args.rounds):
        for name, lib in libs.items():
            for case, (C, rs, block) in cases.items():
                kc, krs = C.clone(), rs.clone()

                def apply():
                    _launch(name, lib, kc, krs, block)

                apply()
                if name not in ABLATIONS and not (
                        torch.equal(kc, want[case][0])
                        and torch.equal(krs, want[case][1])):
                    print(f"{labels[name]} is not exact on {case}",
                          flush=True)
                    return 1
                times[name][case].append(cs._time_ms(apply, 20))
                del kc, krs
            print(f"round {rnd + 1} {labels[name]}: " + ", ".join(
                f"{case} {t[-1]:.4f}" for case, t in times[name].items()),
                flush=True)
    print("medians over rounds (ms; range):", flush=True)
    for name, per_case in times.items():
        print(f"  {labels[name]}: " + ", ".join(
            f"{case} {np.median(t):.4f} ({min(t):.4f}-{max(t):.4f})"
            for case, t in per_case.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
