"""Tuning probe for the two LLR + top-K kernels on the card.

Times ``score_topk`` and ``rect_topk`` at the main paths' shapes (the
dense bench workload's launch, S=8192 and I=20,000 at int32; the largest
launch of config 4's sparse run) for source variants of the kernels, and
``rect_topk`` under every short-row limit of its launch plan. A variant
is a copy of ``tpu_cooccurrence_torch/csrc`` with one edit, built into
``build/variants/<name>/``; every variant must match the plain version
exactly before it is timed. Variants are timed in interleaved rounds, so
a drift of the card shows in every variant alike.

    python3 tune_topk.py [--rounds 5]

Needs one CUDA card and ``nvcc``. Prints the card's name and power limit
first; every time is the median of CUDA-event timings (chip_smoke.py's).
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

import numpy as np

_ROOT = os.path.dirname(os.path.abspath(__file__))

ONE_VECTOR = """\
    int4 next = tid < nvec ? __ldcs(body + tid) : make_int4(0, 0, 0, 0);
    for (int b = 0; b < nvec; b += kThreads) {
      const int4 cur = next;
      const int t = b + kThreads + tid;
      next = t < nvec ? __ldcs(body + t) : make_int4(0, 0, 0, 0);
      const int j0 = head + (b + tid) * kVec;
#pragma unroll
      for (int q = 0; q < kVec; ++q) {
        const int cnt = cell_at<CountT>(cur, q);
        // Lanes past the body hold zeros and queue nothing.
        warp_push(w, sel, cnt != 0, j0 + q, cnt, j0 + q, sc, top_k);
      }
    }
"""

TWO_VECTORS = """\
    int4 next[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int t = u * kThreads + tid;
      next[u] = t < nvec ? __ldcs(body + t) : make_int4(0, 0, 0, 0);
    }
    for (int b = 0; b < nvec; b += 2 * kThreads) {
      int4 cur[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        cur[u] = next[u];
        const int t = b + (2 + u) * kThreads + tid;
        next[u] = t < nvec ? __ldcs(body + t) : make_int4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j0 = head + (b + u * kThreads + tid) * kVec;
#pragma unroll
        for (int q = 0; q < kVec; ++q) {
          const int cnt = cell_at<CountT>(cur[u], q);
          warp_push(w, sel, cnt != 0, j0 + q, cnt, j0 + q, sc, top_k);
        }
      }
    }
"""

#: name -> [(file, old text, new text)]: one edit of the sources each.
VARIANTS = {
    "base": [],
    # Five rect blocks an SM (48 registers, a few bytes spilled) instead
    # of the four its registers allow.
    "rect_5_blocks": [("rect_topk.cu",
                       "__launch_bounds__(kThreads)\nrect_topk_kernel",
                       "__launch_bounds__(kThreads, 5)\nrect_topk_kernel")],
    # Each dense thread loads two int4 vectors a step instead of one.
    "score_two_vectors": [("score_topk.cu", ONE_VECTOR, TWO_VECTORS)],
}

#: Short-row limits of the rect launch plan tried on the base build (0:
#: every row a block; 4,096: every row of config 4 a warp).
SHORT_MAXES = (0, 128, 256, 512, 1024, 2048, 4096)


def _build_variant(name, edits):
    """Copy the sources, apply ``edits``, build both top-K libraries (two
    nvcc at once) and return name -> loaded library, printing ptxas's
    register, shared-memory and spill lines."""
    from tpu_cooccurrence_torch.ops import _build

    out_dir = os.path.join(_ROOT, "build", "variants", name)
    os.makedirs(out_dir, exist_ok=True)
    for f in os.listdir(_build.CSRC_DIR):
        with open(os.path.join(_build.CSRC_DIR, f)) as fh:
            src = fh.read()
        for fname, old, new in edits:
            if fname == f:
                if old not in src:
                    raise SystemExit(f"variant {name}: edit not found in {f}")
                src = src.replace(old, new)
        with open(os.path.join(out_dir, f), "w") as fh:
            fh.write(src)
    procs = []
    for lib in ("score_topk", "rect_topk"):
        target = os.path.join(out_dir, f"{lib}.so")
        procs.append((lib, target, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", target,
             os.path.join(out_dir, f"{lib}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for lib, target, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"variant {name}: nvcc failed for {lib}:\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name} {lib}: {line.strip()}", flush=True)
        handle = ctypes.CDLL(target)
        for fn, argtypes in _build.SIGNATURES[lib].items():
            getattr(handle, fn).argtypes = argtypes
            getattr(handle, fn).restype = (
                ctypes.c_char_p if fn.endswith("error_string")
                else ctypes.c_int)
        libs[lib] = handle
    return libs


def _shapes():
    """The dense main path's launch and config 4's largest rect launch,
    as the paths' own runs hand them to the wrappers."""
    import torch

    import chip_smoke as cs
    from tpu_cooccurrence_torch.state import sparse_scorer as ss

    users, items, ts = cs._bench_stream()
    job, _ = cs._run_job("cuda", "int32", users, items, ts,
                         num_items=20_000)
    sc = job.scorer
    touched = torch.nonzero(sc.row_sums).flatten().to(torch.int32)
    rows = touched[:sc.max_score_rows].contiguous()
    dense = (sc.C, sc.row_sums, rows, float(np.float32(sc.observed)),
             sc.top_k)
    largest = {"s": -1}
    launch = ss.rect_topk

    def recording(*args):
        if args[3].shape[0] > largest["s"]:
            largest.update(s=args[3].shape[0], args=tuple(
                a.clone() if torch.is_tensor(a) else a for a in args))
        return launch(*args)

    ss.rect_topk = recording
    try:
        cs._run_sparse_job("cuda", *cs._config4_stream())
    finally:
        ss.rect_topk = launch
    return dense, largest["args"]


def _exact(got, want) -> bool:
    gv, gi, wv, wi = (t.cpu().numpy() for t in (*got, *want))
    fin = np.isfinite(wv)
    return (np.array_equal(np.isfinite(gv), fin)
            and np.array_equal(gv[fin], wv[fin])
            and np.array_equal(gi[fin], wi[fin]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("tune_topk.py needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, _ROOT)
    import chip_smoke as cs
    from tpu_cooccurrence_torch.ops import _build
    from tpu_cooccurrence_torch.ops import rect_topk as rt
    from tpu_cooccurrence_torch.ops import score_topk as st

    print(cs._card_line(), flush=True)
    dense, rect = _shapes()
    lens = rect[5].cpu().numpy()
    print(f"dense launch: S={dense[2].shape[0]}, I={dense[0].shape[1]}, "
          f"{int((dense[0][dense[2].long()] != 0).sum())} nonzero cells; "
          f"rect launch: S={len(lens)}, {int(lens.sum())} cells, longest "
          f"{int(lens.max())}, {int((lens > 4096).sum())} rows over 4,096",
          flush=True)
    want_d = cs._reference_chunked(*dense)
    want_r = rt.rect_topk_reference(*rect[:8])
    libs = {name: _build_variant(name, edits)
            for name, edits in VARIANTS.items()}
    times = {name: {"dense": [], "rect": []} for name in VARIANTS}
    plans = {m: [] for m in SHORT_MAXES}
    for rnd in range(args.rounds):
        for name in VARIANTS:
            _build._loaded.update(libs[name])
            if not (_exact(st.score_topk(*dense), want_d)
                    and _exact(rt.rect_topk(*rect), want_r)):
                print(f"variant {name} is not exact", flush=True)
                return 1
            d = cs._time_ms(lambda: st.score_topk(*dense), 50)
            r = cs._time_ms(lambda: rt.rect_topk(*rect), 100)
            times[name]["dense"].append(d)
            times[name]["rect"].append(r)
            print(f"round {rnd + 1} {name}: score_topk {d:.4f} ms, "
                  f"rect_topk {r:.4f} ms", flush=True)
        _build._loaded.update(libs["base"])
        for m in SHORT_MAXES:
            plan_args = (*rect[:8], rt.short_rows(lens, m))
            if not _exact(rt.rect_topk(*plan_args), want_r):
                print(f"short_max {m} is not exact", flush=True)
                return 1
            plans[m].append(cs._time_ms(lambda: rt.rect_topk(*plan_args),
                                        100))
        print(f"round {rnd + 1} rect short_max: " + ", ".join(
            f"{m}: {plans[m][-1]:.4f} ms" for m in SHORT_MAXES), flush=True)
    print("medians over rounds (ms):", flush=True)
    for name, t in times.items():
        print(f"  {name}: score_topk {np.median(t['dense']):.4f} "
              f"({min(t['dense']):.4f}-{max(t['dense']):.4f}), rect_topk "
              f"{np.median(t['rect']):.4f} ({min(t['rect']):.4f}-"
              f"{max(t['rect']):.4f})", flush=True)
    for m in SHORT_MAXES:
        print(f"  rect short_max {m} ({rt.short_rows(lens, m)} short rows): "
              f"{np.median(plans[m]):.4f} ({min(plans[m]):.4f}-"
              f"{max(plans[m]):.4f})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
