"""The fused bench run, this checkout against another, in alternating
processes on one card.

Each leg is a fresh process in one checkout (its own package, kernels
and ``chip_smoke.py``): it runs chip_smoke.py's phase-9 workload (the
bench stream, ``--fused-window on``, int32 counts, on cuda) once to warm
up and ``--runs`` times timed, then that checkout's phase 8 (the expand
kernel's cases, which run just before phase 9 in a whole chip_smoke.py
run and leave their allocations in the caching allocator), then
``--runs`` timed runs again. The legs go P, C, C, P, P, C, ... for
``--pairs`` pairs (P = ``--parent DIR``, C = this checkout), so a drift
of the host shows in both alike.

    python3 ab_fused.py --parent DIR [--pairs 6] [--runs 3]

Prints, per leg and run, wall seconds, pairs/s and the host stages
(``StepTimer``), then per part (before and after phase 8) and for each
of pairs/s, sampling and scorer seconds: each checkout's median and
range over all legs, whether this checkout's median lies outside the
other's range, and the two-sided Mann-Whitney U test's p between them.

Needs one CUDA card and ``nvcc``. Prints the card's name and power limit
first.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

_ROOT = os.path.dirname(os.path.abspath(__file__))
_TAG = "AB_RUN "


def _leg(root: str, runs: int) -> int:
    """One leg, in ``root``: prints one ``AB_RUN`` JSON line a run."""
    os.chdir(root)
    sys.path.insert(0, root)
    import chip_smoke as cs
    from tpu_cooccurrence_torch.metrics import OBSERVED_COOCCURRENCES
    from tpu_cooccurrence_torch.ops import _build

    _build.build_all()
    users, items, ts = cs._bench_stream()

    def fused(part, n):
        for i in range(n):
            job, elapsed = cs._run_job("cuda", "int32", users, items, ts,
                                       num_items=20_000, fused_window="on")
            pairs = job.counters.get(OBSERVED_COOCCURRENCES)
            stages = job.step_timer.summary()
            if part is not None:
                print(_TAG + json.dumps(dict(
                    part=part, run=i, wall_s=elapsed, pairs=pairs,
                    pairs_per_s=pairs / elapsed,
                    sample_s=stages["sample_seconds"],
                    score_s=stages["score_seconds"])), flush=True)
            del job

    fused(None, 1)
    fused("before_phase8", runs)
    cs.phase_expand_kernel(cs.ExpandParity())
    fused("after_phase8", runs)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="the other checkout (P)")
    ap.add_argument("--pairs", type=int, default=6)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--leg", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.leg:
        return _leg(args.leg, args.runs)
    if not args.parent:
        ap.error("--parent DIR is required")
    sys.path.insert(0, _ROOT)
    import chip_smoke as cs

    print(cs._card_line(), flush=True)
    roots = {"P": os.path.abspath(args.parent), "C": _ROOT}
    order = [("P", "C") if i % 2 == 0 else ("C", "P")
             for i in range(args.pairs)]
    runs: dict = {}
    for pair, legs in enumerate(order):
        for side in legs:
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--leg",
                 roots[side], "--runs", str(args.runs)],
                capture_output=True, text=True)
            if out.returncode != 0:
                print(out.stdout[-4000:], out.stderr[-4000:], flush=True)
                print(f"leg {side} of pair {pair + 1} failed "
                      f"(rc {out.returncode})", flush=True)
                return 1
            for line in out.stdout.splitlines():
                if not line.startswith(_TAG):
                    continue
                r = json.loads(line[len(_TAG):])
                runs.setdefault((side, r["part"]), []).append(r)
                print(f"pair {pair + 1} {side} {r['part']} run {r['run']}: "
                      f"{r['wall_s']:.4f} s, {r['pairs_per_s']:.1f} pairs/s, "
                      f"sampling {r['sample_s']:.4f} s, scorer "
                      f"{r['score_s']:.4f} s", flush=True)
    from scipy.stats import mannwhitneyu

    for part in ("before_phase8", "after_phase8"):
        for key, unit in (("pairs_per_s", "pairs/s"), ("sample_s", "s"),
                          ("score_s", "s")):
            p, c = ([r[key] for r in runs[(side, part)]] for side in "PC")
            for side, r in (("P", p), ("C", c)):
                print(f"{part} {key} {side}: median {np.median(r):.4f} "
                      f"{unit}, range {min(r):.4f}-{max(r):.4f} over "
                      f"{len(r)} runs", flush=True)
            outside = not min(p) <= np.median(c) <= max(p)
            print(f"{part} {key}: C's median "
                  f"{'outside' if outside else 'inside'} P's range; C/P "
                  f"medians {np.median(c) / np.median(p):.4f}; Mann-Whitney "
                  f"p {mannwhitneyu(p, c).pvalue:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
