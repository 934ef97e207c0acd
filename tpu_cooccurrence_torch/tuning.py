"""The typed tuning-parameter registry, trimmed to the port's slice.

Copy of ``tpu_cooccurrence/tuning.py`` holding only the knobs the port
reads: ``config.py`` takes its defaults and choices from here, so a knob
is declared once. The reference's environment-variable bindings are not
copied (the port reads no environment knobs yet).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class TuningParameter:
    """One declared knob."""

    name: str                 # canonical snake_case registry key
    type: str                 # "int" | "float" | "str" | "choice"
    default: object
    doc: str
    bounds: Optional[Tuple[Optional[float], Optional[float]]] = None
    choices: Optional[Tuple[str, ...]] = None
    unit: str = ""
    flag: Optional[str] = None


#: name -> parameter.
REGISTRY: Dict[str, TuningParameter] = {}


def _register(p: TuningParameter) -> TuningParameter:
    if p.name in REGISTRY:
        raise ValueError(f"duplicate tuning parameter {p.name!r}")
    REGISTRY[p.name] = p
    return p


def get(name: str) -> TuningParameter:
    return REGISTRY[name]


def default(name: str):
    return REGISTRY[name].default


_register(TuningParameter(
    name="count_dtype", type="choice", default="int32",
    choices=("int32", "int16"), flag="--count-dtype",
    doc="Dense C cell dtype; int16 halves device memory and doubles the "
        "dense vocab ceiling (reference-style wraparound)."))
_register(TuningParameter(
    name="pipeline_depth", type="int", default=0, bounds=(0, 2),
    unit="windows", flag="--pipeline-depth",
    doc="Sampled-but-unscored windows in flight: 0 runs each window's "
        "scorer stage on the caller thread; 1-2 run it on a worker thread "
        "while the caller samples the next windows (bit-identical "
        "output)."))
_register(TuningParameter(
    name="max_pairs_per_step", type="int", default=1 << 20,
    bounds=(1, None), unit="cells",
    doc="Folded cells scattered per update call (bounds the device "
        "index buffers of one window)."))
_register(TuningParameter(
    name="max_score_rows_per_call", type="int", default=8192,
    bounds=(1, None), unit="rows",
    doc="Cap on rows scored per kernel launch; the effective chunk also "
        "keeps the [S, I] plain-version working set near 1 GB."))
_register(TuningParameter(
    name="score_ladder", type="int", default=4, bounds=(2, None),
    unit="x per bucket", flag="--score-ladder",
    doc="Sparse score-bucket ladder base (power of two >= 2): the plain "
        "version scores each bucket as one [S, R] rectangle, and the "
        "bucket order is the order rows are emitted in."))
_register(TuningParameter(
    name="row_index", type="choice", default="bitmap",
    choices=("bitmap", "dense"),
    doc="Sparse row-registry layout: bitmap+rank directory "
        "(production) or dense reference arrays (A/B baseline)."))
