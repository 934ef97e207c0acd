"""Run configuration (port of ``tpu_cooccurrence/config.py``).

The port parses every flag name of the reference package's CLI, with the
same defaults, so an existing command line carries over. The flags whose
feature is ported hold fields of :class:`Config`; every other flag is
still parsed, and a value the port does not carry (anything but its
default, or a value of :data:`_PORTED_VALUES`) raises :class:`NotPorted`
(the CLI exits 78, ``EX_CONFIG``) naming the flag: nothing is silently
ignored.

Three backends are ported: ``device`` (the dense ``C``, with its fused
window, ``--fused-window``), ``sparse`` (the slab; ``hybrid`` is its
retired alias) and ``sharded`` (the dense ``C`` row-sharded over
``--num-shards`` devices of one process), each with the pipelined window
loop (``--pipeline-depth``) and full checkpoints (``--checkpoint-dir``).
The port adds ``--device cuda|cpu`` (default ``cuda``).
"""

from __future__ import annotations

import argparse
import dataclasses
import enum
import sys
import time
from typing import Optional, Sequence

from . import tuning
from .ops.rect_topk import ladder_bits
from .ops.score_topk import MAX_TOP_K
from .state.wire import resolve_cell_dtype, resolve_wire_format


class NotPorted(ValueError):
    """A flag whose feature the port does not carry yet."""


class WindowUnit(enum.Enum):
    """Time unit for window sizes (reference: ``Configuration.java:157-179``)."""

    MILLISECONDS = 1
    SECONDS = 1_000
    MINUTES = 60_000
    HOURS = 3_600_000
    DAYS = 86_400_000

    @property
    def millis(self) -> int:
        return self.value

    @classmethod
    def parse(cls, s: str) -> "WindowUnit":
        try:
            return cls[s.upper()]
        except KeyError:
            raise ValueError(f"Unrecognized window unit {s}") from None


def _parse_seed(value: str) -> int:
    """Parse a decimal or ``0x``-prefixed hex seed (``Configuration.java:211-220``)."""
    if value.startswith("0x") or value.startswith("0X"):
        return int(value[2:], 16)
    return int(value)


@dataclasses.dataclass
class Config:
    """Configuration of a co-occurrence run on a ported backend."""

    input: Optional[str] = None
    skip_cuts: bool = False
    item_cut: int = 500
    user_cut: int = 500
    top_k: int = 10
    window_size: int = 0
    window_unit: WindowUnit = WindowUnit.MILLISECONDS
    seed: Optional[int] = None
    buffer_timeout: int = 100  # ms a parsed line may wait in a partial
    # batch when tailing continuously (FlinkCooccurrences.java:46)
    num_items: int = 0  # dense vocab capacity; 0 = derive from the data
    max_pairs_per_step: int = tuning.default("max_pairs_per_step")
    count_dtype: str = tuning.default("count_dtype")
    development_mode: bool = False
    emit_updates: bool = False
    process_continuously: bool = False
    device: str = "cuda"  # the card unless the caller asks for the CPU
    backend: str = "device"  # device | sparse | hybrid (alias) | sharded
    num_shards: int = 1  # item-axis shards of --backend sharded
    score_ladder: Optional[int] = None  # sparse bucket ladder; None = 4
    cell_dtype: str = "auto"  # sparse slab cells; auto = int16 on sparse
    wire_format: str = "auto"  # sparse uplink; auto = packed on sparse
    fused_window: str = "off"  # dense fused window; auto = on on cuda
    # Sampled-but-unscored windows in flight (0 = serial; pipeline.py).
    pipeline_depth: int = tuning.default("pipeline_depth")
    checkpoint_dir: Optional[str] = None
    checkpoint_every_windows: int = 0  # 0 = no periodic checkpoints
    checkpoint_retain: int = 3  # generation-numbered checkpoints kept

    def __post_init__(self):
        if self.seed is None:
            self.seed = time.time_ns()  # reference: System.nanoTime()
        if self.top_k <= 0:
            raise ValueError(f"{self.top_k} is <= 0")
        if self.count_dtype not in tuning.get("count_dtype").choices:
            raise ValueError(f"--count-dtype must be int32|int16, got "
                             f"{self.count_dtype!r}")
        if self.device not in ("cuda", "cpu"):
            raise ValueError(f"--device must be cuda|cpu, got "
                             f"{self.device!r}")
        for flag, value in (("--backend", self.backend),
                            ("--cell-dtype", self.cell_dtype),
                            ("--wire-format", self.wire_format)):
            dest = flag.lstrip("-").replace("-", "_")
            if value not in _PORTED_VALUES[dest]:
                raise NotPorted(f"{flag}={value} is not yet ported to "
                                f"tpu_cooccurrence_torch")
        if self.cell_dtype in ("int16", "int8") and not self.sparse:
            # 'auto' resolves to int32 off the sparse backend; an explicit
            # narrow request there must fail loudly.
            raise ValueError(
                f"--cell-dtype {self.cell_dtype} is --backend sparse "
                f"without --coordinator only (multi-controller "
                f"per-process snapshots carry no wide side-table "
                f"blocks)")
        if self.wire_format == "packed" and not self.sparse:
            raise ValueError(
                "--wire-format packed applies to the sparse backend's "
                "update uplink (other backends ship raw COO or basket "
                "formats)")
        if self.fused_window not in ("auto", "on", "off"):
            raise ValueError(f"--fused-window must be auto|on|off, got "
                             f"{self.fused_window!r}")
        if self.num_shards < 1:
            raise ValueError(
                f"--num-shards must be >= 1, got {self.num_shards}")
        if self.sparse and self.num_shards > 1:
            raise NotPorted(
                f"--backend {self.backend} with --num-shards "
                f"{self.num_shards} (the sharded sparse backend) is not "
                f"yet ported to tpu_cooccurrence_torch")
        if self.fused_window == "on" and self.sparse:
            # The sparse fused window consumes folded deltas, not baskets.
            raise NotPorted("--fused-window on with --backend sparse is "
                            "not yet ported to tpu_cooccurrence_torch")
        if self.fused_window == "on" and self.backend == "sharded":
            raise ValueError(
                f"--fused-window on is --backend device or sparse only "
                f"(got {self.backend}); other backends stay on the "
                f"chained path")
        if self.pipeline_depth not in (0, 1, 2):
            raise ValueError(
                f"--pipeline-depth must be 0, 1 or 2, got "
                f"{self.pipeline_depth}")
        if self.checkpoint_retain < 1:
            raise ValueError(
                f"--checkpoint-retain must be >= 1, got "
                f"{self.checkpoint_retain}")
        if self.score_ladder is not None:
            ladder_bits(self.score_ladder)
        if self.device == "cuda" and self.top_k > MAX_TOP_K:
            raise NotPorted(
                f"--top-k {self.top_k} > {MAX_TOP_K} is not yet ported to "
                f"the CUDA kernel (run with --device cpu, or K <= "
                f"{MAX_TOP_K})")

    @property
    def sparse(self) -> bool:
        """The sparse slab backend (``hybrid`` is its retired alias)."""
        return self.backend in ("sparse", "hybrid")

    @property
    def resolved_cell_dtype(self) -> str:
        """``--cell-dtype`` as the JAX package resolves it: ``auto`` is
        int16 on the (single-process) sparse backend, int32 elsewhere."""
        return resolve_cell_dtype(self.cell_dtype, self.sparse)

    @property
    def resolved_wire_format(self) -> str:
        """``--wire-format``: ``auto`` is packed on the sparse backend."""
        return resolve_wire_format(self.wire_format, self.sparse)

    @property
    def window_millis(self) -> int:
        return self.window_size * self.window_unit.millis

    def log_configuration(self, logger) -> None:
        """Echo the config at startup (reference: ``Configuration.java:272-282``)."""
        logger.info("input\t%s", self.input)
        logger.info("skip cuts\t%s", self.skip_cuts)
        logger.info("item cut (fMax)\t%s", self.item_cut)
        logger.info("user cut (kMax)\t%s", self.user_cut)
        logger.info("topK\t%s", self.top_k)
        logger.info("windowSize\t%s", self.window_size)
        logger.info("windowUnit\t%s", self.window_unit.name)
        logger.info("seed\t%s", self.seed)
        logger.info("buffer timeout\t%s", self.buffer_timeout)
        logger.info("backend\t%s", self.backend)
        if self.sparse:
            logger.info("cellDtype\t%s (--cell-dtype %s)",
                        self.resolved_cell_dtype, self.cell_dtype)
            logger.info("wireFormat\t%s (--wire-format %s)",
                        self.resolved_wire_format, self.wire_format)
            logger.info("scoreLadder\t%s", self.score_ladder
                        or tuning.default("score_ladder"))
        else:
            logger.info("fusedWindow\t%s", self.fused_window)
        logger.info("numItems\t%s", self.num_items)
        logger.info("numShards\t%s", self.num_shards)
        logger.info("device\t%s", self.device)

    @classmethod
    def from_args(cls, argv: Optional[Sequence[str]] = None) -> "Config":
        """Parse the reference package's flags plus ``--device``; raises
        :class:`NotPorted` for a flag of a feature not ported yet."""
        p = argparse.ArgumentParser(
            prog="tpu-cooccurrence-torch",
            description="Streaming item-item co-occurrence (LLR) on a CUDA "
                        "card, PyTorch port of tpu-cooccurrence",
            allow_abbrev=False)
        p.add_argument("-i", "--input", required=True,
                       help="Input file/directory to consume (expected "
                            "format 'user,item,timestamp')")
        p.add_argument("-sc", "--skip-cuts", action="store_true",
                       dest="skip_cuts", help="Skip the interaction cuts")
        p.add_argument("-ic", "--item-cut", type=int, default=500,
                       dest="item_cut",
                       help="Item interaction cut (default: 500)")
        p.add_argument("-uc", "--user-cut", type=int, default=500,
                       dest="user_cut",
                       help="User interaction cut (default: 500)")
        p.add_argument("-k", "--top-k", type=int, default=10, dest="top_k",
                       help="Top K (default: 10)")
        p.add_argument("-ws", "--window-size", type=int, required=True,
                       dest="window_size", help="Window size")
        p.add_argument("-wu", "--window-unit", type=WindowUnit.parse,
                       default=WindowUnit.MILLISECONDS, dest="window_unit",
                       help="TimeUnit for the window (default: milliseconds)")
        p.add_argument("-s", "--seed", type=_parse_seed, default=None,
                       help="Seed for random number generator (decimal or "
                            "0x-hex)")
        p.add_argument("-bt", "--buffer-timeout", type=int, default=100,
                       dest="buffer_timeout",
                       help="Buffer timeout (default: 100ms)")
        p.add_argument("--num-items", type=int, default=0, dest="num_items",
                       help="Dense item-vocabulary capacity on the device "
                            "(0 = derive from data)")
        p.add_argument("--num-shards", type=int, default=1,
                       dest="num_shards",
                       help="Item-axis shards of --backend sharded, one "
                            "device each (default: 1)")
        p.add_argument("--count-dtype",
                       choices=list(tuning.get("count_dtype").choices),
                       default=tuning.default("count_dtype"),
                       dest="count_dtype",
                       help="Dense count-matrix cell dtype (int16 halves "
                            "device memory; counts then wrap like the "
                            "reference's Java shorts)")
        p.add_argument("--emit-updates", action="store_true",
                       dest="emit_updates",
                       help="Stream each window's updated top-K rows to "
                            "stdout (instead of one final dump)")
        p.add_argument("--development-mode", action="store_true",
                       dest="development_mode")
        p.add_argument("--process-continuously", action="store_true",
                       dest="process_continuously")
        p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                       help="Where C, the row sums and the scoring run "
                            "(default: cuda; cpu runs the plain PyTorch "
                            "versions of the kernels)")
        p.add_argument("--score-ladder", type=int, default=None,
                       dest="score_ladder",
                       help="Sparse score-bucket ladder base (power of two "
                            ">= 2; default 4): the plain version's "
                            "rectangle widths and the order rows are "
                            "emitted in")
        p.add_argument("--pipeline-depth", type=int, choices=[0, 1, 2],
                       default=tuning.default("pipeline_depth"),
                       dest="pipeline_depth",
                       help="Overlap host sampling with the scorer stage: "
                            "sample window N+1 while a worker thread "
                            "scores window N (0 = serial, 2 = double-"
                            "buffered; output is bit-identical at every "
                            "depth)")
        p.add_argument("--checkpoint-dir", default=None,
                       dest="checkpoint_dir",
                       help="Restore from the newest checkpoint here at "
                            "start, if there is one, and write "
                            "checkpoints here")
        p.add_argument("--checkpoint-every-windows", type=int, default=0,
                       dest="checkpoint_every_windows",
                       help="Checkpoint every N fired windows (0 = never)")
        p.add_argument("--checkpoint-retain", type=int, default=3,
                       dest="checkpoint_retain",
                       help="Generation-numbered checkpoints to keep "
                            "(restore falls back to the newest one that "
                            "verifies; default: 3)")
        for flags, kw in _NOT_PORTED_FLAGS:
            ported = _PORTED_VALUES.get(kw["dest"])
            p.add_argument(*flags, **kw, help=(
                "not yet ported" if ported is None else
                "ported values: " + ", ".join(ported)))
        raw = list(argv) if argv is not None else sys.argv[1:]
        if any(a == "--sample-workers" or a.startswith("--sample-workers=")
               for a in raw):
            raise ValueError(
                "--sample-workers is retired: use --partition-sampling for "
                "multi-process ingest scale-out")
        ns = vars(p.parse_args(argv))
        fields = {f.name for f in dataclasses.fields(cls)}
        for flags, kw in _NOT_PORTED_FLAGS:
            dest = kw["dest"]
            value = ns.pop(dest)
            if dest in fields:
                ns[dest] = value  # Config.__post_init__ checks it
            elif value not in _PORTED_VALUES.get(dest,
                                                 (kw.get("default"),)):
                raise NotPorted(f"{flags[0]}={value} is not yet ported to "
                                f"tpu_cooccurrence_torch")
        return cls(**ns)


def _flag(name: str, **kw):
    """One not-yet-ported flag: argparse kwargs with an explicit dest."""
    kw["dest"] = name.lstrip("-").replace("-", "_")
    return (name,), kw


_STR = dict(default=None)
_INT0 = dict(type=int, default=0)
_FLAG = dict(action="store_true", default=False)

#: Every flag of the reference package's CLI whose feature the port does
#: not carry yet, in full or in part, with the reference's type and
#: default.
_NOT_PORTED_FLAGS = (
    _flag("--source-format", choices=("files", "partitioned"),
          default="files"),
    _flag("--ingest-partitions", **_INT0),
    _flag("--backend", default="device",
          choices=("oracle", "device", "sharded", "hybrid", "sparse")),
    _flag("--window-slide", type=int, default=None),
    _flag("--profile-dir", **_STR),
    _flag("--journal", **_STR),
    _flag("--metrics-port", type=int, default=None),
    _flag("--healthz-stale-after-s", type=float, default=300.0),
    _flag("--serve-port", type=int, default=None),
    _flag("--serve-history", type=int, default=50),
    _flag("--serve-stale-after-s", type=float, default=0.0),
    _flag("--serve-query-slo-s", type=float, default=0.25),
    _flag("--pallas", choices=("auto", "on", "off"), default="auto"),
    _flag("--fused-window", choices=("auto", "on", "off"), default="off"),
    _flag("--cell-dtype", choices=("auto", "int32", "int16", "int8"),
          default="auto"),
    _flag("--spill-threshold-windows", **_INT0),
    _flag("--spill-target-hbm-frac", type=float, default=0.5),
    _flag("--wire-format", choices=("auto", "raw", "packed"),
          default="auto"),
    _flag("--fixed-score", choices=("auto", "on", "off"), default="auto"),
    _flag("--checkpoint-incremental", **_FLAG),
    _flag("--checkpoint-compact-ratio", type=float, default=0.5),
    _flag("--restart-on-failure", **_INT0),
    _flag("--restart-delay-ms", type=int, default=1000),
    _flag("--restart-backoff-base-ms", **_INT0),
    _flag("--restart-backoff-max-ms", type=int, default=30000),
    _flag("--crash-loop-threshold", type=int, default=3),
    _flag("--crash-loop-window-s", type=float, default=60.0),
    _flag("--watchdog-stale-after-s", type=float, default=0.0),
    _flag("--degrade", **_FLAG),
    _flag("--degrade-window-wall-s", type=float, default=1.0),
    _flag("--degrade-trip-windows", type=int, default=3),
    _flag("--degrade-clear-windows", type=int, default=8),
    _flag("--degrade-shed-factor", type=int, default=2),
    _flag("--degrade-pause-ms", type=int, default=200),
    _flag("--degrade-stale-after-s", type=float, default=30.0),
    _flag("--gang-workers", **_INT0),
    _flag("--gang-heartbeat-s", type=float, default=5.0),
    _flag("--autoscale", choices=("off", "on"), default="off"),
    _flag("--autoscale-min-workers", type=int, default=2),
    _flag("--autoscale-max-workers", **_INT0),
    _flag("--autoscale-trip-windows", type=int, default=3),
    _flag("--autoscale-clear-windows", type=int, default=8),
    _flag("--autoscale-cooldown-windows", type=int, default=8),
    _flag("--gang-stale-after-s", type=float, default=60.0),
    _flag("--collective-timeout-s", type=float, default=0.0),
    _flag("--quarantine-file", **_STR),
    _flag("--max-quarantine-rate", type=float, default=0.01),
    _flag("--max-quarantine-bytes", **_INT0),
    _flag("--scorer-breaker-threshold", **_INT0),
    _flag("--scorer-breaker-probe-windows", type=int, default=8),
    _flag("--inject-fault", action="append", default=None),
    _flag("--fault-state-dir", **_STR),
    _flag("--partition-sampling", **_FLAG),
    _flag("--coordinator", **_STR),
    _flag("--num-processes", type=int, default=None),
    _flag("--process-id", type=int, default=None),
    _flag("--run-id", **_STR),
)

#: Values of those flags that the port carries (their default otherwise);
#: a flag that names a :class:`Config` field keeps its value there. The
#: kernels always run on the card (``--pallas on``); ``--fused-window``
#: is the dense backend's (the sparse one runs chained under ``auto``);
#: the sparse slab takes every cell dtype and wire format and scores
#: variable shapes (eager PyTorch compiles nothing per shape, so
#: ``--fixed-score`` has nothing to fix).
_PORTED_VALUES = {
    "backend": ("device", "sparse", "hybrid", "sharded"),
    "pallas": ("auto", "on"),
    "fused_window": ("auto", "on", "off"),
    "cell_dtype": ("auto", "int32", "int16", "int8"),
    "wire_format": ("auto", "raw", "packed"),
    "fixed_score": ("auto", "off"),
}
