"""The port's CLI (``python -m tpu_cooccurrence_torch.cli --device cpu``)
against the JAX package's CLI on the checked-in MovieLens fixture slices.

The fixtures (``u.data``, ``ratings.csv``) go through the JAX package's
dataset loader into the ``user,item,timestamp`` lines both CLIs read.

- Against ``--backend device``: stdout must be byte-identical on the
  fixtures. Both sides score in float32 with the same operation order and
  render 4 decimals; ties order by the lowest column on both. The port's
  ``--fused-window on`` must equal its chained run and the JAX
  ``--backend device`` with the fused window on or off, byte for byte.
- ``--backend sparse`` against the JAX package's ``--backend sparse``,
  both at their defaults (int16 cells with promotion, the packed uplink):
  stdout byte-identical on the fixtures, with and without
  ``--emit-updates``; ties order by the earliest slab slot on both.
- On a Zipf stream (10,000 events, 2,550 emitted rows) both backends,
  and the sparse one at ``--cell-dtype int8``, are byte-identical only
  within ``topk_parity``: torch and XLA round ``log1p`` differently, so
  about 1% of the lines differ by one unit in the 4th decimal. That test
  holds every emitted line to the JAX line in the same place: same item,
  scores allclose, untied ids equal.
- Against ``--backend oracle`` (float64): the comparator of
  ``tests/test_pipeline.py`` (``assert_latest_close``): scores to
  ``rtol=1e-4, atol=1e-3``, ids exact where every in-row gap exceeds
  ``1e-2``; and the three cross-backend counters identical.

Also pinned: a full port run loads neither ``jax`` nor any module of the
JAX package; no file of the port (nor ``chip_smoke.py``) imports them;
not-yet-ported flags exit 78; ``--device cuda`` without a card exits
nonzero with a clear message.
"""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpu_cooccurrence import cli as jax_cli
from tpu_cooccurrence.config import Backend, Config as JaxConfig
from tpu_cooccurrence.io.synthetic import (movielens_interactions,
                                           zipfian_interactions)
from tpu_cooccurrence.job import CooccurrenceJob as JaxJob
from tpu_cooccurrence.metrics import (OBSERVED_COOCCURRENCES,
                                      RESCORED_ITEMS, ROW_SUM_PROCESS_WINDOW)
from tpu_cooccurrence_torch import cli as port_cli
from tpu_cooccurrence_torch.config import Config as PortConfig
from tpu_cooccurrence_torch.job import CooccurrenceJob as PortJob
from tpu_cooccurrence_torch.ops.score_topk import topk_parity

from test_torch_checkpoint import tie_aware_mismatches

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")
PORT_DIR = os.path.join(REPO, "tpu_cooccurrence_torch")

# (fixture, extra CLI args): whole-history windows, with and without
# tight cuts (so the item cut, the reservoir and its feedback all engage).
RUNS = [
    ("u.data", ["-ws", "1000000000"]),
    ("ratings.csv", ["-ws", "1000000000"]),
    ("ratings.csv", ["-ws", "1", "-wu", "DAYS", "-ic", "4", "-uc", "3"]),
    ("ratings.csv", ["-ws", "100000000000", "--count-dtype", "int16",
                     "-k", "5"]),
]


def _fixture_csv(tmp_path, name):
    (users, items, ts), = movielens_interactions(os.path.join(FIXTURES,
                                                              name))
    path = tmp_path / f"{name}.csv"
    with open(path, "w") as f:
        for u, i, t in zip(users.tolist(), items.tolist(), ts.tolist()):
            f.write(f"{u},{i},{t}\n")
    return str(path), (users, items, ts)


def _run(capsys, main, argv):
    capsys.readouterr()
    rc = main(argv)
    assert rc == 0
    return capsys.readouterr().out


def _parse(out):
    """stdout rows -> {item: [(other, score), ...]}."""
    rows = {}
    for line in out.splitlines():
        if not line:
            continue
        item, _, rest = line.partition("\t")
        rows[int(item)] = [(int(o), float(s)) for o, s in
                           (tok.split(":") for tok in rest.split())]
    return rows


def _assert_latest_close(a, b, rtol=1e-4, atol=1e-3, gap=1e-2):
    """``tests/test_pipeline.py``'s f32-vs-f64 comparator."""
    assert set(a) == set(b)
    for item in a:
        o, p = a[item], b[item]
        assert len(o) == len(p), f"row {item}: {o} vs {p}"
        o_scores = np.array([s for _, s in o])
        np.testing.assert_allclose([s for _, s in p], o_scores, rtol=rtol,
                                   atol=atol)
        if len(o_scores) > 1 and np.min(np.abs(np.diff(o_scores))) > gap:
            assert [j for j, _ in o][:-1] == [j for j, _ in p][:-1], item


@pytest.mark.parametrize("fixture,args", RUNS)
def test_cli_matches_jax_device_and_oracle(capsys, tmp_path, fixture, args):
    path, _ = _fixture_csv(tmp_path, fixture)
    base = ["-i", path, "-s", "0xC0FFEE", *args]
    port = _run(capsys, port_cli.main, base + ["--device", "cpu"])
    device = _run(capsys, jax_cli.main, base + ["--backend", "device"])
    oracle = _run(capsys, jax_cli.main, base + ["--backend", "oracle"])
    assert port.strip(), "the fixture produced no rows"
    assert port == device
    _assert_latest_close(_parse(oracle), _parse(port))


FUSED_RUNS = [
    ("u.data", ["-ws", "1000000000"]),
    ("u.data", ["-ws", "1000000000", "--count-dtype", "int16", "-k", "5"]),
    ("ratings.csv", ["-ws", "1000000000"]),
    ("ratings.csv", ["-ws", "100000000000", "--count-dtype", "int16",
                     "-k", "5"]),
    ("ratings.csv", ["-ws", "1", "-wu", "DAYS", "-ic", "4", "-uc", "3"]),
]


@pytest.mark.parametrize("fixture,args", FUSED_RUNS)
def test_cli_fused_window_matches_chained_and_jax_device(capsys, tmp_path,
                                                         fixture, args):
    path, _ = _fixture_csv(tmp_path, fixture)
    base = ["-i", path, "-s", "0xC0FFEE", *args]
    fused = _run(capsys, port_cli.main,
                 base + ["--device", "cpu", "--fused-window", "on"])
    chained = _run(capsys, port_cli.main, base + ["--device", "cpu"])
    device = _run(capsys, jax_cli.main, base + ["--backend", "device"])
    jax_fused = _run(capsys, jax_cli.main,
                     base + ["--backend", "device", "--fused-window", "on"])
    assert fused.strip(), "the fixture produced no rows"
    assert fused == chained == device == jax_fused


@pytest.mark.parametrize("fixture", ["u.data", "ratings.csv"])
@pytest.mark.parametrize("cuts", [(500, 500), (4, 3)])
def test_cross_backend_counters_match_oracle(tmp_path, fixture, cuts):
    _, (users, items, ts) = _fixture_csv(tmp_path, fixture)
    kw = dict(window_size=86_400_000, seed=0xC0FFEE, item_cut=cuts[0],
              user_cut=cuts[1])
    port = PortJob(PortConfig(**kw, device="cpu"))
    oracle = JaxJob(JaxConfig(**kw, backend=Backend.ORACLE))
    for job in (port, oracle):
        job.add_batch(users, items, ts)
        job.finish()
    assert port.counters.get(OBSERVED_COOCCURRENCES) > 0
    for name in (OBSERVED_COOCCURRENCES, ROW_SUM_PROCESS_WINDOW,
                 RESCORED_ITEMS):
        assert port.counters.get(name) == oracle.counters.get(name), name


def test_port_run_loads_no_jax(tmp_path):
    """A full CLI run in a fresh interpreter leaves neither jax nor any
    module of the JAX package in sys.modules."""
    path, _ = _fixture_csv(tmp_path, "ratings.csv")
    code = (
        "import json, sys\n"
        "from tpu_cooccurrence_torch import cli\n"
        f"argv = ['-i', {path!r}, '-ws', '1000000000', '-s', '0xC0FFEE', "
        "'--device', 'cpu']\n"
        "rc = (cli.main(argv) or cli.main(argv + ['--backend', 'sparse'])\n"
        "      or cli.main(argv + ['--fused-window', 'on'])\n"
        "      or cli.main(argv + ['--backend', 'sharded', '--num-shards', "
        "'2']))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'tpu_cooccurrence'))\n"
        "print(json.dumps({'rc': rc, 'bad': bad}))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    lines = res.stdout.strip().splitlines()
    assert len(lines) > 1, "the run printed no rows"
    assert json.loads(lines[-1]) == {"rc": 0, "bad": []}


def _port_sources():
    for root, _, files in os.walk(PORT_DIR):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(root, name)
    yield os.path.join(REPO, "chip_smoke.py")


@pytest.mark.parametrize("path", sorted(_port_sources()),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_port_sources_import_no_jax(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "tpu_cooccurrence"), (
                f"{os.path.relpath(path, REPO)}:{node.lineno} imports "
                f"{name}")


@pytest.mark.parametrize("flag", [
    ["--backend", "sparse", "--num-shards", "2"],
    ["--backend", "oracle"],
    ["--pallas", "off"],
    ["--checkpoint-incremental"],
    ["--restart-on-failure", "1"],
    ["--serve-port", "8080"],
    ["--metrics-port", "9090"],
    ["--journal", "j.jsonl"],
    ["--gang-workers", "2"],
    ["--degrade"],
    ["--autoscale", "on"],
    ["--window-slide", "5"],
    ["-k", "129"],
    ["--profile-dir", "d"],
    ["--quarantine-file", "q"],
    ["--fixed-score", "on", "--backend", "sparse"],
    ["--spill-threshold-windows", "3", "--backend", "sparse"],
    ["--fused-window", "on", "--backend", "sparse"],
])
def test_not_yet_ported_flag_exits_78(caplog, tmp_path, flag):
    path, _ = _fixture_csv(tmp_path, "u.data")
    rc = port_cli.main(["-i", path, "-ws", "100", *flag])
    assert rc == 78
    msg = "\n".join(r.getMessage() for r in caplog.records)
    assert "not yet ported" in msg
    assert flag[0] in msg or "--top-k" in msg


def test_cuda_without_a_card_exits_with_a_clear_error(caplog, tmp_path,
                                                     monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path, _ = _fixture_csv(tmp_path, "u.data")
    rc = port_cli.main(["-i", path, "-ws", "100", "--device", "cuda"])
    assert rc == port_cli.EX_UNAVAILABLE != 0
    msg = "\n".join(r.getMessage() for r in caplog.records)
    assert "no CUDA device" in msg and "--device cpu" in msg


def _zipf_csv(tmp_path):
    """A small Zipf stream as CSV: 6,000 events over 30 windows of 10 ms."""
    users, items, ts = zipfian_interactions(
        n_events=6_000, n_items=400, n_users=150, alpha=1.1, seed=5,
        events_per_ms=20)
    path = tmp_path / "zipf_small.csv"
    with open(path, "w") as f:
        for u, i, t in zip(users.tolist(), items.tolist(), ts.tolist()):
            f.write(f"{u},{i},{t}\n")
    return str(path)


@pytest.mark.parametrize("path_args", [
    [], ["--fused-window", "on"], ["--backend", "sparse"]],
    ids=["chained", "fused", "sparse"])
def test_cli_pipelined_stdout_equals_serial(capsys, tmp_path, path_args):
    """``--pipeline-depth 1|2 --emit-updates``: the stream comes from the
    scorer worker and equals depth 0's byte for byte (cuts tight enough
    for replacements and feedback)."""
    base = ["-i", _zipf_csv(tmp_path), "-s", "0xC0FFEE", "-ws", "10",
            "-ic", "60", "-uc", "4", "--device", "cpu", "--emit-updates",
            *path_args]
    serial = _run(capsys, port_cli.main, base)
    assert len(serial.splitlines()) > 100
    for depth in ("1", "2"):
        assert _run(capsys, port_cli.main,
                    base + ["--pipeline-depth", depth]) == serial


def _last_row_per_item(out):
    rows = {}
    for line in out.splitlines():
        item, _, rest = line.partition("\t")
        rows[item] = rest
    return rows


def _assert_same_lines(got, want, ties_may_swap):
    """Same items in the same order with the same rendered scores; ids
    equal, or on the sparse path equal wherever the score is untied (its
    restore lays each row's cells out in key order, and the top-K keeps
    the earliest slot among equal scores)."""
    if not ties_may_swap:
        assert got == want
        return
    g_items, g_vals, g_ids = _emitted_lines(got, 10)
    w_items, w_vals, w_ids = _emitted_lines(want, 10)
    assert g_items == w_items
    np.testing.assert_array_equal(g_vals, w_vals)
    assert tie_aware_mismatches(g_vals, g_ids, w_vals, w_ids, 0.0, 0.0) == 0


@pytest.mark.parametrize("path_args", [[], ["--backend", "sparse"]],
                         ids=["dense", "sparse"])
def test_cli_second_run_resumes_and_replays(capsys, tmp_path, path_args):
    """A second run on the same ``--checkpoint-dir`` restores the newest
    generation (windows still buffered in it fire again, the consumed
    input is not re-read): without --emit-updates it prints what the
    first run printed; with it, it first replays the restored rows, and
    every item's last line equals the first run's."""
    path = _zipf_csv(tmp_path)
    sparse = bool(path_args)
    for emit in ([], ["--emit-updates"]):
        ck = tmp_path / f"ck{len(emit)}"
        args = ["-i", path, "-s", "0xC0FFEE", "-ws", "10", "-ic", "60",
                "-uc", "4", "--device", "cpu", *path_args,
                *emit, "--pipeline-depth", "2", "--checkpoint-dir", str(ck),
                "--checkpoint-every-windows", "7"]
        first = _run(capsys, port_cli.main, args)
        newest = max(ck.glob("state.*.npz"),
                     key=lambda p: int(p.name.split(".")[1]))
        with np.load(newest) as f:
            restored = f["latest_items"].tolist()
            fired = json.loads(bytes(f["meta_json"]))["windows_fired"]
        assert restored and fired % 7 == 0
        second = _run(capsys, port_cli.main, args)
        if not emit:
            _assert_same_lines(second, first, sparse)
            continue
        lines = second.splitlines()
        assert [int(ln.partition("\t")[0])
                for ln in lines[:len(restored)]] == restored
        last = [_last_row_per_item(out) for out in (second, first)]
        assert last[0].keys() == last[1].keys()
        _assert_same_lines(
            *("\n".join(f"{k}\t{v}" for k, v in sorted(rows.items()))
              for rows in last), sparse)


SPARSE_RUNS = [
    ("u.data", ["-ws", "1000000000"]),
    ("ratings.csv", ["-ws", "1000000000"]),
    ("ratings.csv", ["-ws", "1", "-wu", "DAYS", "-ic", "4", "-uc", "3"]),
]


@pytest.mark.parametrize("emit", [False, True])
@pytest.mark.parametrize("fixture,args", SPARSE_RUNS)
def test_cli_sparse_matches_jax_sparse_and_oracle(capsys, tmp_path, fixture,
                                                  args, emit):
    path, _ = _fixture_csv(tmp_path, fixture)
    base = ["-i", path, "-s", "0xC0FFEE", *args]
    base += ["--emit-updates"] if emit else []
    port = _run(capsys, port_cli.main,
                base + ["--backend", "sparse", "--device", "cpu"])
    jax_sparse = _run(capsys, jax_cli.main, base + ["--backend", "sparse"])
    assert port.strip(), "the fixture produced no rows"
    assert port == jax_sparse
    if not emit:
        oracle = _run(capsys, jax_cli.main, base + ["--backend", "oracle"])
        _assert_latest_close(_parse(oracle), _parse(port))


def _emitted_lines(out, k):
    """``--emit-updates`` stdout -> (items in emission order, vals [N, K]
    f32, ids [N, K]); lanes past a row's partners are (-inf, -1)."""
    lines = [ln for ln in out.splitlines() if ln]
    items = []
    vals = np.full((len(lines), k), -np.inf, dtype=np.float32)
    ids = np.full((len(lines), k), -1, dtype=np.int64)
    for r, line in enumerate(lines):
        item, _, rest = line.partition("\t")
        items.append(int(item))
        for c, tok in enumerate(rest.split()):
            other, score = tok.split(":")
            vals[r, c], ids[r, c] = float(score), int(other)
    return items, vals, ids


#: A Zipf stream large enough that torch's and XLA's log1p roundings
#: show in the rendered scores (10,000 events, 3,000 items, 800 users).
STREAM = dict(n_events=10_000, n_items=3_000, n_users=800, alpha=1.1,
              seed=7, events_per_ms=50)


@pytest.mark.parametrize("port_args,jax_args", [
    (["--device", "cpu"], ["--backend", "device"]),
    (["--backend", "sparse", "--device", "cpu"], ["--backend", "sparse"]),
    (["--backend", "sparse", "--cell-dtype", "int8", "--device", "cpu"],
     ["--backend", "sparse", "--cell-dtype", "int8"]),
], ids=["dense", "sparse", "sparse-int8"])
def test_cli_matches_jax_on_a_zipf_stream(capsys, tmp_path, port_args,
                                          jax_args):
    """Every line the port emits stands where the JAX line does, for the
    same item, in ``topk_parity``: scores within ``rtol=1e-5`` plus
    ``atol=1e-4``, one unit in the rendered 4th decimal (a float32 score
    one ulp apart can round either way), and untied ids equal. The
    latest rows then pass the tie-aware ``_assert_latest_close``. At
    ``--cell-dtype int8`` 83 rows of this stream promote to the wide
    side-table on both sides."""
    users, items, ts = zipfian_interactions(**STREAM)
    path = tmp_path / "zipf.csv"
    with open(path, "w") as f:
        for u, i, t in zip(users.tolist(), items.tolist(), ts.tolist()):
            f.write(f"{u},{i},{t}\n")
    base = ["-i", str(path), "-s", "0xC0FFEE", "-ws", "100", "-uc", "30",
            "-ic", "200", "--emit-updates"]
    port = _run(capsys, port_cli.main, base + port_args)
    ref = _run(capsys, jax_cli.main, base + jax_args)
    p_items, p_vals, p_ids = _emitted_lines(port, 10)
    j_items, j_vals, j_ids = _emitted_lines(ref, 10)
    assert len(p_items) > 2000, "the stream emitted too few rows"
    assert p_items == j_items
    np.testing.assert_array_equal(np.isfinite(p_vals), np.isfinite(j_vals))
    ok, mism = topk_parity(p_vals, p_ids, j_vals, j_ids, rtol=1e-5,
                           atol=1e-4)
    assert ok and mism == 0, (ok, mism)
    _assert_latest_close(_parse(ref), _parse(port))


@pytest.mark.parametrize("fixture", ["u.data", "ratings.csv"])
@pytest.mark.parametrize("cuts", [(500, 500), (4, 3)])
def test_sparse_counters_match_oracle(tmp_path, fixture, cuts):
    _, (users, items, ts) = _fixture_csv(tmp_path, fixture)
    kw = dict(window_size=86_400_000, seed=0xC0FFEE, item_cut=cuts[0],
              user_cut=cuts[1])
    port = PortJob(PortConfig(**kw, backend="sparse", device="cpu"))
    oracle = JaxJob(JaxConfig(**kw, backend=Backend.ORACLE))
    for job in (port, oracle):
        job.add_batch(users, items, ts)
        job.finish()
    assert port.counters.get(OBSERVED_COOCCURRENCES) > 0
    for name in (OBSERVED_COOCCURRENCES, ROW_SUM_PROCESS_WINDOW,
                 RESCORED_ITEMS):
        assert port.counters.get(name) == oracle.counters.get(name), name


def test_hybrid_is_the_sparse_backend(capsys, caplog, tmp_path):
    path, _ = _fixture_csv(tmp_path, "ratings.csv")
    base = ["-i", path, "-ws", "1000000000", "-s", "0xC0FFEE",
            "--device", "cpu", "--backend"]
    sparse = _run(capsys, port_cli.main, base + ["sparse"])
    assert "hybrid is retired" not in caplog.text
    hybrid = _run(capsys, port_cli.main, base + ["hybrid"])
    assert hybrid == sparse and sparse.strip()
    assert "--backend hybrid is retired; running the sparse backend" in (
        caplog.text)


def test_sparse_config_echo_names_the_resolved_cell_dtype(caplog, tmp_path):
    path, _ = _fixture_csv(tmp_path, "u.data")
    caplog.set_level("INFO", logger="tpu_cooccurrence_torch")
    assert port_cli.main(["-i", path, "-ws", "1000000000", "--backend",
                          "sparse", "--device", "cpu",
                          "--score-ladder", "16"]) == 0
    # The JAX package's auto rule: int16 cells and the packed uplink on
    # the sparse backend.
    assert "cellDtype\tint16 (--cell-dtype auto)" in caplog.text
    assert "wireFormat\tpacked (--wire-format auto)" in caplog.text
    assert "scoreLadder\t16" in caplog.text


@pytest.mark.parametrize("field,value,message", [
    ("cell_dtype", "int16", "--cell-dtype int16 is --backend sparse"),
    ("cell_dtype", "int8", "--cell-dtype int8 is --backend sparse"),
    ("wire_format", "packed", "--wire-format packed applies to the sparse"),
])
def test_narrow_cells_and_packed_are_sparse_only(caplog, tmp_path, field,
                                                 value, message):
    """As in the JAX package: off the sparse backend ``auto`` resolves to
    int32 and raw, and an explicit narrow or packed request is refused
    (exit 78) with the JAX package's message."""
    path, _ = _fixture_csv(tmp_path, "u.data")
    flag = "--" + field.replace("_", "-")
    assert port_cli.main(["-i", path, "-ws", "100", "--device", "cpu",
                          flag, value]) == port_cli.EX_CONFIG
    assert message in caplog.text
    with pytest.raises(ValueError, match=message):
        JaxConfig(window_size=100, seed=1, backend=Backend.DEVICE,
                  **{field: value})
    cfg = PortConfig(window_size=100, device="cpu")
    assert (cfg.resolved_cell_dtype, cfg.resolved_wire_format) == (
        "int32", "raw")


def test_bad_score_ladder_is_a_config_error(caplog, tmp_path):
    path, _ = _fixture_csv(tmp_path, "u.data")
    assert port_cli.main(["-i", path, "-ws", "100", "--backend", "sparse",
                          "--device", "cpu", "--score-ladder", "6"]) == 78
    assert "power of two" in caplog.text


def test_slab_capacity_error_exits_78(caplog, tmp_path, monkeypatch):
    from tpu_cooccurrence_torch.state import sparse_scorer

    def full(self, ts, pairs):
        raise sparse_scorer.SlabCapacityError("slot space crossed")

    monkeypatch.setattr(sparse_scorer.SparseDeviceScorer, "process_window",
                        full)
    path, _ = _fixture_csv(tmp_path, "ratings.csv")
    assert port_cli.main(["-i", path, "-ws", "1000000000", "--backend",
                          "sparse", "--device", "cpu"]) == port_cli.EX_CONFIG
    assert "slab capacity exhausted: slot space crossed" in caplog.text
