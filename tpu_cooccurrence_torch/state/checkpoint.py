"""Checkpoint / resume of the whole job (copy of
``tpu_cooccurrence/state/checkpoint.py``, single-process full generations).

A checkpoint captures every piece of the job's state: vocabularies,
item-cut counters, the reservoirs (histories, totals, draw counters), the
in-flight window buffers and watermark, the scorer's counts, row sums and
``observed``, the latest top-K rows and the source position, so a
restored job continues exactly where the checkpointed one stood.

Format: the reference package's, key for key and meta for meta, so a
checkpoint written by either package restores in the other. One ``.npz``
holds the arrays and the JSON-encoded scalars (``meta_json``) and is
committed by one atomic rename; a ``meta.json`` sidecar is written
afterwards for people to read and plays no part in restore.

Durability:

* **Integrity digest**: a sha256 over every array rides inside the
  ``.npz`` (``digest_sha256``); a torn or bit-rotted file fails
  verification instead of restoring garbage.
* **Generations**: each save commits ``state.<gen>.npz`` with a rising
  generation number and rewrites the advisory ``LATEST`` pointer;
  ``--checkpoint-retain`` newest generations are kept. Restore walks
  newest to oldest, moves a generation that fails verification aside as
  ``*.corrupt`` (counted on ``cooc_checkpoint_quarantined_total``) and
  restores the newest one that verifies.
* Orphaned ``*.tmp`` files (a crash between ``mkstemp`` and the rename)
  are swept by the next :func:`save` once they are old enough.
* **Directory durability**: after the rename the directory itself is
  fsynced, so the new entry survives a power loss.

Blob codec: under ``--wire-format auto`` or ``packed`` the sorted cell
keys are written delta + varint and the nonnegative count arrays varint
(``ckpt_codec`` in the meta, as the reference package writes them, on
every backend); under ``raw`` every array is written as it is. Restore
reads either layout from the meta. It
refuses, with :class:`ValueError` and never in part, the reference
package's checkpoints of features it does not carry: an incremental
chain (``ckpt_delta``, ``delta*.bin``), multi-host epoch markers or
process-suffixed files, a partitioned-source offset section, and a
partition-sampled reservoir (``sampler_part``).
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import re
import tempfile
import time

import numpy as np

from ..metrics import RESCORED_ITEMS
from ..observability.registry import REGISTRY
from .wire import (checkpoint_codec, decode_sorted_u64, decode_varint,
                   encode_sorted_u64, encode_varint)

LOG = logging.getLogger("tpu_cooccurrence_torch.checkpoint")

#: Orphaned ``*.tmp`` snapshots younger than this are left alone by the
#: sweep: they may belong to a live writer.
TMP_SWEEP_AGE_S = 900.0

#: Checkpoint files that failed verification, moved aside as ``*.corrupt``.
QUARANTINE_GAUGE = "cooc_checkpoint_quarantined_total"
#: Generation last written (save) or restored (restore).
GENERATION_GAUGE = "cooc_checkpoint_generation"
#: Last commit's bytes (the npz).
COMMIT_BYTES_GAUGE = "cooc_checkpoint_commit_bytes"
#: Last commit's wall seconds (state snapshot to durable rename).
COMMIT_SECONDS_GAUGE = "cooc_checkpoint_commit_seconds"

#: Config keys a checkpoint must agree on with the restoring job.
#: ``window_millis`` included: buffered in-flight events restored into a
#: job with another window size would be silently re-windowed.
CONFIG_KEYS = ("seed", "skip_cuts", "item_cut", "user_cut", "top_k",
               "window_slide", "window_millis")

#: Files of the reference package's planes the port does not carry: a
#: row-delta generation, a multi-host epoch marker, a process-suffixed
#: generation.
_FOREIGN = re.compile(r"^(?:delta.*\.bin|EPOCH.*|state\.p\d+\..*npz)$")


class CheckpointCorrupt(ValueError):
    """A checkpoint file failed to load or verify its digest."""


# -- naming ------------------------------------------------------------


def _legacy_path(directory: str) -> str:
    return os.path.join(directory, "state.npz")


def _gen_path(directory: str, gen: int) -> str:
    return os.path.join(directory, f"state.{gen}.npz")


def _latest_path(directory: str) -> str:
    return os.path.join(directory, "LATEST")


def _fsync_dir(directory: str) -> None:
    """fsync the directory so a just-committed rename survives power loss
    (``os.replace`` alone only updates the cached directory entry).
    Best-effort: a filesystem without directory fds must not fail the
    checkpoint it is trying to harden."""
    try:
        fd = os.open(directory, os.O_RDONLY | getattr(os, "O_DIRECTORY", 0))
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def generations(directory: str) -> "list[tuple[int, str]]":
    """Restorable generations in ``directory``, newest first, as
    ``(gen, path)``. A legacy un-numbered ``state.npz`` appears as
    generation 0."""
    pat = re.compile(r"^state\.(\d+)\.npz$")
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    out = [(int(m.group(1)), os.path.join(directory, name))
           for name, m in ((n, pat.match(n)) for n in names) if m]
    legacy = _legacy_path(directory)
    if os.path.exists(legacy):
        out.append((0, legacy))
    out.sort(reverse=True)
    return out


def _foreign_files(directory: str) -> "list[str]":
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    return sorted(n for n in names if _FOREIGN.match(n))


def exists(directory: str) -> bool:
    """True when ``directory`` holds a checkpoint of either package: a
    generation this job could restore, or files of a plane the port does
    not carry (which :func:`restore` then refuses)."""
    return bool(generations(directory) or _foreign_files(directory))


# -- integrity ---------------------------------------------------------


def compute_digest(arrays: "dict[str, np.ndarray]") -> str:
    """sha256 over every array's name, dtype, shape and bytes, in sorted
    name order: the payload the atomic rename commits."""
    h = hashlib.sha256()
    for key in sorted(arrays):
        a = np.ascontiguousarray(arrays[key])
        h.update(key.encode())
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.reshape(-1).view(np.uint8))  # a.tobytes(), uncopied
    return h.hexdigest()


def _load_verified(path: str) -> "dict[str, np.ndarray]":
    """Load ``path`` and verify its embedded digest.

    Raises :class:`CheckpointCorrupt` on a read failure (torn zip,
    truncated member) or a digest mismatch. A file without a digest
    (written before digests existed) loads with a warning."""
    try:
        with np.load(path) as data:
            arrays = {k: data[k] for k in data.files}
    except (MemoryError, OSError):
        # Environmental, not corruption: a transient EIO or a tight-memory
        # load must not get a good snapshot quarantined.
        raise
    except Exception as exc:  # BadZipFile / zlib.error / ValueError ...
        raise CheckpointCorrupt(f"unreadable checkpoint {path}: {exc}")
    stored = arrays.pop("digest_sha256", None)
    if stored is None:
        LOG.warning("checkpoint %s predates integrity digests; restoring "
                    "unverified", path)
        return arrays
    expected = bytes(stored).decode()
    actual = compute_digest(arrays)
    if actual != expected:
        raise CheckpointCorrupt(
            f"checkpoint digest mismatch in {path}: stored {expected[:12]}…, "
            f"recomputed {actual[:12]}…")
    return arrays


def _update_latest(directory: str) -> None:
    """Point ``LATEST`` at the newest surviving generation (or remove it
    when none survive): an operator breadcrumb, never read by restore."""
    gens = generations(directory)
    latest = _latest_path(directory)
    try:
        if not gens:
            os.remove(latest)
            return
        tmp = latest + ".tmp"
        with open(tmp, "w") as f:
            f.write(os.path.basename(gens[0][1]) + "\n")
        os.replace(tmp, latest)
    except OSError:
        pass  # advisory; never fail recovery over it


def _quarantine(path: str, directory: str) -> None:
    """Move a file that failed verification aside as ``<path>.corrupt``
    so no later restore hits it again, and count it."""
    target = path + ".corrupt"
    try:
        os.replace(path, target)
    except OSError as exc:
        LOG.error("could not quarantine corrupt checkpoint %s: %s",
                  path, exc)
        return
    _update_latest(directory)
    REGISTRY.gauge(
        QUARANTINE_GAUGE,
        help="checkpoint files that failed verification, moved aside "
             "as *.corrupt").add(1)
    LOG.error("quarantined corrupt checkpoint %s -> %s", path, target)


def _decode_codec(data: "dict[str, np.ndarray]", meta: dict) -> None:
    """Decode ``ckpt_codec``-packed blobs (the reference package's delta +
    varint format) back to canonical arrays, in place. No record: the raw
    layout, nothing to do."""
    codec = meta.get("ckpt_codec")
    if not codec:
        return
    if codec.get("v") != 1:
        raise ValueError(
            f"unknown checkpoint codec version {codec.get('v')!r} "
            f"(written by a newer version?)")
    for name, (spec, count) in codec["arrays"].items():
        blob = data.pop(name + "__packed")
        if spec == "sdv":
            data[name] = decode_sorted_u64(blob, count)
        elif spec == "v":
            data[name] = decode_varint(blob, count).astype(np.int64)
        else:
            raise ValueError(
                f"unknown checkpoint array codec {spec!r} for {name}")


def _sweep_orphan_tmps(directory: str) -> None:
    """Delete ``*.tmp`` snapshots abandoned by a crash between ``mkstemp``
    and ``os.replace``, once older than :data:`TMP_SWEEP_AGE_S`."""
    now = time.time()
    try:
        names = os.listdir(directory)
    except OSError:
        return
    for name in names:
        if not name.endswith(".tmp"):
            continue
        p = os.path.join(directory, name)
        try:
            if now - os.path.getmtime(p) > TMP_SWEEP_AGE_S:
                os.remove(p)
                LOG.info("swept orphaned checkpoint tmp %s", p)
        except OSError:
            continue  # raced with another sweeper or the owner's rename


def _config_meta(config) -> dict:
    """The :data:`CONFIG_KEYS` of a port config (tumbling windows only:
    ``window_slide`` is None)."""
    meta = {k: getattr(config, k) for k in CONFIG_KEYS
            if k != "window_slide"}
    meta["window_slide"] = None
    return meta


# -- save / restore ----------------------------------------------------


def _pack_blobs(arrays: dict, meta: dict) -> None:
    """Encode, in place, the arrays the reference package's codec packs:
    sorted nonnegative ``*rows_key`` as delta + varint (``sdv``), and
    nonnegative ``*_cnt`` as varint (``v``), each a non-empty 1-D int64
    array; the codec goes into ``meta["ckpt_codec"]``. An array that does
    not qualify stays raw."""
    packed = {}
    for name, arr in arrays.items():
        arr = np.asarray(arr)
        if arr.ndim != 1 or arr.dtype != np.int64 or not len(arr):
            continue
        if name.endswith("rows_key"):
            try:
                packed[name] = ("sdv", len(arr), encode_sorted_u64(arr))
            except ValueError:
                continue  # not sorted or negative: stays raw
        elif name.endswith("_cnt") and int(arr.min()) >= 0:
            packed[name] = ("v", len(arr), encode_varint(arr))
    if packed:
        meta["ckpt_codec"] = {
            "v": 1,
            "arrays": {name: [spec, count]
                       for name, (spec, count, _b) in packed.items()}}
        for name, (_spec, _count, blob) in packed.items():
            del arrays[name]
            arrays[name + "__packed"] = blob


def save(job, directory: str, source=None) -> str:
    """Write a checkpoint of ``job`` (and optionally its file source) as
    the next generation; returns its path."""
    t0 = time.monotonic()
    os.makedirs(directory, exist_ok=True)
    _sweep_orphan_tmps(directory)
    arrays = {}
    meta = {
        **_config_meta(job.config),
        "windows_fired": job.windows_fired,
        "emissions": job.emissions,
        # A deferred-results scorer materializes each row once from its
        # device table however many windows rescored it, so its emission
        # count is not comparable with the rescored-rows counter. Record
        # the count a per-window scorer should resume with beside the
        # real one; restore picks by the restoring scorer's mode.
        "emissions_per_window_resume": (
            job.counters.get(RESCORED_ITEMS)
            if getattr(job.scorer, "defer_results", False)
            else job.emissions),
        "max_ts_seen": job.engine.max_ts_seen,
        "counters": job.counters.as_dict(),
    }
    arrays["item_vocab"] = job.item_vocab.checkpoint_state()
    arrays["user_vocab"] = job.user_vocab.checkpoint_state()
    arrays["item_cut_counts"] = job.item_cut.counts
    arrays.update(job.sampler.checkpoint_state(len(job.user_vocab)))

    # In-flight window buffers, flattened.
    starts, users_l, items_l, ts_l = [], [], [], []
    for start, chunks in job.engine._buffers.items():
        for (u, i, t) in chunks:
            starts.append(np.full(len(u), start, dtype=np.int64))
            users_l.append(u)
            items_l.append(i)
            ts_l.append(t)
    if starts:
        arrays["buf_start"] = np.concatenate(starts)
        arrays["buf_users"] = np.concatenate(users_l)
        arrays["buf_items"] = np.concatenate(items_l)
        arrays["buf_ts"] = np.concatenate(ts_l)

    for key, val in job.scorer.checkpoint_state().items():
        arrays[f"scorer_{key}"] = val

    if source is not None:
        meta["source"] = source.checkpoint_state()
        meta["ingest_offsets"] = source.offsets_state()

    # Latest emitted top-K (the consumable result state), external ids.
    lat_items, lat_offsets, lat_others, lat_scores = [], [0], [], []
    snap = job.latest.snapshot()
    for item in sorted(snap):
        top = snap[item]
        lat_items.append(item)
        lat_others.extend(j for j, _ in top)
        lat_scores.extend(sc for _, sc in top)
        lat_offsets.append(len(lat_others))
    arrays["latest_items"] = np.asarray(lat_items, dtype=np.int64)
    arrays["latest_offsets"] = np.asarray(lat_offsets, dtype=np.int64)
    arrays["latest_others"] = np.asarray(lat_others, dtype=np.int64)
    arrays["latest_scores"] = np.asarray(lat_scores, dtype=np.float64)

    if checkpoint_codec(job.config.wire_format) == "packed":
        _pack_blobs(arrays, meta)

    gens = generations(directory)
    gen = (gens[0][0] if gens else 0) + 1

    # The meta rides inside the .npz so one rename commits the whole
    # checkpoint (two renames could leave arrays N beside meta N-1).
    arrays["meta_json"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8)
    # Digest exactly what savez stores (asarray-converted).
    arrays = {k: np.asarray(v) for k, v in arrays.items()}
    arrays["digest_sha256"] = np.frombuffer(
        compute_digest(arrays).encode(), dtype=np.uint8)

    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    os.close(fd)
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    npz_path = _gen_path(directory, gen)
    os.replace(tmp, npz_path)
    _update_latest(directory)
    _fsync_dir(directory)

    # Retention: the newest N generations (quarantined files keep their
    # renamed forms and are not counted).
    for _old_gen, old_path in generations(directory)[
            job.config.checkpoint_retain:]:
        try:
            os.remove(old_path)
        except OSError:
            pass

    commit_bytes = os.path.getsize(npz_path)
    REGISTRY.gauge(GENERATION_GAUGE,
                   help="checkpoint generation last written or "
                        "restored").set(gen)
    REGISTRY.gauge(COMMIT_BYTES_GAUGE,
                   help="bytes committed by the last checkpoint "
                        "generation").set(commit_bytes)
    REGISTRY.gauge(COMMIT_SECONDS_GAUGE,
                   help="wall seconds of the last checkpoint "
                        "commit").set(time.monotonic() - t0)
    meta_tmp = os.path.join(directory, "meta.json.tmp")
    with open(meta_tmp, "w") as f:
        json.dump(meta, f)
    os.replace(meta_tmp, os.path.join(directory, "meta.json"))
    return npz_path


def restore(job, directory: str, source=None) -> None:
    """Restore ``job`` (built with the same config) from the newest
    generation that verifies.

    Walks generations newest to oldest by the number in the file name; a
    generation that fails to load or verify is quarantined as
    ``*.corrupt`` and the walk goes on, so a torn newest checkpoint costs
    one generation. A config mismatch, or a checkpoint of a plane the
    port does not carry, raises :class:`ValueError` at once and
    quarantines nothing."""
    foreign = _foreign_files(directory)
    if foreign:
        raise ValueError(
            f"checkpoint dir {directory} holds files of a checkpoint plane "
            f"the port does not carry (incremental chains, multi-host "
            f"epochs or process-suffixed generations): {foreign[:4]}")
    gens = generations(directory)
    if not gens:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    data = None
    restored_gen = None
    for gen, path in gens:
        try:
            data = _load_verified(path)
        except CheckpointCorrupt as exc:
            LOG.error("checkpoint generation %d failed verification: %s",
                      gen, exc)
            _quarantine(path, directory)
            continue
        restored_gen = gen
        break
    if data is None:
        raise CheckpointCorrupt(
            f"no checkpoint generation in {directory} verifies "
            f"(walked all {len(gens)})")
    _apply_restored(job, data, restored_gen, source=source)
    if restored_gen != gens[0][0]:
        LOG.warning("restored checkpoint generation %d (newest was %d; "
                    "newer generations failed verification)",
                    restored_gen, gens[0][0])


def _refuse_unported(meta: dict, data: dict) -> None:
    """Raise :class:`ValueError` for a checkpoint of a plane the port does
    not carry: restoring part of it would silently lose state."""
    if meta.get("ckpt_delta") is not None:
        raise ValueError("checkpoint is an incremental (delta-chain) "
                         "generation: --checkpoint-incremental is not "
                         "ported")
    if "gang_topology" in meta or "rescaled_from" in meta:
        raise ValueError("checkpoint was written by a multi-process gang: "
                         "multi-host runs are not ported")
    fmt = (meta.get("ingest_offsets") or {}).get("format", "files")
    if fmt != "files":
        raise ValueError(f"checkpoint carries {fmt!r} ingest offsets: "
                         f"--source-format partitioned is not ported")
    if "sampler_part" in data:
        raise ValueError("checkpoint was written with --partition-sampling, "
                         "which is not ported")


def _apply_restored(job, data: "dict[str, np.ndarray]", restored_gen: int,
                    source=None) -> None:
    """Land a verified checkpoint ``data`` dict in ``job``. Every check
    runs before the first write, so a refused checkpoint leaves the job
    as it was."""
    if "meta_json" not in data:
        raise ValueError(
            "incompatible checkpoint format: no embedded meta_json "
            "(written before atomic commits) — re-checkpoint")
    meta = json.loads(bytes(data["meta_json"]).decode())
    _refuse_unported(meta, data)
    mine = _config_meta(job.config)
    for key in CONFIG_KEYS:
        if mine[key] != meta.get(key):
            raise ValueError(
                f"checkpoint config mismatch for {key}: "
                f"{meta.get(key)} != {mine[key]}")
    _decode_codec(data, meta)

    job.item_vocab.restore_state(data["item_vocab"])
    job.user_vocab.restore_state(data["user_vocab"])
    job.item_cut.counts = data["item_cut_counts"].copy()
    if "hist" in data:
        job.sampler.restore_state(
            {k: data[k] for k in ("hist", "hist_len", "total", "draws")},
            len(job.user_vocab))

    job.engine.max_ts_seen = meta["max_ts_seen"]
    job.engine._buffers.clear()
    if "buf_start" in data:
        starts = data["buf_start"]
        for start in np.unique(starts):
            sel = starts == start
            job.engine._buffers[int(start)] = [
                (data["buf_users"][sel], data["buf_items"][sel],
                 data["buf_ts"][sel])]

    job.scorer.restore_state(
        {k[len("scorer_"):]: v for k, v in data.items()
         if k.startswith("scorer_")})

    job.windows_fired = meta["windows_fired"]
    job.emissions = (meta["emissions"]
                     if getattr(job.scorer, "defer_results", False)
                     else meta.get("emissions_per_window_resume",
                                   meta["emissions"]))
    job.counters.replace_all(meta["counters"])

    # The store keeps dense ids; the .npz holds external ids.
    job.latest.clear()
    items = data["latest_items"]
    offsets = data["latest_offsets"]
    others = data["latest_others"]
    scores = data["latest_scores"]
    to_dense = job.item_vocab.to_dense
    for pos, item in enumerate(items.tolist()):
        lo, hi = int(offsets[pos]), int(offsets[pos + 1])
        top = list(zip((to_dense(j) for j in others[lo:hi].tolist()),
                       scores[lo:hi].tolist()))
        job.latest.set_row(to_dense(item), top)

    if source is not None:
        if "ingest_offsets" in meta:
            source.restore_offsets(meta["ingest_offsets"])
        if "source" in meta:
            source.restore_state(meta["source"])
    REGISTRY.gauge(GENERATION_GAUGE,
                   help="checkpoint generation last written or "
                        "restored").set(restored_gen)
