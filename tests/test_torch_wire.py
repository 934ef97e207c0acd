"""The port's wire codecs (``tpu_cooccurrence_torch.state.wire``) against
the JAX package's (``tpu_cooccurrence.state.wire``) on the same seeded
numpy inputs.

- Encoders: ``pack_bits`` at every width 1-32, ``encode_update`` (empty
  sections and n = 0 included), ``encode_varint``,
  ``encode_zigzag_varint`` and ``encode_sorted_u64`` give words, headers
  and bytes equal to the JAX ones, and the port's decoders invert them.
- The device decode: the port's ``decode_update`` on CPU tensors equals
  JAX ``decode_update_host`` and JAX's jit ``decode_update`` (on the CPU)
  exactly, padding included, over the whole int32 range of values.
- ``checkpoint_codec``, ``packed_nbytes`` and the ledger's encoded-upload
  record.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_cooccurrence.state import wire as jw
from tpu_cooccurrence_torch.observability import TransferLedger
from tpu_cooccurrence_torch.state import wire as pw


@pytest.mark.parametrize("width", range(1, 33))
def test_pack_bits_matches_jax(width):
    rng = np.random.default_rng(width)
    hi = 1 << width
    for n in (0, 1, 2, 31, 32, 33, 63, 64, 65, 1000):
        vals = rng.integers(0, hi, n, dtype=np.uint64)
        if n:
            vals[0] = hi - 1  # the largest value survives
            vals[-1] = 0
        words = pw.pack_bits(vals, width)
        assert words.dtype == np.uint32
        np.testing.assert_array_equal(words, jw.pack_bits(vals, width))
        np.testing.assert_array_equal(pw.unpack_bits(words, width, n), vals)


def test_pack_bits_rejects_what_jax_rejects():
    for mod in (pw, jw):
        with pytest.raises(ValueError, match="width"):
            mod.pack_bits(np.zeros(1, np.uint64), 0)
        with pytest.raises(ValueError, match="width"):
            mod.pack_bits(np.zeros(1, np.uint64), 33)
        with pytest.raises(ValueError, match="fit"):
            mod.pack_bits(np.asarray([4], np.uint64), 2)


def _make_update(rng, n_new, n_d, n_rs, heap=1 << 18, items=5000):
    """A raw update buffer of live entries: new cells (slot, partner id),
    deltas (slot, any int32 value), row sums (row, +/- sum)."""
    n = n_new + n_d + n_rs
    upd = np.empty((2, n), dtype=np.int32)
    slots = rng.choice(heap, n_new + n_d, replace=False).astype(np.int32)
    upd[0, :n_new] = slots[:n_new]
    upd[1, :n_new] = rng.integers(0, items, n_new)
    upd[0, n_new:n_new + n_d] = slots[n_new:]
    upd[1, n_new:n_new + n_d] = rng.integers(-(2**31), 2**31, n_d)
    upd[0, n_new + n_d:] = rng.choice(items, n_rs, replace=False)
    upd[1, n_new + n_d:] = rng.integers(-30000, 30000, n_rs)
    return upd, (n_new, n_new + n_d), n


SHAPES = [(10, 300, 60), (0, 500, 90), (7, 0, 0), (0, 0, 0), (1, 1, 1),
          (0, 0, 40), (400, 3, 0), (25, 400, 80)]


@pytest.mark.parametrize("shape", SHAPES)
def test_encode_update_matches_jax(shape):
    rng = np.random.default_rng(sum(shape))
    upd, bounds, n = _make_update(rng, *shape)
    got = pw.encode_update(upd, bounds, n)
    want = jw.encode_update(upd, np.asarray(bounds, np.int32), n)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert pw.packed_nbytes(*got) == jw.packed_nbytes(*want)


def _pad(words, n):
    out = np.zeros(n, np.uint32)
    out[: len(words)] = words
    return out


def _port_decode(words_i, words_v, header, n_pad):
    got, bounds = pw.decode_update(pw.words_tensor(words_i, "cpu"),
                                   pw.words_tensor(words_v, "cpu"), header,
                                   n_pad)
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, n_pad)
    return got.numpy(), list(bounds)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("extra", [0, 37])
def test_decode_update_matches_jax_host(shape, extra):
    """The port's tensor decode equals JAX ``decode_update_host``, padding
    entries ``(SENT, 0)`` included, on buffers whose delta values span
    int32; so does the port's own host decoder."""
    rng = np.random.default_rng(sum(shape) + extra)
    upd, bounds, n = _make_update(rng, *shape)
    n_pad = n + extra
    words_i, words_v, header = jw.encode_update(
        upd, np.asarray(bounds, np.int32), n)
    host, host_b = jw.decode_update_host(words_i, words_v, header, n_pad)
    got, got_b = _port_decode(words_i, words_v, header, n_pad)
    np.testing.assert_array_equal(got, host)
    assert got_b == host_b.tolist()
    mine, mine_b = pw.decode_update_host(words_i, words_v, header, n_pad)
    np.testing.assert_array_equal(mine, host)
    np.testing.assert_array_equal(mine_b, host_b)


@pytest.mark.parametrize("shape", [(25, 400, 80), (0, 500, 90)])
def test_decode_update_matches_jax_jit(shape):
    """The port's tensor decode equals JAX's traceable ``decode_update``
    (run on the CPU), whose words carry guard padding."""
    rng = np.random.default_rng(sum(shape))
    upd, bounds, n = _make_update(rng, *shape)
    n_pad = n + 19
    words_i, words_v, header = jw.encode_update(
        upd, np.asarray(bounds, np.int32), n)
    jit, jit_b = jw.decode_update(
        jnp.asarray(_pad(words_i, 2 * len(words_i) + 8)),
        jnp.asarray(_pad(words_v, 2 * len(words_v) + 8)),
        jnp.asarray(header), n_pad)
    got, got_b = _port_decode(words_i, words_v, header, n_pad)
    np.testing.assert_array_equal(got, np.asarray(jit))
    assert got_b == np.asarray(jit_b).tolist()


def test_decode_update_at_the_extremes():
    """Widths of 32 bits in both columns: slots and ids near 2^31, and
    deltas at both ends of int32 (zigzag near 2^32)."""
    top = 2**31 - 1
    upd = np.asarray([[top - 1, 0, top, 5, 7, 1],
                      [top, 0, -(2**31), top, 1, -1]], dtype=np.int32)
    bounds = (2, 4)
    words_i, words_v, header = pw.encode_update(upd, bounds, 6)
    assert header[1] == 31 and header[2] == 32
    got, _ = _port_decode(words_i, words_v, header, 6)
    host, _ = jw.decode_update_host(words_i, words_v, header, 6)
    np.testing.assert_array_equal(got, host)
    # Sorted inside each section, equal as multisets to the raw buffer.
    for lo, hi in ((0, 2), (2, 4), (4, 6)):
        assert sorted(zip(*got[:, lo:hi].tolist())) == sorted(
            zip(*upd[:, lo:hi].tolist()))


def test_varint_encoders_match_jax():
    rng = np.random.default_rng(0)
    for n in (0, 1, 500):
        vals = rng.integers(0, 2**62, n, dtype=np.uint64)
        signed = rng.integers(-2**62, 2**62, n, dtype=np.int64)
        if n:
            vals[0], vals[-1] = 0, np.uint64(2**63)
            signed[0] = np.iinfo(np.int64).min
            signed[-1] = np.iinfo(np.int64).max
        buf = pw.encode_varint(vals)
        np.testing.assert_array_equal(buf, jw.encode_varint(vals))
        np.testing.assert_array_equal(pw.decode_varint(buf, n), vals)
        zbuf = pw.encode_zigzag_varint(signed)
        np.testing.assert_array_equal(zbuf, jw.encode_zigzag_varint(signed))
        np.testing.assert_array_equal(pw.decode_zigzag_varint(zbuf, n),
                                      signed)
    for mod in (pw, jw):
        with pytest.raises(ValueError, match="nonnegative"):
            mod.encode_varint(np.asarray([-1], np.int64))


def test_sorted_u64_matches_jax():
    rng = np.random.default_rng(1)
    rows = np.repeat(np.arange(200, dtype=np.int64), 100)
    keys = np.unique((rows << 32) | rng.integers(0, 5000, 20000))
    blob = pw.encode_sorted_u64(keys)
    np.testing.assert_array_equal(blob, jw.encode_sorted_u64(keys))
    np.testing.assert_array_equal(pw.decode_sorted_u64(blob, len(keys)),
                                  keys)
    assert blob.nbytes * 2 < keys.nbytes
    assert len(pw.encode_sorted_u64(np.zeros(0, np.int64))) == 0
    for bad in ([5, 3], [-1, 2]):
        with pytest.raises(ValueError):
            pw.encode_sorted_u64(np.asarray(bad, np.int64))


def test_checkpoint_codec_matches_jax():
    for flag in ("auto", "raw", "packed"):
        assert pw.checkpoint_codec(flag) == jw.checkpoint_codec(flag)


def test_ledger_records_encoded_uploads():
    ledger = TransferLedger()
    ledger.up(np.zeros(10, np.int32))
    ledger.up_encoded(4000, np.zeros(3, np.uint32), torch.zeros(5))
    snap = ledger.snapshot()
    assert snap["h2d_bytes"] == 40 + 12 + 20 and snap["h2d_calls"] == 2
    assert (snap["uplink_raw_bytes"], snap["uplink_enc_bytes"]) == (4000, 32)
    ledger.reset()
    assert ledger.snapshot()["uplink_raw_bytes"] == 0
