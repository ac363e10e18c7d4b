"""Binary codec round-trips + known packed-varint values
(mirrors `UtilsTest.java:41-100` packInt/packLong tests)."""

import numpy as np
import pytest

from similaritysearchbyrdf_tpu.storage import serializers as S


@pytest.mark.parametrize("v", [0, 1, 127, 128, 255, 16383, 16384, 2**31 - 1])
def test_pack_int_roundtrip(v):
    buf = S.pack_int(v)
    got, off = S.unpack_int(buf)
    assert got == v and off == len(buf)


def test_pack_int_known_encodings():
    # 7-bit groups, continuation high bit on all but last (MapDB DataIO)
    assert S.pack_int(0) == bytes([0x00])
    assert S.pack_int(1) == bytes([0x01])
    assert S.pack_int(127) == bytes([0x7F])
    assert S.pack_int(128) == bytes([0x81, 0x00])
    assert S.pack_int(300) == bytes([0x82, 0x2C])


@pytest.mark.parametrize("v", [0, 1, 127, 128, 2**31, 2**63 - 1])
def test_pack_long_roundtrip(v):
    buf = S.pack_long(v)
    got, off = S.unpack_long(buf)
    assert got == v and off == len(buf)


def test_int_long_big_endian():
    assert S.serialize_int(1) == b"\x00\x00\x00\x01"
    assert S.serialize_long(1) == b"\x00\x00\x00\x00\x00\x00\x00\x01"
    assert S.deserialize_int(S.serialize_int(-5))[0] == -5
    assert S.deserialize_long(S.serialize_long(-5))[0] == -5


def test_id_hash_pair_roundtrip():
    buf = S.serialize_id_hash_pair(42, 0x12345678)
    (vid, h), off = S.deserialize_id_hash_pair(buf)
    assert (vid, h) == (42, 0x12345678) and off == len(buf)


def test_sparse_vector_roundtrip():
    idx = np.array([0, 5, 9], dtype=np.int32)
    vals = np.array([1.5, -2.5, 3.25])
    buf = S.serialize_sparse_vector(7, 10, idx, vals)
    (vid, size, i2, v2), off = S.deserialize_sparse_vector(buf)
    assert (vid, size) == (7, 10) and off == len(buf)
    np.testing.assert_array_equal(i2, idx)
    np.testing.assert_allclose(v2, vals)


def test_dense_vector_roundtrip():
    vals = np.array([0.1, 0.2, -0.3])
    buf = S.serialize_dense_vector(3, vals)
    (vid, v2), off = S.deserialize_dense_vector(buf)
    assert vid == 3 and off == len(buf)
    np.testing.assert_allclose(v2, vals)


def test_dense_batch_codec_matches_per_record():
    """Native batch encoding must be byte-identical to the per-record
    python codec, and decode must round-trip."""
    import numpy as np

    from similaritysearchbyrdf_tpu.storage.serializers import (
        deserialize_dense_batch, serialize_dense_batch,
        serialize_dense_vector,
    )

    rng = np.random.default_rng(0)
    n, d = 200, 24
    ids = rng.integers(0, 2**31 - 1, n).astype(np.int32)
    values = rng.normal(size=(n, d))
    batch = serialize_dense_batch(ids, values)
    per_record = b"".join(
        serialize_dense_vector(int(ids[i]), values[i]) for i in range(n)
    )
    assert batch == per_record
    ids2, values2 = deserialize_dense_batch(batch)
    np.testing.assert_array_equal(ids2, ids)
    np.testing.assert_allclose(values2, values)


def test_sparse_batch_codec_matches_per_record():
    import numpy as np

    from similaritysearchbyrdf_tpu.storage.serializers import (
        deserialize_sparse_batch, serialize_sparse_batch,
        serialize_sparse_vector,
    )

    rng = np.random.default_rng(1)
    n, dim, max_nnz = 150, 512, 12
    ids = rng.integers(0, 2**31 - 1, n).astype(np.int32)
    lengths = rng.integers(1, max_nnz + 1, n).astype(np.int32)
    indices = np.zeros((n, max_nnz), np.int32)
    values = np.zeros((n, max_nnz), np.float64)
    for i in range(n):
        k = lengths[i]
        indices[i, :k] = np.sort(rng.choice(dim, size=k, replace=False))
        values[i, :k] = rng.normal(size=k)
    batch = serialize_sparse_batch(ids, dim, indices, values, lengths)
    per_record = b"".join(
        serialize_sparse_vector(int(ids[i]), dim, indices[i, :lengths[i]],
                                values[i, :lengths[i]])
        for i in range(n)
    )
    assert batch == per_record
    ids2, size2, idx2, val2, len2 = deserialize_sparse_batch(batch)
    assert size2 == dim
    np.testing.assert_array_equal(ids2, ids)
    np.testing.assert_array_equal(len2, lengths)
    for i in range(n):
        k = lengths[i]
        np.testing.assert_array_equal(idx2[i, :k], indices[i, :k])
        np.testing.assert_allclose(val2[i, :k], values[i, :k])


# ---------------------------------------------------------------------------
# Golden-bytes fixtures: byte renderings of the JVM wire
# formats generated INDEPENDENTLY from the format spec (java.io.DataOutput +
# MapDB DataIO varints) by scripts/make_golden_fixtures.py — not by these
# codecs. Asserting byte equality here closes the "bit-compatible with
# `Serializers.scala:16-102` / `DataIO.java:60-130`" claim.
# ---------------------------------------------------------------------------

import os

_FIX = os.path.join(os.path.dirname(__file__), "fixtures")


def _fixture(name):
    with open(os.path.join(_FIX, name), "rb") as f:
        return f.read()


def test_golden_dense_vectors():
    golden = _fixture("densevectors_golden.bin")
    recs = [
        (3, np.array([1.0, 2.0, 3.0])),
        (4, np.array([4.0, 5.0, 6.0])),
        (2**31 - 1, np.array([-0.3333333333333333, 1e300])),
    ]
    assert b"".join(
        S.serialize_dense_vector(vid, vals) for vid, vals in recs
    ) == golden
    off = 0
    for vid, vals in recs:
        (got_id, got_vals), off = S.deserialize_dense_vector(golden, off)
        assert got_id == vid
        np.testing.assert_array_equal(got_vals, vals)
    assert off == len(golden)


def test_golden_sparse_vectors():
    golden = _fixture("sparsevectors_golden.bin")
    recs = [
        (3, 3, np.array([0, 1, 2]), np.array([1.0, 2.0, 3.0])),
        (5, 2, np.array([0, 1]), np.array([1.0, 2.0])),
        (7, 1 << 20, np.array([(1 << 20) - 1]), np.array([-2.5])),
    ]
    assert b"".join(
        S.serialize_sparse_vector(vid, size, idx, vals)
        for vid, size, idx, vals in recs
    ) == golden
    off = 0
    for vid, size, idx, vals in recs:
        (gid, gsize, gidx, gvals), off = S.deserialize_sparse_vector(
            golden, off)
        assert (gid, gsize) == (vid, size)
        np.testing.assert_array_equal(gidx, idx)
        np.testing.assert_array_equal(gvals, vals)
    assert off == len(golden)


def test_golden_id_hash_pairs():
    golden = _fixture("idhashpairs_golden.bin")
    recs = [(42, 0x12345678), (0, -1 + (1 << 64)), (-7, 2**63 - 1)]
    # writeLong renders -1 as 0xFF..FF; our codec takes the unsigned view
    assert b"".join(
        S.serialize_id_hash_pair(vid, h % (1 << 64)) for vid, h in recs
    ) == golden


def test_golden_packed_varints():
    golden = _fixture("packed_varints_golden.bin")
    ints = [0, 1, 127, 128, 300, 16383, 16384, 2**31 - 1]
    longs = [0, 1, 127, 128, 2**31, 2**63 - 1]
    buf = b"".join(S.pack_int(v) for v in ints)
    buf += b"".join(S.pack_long(v) for v in longs)
    assert buf == golden
    off = 0
    for v in ints:
        got, off = S.unpack_int(golden, off)
        assert got == v
    for v in longs:
        got, off = S.unpack_long(golden, off)
        assert got == v
    assert off == len(golden)


def test_golden_native_batch_codec():
    """The C++ batch codec (native/rdf_codec.cc) must emit the same golden
    stream for the dense/sparse record sequences."""
    from similaritysearchbyrdf_tpu.native import loader

    if loader._get_lib() is None:
        pytest.skip("native library not built")
    ids = np.array([3, 4], np.int32)
    values = np.array([[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]])
    enc = loader.encode_dense_batch(ids, values)
    golden = _fixture("densevectors_golden.bin")
    # golden's third record has a different dim; compare the first two
    assert enc == golden[: len(enc)]
    sids = np.array([3], np.int32)
    sidx = np.array([[0, 1, 2]], np.int32)
    svals = np.array([[1.0, 2.0, 3.0]])
    slens = np.array([3], np.int32)
    senc = loader.encode_sparse_batch(sids, 3, sidx, svals, slens)
    sg = _fixture("sparsevectors_golden.bin")
    assert senc == sg[: len(senc)]


def test_reference_text_fixture_files():
    """Parse the reference's own checked-in dataset files
    (`src/test/resources/VectorTest/{dense,sparse}vectorfile`, data files
    mirrored under tests/fixtures) to the values its VectorSuite asserts
    (`VectorSuite.scala:9-38`)."""
    from similaritysearchbyrdf_tpu import vectors as V

    with open(os.path.join(_FIX, "sparsevectorfile")) as f:
        rows = [V.from_string(line) for line in f.read().splitlines() if line]
    assert [(r[0], r[1]) for r in rows] == [(3, 3), (4, 3), (5, 2)]
    np.testing.assert_array_equal(rows[0][2], [0, 1, 2])
    np.testing.assert_array_equal(rows[0][3], [1.0, 2.0, 3.0])
    np.testing.assert_array_equal(rows[2][2], [0, 1])
    np.testing.assert_array_equal(rows[2][3], [1.0, 2.0])
    with open(os.path.join(_FIX, "densevectorfile")) as f:
        dense = [V.from_string_dense(line)
                 for line in f.read().splitlines() if line]
    np.testing.assert_allclose(dense[0], [0.3, 0.2, 0.9])
