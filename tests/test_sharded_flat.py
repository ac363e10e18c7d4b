"""Mesh-sharded flat engine on the 8-device virtual CPU mesh: parity with
the single-device FlatIndex and the exact engine."""

import numpy as np

from similaritysearchbyrdf_tpu import DenseBatch, FlatIndex, exact_search
from similaritysearchbyrdf_tpu.parallel.sharded_flat import ShardedFlatIndex


def _data(n=2000, d=32, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(40, d))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    x = centers[rng.integers(0, 40, n)] + 0.1 * rng.normal(size=(n, d))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x.astype(np.float32)


def test_sharded_flat_matches_exact():
    x = _data()
    batch = DenseBatch(np.arange(2000, dtype=np.int32), x)
    sharded = ShardedFlatIndex(refine=64, block=128).fit(batch)
    assert sharded.mesh.shape["shard"] == 8
    q = x[:48]
    ids, scores = sharded.query(q, k=10, query_ids=np.arange(48))
    gt_ids, gt_scores = exact_search(x, q, k=10, exclude_self=True)
    hits = sum(
        len(set(map(int, ids[i])) & set(map(int, gt_ids[i])))
        for i in range(48)
    )
    assert hits / 480 >= 0.99
    np.testing.assert_allclose(scores[:, 0], gt_scores[:, 0], rtol=1e-5)


def test_sharded_flat_matches_single_device():
    # n NOT a multiple of ndev exercises shard padding (-1 row ids)
    x = _data(n=1997, seed=3)
    uids = 500 + np.arange(1997, dtype=np.int32)
    batch = DenseBatch(uids, x)
    single = FlatIndex(refine=64, block=256).fit(batch)
    sharded = ShardedFlatIndex(refine=64, block=128).fit(batch)
    q = x[100:148]
    qi = uids[100:148]
    a_ids, a_sc = single.query(q, k=8, query_ids=qi)
    b_ids, b_sc = sharded.query(q, k=8, query_ids=qi)
    # both exclude self and rescore exactly; ties can reorder equal scores
    np.testing.assert_allclose(a_sc, b_sc, rtol=1e-5)
    same = (a_ids == b_ids).mean()
    assert same > 0.95
    for i in range(48):
        assert int(qi[i]) not in set(map(int, b_ids[i]))


def test_sharded_flat_unfitted():
    idx = ShardedFlatIndex()
    ids, _ = idx.query(np.zeros((2, 8), np.float32), k=3)
    assert ids.shape == (2, 3) and (ids == -1).all()


def _sparse_data(n=800, d=256, nnz=10, seed=5):
    from similaritysearchbyrdf_tpu.vectors import sparse_batch_from_rows

    rng = np.random.default_rng(seed)
    centers = [rng.choice(d, size=nnz, replace=False) for _ in range(25)]
    rows, ids = [], []
    for i in range(n):
        c = int(rng.integers(0, 25))
        idx = np.sort(centers[c])
        val = 1.0 + 0.1 * rng.normal(size=nnz)
        rows.append((idx, val.astype(np.float64)))
        ids.append(i)
    return sparse_batch_from_rows(ids, d, rows, nnz_pad=nnz)


def test_sharded_sparse_flat_matches_single_device():
    from similaritysearchbyrdf_tpu.ops.flat import SparseFlatIndex
    from similaritysearchbyrdf_tpu.parallel.sharded_flat import (
        ShardedSparseFlatIndex,
    )

    batch = _sparse_data(n=797)           # non-multiple of 8: shard padding
    single = SparseFlatIndex(refine=64).fit(batch)
    sharded = ShardedSparseFlatIndex(refine=64).fit(batch)
    assert sharded.mesh.shape["shard"] == 8
    qi = batch.indices[:32]
    qv = batch.values[:32]
    qids = batch.ids[:32].astype(np.int32)
    a_ids, a_sc = single.query(qi, qv, k=8, query_ids=qids)
    b_ids, b_sc = sharded.query(qi, qv, k=8, query_ids=qids)
    np.testing.assert_allclose(a_sc, b_sc, rtol=1e-5)
    assert (a_ids == b_ids).mean() > 0.95   # ties may reorder equal scores
    for i in range(32):
        assert int(qids[i]) not in set(map(int, b_ids[i]))


def test_sharded_sparse_flat_unfitted():
    from similaritysearchbyrdf_tpu.parallel.sharded_flat import (
        ShardedSparseFlatIndex,
    )

    idx = ShardedSparseFlatIndex()
    ids, _ = idx.query(np.zeros((2, 4), np.int32), np.zeros((2, 4), np.float32), k=3)
    assert ids.shape == (2, 3) and (ids == -1).all()


def test_sharded_flat_save_load_roundtrip(tmp_path):
    """Mesh-engine checkpoint for the flat engine; rows are shard-agnostic
    so the round trip must hold query results bit-equal."""
    from similaritysearchbyrdf_tpu import save_sharded_flat, load_sharded_flat
    from similaritysearchbyrdf_tpu.parallel.sharded_flat import ShardedFlatIndex
    from similaritysearchbyrdf_tpu.vectors import DenseBatch

    rng = np.random.default_rng(3)
    x = rng.normal(size=(640, 24)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    idx = ShardedFlatIndex(refine=64).fit(
        DenseBatch(np.arange(640, dtype=np.int32), x))
    p = str(tmp_path / "sflat")
    save_sharded_flat(idx, p)
    idx2 = load_sharded_flat(p)
    q = x[:16]
    i1, s1 = idx.query(q, k=5, query_ids=np.arange(16))
    i2, s2 = idx2.query(q, k=5, query_ids=np.arange(16))
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(s1, s2, rtol=1e-6)


def test_sharded_flat_grouped_matches_scan():
    """Grouped mode (per-chip fused gmax + window rescore) returns the same
    ids/scores as scan mode across the 8-device mesh."""
    x = _data(n=3011, seed=5)
    uids = np.arange(3011, dtype=np.int32)
    batch = DenseBatch(uids, x)
    scan = ShardedFlatIndex(refine=64, block=128, mode="scan").fit(batch)
    grp = ShardedFlatIndex(refine=64, mode="grouped").fit(batch)
    q = x[:48]
    qi = uids[:48]
    a_ids, a_sc = scan.query(q, k=10, query_ids=qi)
    b_ids, b_sc = grp.query(q, k=10, query_ids=qi)
    np.testing.assert_allclose(a_sc, b_sc, rtol=1e-5)
    assert (a_ids == b_ids).mean() > 0.95   # ties may reorder equal scores


def test_sharded_flat_halved_gmax_matches():
    """A sharded flat index saved before the strided gmax sketch copy was
    removed (its sidecar carries "gmax_halved": true) still loads, and the
    loaded index returns what the saved one did."""
    import json
    import tempfile

    from similaritysearchbyrdf_tpu.storage.persist import (
        load_sharded_flat, save_sharded_flat)

    x = _data(n=2500, seed=7)
    uids = np.arange(2500, dtype=np.int32)
    batch = DenseBatch(uids, x)
    idx = ShardedFlatIndex(refine=64, mode="grouped").fit(batch)
    q = x[:32]
    a_ids, a_sc = idx.query(q, k=10, query_ids=uids[:32])
    with tempfile.TemporaryDirectory() as td:
        save_sharded_flat(idx, td + "/sf")
        with open(td + "/sf.json") as f:
            meta = json.load(f)
        assert "gmax_halved" not in meta
        meta["gmax_halved"] = True
        with open(td + "/sf.json", "w") as f:
            json.dump(meta, f)
        back = load_sharded_flat(td + "/sf")
        assert not hasattr(back.state, "sketch_gmax")
        b_ids, b_sc = back.query(q, k=10, query_ids=uids[:32])
    np.testing.assert_allclose(a_sc, b_sc, rtol=1e-5)
    assert (a_ids == b_ids).all()
