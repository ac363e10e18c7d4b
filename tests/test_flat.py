"""Quantized-flat engine vs the exact ground-truth engine."""

import numpy as np
import pytest

from similaritysearchbyrdf_tpu import DenseBatch, FlatIndex, exact_search


def _corpus(n=3000, d=48, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(64, d))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    x = centers[rng.integers(0, 64, n)] + 0.08 * rng.normal(size=(n, d))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x.astype(np.float32)


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_flat_matches_exact(dtype):
    x = _corpus()
    idx = FlatIndex(sketch_dtype=dtype, refine=64, block=512).fit(
        DenseBatch(np.arange(3000, dtype=np.int32), x)
    )
    q = x[:64]
    ids, scores = idx.query(q, k=10, query_ids=np.arange(64))
    gt_ids, gt_scores = exact_search(x, q, k=10, exclude_self=True)
    # recall@10 ≈ 1: the sketch only has to land the true top-10 inside the
    # refine=64 survivors; the exact rescoring then orders them perfectly
    hits = sum(
        len(set(map(int, ids[i])) & set(map(int, gt_ids[i])))
        for i in range(64)
    )
    assert hits / (64 * 10) >= 0.99
    # surviving overlap rows must carry exact f32 scores
    for i in range(4):
        common = set(map(int, ids[i])) & set(map(int, gt_ids[i]))
        for uid in common:
            a = scores[i][list(ids[i]).index(uid)]
            b = gt_scores[i][list(gt_ids[i]).index(uid)]
            np.testing.assert_allclose(a, b, rtol=1e-5)


def test_flat_excludes_self_and_pads():
    x = _corpus(n=1000, d=32)
    # n NOT a multiple of block exercises the pad/validity path
    idx = FlatIndex(refine=32, block=384, query_batch=128).fit(
        DenseBatch(np.arange(1000, dtype=np.int32), x)
    )
    ids, _ = idx.query(x[:50], k=5, query_ids=np.arange(50))
    assert ids.shape == (50, 5)
    for i in range(50):
        assert i not in set(map(int, ids[i]))
        assert all(v >= -1 and v < 1000 for v in ids[i])
    # without exclusion the query itself must win
    ids2, sc2 = idx.query(x[:50], k=1, exclude_self=False)
    assert (ids2[:, 0] == np.arange(50)).mean() >= 0.98


def test_flat_user_ids_and_dead_rows():
    x = _corpus(n=500, d=32)
    user_ids = 10_000 + np.arange(500, dtype=np.int32)
    user_ids[7] = -1          # dead row must never surface
    idx = FlatIndex(refine=32, block=256).fit(DenseBatch(user_ids, x))
    ids, _ = idx.query(x[:20], k=8, exclude_self=False)
    assert ids.min() >= 10_000 or (ids == -1).any()
    assert 9_999 not in set(ids.flatten().tolist())
    assert -1 not in set(ids[:, 0].tolist())  # top-1 always exists
    # row 7's user id is dead: its vector must not appear anywhere
    assert (ids != 10_007).all()


def test_flat_unfitted_contract():
    idx = FlatIndex()
    ids, scores = idx.query(np.zeros((3, 8), np.float32), k=4)
    assert ids.shape == (3, 4) and (ids == -1).all()


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_flat_save_load_roundtrip(tmp_path, dtype):
    from similaritysearchbyrdf_tpu.storage.persist import save_flat, load_flat

    x = _corpus(n=800, d=32, seed=4)
    idx = FlatIndex(sketch_dtype=dtype, refine=32, block=256).fit(
        DenseBatch(np.arange(800, dtype=np.int32), x)
    )
    a_ids, a_sc = idx.query(x[:20], k=5, query_ids=np.arange(20))
    save_flat(idx, str(tmp_path / "flat"))
    idx2 = load_flat(str(tmp_path / "flat"))
    b_ids, b_sc = idx2.query(x[:20], k=5, query_ids=np.arange(20))
    np.testing.assert_array_equal(a_ids, b_ids)
    np.testing.assert_allclose(a_sc, b_sc, rtol=1e-6)


def test_grouped_matches_flat():
    import jax.numpy as jnp

    from similaritysearchbyrdf_tpu.ops.flat import (
        build_flat_sketch, flat_topk, flat_topk_grouped,
    )

    x = _corpus(n=5000, d=48, seed=9)
    c = jnp.asarray(x)
    sk, _ = build_flat_sketch(c)
    rid = jnp.arange(5000, dtype=jnp.int32)
    q = jnp.asarray(x[:64])
    qi = jnp.arange(64, dtype=jnp.int32)
    a_ids, a_sc = flat_topk(sk, c, rid, q, qi, 10, refine=64, block=1024)
    b_ids, b_sc = flat_topk_grouped(sk, c, rid, q, qi, 10, refine=64,
                                    r_groups=32)
    # both rescore exactly; the grouped preselect cannot drop a true top-k
    np.testing.assert_allclose(np.asarray(a_sc), np.asarray(b_sc), rtol=1e-5)
    assert (np.asarray(a_ids) == np.asarray(b_ids)).mean() > 0.99


def test_argpack_candidates_top1_guarantee():
    """argpack's candidate set always contains the global sketch argmax
    (the top-1 row IS its group's argmax, and its group ranks first), and
    recall@10 with fresh queries stays near exact2's at moderate scale."""
    import jax.numpy as jnp

    from similaritysearchbyrdf_tpu.ops.flat import (build_flat_sketch,
                                                    flat_topk_grouped)

    rng = np.random.default_rng(4)
    n, d, b, k = 40000, 64, 64, 10
    x = rng.normal(size=(n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = rng.normal(size=(b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    c = jnp.asarray(x)
    sk, _ = build_flat_sketch(c)
    rid = jnp.arange(n, dtype=jnp.int32)
    qd = jnp.asarray(q)
    qi = jnp.full((b,), -1, jnp.int32)
    ids_a, _ = flat_topk_grouped(sk, c, rid, qd, qi, k, refine=128,
                                 select_mode="argpack",
                                 exclude_self=False)
    gt = np.argsort(-(q @ x.T), axis=1)
    ia = np.asarray(ids_a)
    assert (ia[:, 0] == gt[:, 0]).all()
    rec = np.mean([len(set(map(int, ia[i])) & set(map(int, gt[i, :k])))
                   for i in range(b)]) / k
    assert rec >= 0.95, rec


def test_flat_engine_through_front_end(tmp_path):
    """conf.engine='flat' routes the reference front-end surface through
    the quantized-flat engine (steps accepted and ignored)."""
    from similaritysearchbyrdf_tpu.config import RDFConfig
    from similaritysearchbyrdf_tpu.deploy.dense import DenseRDFInit

    x = _corpus(n=1500, d=32, seed=6)
    path = tmp_path / "vecs.txt"
    with open(path, "w") as f:
        for i, row in enumerate(x):
            f.write(f"{i},[{','.join(f'{v:.6f}' for v in row)}]\n")
    front = DenseRDFInit()
    conf = RDFConfig(vector_dim=32, table_num=2, permutation_num=1,
                     family_size=40, top_k=10, engine="flat")
    front.initializeRDFHashMap(conf)
    batch = front.newFastFit(str(path))
    assert batch.n == 1500
    ids, scores = front.forest.query(x[:16], steps=1,
                                     query_ids=np.arange(16))
    gt_ids, _ = exact_search(x, x[:16], k=10, exclude_self=True)
    hits = sum(len(set(map(int, ids[i])) & set(map(int, gt_ids[i])))
               for i in range(16))
    assert hits / 160 >= 0.99
    # key-based batch query path works through the adapter too
    out = front.query_batch([0, 5, 9], steps=1)
    assert len(out) == 3 and all(len(o) > 0 for o in out)


def _sparse_corpus(n=3000, vocab=512, nnz=16, seed=0):
    rng = np.random.default_rng(seed)
    idx = np.stack([
        np.sort(rng.choice(vocab, size=nnz, replace=False))
        for _ in range(n)
    ]).astype(np.int32)
    val = rng.lognormal(0.0, 0.4, size=(n, nnz)).astype(np.float32)
    val /= np.linalg.norm(val, axis=1, keepdims=True)
    return idx, val


def test_sparse_flat_matches_exact():
    from similaritysearchbyrdf_tpu.ops.exact import exact_topk_sparse
    from similaritysearchbyrdf_tpu.ops.flat import SparseFlatIndex
    from similaritysearchbyrdf_tpu.vectors import SparseBatch
    import jax.numpy as jnp

    n, vocab, nnz = 3000, 512, 16
    idx, val = _sparse_corpus(n, vocab, nnz)
    batch = SparseBatch(ids=np.arange(n, dtype=np.int32), size=vocab,
                        indices=idx, values=val,
                        lengths=np.full(n, nnz, np.int32))
    engine = SparseFlatIndex(refine=64, r_groups=16).fit(batch)
    nq = 48
    ids, scores = engine.query(idx[:nq], val[:nq], k=10,
                               query_ids=np.arange(nq))
    # exact GT via densified queries
    qd = np.zeros((nq, vocab), np.float32)
    np.put_along_axis(qd, idx[:nq], val[:nq], axis=1)
    gt_ids, gt_sc = exact_topk_sparse(
        jnp.asarray(idx), jnp.asarray(val), jnp.asarray(qd), 10,
        exclude_diag_offset=0,
    )
    gt_ids = np.asarray(gt_ids)
    hits = sum(len(set(map(int, ids[i])) & set(map(int, gt_ids[i])))
               for i in range(nq))
    assert hits / (nq * 10) >= 0.97
    # exact tail: overlapping results carry exact sparse-dot scores
    gt_sc = np.asarray(gt_sc)
    for i in range(4):
        common = set(map(int, ids[i])) & set(map(int, gt_ids[i]))
        for uidv in list(common)[:3]:
            a = scores[i][list(ids[i]).index(uidv)]
            bsc = gt_sc[i][list(gt_ids[i]).index(uidv)]
            np.testing.assert_allclose(a, bsc, rtol=1e-4)


def test_sparse_flat_excludes_self():
    from similaritysearchbyrdf_tpu.ops.flat import SparseFlatIndex
    from similaritysearchbyrdf_tpu.vectors import SparseBatch

    idx, val = _sparse_corpus(800, 256, 8, seed=3)
    batch = SparseBatch(ids=np.arange(800, dtype=np.int32), size=256,
                        indices=idx, values=val,
                        lengths=np.full(800, 8, np.int32))
    engine = SparseFlatIndex(refine=32, r_groups=8).fit(batch)
    ids, _ = engine.query(idx[:20], val[:20], k=5, query_ids=np.arange(20))
    for i in range(20):
        assert i not in set(map(int, ids[i]))
    ids2, _ = engine.query(idx[:20], val[:20], k=1, exclude_self=False)
    assert (ids2[:, 0] == np.arange(20)).mean() >= 0.9


def test_grouped_large_group_matches_flat():
    """group > 64 expands into several 64-row rescore windows; results
    must still match the plain scan at rescue-proof settings."""
    import jax.numpy as jnp

    from similaritysearchbyrdf_tpu.ops.flat import (
        build_flat_sketch, flat_topk, flat_topk_grouped,
    )

    x = _corpus(n=6000, d=48, seed=10)
    c = jnp.asarray(x)
    sk, _ = build_flat_sketch(c)
    rid = jnp.arange(6000, dtype=jnp.int32)
    q = jnp.asarray(x[:64])
    qi = jnp.arange(64, dtype=jnp.int32)
    a_ids, a_sc = flat_topk(sk, c, rid, q, qi, 10, refine=64, block=1024)
    for group in (256, 512):
        b_ids, b_sc = flat_topk_grouped(sk, c, rid, q, qi, 10, refine=64,
                                        r_groups=12, group=group)
        np.testing.assert_allclose(np.asarray(a_sc), np.asarray(b_sc),
                                   rtol=1e-5)
        assert (np.asarray(a_ids) == np.asarray(b_ids)).mean() > 0.99


def test_two_level_group_select_is_exact():
    """The hierarchical group select in _grouped_candidates (top-RG
    supergroups -> top-RG children) must return EXACTLY the top-RG groups:
    any top-RG group's supergroup has super-max >= the RG-th best group
    max, and at most RG supergroups can contain such a group. Checked
    against a brute-force top-RG over the group maxima."""
    import jax.numpy as jnp

    from similaritysearchbyrdf_tpu.ops.flat import _grouped_candidates

    rng = np.random.default_rng(17)
    n, d, b, group, rg = 65536, 16, 4, 64, 4
    x = rng.normal(size=(n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = x[:b] + 0.01 * rng.normal(size=(b, d)).astype(np.float32)
    sk = jnp.asarray(
        np.clip(np.round(x * (127.0 / np.abs(x).max())), -127, 127)
    ).astype(jnp.int8)

    cand, sel_s = _grouped_candidates(
        sk, jnp.asarray(q), refine=rg * group, r_groups=rg, group=group, recall_target=0.998,
    )
    # reference: exact top-rg groups by group-max of the same quantized dot
    qs = 127.0 / np.abs(q).max(axis=1, keepdims=True)
    qq = np.clip(np.round(q * qs), -127, 127).astype(np.int32)
    scores = np.asarray(sk, np.int32) @ qq.T                   # [N, B]
    gmax = scores.reshape(n // group, group, b).max(axis=1).T  # [B, NG]
    # the path requires ng % 64 == 0 and ng//64 >= 4*rg — holds here
    assert (n // group) % 64 == 0 and (n // group) // 64 >= 4 * rg
    for i in range(b):
        want = set(np.argsort(-gmax[i], kind="stable")[:rg].tolist())
        got_groups = set((np.asarray(cand[i]) // group).tolist())
        # candidate rows cover exactly the top-rg groups (ties can swap
        # members with equal gmax — accept any group whose max ties the
        # rg-th best)
        thr = np.sort(gmax[i])[-rg]
        assert all(gmax[i][g] >= thr for g in got_groups)
        assert len(got_groups) == rg
        # and every strictly-above-threshold group is present
        strict = {g for g in want if gmax[i][g] > thr}
        assert strict <= got_groups


@pytest.mark.parametrize("mode,sg", [("exact2", 8), ("exact2", 16),
                                     ("exact2", 64), ("topk", 64)])
def test_select_modes_agree(mode, sg):
    """Every exact select mode (two-level at any supergroup width, flat
    top_k) must pick the same top-RG groups — the two-level row-gather
    variant exists only to cut the child gather's element count."""
    import jax.numpy as jnp

    from similaritysearchbyrdf_tpu.ops.flat import _grouped_candidates

    rng = np.random.default_rng(23)
    n, d, b, group, rg = 65536, 16, 4, 64, 4
    x = rng.normal(size=(n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = x[:b] + 0.01 * rng.normal(size=(b, d)).astype(np.float32)
    sk = jnp.asarray(
        np.clip(np.round(x * (127.0 / np.abs(x).max())), -127, 127)
    ).astype(jnp.int8)

    base, base_s = _grouped_candidates(
        sk, jnp.asarray(q), refine=rg * group, r_groups=rg, group=group, recall_target=0.998,
        select_mode="topk", select_sg=64,
    )
    got, got_s = _grouped_candidates(
        sk, jnp.asarray(q), refine=rg * group, r_groups=rg, group=group, recall_target=0.998,
        select_mode=mode, select_sg=sg,
    )
    for i in range(b):
        want = set((np.asarray(base[i]) // group).tolist())
        have = set((np.asarray(got[i]) // group).tolist())
        assert want == have
    np.testing.assert_allclose(
        np.sort(np.asarray(base_s), axis=1),
        np.sort(np.asarray(got_s), axis=1), rtol=1e-5)


@pytest.mark.parametrize("mode", ["grouped", "scan"])
def test_flat_bf16_corpus_tier(mode, tmp_path):
    """corpus_dtype="bfloat16": the exact tier lives in bf16 (half the
    refine-gather traffic + HBM), dots accumulate in f32 — recall@10 vs
    exact GT must stay ~1 on separated clusters, and save/load roundtrips
    the dtype + results."""
    x = _corpus()
    idx = FlatIndex(refine=64, block=512, mode=mode,
                    corpus_dtype="bfloat16").fit(
        DenseBatch(np.arange(3000, dtype=np.int32), x)
    )
    import jax.numpy as jnp
    assert idx.corpus.dtype == jnp.bfloat16
    q = x[:64]
    ids, scores = idx.query(q, k=10, query_ids=np.arange(64))
    gt_ids, gt_scores = exact_search(x, q, k=10, exclude_self=True)
    hits = sum(
        len(set(map(int, ids[i])) & set(map(int, gt_ids[i])))
        for i in range(64)
    )
    assert hits / 640 >= 0.97, hits / 640
    # bf16 scores track the exact f32 scores to bf16 precision
    np.testing.assert_allclose(scores[:, 0], gt_scores[:, 0], rtol=2e-2)

    from similaritysearchbyrdf_tpu.storage.persist import load_flat, save_flat
    save_flat(idx, str(tmp_path / "m"))
    idx2 = load_flat(str(tmp_path / "m"))
    assert idx2.corpus.dtype == jnp.bfloat16
    ids2, _ = idx2.query(q, k=10, query_ids=np.arange(64))
    np.testing.assert_array_equal(ids, ids2)


def test_flat_query_chunks_capped_results_match():
    """Query-batch chunking must not change results: query in several
    chunks and compare against one-chunk ground truth."""
    rng = np.random.default_rng(9)
    x = rng.normal(size=(3000, 32)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    idx = FlatIndex(refine=64).fit(DenseBatch(np.arange(3000, dtype=np.int32), x))
    q = x[:300]
    ids_a, _ = idx.query(q, k=10, query_ids=np.arange(300))
    idx.query_batch = 128          # force multi-chunk
    ids_b, _ = idx.query(q, k=10, query_ids=np.arange(300))
    np.testing.assert_array_equal(ids_a, ids_b)


def test_argpack_l2_sort_matches_approx():
    """The exact 2-operand-sort level-2 must agree with the approx_max_k
    level-2."""
    from similaritysearchbyrdf_tpu.ops.flat import (_pad_lanes,
                                                    build_flat_sketch,
                                                    flat_topk_grouped)
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    n, d = 60_000, 32
    x = rng.normal(size=(n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    corpus = _pad_lanes(jnp.asarray(x))
    sketch, _ = build_flat_sketch(jnp.asarray(x), "int8")
    row_ids = jnp.arange(n, dtype=jnp.int32)
    q = jnp.asarray(x[:64])
    qids = jnp.arange(64, dtype=jnp.int32)
    kw = dict(refine=128, r_groups=24, select_mode="argpack", select_sg=4,
              exclude_self=True)
    ids_a, _ = flat_topk_grouped(sketch, corpus, row_ids, q, qids, 10,
                                 argpack_l2="approx", **kw)
    ids_s, _ = flat_topk_grouped(sketch, corpus, row_ids, q, qids, 10,
                                 argpack_l2="sort", **kw)
    ov = np.mean([len(set(map(int, np.asarray(ids_a)[i]))
                      & set(map(int, np.asarray(ids_s)[i])))
                  for i in range(64)])
    assert ov >= 9.5, ov


def test_default_select_sg_mode_dependent(monkeypatch):
    """Shipped defaults: sg=32 for argpack, sg=64 for exact2;
    FLAT_SELECT_SG env overrides both."""
    import similaritysearchbyrdf_tpu.ops.flat as F

    monkeypatch.setattr(F, "_SELECT_SG_ENV", None)
    assert F._default_select_sg("argpack") == 32
    assert F._default_select_sg("exact2") == 64
    monkeypatch.setattr(F, "_SELECT_SG_ENV", "16")
    assert F._default_select_sg("argpack") == 16
    assert F._default_select_sg("exact2") == 16
