"""End-to-end forest parity vs the scalar oracle, plus recall sanity —
the batched analogue of the reference's `TestSingleRDFSuite.scala`
experiments."""

import numpy as np
import jax.numpy as jnp

import oracle
from similaritysearchbyrdf_tpu.config import RDFConfig, TableConfig
from similaritysearchbyrdf_tpu.index.forest import RDFForest, query_dense
from similaritysearchbyrdf_tpu.vectors import DenseBatch


def _conf(**kw):
    base = dict(
        vector_dim=24,
        table_num=3,
        permutation_num=2,
        family_size=30,
        partition_bits=2,
        lsh_table=TableConfig(chain_length=12, bucket_overflow=16),
        query_batch_size=32,
        max_candidates=2048,
        seed=7,
    )
    base.update(kw)
    return RDFConfig(**base)


def _clustered_data(rng, n=1200, d=24, n_clusters=30):
    centers = rng.normal(size=(n_clusters, d))
    assign = rng.integers(0, n_clusters, size=n)
    x = centers[assign] + 0.15 * rng.normal(size=(n, d))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x.astype(np.float32)


def _oracle_query(forest, queries, steps, multiprobe, k, query_ids=None):
    """Full oracle pipeline: per-table hash+partition via device kernels
    (already unit-tested for parity), then scalar bucket/probe/dedup/rerank."""
    from similaritysearchbyrdf_tpu.ops.hashing import hash_dense
    from similaritysearchbyrdf_tpu.index.partitioner import partition_of_hash

    state = forest.state
    lay = forest.layout
    h = np.asarray(hash_dense(state.model, jnp.asarray(queries)))
    homes = np.asarray(partition_of_hash(jnp.asarray(h), state.part_proj))
    sk = np.asarray(state.tables.sorted_keys)
    si = np.asarray(state.tables.sorted_ids)
    # the stored corpus is lane-padded to 128; the oracle works in true D
    corpus = np.asarray(state.corpus)[:, : forest.conf.vector_dim]
    row_ids = np.asarray(state.row_ids)
    results = []
    for b in range(queries.shape[0]):
        cand_rows = oracle.query_candidates(
            [sk[t] for t in range(sk.shape[0])],
            [si[t] for t in range(sk.shape[0])],
            h[b], homes[b], lay.partition_bits, lay.seg_bits,
            lay.bits_per_level, lay.num_levels,
            forest.conf.lsh_table.bucket_overflow, steps, multiprobe,
        )
        exclude = -1
        if query_ids is not None:
            # exclusion is by user id
            cand_rows = {r for r in cand_rows if row_ids[r] != query_ids[b]}
        top_rows = oracle.exact_topk(corpus, cand_rows, queries[b], k, exclude)
        results.append([int(row_ids[r]) for r in top_rows])
    return results


def test_query_matches_oracle_no_probe():
    rng = np.random.default_rng(0)
    x = _clustered_data(rng)
    conf = _conf()
    forest = RDFForest(conf).fit(DenseBatch(np.arange(len(x), dtype=np.int32), x))
    q = x[:24]
    ids, scores = forest.query(q, steps=0, multiprobe=False)
    expect = _oracle_query(forest, q, steps=0, multiprobe=False, k=conf.top_k)
    for b in range(len(q)):
        got = [i for i in ids[b] if i >= 0]
        assert got == expect[b], b


def test_query_matches_oracle_multiprobe_steps():
    rng = np.random.default_rng(1)
    x = _clustered_data(rng, n=800)
    conf = _conf(max_candidates=4096)
    forest = RDFForest(conf).fit(DenseBatch(np.arange(len(x), dtype=np.int32), x))
    q = x[10:26]
    for steps in (0, 1):
        ids, scores = forest.query(q, steps=steps, multiprobe=True)
        expect = _oracle_query(forest, q, steps=steps, multiprobe=True, k=conf.top_k)
        for b in range(len(q)):
            got = [i for i in ids[b] if i >= 0]
            assert got == expect[b], (steps, b)


def test_query_excludes_self():
    rng = np.random.default_rng(2)
    x = _clustered_data(rng, n=600)
    conf = _conf()
    qids = np.arange(len(x), dtype=np.int32)
    forest = RDFForest(conf).fit(DenseBatch(qids, x))
    q = x[:16]
    ids, _ = forest.query(q, steps=0, query_ids=qids[:16])
    for b in range(16):
        assert qids[b] not in set(ids[b].tolist())
    expect = _oracle_query(forest, q, steps=0, multiprobe=True,
                           k=conf.top_k, query_ids=qids[:16])
    for b in range(16):
        got = [i for i in ids[b] if i >= 0]
        assert got == expect[b], b


def test_stepwise_grows_candidates():
    """More steps must never shrink the candidate set — mirrors the
    reference's step-wise growth experiment (`TestSingleRDFSuite.scala:95`)."""
    rng = np.random.default_rng(3)
    x = _clustered_data(rng, n=1000)
    conf = _conf()
    forest = RDFForest(conf).fit(DenseBatch(np.arange(len(x), dtype=np.int32), x))
    q = x[:16]
    totals = []
    for steps in (0, 1, 2):
        _, _, ncand = query_dense(
            forest.state, jnp.asarray(q),
            jnp.full((16,), -1, dtype=jnp.int32), forest.layout,
            steps=steps, m_cap=conf.max_candidates, k=10,
        )
        totals.append(np.asarray(ncand))
    assert (totals[1] >= totals[0]).all()
    assert (totals[2] >= totals[1]).all()


def test_recall_reasonable_on_clustered_data():
    rng = np.random.default_rng(4)
    x = _clustered_data(rng, n=2000, n_clusters=40)
    conf = _conf(table_num=6, permutation_num=2)
    forest = RDFForest(conf).fit(DenseBatch(np.arange(len(x), dtype=np.int32), x))
    q = x[:64]
    ids, _ = forest.query(q, steps=1, query_ids=np.arange(64))
    sims = q @ x.T
    recall = 0.0
    for i in range(64):
        order = np.argsort(-sims[i], kind="stable")
        gt = [j for j in order if j != i][:10]
        recall += len(set(gt) & set(int(v) for v in ids[i] if v >= 0)) / 10
    recall /= 64
    assert recall > 0.5, recall


def test_add_incremental():
    rng = np.random.default_rng(5)
    x = _clustered_data(rng, n=500)
    conf = _conf()
    forest = RDFForest(conf).fit(DenseBatch(np.arange(300, dtype=np.int32), x[:300]))
    forest.add(DenseBatch(np.arange(300, 500, dtype=np.int32), x[300:]))
    assert forest.size() == 500
    ids, _ = forest.query(x[:8], steps=0)
    assert (np.asarray(ids) >= -1).all()


def test_empty_and_tiny_corpus():
    conf = _conf()
    rng = np.random.default_rng(6)
    x = rng.normal(size=(3, 24)).astype(np.float32)
    forest = RDFForest(conf).fit(DenseBatch(np.arange(3, dtype=np.int32), x))
    ids, scores = forest.query(x, steps=0)
    assert ids.shape == (3, conf.top_k)


def test_coarse_tier_exhaustive_matches_reference_path():
    """With refine >= m_cap the coarse path exactly re-scores every
    candidate, so results must match the reference scoring path
    id-for-id."""
    from similaritysearchbyrdf_tpu.config import RDFConfig, TableConfig
    from similaritysearchbyrdf_tpu.index.forest import RDFForest
    from similaritysearchbyrdf_tpu.vectors import DenseBatch

    base = dict(
        vector_dim=24, table_num=3, permutation_num=2, family_size=30,
        partition_bits=2, lsh_table=TableConfig(chain_length=12,
                                                bucket_overflow=16),
        query_batch_size=16, max_candidates=1024, top_k=8, seed=11,
    )
    rng = np.random.default_rng(4)
    centers = rng.normal(size=(12, 24))
    x = centers[rng.integers(0, 12, 500)] + 0.1 * rng.normal(size=(500, 24))
    x = (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)
    batch = DenseBatch(np.arange(500, dtype=np.int32), x)

    ref = RDFForest(RDFConfig(**base)).fit(batch)
    co = RDFForest(RDFConfig(**base, coarse_dim=16,
                             coarse_refine=1024)).fit(batch)
    ids_a, sc_a = ref.query(x[:16], steps=1, query_ids=np.arange(16))
    ids_b, sc_b = co.query(x[:16], steps=1, query_ids=np.arange(16))
    np.testing.assert_array_equal(ids_a, ids_b)
    np.testing.assert_allclose(sc_a, sc_b, rtol=1e-5)


def test_coarse_tier_small_refine_recall():
    """A narrow refine slice must still recover nearly all of the
    exhaustive path's top-k on clustered data."""
    from similaritysearchbyrdf_tpu.config import RDFConfig, TableConfig
    from similaritysearchbyrdf_tpu.index.forest import RDFForest
    from similaritysearchbyrdf_tpu.vectors import DenseBatch

    base = dict(
        vector_dim=24, table_num=3, permutation_num=2, family_size=30,
        partition_bits=2, lsh_table=TableConfig(chain_length=12,
                                                bucket_overflow=16),
        query_batch_size=16, max_candidates=2048, top_k=10, seed=11,
    )
    rng = np.random.default_rng(5)
    centers = rng.normal(size=(12, 24))
    x = centers[rng.integers(0, 12, 2000)] + 0.1 * rng.normal(size=(2000, 24))
    x = (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)
    batch = DenseBatch(np.arange(2000, dtype=np.int32), x)

    ref = RDFForest(RDFConfig(**base)).fit(batch)
    co = RDFForest(RDFConfig(**base, coarse_dim=24,
                             coarse_refine=256)).fit(batch)  # full-dim int8
    ids_a, _ = ref.query(x[:32], steps=1, query_ids=np.arange(32))
    ids_b, _ = co.query(x[:32], steps=1, query_ids=np.arange(32))
    hits = 0
    for i in range(32):
        hits += len(set(ids_a[i][ids_a[i] >= 0].tolist())
                    & set(ids_b[i][ids_b[i] >= 0].tolist()))
    assert hits / max((ids_a >= 0).sum(), 1) > 0.95


def test_coarse_window_mode_matches_reference_path():
    """coarse_window forces the aligned-window flatten; with exhaustive
    refine it must still match the classic scoring path id-for-id (window
    head/tail rows masked correctly)."""
    from similaritysearchbyrdf_tpu.config import RDFConfig, TableConfig
    from similaritysearchbyrdf_tpu.index.forest import RDFForest
    from similaritysearchbyrdf_tpu.vectors import DenseBatch

    base = dict(
        vector_dim=24, table_num=3, permutation_num=2, family_size=30,
        partition_bits=2, lsh_table=TableConfig(chain_length=12,
                                                bucket_overflow=16),
        query_batch_size=16, max_candidates=4096, top_k=8, seed=19,
    )
    rng = np.random.default_rng(6)
    centers = rng.normal(size=(12, 24))
    x = centers[rng.integers(0, 12, 700)] + 0.1 * rng.normal(size=(700, 24))
    x = (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)
    batch = DenseBatch(np.arange(700, dtype=np.int32), x)

    ref = RDFForest(RDFConfig(**base)).fit(batch)
    co = RDFForest(RDFConfig(**base, coarse_dim=24, coarse_refine=4096,
                             coarse_window=64)).fit(batch)
    ids_a, sc_a = ref.query(x[:16], steps=1, query_ids=np.arange(16))
    ids_b, sc_b = co.query(x[:16], steps=1, query_ids=np.arange(16))
    np.testing.assert_array_equal(ids_a, ids_b)
    np.testing.assert_allclose(sc_a, sc_b, rtol=1e-5)


def test_coarse_window_end_of_table_clamp():
    """A live window within `win` of the table's end used to be CLIPPED
    inside the gather while `pos` kept the unclipped start — its live rows
    scored against SHIFTED source rows. The clamp-before-pos fix keeps
    score[j] == dot(q, tier[pos[j]]) for every valid slot, including
    windows whose unclipped span would run past caprows."""
    from similaritysearchbyrdf_tpu.index.forest import _coarse_block_scores

    rng = np.random.default_rng(8)
    caprows, d, cs, win = 128, 16, 128, 64
    tier = jnp.asarray(
        rng.integers(-127, 128, (1, caprows, cs), dtype=np.int8)
    )
    proj = jnp.asarray(np.eye(d, cs, dtype=np.float32))
    q = jnp.asarray(rng.normal(size=(1, d)).astype(np.float32))
    # window start 96: unclipped span [96, 160) exceeds caprows=128, live
    # rows [100, 124) sit entirely inside the table
    base_b = jnp.asarray([[96]], jnp.int32)
    table_b2 = jnp.zeros((1, 1), jnp.int32)
    start_b = jnp.asarray([[100]], jnp.int32)
    end_b = jnp.asarray([[124]], jnp.int32)
    scores, pos, _ = _coarse_block_scores(
        tier, proj, q, base_b, table_b2, end_b, win,
        start_b=start_b, abs_starts=True,
    )
    scores, pos = np.asarray(scores)[0], np.asarray(pos)[0]
    q_low = np.asarray((q @ proj).astype(jnp.bfloat16))[0]
    tier_np = np.asarray(tier)[0]
    # bf16 products accumulated in f32 (the einsum's preferred_element_type)
    q32 = np.asarray(jnp.asarray(q_low).astype(jnp.bfloat16)).astype(
        np.float32
    )
    for j in range(win):
        if 100 <= pos[j] < 124:
            row32 = np.asarray(
                jnp.asarray(tier_np[pos[j]]).astype(jnp.bfloat16)
            ).astype(np.float32)
            want = float((row32 * q32).sum())
            np.testing.assert_allclose(scores[j], want, rtol=1e-3)
        else:
            assert scores[j] == -np.inf, (j, pos[j], scores[j])


def test_coarse_window_tournament_prefilter_recall():
    """With refine << m_cap the window path engages the strided 4-way
    max-tournament prefilter (approximate select). It must still recover
    nearly all of the exhaustive-refine window path's answers — a row is
    dropped only when a better row lands in its strided 4-member group,
    and bucket-mates (consecutive slots) are spread across groups."""
    from similaritysearchbyrdf_tpu.config import RDFConfig, TableConfig
    from similaritysearchbyrdf_tpu.index.forest import RDFForest
    from similaritysearchbyrdf_tpu.vectors import DenseBatch

    base = dict(
        vector_dim=24, table_num=3, permutation_num=2, family_size=30,
        partition_bits=2, lsh_table=TableConfig(chain_length=12,
                                                bucket_overflow=16),
        query_batch_size=16, max_candidates=8192, top_k=8, seed=19,
    )
    rng = np.random.default_rng(8)
    centers = rng.normal(size=(12, 24))
    x = centers[rng.integers(0, 12, 900)] + 0.1 * rng.normal(size=(900, 24))
    x = (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)
    batch = DenseBatch(np.arange(900, dtype=np.int32), x)

    full = RDFForest(RDFConfig(**base, coarse_dim=24, coarse_refine=8192,
                               coarse_window=64)).fit(batch)
    pre = RDFForest(RDFConfig(**base, coarse_dim=24, coarse_refine=512,
                              coarse_window=64)).fit(batch)
    ids_a, _ = full.query(x[:16], steps=1, query_ids=np.arange(16))
    ids_b, _ = pre.query(x[:16], steps=1, query_ids=np.arange(16))
    hits = total = 0
    for i in range(16):
        ga = set(ids_a[i][ids_a[i] >= 0].tolist())
        gb = set(ids_b[i][ids_b[i] >= 0].tolist())
        hits += len(ga & gb)
        total += len(ga)
    assert hits / max(total, 1) > 0.9, hits / max(total, 1)


def test_head_tier_masked_mean():
    """`build_head_tier` = masked mean of each `hp` consecutive coarse rows
    per lane segment (padding rows excluded from the divisor)."""
    from similaritysearchbyrdf_tpu.config import RDFConfig, TableConfig
    from similaritysearchbyrdf_tpu.index.forest import RDFForest
    from similaritysearchbyrdf_tpu.vectors import DenseBatch

    rng = np.random.default_rng(3)
    centers = rng.normal(size=(10, 24))
    x = centers[rng.integers(0, 10, 500)] + 0.1 * rng.normal(size=(500, 24))
    x = (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)
    hp = 16
    conf = RDFConfig(
        vector_dim=24, table_num=3, permutation_num=2, family_size=30,
        partition_bits=2, lsh_table=TableConfig(chain_length=12,
                                                bucket_overflow=16),
        query_batch_size=16, max_candidates=4096, top_k=8, seed=19,
        coarse_dim=8, coarse_refine=4096, coarse_window=64,
        coarse_head_pool=hp,
    )
    f = RDFForest(conf).fit(DenseBatch(np.arange(500, dtype=np.int32), x))
    st = f.state
    assert st.coarse_head is not None
    cbt = np.asarray(st.coarse_by_table, dtype=np.float32)
    si = np.asarray(st.tables.sorted_ids)
    lg_n, caprows, lanes = cbt.shape
    cs = st.coarse_proj.shape[1]
    g = lanes // cs
    l = si.shape[0]
    hr = (caprows + hp - 1) // hp
    pad = hr * hp - caprows
    sums = np.pad(cbt, ((0, 0), (0, pad), (0, 0))).reshape(
        lg_n, hr, hp, lanes).sum(axis=2)
    cnt = np.pad((si >= 0).astype(np.int32), ((0, 0), (0, pad))).reshape(
        l, hr, hp).sum(axis=2)
    if lg_n * g != l:
        cnt = np.concatenate(
            [cnt, np.zeros((lg_n * g - l, hr), np.int32)], axis=0)
    cnt = cnt.reshape(lg_n, g, hr).transpose(0, 2, 1)
    ref = sums / np.maximum(np.repeat(cnt, cs, axis=2), 1)
    got = np.asarray(st.coarse_head, dtype=np.float32)
    assert got.shape == (lg_n, hr, lanes)
    scale = np.abs(ref).max() + 1e-9
    assert np.abs(ref - got).max() / scale < 0.01  # bf16 rounding only


def test_window_prune_keeps_all_is_parity():
    """Two-phase pruning with `window_keep` large enough to cover every
    live window must return the same top-k as the unpruned window path
    when refine is exhaustive for both slab widths (the pruned slab is a
    reordered subset containing all live windows)."""
    from similaritysearchbyrdf_tpu.config import RDFConfig, TableConfig
    from similaritysearchbyrdf_tpu.index.forest import RDFForest
    from similaritysearchbyrdf_tpu.vectors import DenseBatch

    base = dict(
        vector_dim=24, table_num=3, permutation_num=2, family_size=30,
        partition_bits=2, lsh_table=TableConfig(chain_length=12,
                                                bucket_overflow=16),
        query_batch_size=16, max_candidates=4096, top_k=8, seed=19,
    )
    rng = np.random.default_rng(5)
    centers = rng.normal(size=(12, 24))
    x = centers[rng.integers(0, 12, 700)] + 0.1 * rng.normal(size=(700, 24))
    x = (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)
    batch = DenseBatch(np.arange(700, dtype=np.int32), x)

    f = RDFForest(RDFConfig(**base, coarse_dim=24, coarse_refine=4096,
                            coarse_window=64, coarse_head_pool=8)).fit(batch)
    # keep = MB-1 engages the prune machinery (< m_cap//win) while still
    # covering every live window: 700 rows / 64-slot windows across 6
    # tables * few probes << 63 windows
    keep = base["max_candidates"] // 64 - 1
    ids_a, sc_a = f.query(x[:16], steps=1, query_ids=np.arange(16),
                          window_keep=0)
    ids_b, sc_b = f.query(x[:16], steps=1, query_ids=np.arange(16),
                          window_keep=keep)
    np.testing.assert_array_equal(ids_a, ids_b)
    np.testing.assert_allclose(sc_a, sc_b, rtol=1e-5)


def test_prune_windows_slot_order():
    """Survivors of `_prune_windows` must come out in ascending slot
    (address) order: the window flatten lays ranges out as adjacent slots
    = adjacent source rows, so the gather after the prune reads rows in
    address order; a score-ordered prune would scatter it."""
    import jax.numpy as jnp

    from similaritysearchbyrdf_tpu.index.forest import _prune_windows

    rng = np.random.default_rng(0)
    b, mb, win, hp, keep = 4, 32, 16, 8, 8
    lg_n, hr, lanes = 3, 64, 16
    head = jnp.asarray(rng.normal(size=(lg_n, hr, lanes)),
                       dtype=jnp.bfloat16)
    q_low = jnp.asarray(rng.normal(size=(b, lanes)), dtype=jnp.bfloat16)
    # a few live ranges per query, each spanning 2-4 windows
    start = rng.integers(0, hr * hp - 4 * win, size=(b, mb)).astype(np.int32)
    start = np.sort(start, axis=1)
    base = (start // win) * win
    end = start + rng.integers(win, 4 * win, size=(b, mb)).astype(np.int32)
    table = rng.integers(0, lg_n, size=(b, mb)).astype(np.int32)
    bb, tb, sb, eb = _prune_windows(
        head, hp, q_low, None, jnp.asarray(base), jnp.asarray(table),
        jnp.asarray(start), jnp.asarray(end), win, keep, 1,
    )
    bb = np.asarray(bb)
    # blk_start[slot] = base[slot] + slot*win is strictly increasing per
    # query (base is sorted), so slot-ordered survivors must be too
    assert (np.diff(bb, axis=1) > 0).all(), bb


def test_window_prune_recall_sane():
    """Aggressive pruning (keep = a quarter of the windows) on clustered
    data should preserve most of the unpruned answers — the head proxy
    ranks the home/near buckets far above the tail."""
    from similaritysearchbyrdf_tpu.config import RDFConfig, TableConfig
    from similaritysearchbyrdf_tpu.index.forest import RDFForest
    from similaritysearchbyrdf_tpu.vectors import DenseBatch

    base = dict(
        vector_dim=24, table_num=3, permutation_num=2, family_size=30,
        partition_bits=2, lsh_table=TableConfig(chain_length=12,
                                                bucket_overflow=16),
        query_batch_size=16, max_candidates=4096, top_k=8, seed=19,
    )
    rng = np.random.default_rng(9)
    centers = rng.normal(size=(12, 24))
    x = centers[rng.integers(0, 12, 900)] + 0.1 * rng.normal(size=(900, 24))
    x = (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)
    batch = DenseBatch(np.arange(900, dtype=np.int32), x)

    f = RDFForest(RDFConfig(**base, coarse_dim=24, coarse_refine=4096,
                            coarse_window=64, coarse_head_pool=8,
                            coarse_keep=16)).fit(batch)
    ids_a, _ = f.query(x[:16], steps=1, query_ids=np.arange(16),
                       window_keep=0)
    ids_b, _ = f.query(x[:16], steps=1, query_ids=np.arange(16))  # conf keep
    hits = total = 0
    for i in range(16):
        ga = set(ids_a[i][ids_a[i] >= 0].tolist())
        gb = set(ids_b[i][ids_b[i] >= 0].tolist())
        hits += len(ga & gb)
        total += len(ga)
    assert hits / max(total, 1) > 0.85, hits / max(total, 1)


def test_dense_similarity_threshold_filter():
    """similarity_threshold > 0 post-filters results by exact score — the
    live equivalent of the reference's dead hash-distance filter
    (`RandomDrawTreeMap.java:856-868`)."""
    rng = np.random.default_rng(17)
    x = _clustered_data(rng, n=400)
    batch = DenseBatch(np.arange(len(x), dtype=np.int32), x)
    base = RDFForest(_conf()).fit(batch)
    ids0, sc0 = base.query(x[:8], steps=1, query_ids=np.arange(8))
    finite = np.isfinite(sc0)
    assert finite.any()
    thr = float(np.median(sc0[finite]))
    filt = RDFForest(_conf(similarity_threshold=thr)).fit(batch)
    ids1, sc1 = filt.query(x[:8], steps=1, query_ids=np.arange(8))
    keep = sc0 >= thr
    np.testing.assert_array_equal(ids1, np.where(keep, ids0, -1))
    assert (sc1[~keep] == -np.inf).all()


def test_pstable_forest_end_to_end():
    """pStable family end-to-end: model width is tableNum (the reference's
    pick ignores permutationNum, `PStableHashFamily.scala:59-77`), so the
    partition chains must size by `conf.hash_tables` — fit+query must work
    and recall clustered structure (regression: r2 sizing bug)."""
    from similaritysearchbyrdf_tpu.config import RDFConfig, TableConfig
    from similaritysearchbyrdf_tpu.index.forest import RDFForest
    from similaritysearchbyrdf_tpu.ops.exact import exact_search
    from similaritysearchbyrdf_tpu.vectors import DenseBatch

    rng = np.random.default_rng(3)
    centers = rng.normal(size=(50, 16))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    x = centers[rng.integers(0, 50, 4000)] + 0.05 * rng.normal(size=(4000, 16))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    x = x.astype(np.float32)
    conf = RDFConfig(
        vector_dim=16, table_num=4, permutation_num=2, family_size=20,
        partition_bits=2, family_name="pStable",
        lsh_table=TableConfig(chain_length=8, bucket_overflow=50),
    )
    forest = RDFForest(conf).fit(DenseBatch(np.arange(4000, dtype=np.int32), x))
    assert forest.state.tables.num_tables == conf.hash_tables == 4
    got, _ = forest.query(x[:200], steps=1, query_ids=np.arange(200))
    gt, _ = exact_search(x, x[:200], k=10, exclude_self=True)
    gt = np.asarray(gt)
    hits = sum(
        len(set(gt[i].tolist()) & set(int(v) for v in got[i] if v >= 0))
        for i in range(200)
    )
    assert hits / 2000 > 0.9


def test_fit_from_device_resident_values_matches_host():
    """fit_dense must accept a DenseBatch whose values are already a
    device array (steady-state refits skip the host staging + upload) and
    produce bit-identical state."""
    from similaritysearchbyrdf_tpu.index.forest import fit_dense

    rng = np.random.default_rng(33)
    x = rng.normal(size=(700, 24)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    ids = np.arange(700, dtype=np.int32)
    conf = RDFConfig(
        vector_dim=24, table_num=3, permutation_num=1, family_size=30,
        partition_bits=2,
        lsh_table=TableConfig(chain_length=12, bucket_overflow=16),
        query_batch_size=32, max_candidates=2048, top_k=5, seed=11,
        coarse_dim=8, coarse_refine=512,
    )
    host = RDFForest(conf).fit(DenseBatch(ids, x))
    dev = RDFForest(conf)
    dev.model, dev.part_proj = host.model, host.part_proj
    dev.state = fit_dense(conf, DenseBatch(ids, jnp.asarray(x)),
                          model=host.model, part_proj=host.part_proj,
                          nb_pad=host.state.tables.bucket_keys.shape[1])
    np.testing.assert_array_equal(
        np.asarray(host.state.tables.sorted_keys),
        np.asarray(dev.state.tables.sorted_keys))
    np.testing.assert_array_equal(
        np.asarray(host.state.tables.sorted_ids),
        np.asarray(dev.state.tables.sorted_ids))
    np.testing.assert_array_equal(
        np.asarray(host.state.corpus), np.asarray(dev.state.corpus))
    a, sa = host.query(x[:8], steps=1, query_ids=np.arange(8))
    b, sb = dev.query(x[:8], steps=1, query_ids=np.arange(8))
    np.testing.assert_array_equal(a, b)
