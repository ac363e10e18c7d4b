"""Tiered persistence at many generations (not only 2-3)."""

import numpy as np

from similaritysearchbyrdf_tpu.config import RDFConfig, TableConfig
from similaritysearchbyrdf_tpu.storage.persist import (GenerationStore,
                                                       TieredForest)
from similaritysearchbyrdf_tpu.vectors import DenseBatch


def _conf(seed=9):
    return RDFConfig(
        vector_dim=16, table_num=2, permutation_num=1, family_size=20,
        partition_bits=2, lsh_table=TableConfig(chain_length=24,
                                                bucket_overflow=16),
        query_batch_size=16, max_candidates=512, top_k=5, seed=seed,
    )


def _clustered(rng, n, d, centers):
    cid = rng.integers(0, len(centers), n)
    x = centers[cid] + 0.03 * rng.normal(size=(n, d))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x.astype(np.float32), cid


def test_eight_generations_merge_and_gate(tmp_path):
    """8 spilled generations, each holding a disjoint cluster region:
    (1) the merged query finds the true nearest across all generations,
    (2) the exact key-summary gate loads a strict subset of generations
    for cluster-local queries, (3) gated results == ungated results."""
    rng = np.random.default_rng(0)
    d, per_gen, n_gens = 16, 96, 8
    centers = rng.normal(size=(n_gens, d))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    conf = _conf()
    store = GenerationStore(str(tmp_path), "g")
    tiered = TieredForest(conf, store)
    all_x = []
    for g in range(n_gens):
        x = centers[g] + 0.03 * rng.normal(size=(per_gen, d))
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        x = x.astype(np.float32)
        all_x.append(x)
        tiered.fit(DenseBatch(
            np.arange(g * per_gen, (g + 1) * per_gen, dtype=np.int32), x))
        tiered.spill()
    assert len(store.generations()) == n_gens
    x_all = np.concatenate(all_x)

    # queries near generation 5's cluster: nearest neighbors live there
    q = all_x[5][:8]
    ids, scores = tiered.query(q, steps=1, query_ids=np.arange(
        5 * per_gen, 5 * per_gen + 8))
    gt = np.argsort(-(q @ x_all.T), axis=1)
    hits = 0
    for i in range(8):
        want = [v for v in gt[i] if v != 5 * per_gen + i][:5]
        hits += len(set(want) & set(int(v) for v in ids[i] if v >= 0))
        # every returned neighbor must come from the right cluster region
        got = ids[i][ids[i] >= 0]
        assert ((got >= 5 * per_gen) & (got < 6 * per_gen)).all(), ids[i]
    assert hits / 40 >= 0.7, hits    # LSH recall@5 across the merge

    loads_localized = store.disk_loads
    # the exact key-summary gate must have pruned at least one generation
    # for cluster-5-local probes (clusters are far apart; their bucket
    # key ranges are disjoint at chain length 24)
    assert loads_localized < n_gens, loads_localized

    # ungated (gate forced open) must return the same results
    import similaritysearchbyrdf_tpu.storage.persist as persist_mod

    orig = TieredForest._summary_matches
    try:
        TieredForest._summary_matches = staticmethod(
            lambda *a, **k: True)
        ids_u, scores_u = tiered.query(q, steps=1, query_ids=np.arange(
            5 * per_gen, 5 * per_gen + 8))
    finally:
        TieredForest._summary_matches = staticmethod(orig)
    np.testing.assert_array_equal(ids, ids_u)
    np.testing.assert_allclose(scores, scores_u, rtol=1e-6)
    assert store.disk_loads == n_gens     # the forced-open pass loaded all


def test_probe_uniques_hoist_matches_inline(tmp_path):
    """_probe_uniques precomputation must not change gate decisions."""
    rng = np.random.default_rng(1)
    conf = _conf()
    store = GenerationStore(str(tmp_path), "g")
    tiered = TieredForest(conf, store)
    centers = rng.normal(size=(4, 16))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    for g in range(4):
        x, _ = _clustered(rng, 64, 16, centers[g:g + 1])
        tiered.fit(DenseBatch(
            np.arange(g * 64, (g + 1) * 64, dtype=np.int32), x))
        tiered.spill()
    q, _ = _clustered(rng, 8, 16, centers[1:2])
    probe_keys, table_of = tiered._probe_keys_host(q, steps=1)
    from similaritysearchbyrdf_tpu.storage.persist import model_fingerprint

    fp = model_fingerprint(tiered._prototype().model)
    uniques = TieredForest._probe_uniques(
        probe_keys, table_of, conf.table_num * conf.permutation_num)
    for stem in store.generations():
        s = store.key_summary(stem)
        a = TieredForest._summary_matches(s, probe_keys, table_of, fp)
        b = TieredForest._summary_matches(s, probe_keys, table_of, fp,
                                          probe_uniques=uniques)
        assert a == b
