"""Slot-folded coarse tier + groupmax query path (coarse_layout="folded").

Covers: tier layout (fold consecutive slots of one table per 128-lane row),
bit-parity of the packed row max (`rowmax_packed`) against a numpy oracle, end-to-end
recall parity with the lane-packed tier at equal rerank breadth, per-call
knob overrides, and checkpoint round-trip (the tier is derived data and is
rebuilt on load)."""

import numpy as np
import pytest

import jax.numpy as jnp

from similaritysearchbyrdf_tpu import DenseBatch, RDFConfig, RDFForest
from similaritysearchbyrdf_tpu.config import TableConfig
from similaritysearchbyrdf_tpu.index import forest as forest_mod
from similaritysearchbyrdf_tpu.index.forest import I32_DEAD, rowmax_packed


def _corpus(n=4096, d=32, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(64, d)).astype(np.float32)
    x = (
        centers[rng.integers(0, 64, n)]
        + 0.3 * rng.normal(size=(n, d))
    ).astype(np.float32)
    q = x[:64] + 0.05 * rng.normal(size=(64, d)).astype(np.float32)
    gt = np.argsort(-(q @ x.T), axis=1)[:, :10]
    return x, q, gt


def _conf(layout, **kw):
    base = dict(
        vector_dim=32, table_num=4, permutation_num=1, top_k=10,
        lsh_table=TableConfig(chain_length=12, bucket_overflow=64),
        coarse_dim=16, coarse_layout=layout, coarse_refine=512,
        max_candidates=4096,
        coarse_window=256 if layout == "folded" else -1,
        query_batch_size=64,
    )
    base.update(kw)
    return RDFConfig(**base)


def _recall(ids, gt):
    return np.mean(
        [len(set(ids[i]) & set(gt[i])) / gt.shape[1]
         for i in range(gt.shape[0])]
    )


def test_folded_tier_layout():
    """Slot j of table t lands at [t, j//fold, (j%fold)*cs : +cs] and holds
    the same int8 row the lane-packed tier stores for that slot."""
    x, _, _ = _corpus()
    conf = _conf("folded")
    f = RDFForest(conf).fit(DenseBatch(np.arange(len(x), dtype=np.int64), x))
    st = f.state
    assert st.coarse_folded is not None and st.coarse_by_table is None
    low = np.asarray(
        forest_mod._coarse_low(
            jnp.pad(st.coarse_proj,
                    ((0, st.corpus.shape[1] - conf.vector_dim), (0, 0))),
            st.corpus, True,
        )
    )
    si = np.asarray(st.tables.sorted_ids)
    folded = np.asarray(st.coarse_folded)
    l, caprows = si.shape
    cs = st.coarse_proj.shape[1]
    fold = 128 // cs
    assert folded.shape == (l, caprows // fold, fold * cs)
    rng = np.random.default_rng(1)
    for t in rng.integers(0, l, 2):
        for j in rng.integers(0, caprows, 64):
            want = low[si[t, j]] if si[t, j] >= 0 else np.zeros(cs, np.int8)
            got = folded[t, j // fold, (j % fold) * cs:(j % fold + 1) * cs]
            np.testing.assert_array_equal(got, want)


def test_rowmax_fallback_matches_numpy_oracle():
    rng = np.random.default_rng(2)
    l_n, capf, lanes = 3, 64, 128
    cs, fold = 16, 8
    b, mb, wpr, rpg = 4, 6, 8, 8
    mshift = 6
    folded = rng.integers(-127, 128, (l_n, capf, lanes), dtype=np.int8)
    qi8 = rng.integers(-127, 128, (b, cs), dtype=np.int8)
    qmat = np.zeros((b, fold, lanes), np.int8)
    for s in range(fold):
        qmat[:, s, s * cs:(s + 1) * cs] = qi8
    table = rng.integers(0, l_n, (b, mb)).astype(np.int32)
    rs = (rng.integers(0, (capf - wpr) // 8 + 1, (b, mb)) * 8).astype(
        np.int32
    )
    rs[:, -1] = -1                      # a dead window per query
    got = np.asarray(
        rowmax_packed(
            jnp.asarray(folded), jnp.asarray(qmat), jnp.asarray(table),
            jnp.asarray(rs), wpr=wpr, rpg=rpg, mshift=mshift,
        )
    ).reshape(b, mb, wpr)
    for bi in range(b):
        for m in range(mb):
            if rs[bi, m] < 0:
                assert (got[bi, m] == I32_DEAD).all()
                continue
            rows = folded[table[bi, m], rs[bi, m]:rs[bi, m] + wpr]
            for r in range(wpr):
                best = None
                for s in range(fold):
                    seg = rows[r, s * cs:(s + 1) * cs].astype(np.int64)
                    sc = int(seg @ qi8[bi].astype(np.int64))
                    member = (r % rpg) * fold + s
                    pk = (sc << mshift) | member
                    best = pk if best is None else max(best, pk)
                assert got[bi, m, r] == best


def test_folded_recall_matches_lane():
    """Whole-group rerank (rows_keep=0) at equal refine is within a few
    points of the lane-packed tier; argmax-only modes run and return valid
    ids (their recall is structurally lower at smoke scale — the mode
    targets m_cap >= 2^18 where groups are plentiful)."""
    x, q, gt = _corpus()
    batch = DenseBatch(np.arange(len(x), dtype=np.int64), x)
    lane = RDFForest(_conf("lane")).fit(batch)
    fold = RDFForest(_conf("folded")).fit(batch)
    kw = dict(steps=1, probe_mode="margin", probe_budget=8)
    ids_l, _ = lane.query(q, **kw)
    r_lane = _recall(ids_l, gt)
    ids_f, sc_f = fold.query(q, **kw)      # conf default rows_keep=0
    r_fold = _recall(ids_f, gt)
    assert r_fold >= r_lane - 0.06, (r_fold, r_lane)
    # scores are exact dots of the returned ids (full-precision rerank)
    exact = np.einsum("qd,qkd->qk", q, x[np.maximum(ids_f, 0)])
    valid = ids_f >= 0
    np.testing.assert_allclose(sc_f[valid], exact[valid], rtol=1e-5)
    # per-call knob overrides: argmax-only keeps fewer rows but still
    # returns valid ids, and wider refine is monotone (>= - noise)
    ids_a, _ = fold.query(q, rows_keep=1, coarse_group=16, **kw)
    assert (ids_a[ids_a >= 0] < len(x)).all()
    ids_w, _ = fold.query(q, coarse_refine=1024, **kw)
    assert _recall(ids_w, gt) >= r_fold - 0.02
    # fine selection granularity (gsl=8 = one physical row per group,
    # rpg=1): same refine spread over 8x more groups must not lose recall
    ids_g8, _ = fold.query(q, coarse_group=8, **kw)
    r_g8 = _recall(ids_g8, gt)
    assert r_g8 >= r_fold - 0.02
    # select_mult dedup: over-select 2x, dedup ids, truncate to the same
    # refine — unique candidates are a superset, recall must not drop
    ids_sm, _ = fold.query(q, coarse_group=8, select_mult=2, **kw)
    assert _recall(ids_sm, gt) >= r_g8 - 0.01


def test_packed_sorts_match_two_operand_fallback(monkeypatch):
    """The single-operand packed select/dedup sorts (FOLD_PACK_SELECT /
    FOLD_PACK_DEDUP) quantize only tie-breaking LSBs: recall against exact
    GT must match the 2-operand exact-sort fallback to within tie noise,
    and the returned ids must be valid under both."""
    x, q, gt = _corpus()
    batch = DenseBatch(np.arange(len(x), dtype=np.int64), x)
    f = RDFForest(_conf("folded")).fit(batch)
    kw = dict(steps=1, probe_mode="margin", probe_budget=8,
              coarse_group=8, select_mult=2)
    recs = {}
    for packed in (True, False):
        monkeypatch.setattr(forest_mod, "_FOLD_PACK_SELECT", packed)
        monkeypatch.setattr(forest_mod, "_FOLD_PACK_DEDUP", packed)
        # the flags are read at trace time, not part of the jit key
        import jax
        jax.clear_caches()
        ids, _ = f.query(q, **kw)
        assert (ids[ids >= 0] < len(x)).all()
        recs[packed] = _recall(ids, gt)
    assert abs(recs[True] - recs[False]) <= 0.02, recs

    # slot-keep path (rows_keep=2): the packed select must carry the
    # member bits through selection — parity vs the 2-operand sort
    kw2 = dict(steps=1, probe_mode="margin", probe_budget=8,
               coarse_group=8, rows_keep=2)
    recs2 = {}
    for packed in (True, False):
        monkeypatch.setattr(forest_mod, "_FOLD_PACK_SELECT", packed)
        import jax
        jax.clear_caches()
        ids, _ = f.query(q, **kw2)
        assert (ids[ids >= 0] < len(x)).all()
        recs2[packed] = _recall(ids, gt)
    assert abs(recs2[True] - recs2[False]) <= 0.02, recs2


def test_folded_default_window_auto_clamps():
    """With coarse_window unset the groupmax path picks the largest pow2
    window <= min(4096, m_cap, table capacity) — small m_cap or tiny
    corpora must work out of the box instead of tripping the divisibility
    assert."""
    x, q, gt = _corpus()
    batch = DenseBatch(np.arange(len(x), dtype=np.int64), x)
    f = RDFForest(_conf("folded", coarse_window=-1, max_candidates=2048))
    f.fit(batch)
    ids, _ = f.query(q, steps=1, probe_mode="margin", probe_budget=8)
    assert (ids[ids >= 0] < len(x)).all()
    assert _recall(ids, gt) > 0.5


def test_folded_checkpoint_roundtrip(tmp_path):
    from similaritysearchbyrdf_tpu.storage.persist import (
        load_forest,
        save_forest,
    )

    x, q, gt = _corpus(n=2048)
    conf = _conf("folded", max_candidates=2048)
    f = RDFForest(conf).fit(DenseBatch(np.arange(len(x), dtype=np.int64), x))
    kw = dict(steps=1, probe_mode="margin", probe_budget=8)
    ids0, sc0 = f.query(q, **kw)
    path = tmp_path / "fold_ckpt"
    save_forest(f, str(path))
    g = load_forest(str(path))
    assert g.state.coarse_folded is not None
    np.testing.assert_array_equal(
        np.asarray(g.state.coarse_folded), np.asarray(f.state.coarse_folded)
    )
    ids1, sc1 = g.query(q, **kw)
    np.testing.assert_array_equal(ids0, ids1)


def test_folded_requires_int8():
    with pytest.raises(AssertionError):
        RDFForest(_conf("folded", coarse_dtype="bfloat16")).fit(
            DenseBatch(np.arange(256, dtype=np.int64),
                       np.ones((256, 32), np.float32))
        )


def test_pca_projection_orders_better_than_random():
    """coarse_proj_mode='pca' must (a) produce an orthonormal [d, cd]
    basis, (b) capture more corpus energy than a random basis on an
    anisotropic corpus, and (c) be deterministic in the corpus (checkpoint
    rebuild contract)."""
    from similaritysearchbyrdf_tpu.index.forest import _coarse_projection

    rng = np.random.default_rng(3)
    d, cd, n = 48, 8, 4000
    # anisotropic: energy concentrated in a random 8-dim subspace
    basis = np.linalg.qr(rng.normal(size=(d, d)))[0][:, :8]
    x = (rng.normal(size=(n, 8)) @ basis.T
         + 0.1 * rng.normal(size=(n, d))).astype(np.float32)
    xd = jnp.asarray(x)

    p_pca = _coarse_projection(xd, d, cd, seed=7, mode="pca")
    p_rnd = _coarse_projection(xd, d, cd, seed=7, mode="random")
    np.testing.assert_allclose(p_pca.T @ p_pca, np.eye(cd), atol=1e-4)
    e_pca = np.linalg.norm(x @ p_pca) ** 2
    e_rnd = np.linalg.norm(x @ p_rnd) ** 2
    assert e_pca > 1.5 * e_rnd, (e_pca, e_rnd)
    p2 = _coarse_projection(jnp.asarray(x.copy()), d, cd, seed=7,
                            mode="pca")
    np.testing.assert_array_equal(p_pca, p2)


def test_pca_tier_save_load_rebuild(tmp_path):
    """A pca-projected folded tier must rebuild bit-identically on load
    (derived-data contract) and answer queries identically."""
    from similaritysearchbyrdf_tpu.storage.persist import (
        load_forest, save_forest)

    x, q, gt = _corpus()
    batch = DenseBatch(np.arange(len(x), dtype=np.int64), x)
    conf = _conf("folded", coarse_proj_mode="pca")
    f = RDFForest(conf).fit(batch)
    ids0, sc0 = f.query(q, steps=1, query_ids=np.arange(len(q)))
    save_forest(f, str(tmp_path / "pca"))
    loaded = load_forest(str(tmp_path / "pca"))
    np.testing.assert_array_equal(
        np.asarray(loaded.state.coarse_folded),
        np.asarray(f.state.coarse_folded))
    ids1, sc1 = loaded.query(q, steps=1, query_ids=np.arange(len(q)))
    np.testing.assert_array_equal(ids0, ids1)


def test_rowmax_emit2_fallback_and_kernel_parity():
    """emit2: the first output must be each live row's best packed value
    and the second its second-best (numpy oracle); dead windows emit
    I32_DEAD on both."""
    rng = np.random.default_rng(29)
    l_n, capf, lanes = 3, 256, 128
    cs, fold = 16, 8
    b, mb, wpr, rpg = 4, 16, 16, 1      # rpg=1: gsl == fold == 8
    gsl = rpg * fold
    mshift = gsl.bit_length() - 1
    folded = rng.integers(-127, 128, (l_n, capf, lanes), dtype=np.int8)
    qi8 = rng.integers(-127, 128, (b, cs), dtype=np.int8)
    qmat = np.zeros((b, fold, lanes), np.int8)
    for s in range(fold):
        qmat[:, s, s * cs:(s + 1) * cs] = qi8
    table = rng.integers(0, l_n, (b, mb)).astype(np.int32)
    rs = (rng.integers(0, (capf - wpr) // 8 + 1, (b, mb)) * 8).astype(
        np.int32)
    rs[:, -1] = -1
    args = (jnp.asarray(folded), jnp.asarray(qmat), jnp.asarray(table),
            jnp.asarray(rs))
    fb1, fb2 = rowmax_packed(*args, wpr=wpr, rpg=rpg, mshift=mshift,
                             emit2=True)
    fb1 = np.asarray(fb1).reshape(b, mb, wpr)
    fb2 = np.asarray(fb2).reshape(b, mb, wpr)
    assert (fb1[:, -1] == I32_DEAD).all() and (fb2[:, -1] == I32_DEAD).all()
    for bi in range(b):
        for m in range(mb - 1):
            rows = folded[table[bi, m], rs[bi, m]:rs[bi, m] + wpr]
            for r in range(wpr):
                pks = []
                for s in range(fold):
                    seg = rows[r, s * cs:(s + 1) * cs].astype(np.int64)
                    sc = int(seg @ qi8[bi].astype(np.int64))
                    pks.append((sc << mshift) | s)
                pks.sort(reverse=True)
                assert fb1[bi, m, r] == pks[0]
                assert fb2[bi, m, r] == pks[1]


def test_folded_slot_keep_recall():
    """rows_keep=2 at gsl==fold (slot-level rerank) must run end-to-end,
    return valid ids, and be monotone in refine. At smoke scale the
    selection width barely exceeds the refine budget, so slot-keep cannot
    show its coverage advantage (that is a Deep-scale property where
    width >> refine); here we assert it stays within a sane band of whole-group rerank at
    the SAME refine and recovers most of it at double refine."""
    x, q, gt = _corpus()
    batch = DenseBatch(np.arange(len(x), dtype=np.int64), x)
    base = RDFForest(
        _conf("folded", coarse_group=8, coarse_refine=1024,
              coarse_window=128)).fit(batch)
    ids0, _ = base.query(q, steps=1, query_ids=np.arange(len(q)))
    r0 = _recall(ids0, gt)

    slot = RDFForest(
        _conf("folded", coarse_group=8, coarse_refine=1024,
              coarse_window=128, coarse_rows_keep=2)).fit(batch)
    ids1, _ = slot.query(q, steps=1, query_ids=np.arange(len(q)))
    r1 = _recall(ids1, gt)
    assert (ids1[ids1 >= 0] < len(x)).all()
    assert r1 >= r0 - 0.2, (r1, r0)

    slot2 = RDFForest(
        _conf("folded", coarse_group=8, coarse_refine=2048,
              coarse_window=128, coarse_rows_keep=2)).fit(batch)
    ids2, _ = slot2.query(q, steps=1, query_ids=np.arange(len(q)))
    r2 = _recall(ids2, gt)
    assert r2 >= r1 - 0.02, (r2, r1)


def test_staged_rerank_stage2():
    """Staged rerank (stage2 > 0): exact scoring only the best `stage2`
    unique ids by int8 coarse slot score. stage2 >= the selected-slot
    count must return EXACTLY the plain path's top-k (every unique id
    survives the staging; duplicate copies carry equal exact scores);
    small stage2 trades recall smoothly and is monotone in stage2."""
    x, q, gt = _corpus()
    batch = DenseBatch(np.arange(len(x), dtype=np.int64), x)
    f = RDFForest(
        _conf("folded", coarse_group=8, coarse_refine=1024,
              coarse_window=128)).fit(batch)
    kw = dict(steps=1, probe_mode="margin", probe_budget=8,
              query_ids=np.arange(len(q)))
    ids0, sc0 = f.query(q, **kw)
    r0 = _recall(ids0, gt)
    # stage2 >= rgg*gsl disables staging structurally; a stage2 equal to
    # the full selected width keeps every unique id -> identical top-k
    ids_full, sc_full = f.query(q, stage2=1024, **kw)
    np.testing.assert_array_equal(np.sort(ids_full, 1), np.sort(ids0, 1))
    np.testing.assert_allclose(
        np.sort(sc_full, 1), np.sort(sc0, 1), rtol=1e-5)
    # narrow stage2: valid ids, exact returned scores, sane recall
    ids_s, sc_s = f.query(q, stage2=256, **kw)
    assert (ids_s[ids_s >= 0] < len(x)).all()
    exact = np.einsum("qd,qkd->qk", q, x[np.maximum(ids_s, 0)])
    valid = ids_s >= 0
    np.testing.assert_allclose(sc_s[valid], exact[valid], rtol=1e-5)
    r_s = _recall(ids_s, gt)
    assert r_s >= r0 - 0.15, (r_s, r0)
    # monotone in stage2 (wider exact budget can only help, modulo none)
    ids_m, _ = f.query(q, stage2=512, **kw)
    assert _recall(ids_m, gt) >= r_s - 0.02
    # dedup: no duplicate ids in a row's top-k
    for row in ids_s:
        live = row[row >= 0]
        assert len(set(live.tolist())) == len(live)


def test_staged_rerank_stage2_rpg2():
    """stage2 slot-score ordering at rpg > 1 (gsl=16, fold=8): the
    [B, rgg*rpg, fold] rescore flatten must match cand2's (row, seg)
    slot order — verified by the stage2 >= full-width equivalence (any
    order mismatch would mis-assign scores to ids, and the score-ordered
    dedup would surface different ids than the plain path)."""
    x, q, gt = _corpus()
    batch = DenseBatch(np.arange(len(x), dtype=np.int64), x)
    f = RDFForest(
        _conf("folded", coarse_group=16, coarse_refine=1024,
              coarse_window=128)).fit(batch)
    kw = dict(steps=1, probe_mode="margin", probe_budget=8,
              query_ids=np.arange(len(q)))
    ids0, sc0 = f.query(q, **kw)
    ids_full, sc_full = f.query(q, stage2=1024, **kw)
    np.testing.assert_array_equal(np.sort(ids_full, 1), np.sort(ids0, 1))
    ids_s, _ = f.query(q, stage2=256, **kw)
    r0 = _recall(ids0, gt)
    r_s = _recall(ids_s, gt)
    assert r_s >= r0 - 0.15, (r_s, r0)
