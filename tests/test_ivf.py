"""Clustered-flat (IVF) engine: k-means layout invariants + recall vs exact."""

import numpy as np

from similaritysearchbyrdf_tpu import DenseBatch, exact_search
from similaritysearchbyrdf_tpu.ops.ivf import IVFFlatIndex, build_ivf


def _data(n=3000, d=32, seed=0, n_clusters=40):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, d))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    x = centers[rng.integers(0, n_clusters, n)] + 0.08 * rng.normal(size=(n, d))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x.astype(np.float32)


def test_build_layout_invariants():
    x = _data(n=1000)
    st = build_ivf(x, np.arange(1000, dtype=np.int32), target_cluster=64,
                   iters=4)
    starts = np.asarray(st.starts)
    rid = np.asarray(st.row_ids)
    assert (starts % 8 == 0).all()                 # 8-aligned clusters
    assert starts[-1] == rid.shape[0]
    live = rid >= 0
    assert live.sum() == 1000                      # every row present once
    assert len(set(rid[live].tolist())) == 1000
    # cluster-ordered exact rows match the original corpus rows
    corpus = np.asarray(st.corpus)[:, :32]
    src = x[rid[live]]
    np.testing.assert_allclose(corpus[live], src, rtol=1e-6)


def test_ivf_recall_full_probe_matches_exact():
    """nprobe = all clusters ⇒ every row is scored: recall ≈ exact (int8
    sketch preselection bound only, same as the flat engine)."""
    x = _data()
    batch = DenseBatch(np.arange(len(x), dtype=np.int32), x)
    idx = IVFFlatIndex(target_cluster=128, nprobe=64, iters=4,
                       win=64, refine=256).fit(batch)
    kc = int(np.asarray(idx.state.centroids).shape[0])
    q = x[:64]
    ids, scores = idx.query(q, k=10, query_ids=np.arange(64), nprobe=kc)
    gt_ids, gt_s = exact_search(x, q, k=10, exclude_self=True)
    hits = sum(len(set(map(int, ids[i])) & set(map(int, gt_ids[i])))
               for i in range(64))
    assert hits / 640 >= 0.97, hits / 640
    np.testing.assert_allclose(scores[:, 0], gt_s[:, 0], rtol=1e-4)
    for i in range(64):
        assert i not in set(map(int, ids[i]))       # self excluded


def test_ivf_recall_partial_probe():
    """A modest nprobe on clustered data must retain high recall — the IVF
    contract (probing the top clusters finds the true neighbors)."""
    x = _data(n=4000)
    batch = DenseBatch(np.arange(len(x), dtype=np.int32), x)
    idx = IVFFlatIndex(target_cluster=128, nprobe=8, iters=6,
                       win=64, refine=256).fit(batch)
    q = x[:64]
    ids, _ = idx.query(q, k=10, query_ids=np.arange(64))
    gt_ids, _ = exact_search(x, q, k=10, exclude_self=True)
    hits = sum(len(set(map(int, ids[i])) & set(map(int, gt_ids[i])))
               for i in range(64))
    assert hits / 640 >= 0.9, hits / 640


def test_ivf_unfitted():
    idx = IVFFlatIndex()
    ids, _ = idx.query(np.zeros((2, 8), np.float32), k=3)
    assert ids.shape == (2, 3) and (ids == -1).all()

def test_window_budget_never_truncates():
    """`ivf_window_budget` must cover the windows of ANY nprobe-cluster
    probe set: querying with that budget returns identical results to a
    whole-corpus window budget (no silent truncation — the round-2 review
    found the old 2*nprobe heuristic dropped probed rows)."""
    from similaritysearchbyrdf_tpu.ops.ivf import ivf_topk, ivf_window_budget

    x = _data(n=2500, seed=3)
    st = build_ivf(x, np.arange(len(x), dtype=np.int32), target_cluster=48,
                   iters=4)
    starts, ends = np.asarray(st.starts), np.asarray(st.ends)
    win, nprobe = 16, 6
    wb = ivf_window_budget(starts, ends, nprobe, win)
    # exact worst case: sum of the nprobe largest clusters' window counts
    wc = np.sort(-(-(ends - starts[:-1]) // win))[::-1]
    assert wb >= wc[:nprobe].sum()
    q = x[:32]
    import jax.numpy as jnp
    qd = jnp.asarray(q)
    qi = jnp.arange(32, dtype=jnp.int32)
    args = (st.sketch, st.corpus, st.row_ids, st.centroids, st.starts,
            st.ends, qd, qi, 10)
    ids_a, sc_a = ivf_topk(*args, nprobe=nprobe, win=win, wb=wb, refine=256)
    full = (int(st.sketch.shape[0]) + win - 1) // win   # every window
    ids_b, sc_b = ivf_topk(*args, nprobe=nprobe, win=win, wb=full, refine=256)
    np.testing.assert_array_equal(np.asarray(ids_a), np.asarray(ids_b))
    np.testing.assert_allclose(np.asarray(sc_a), np.asarray(sc_b), rtol=1e-5)


def test_ivf_pad_rows_never_reach_results():
    """Clusters are 8-padded; pad rows score 0 which can beat real negative
    candidates — `ends` must fence them out even when every real score is
    negative (anti-correlated queries)."""
    rng = np.random.default_rng(9)
    x = _data(n=600, seed=9)
    batch = DenseBatch(np.arange(len(x), dtype=np.int32), x)
    idx = IVFFlatIndex(target_cluster=32, nprobe=64, iters=4, win=8,
                       refine=600).fit(batch)
    q = -x[:16]                       # all true scores <= 0
    ids, scores = idx.query(q, k=10, exclude_self=False)
    assert (ids >= 0).all()
    # scores of returned rows must match the exact dot products (a pad row
    # would report score 0 with some real row id, or id -1)
    for i in range(16):
        got = np.sort(scores[i])[::-1]
        exact = np.sort(q[i] @ x[ids[i]].T)[::-1]
        np.testing.assert_allclose(got, exact, rtol=1e-4, atol=1e-5)


def test_ivf_sampled_training_recall():
    """`train_sample` (Lloyd on a subsample + one full assignment) keeps
    partial-probe recall — the big-N build speedup must not cost quality."""
    x = _data(n=4000, seed=5)
    batch = DenseBatch(np.arange(len(x), dtype=np.int32), x)
    idx = IVFFlatIndex(target_cluster=128, nprobe=8, iters=6, win=64,
                       refine=256, train_sample=1500).fit(batch)
    q = x[:64]
    ids, _ = idx.query(q, k=10, query_ids=np.arange(64))
    gt_ids, _ = exact_search(x, q, k=10, exclude_self=True)
    hits = sum(len(set(map(int, ids[i])) & set(map(int, gt_ids[i])))
               for i in range(64))
    assert hits / 640 >= 0.9, hits / 640
    # layout invariants hold for the sampled path too
    st = idx.state
    rid = np.asarray(st.row_ids)
    assert (rid >= 0).sum() == 4000


def test_tune_nprobe_hits_target_and_monotone():
    """tune_nprobe picks the smallest candidate whose results match the
    index's own full-probe pass at the target recall, and sets it on the
    index. On a well-clustered corpus a tight target must still be met by
    SOME candidate (the full-probe candidate itself closes the loop)."""
    from similaritysearchbyrdf_tpu.ops.ivf import IVFFlatIndex, tune_nprobe
    from similaritysearchbyrdf_tpu.vectors import DenseBatch

    rng = np.random.default_rng(13)
    centers = rng.normal(size=(40, 16))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    x = centers[rng.integers(0, 40, 3000)] + 0.05 * rng.normal(size=(3000, 16))
    x = (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)
    idx = IVFFlatIndex(target_cluster=64, nprobe=1, refine=128,
                       iters=4).fit(
                           DenseBatch(np.arange(3000, dtype=np.int32), x))
    q = x[:32]
    p = tune_nprobe(idx, q, target_recall=0.98, k=5)
    assert idx.nprobe == p
    kc = int(idx.state.centroids.shape[0])
    assert 1 <= p <= kc
    # the tuned point really achieves the target vs the full-probe pass
    ref, _ = idx.query(q, k=5, exclude_self=False, nprobe=kc)
    got, _ = idx.query(q, k=5, exclude_self=False, nprobe=p)
    ref_sets = [set(map(int, r[r >= 0])) for r in ref]
    hits = sum(len(ref_sets[i] & set(map(int, got[i][got[i] >= 0])))
               for i in range(32))
    assert hits / max(sum(len(s) for s in ref_sets), 1) >= 0.98


def test_streamed_build_matches_regular():
    """build_ivf_streamed (host-resident f32, bf16 device tier, chunked
    relayout via donated dynamic_update_slice) must produce the same
    layout invariants and near-identical recall as build_ivf — the 30M
    single-device path."""
    import jax.numpy as jnp

    from similaritysearchbyrdf_tpu.ops.ivf import (build_ivf_streamed,
                                                   ivf_topk,
                                                   ivf_window_budget)

    x = _data(n=3000, d=32, seed=4)
    st = build_ivf_streamed(x, np.arange(3000, dtype=np.int32),
                            target_cluster=64, iters=3, seed=0,
                            train_sample=3000, chunk_rows=1024,
                            kmeans_chunk=1024)
    assert st.corpus.dtype == jnp.bfloat16
    starts = np.asarray(st.starts)
    rid = np.asarray(st.row_ids)
    assert (starts % 8 == 0).all()
    live = rid >= 0
    assert live.sum() == 3000
    assert len(set(rid[live].tolist())) == 3000
    # allocation may overhang the last cluster end by < chunk_rows; all
    # overhang rows are dead
    assert rid.shape[0] >= starts[-1]
    assert (rid[starts[-1]:] == -1).all()
    # rows in the bf16 tier match the source corpus at bf16 precision
    corpus = np.asarray(st.corpus.astype(jnp.float32))[:, :32]
    np.testing.assert_allclose(corpus[live], x[rid[live]], atol=4e-3)

    # full-probe query over the bf16 tier finds the exact neighbors
    q = x[:32]
    gt, _ = exact_search(x, q, k=5, exclude_self=True)
    kc = int(st.centroids.shape[0])
    wb = ivf_window_budget(st.starts, st.ends, kc, 64)
    ids, _ = ivf_topk(st.sketch, st.corpus, st.row_ids, st.centroids,
                      st.starts, st.ends, jnp.asarray(q),
                      jnp.arange(32, dtype=jnp.int32), 5, nprobe=kc,
                      win=64, wb=wb, refine=256)
    ids = np.asarray(ids)
    hits = sum(len(set(map(int, ids[i])) & set(map(int, gt[i])))
               for i in range(32))
    assert hits / (32 * 5) >= 0.95


# ---------------------------------------------------------------------------
# two-phase window pruning (head tier; _ivf_prune_windows)
# ---------------------------------------------------------------------------


def test_ivf_heads_masked_mean():
    """build_ivf_heads = masked mean of int8 sketch rows per hp-group (pad
    rows with row_id -1 excluded, all-dead groups zero)."""
    import jax.numpy as jnp

    from similaritysearchbyrdf_tpu.ops.ivf import build_ivf_heads

    rng = np.random.default_rng(3)
    n, dp, hp = 100, 128, 16     # n not a multiple of hp: tail pool padded
    sk = rng.integers(-127, 128, size=(n, dp)).astype(np.int8)
    rid = np.arange(n, dtype=np.int32)
    rid[5:16] = -1               # a dead stretch inside pool groups 0/1
    heads = np.asarray(build_ivf_heads(jnp.asarray(sk), jnp.asarray(rid), hp))
    h = (n + hp - 1) // hp
    assert heads.shape == (h, dp)
    skp = np.zeros(((h * hp), dp), np.float32)
    skp[:n] = sk
    lv = np.zeros((h * hp,), bool)
    lv[:n] = rid >= 0
    for g in range(h):
        rows = skp[g * hp:(g + 1) * hp]
        m = lv[g * hp:(g + 1) * hp]
        want = rows[m].mean(axis=0) if m.any() else np.zeros(dp)
        np.testing.assert_allclose(
            heads[g], want.astype(np.float32), rtol=0.02, atol=0.5)


def test_ivf_prune_slot_order_subsequence():
    """Survivor windows must come out in SLOT order (an order-preserving
    subsequence of the input windows), so the window gather after the
    prune reads rows in address order."""
    import jax.numpy as jnp

    from similaritysearchbyrdf_tpu.ops.ivf import _ivf_prune_windows

    rng = np.random.default_rng(4)
    b, wbf, hp, win, dp, keep = 3, 24, 8, 16, 128, 7
    heads = jnp.asarray(rng.normal(size=(64, dp)).astype(np.float32)
                        ).astype(jnp.bfloat16)
    blk = jnp.asarray(np.stack([
        np.sort(rng.choice(64, size=wbf, replace=False)) * 8
        for _ in range(b)
    ]).astype(np.int32))
    end_b = blk + win - 3
    live = jnp.asarray(rng.random((b, wbf)) < 0.9)
    qb = jnp.asarray(rng.normal(size=(b, dp)).astype(np.float32)
                     ).astype(jnp.bfloat16)
    pb, pe, pl = _ivf_prune_windows(heads, hp, qb, blk, end_b, live,
                                    win, keep)
    assert pb.shape == (b, keep)
    blk_np = np.asarray(blk)
    for i in range(b):
        out = np.asarray(pb[i])
        # strictly increasing positions within the (sorted, distinct) input
        # slots = an order-preserving subsequence
        idxs = [int(np.flatnonzero(blk_np[i] == v)[0]) for v in out]
        assert idxs == sorted(idxs) and len(set(idxs)) == keep


def test_ivf_two_phase_pruning_recall_and_knobs():
    """End-to-end: keep >= wb is bit-identical to the single-phase path;
    a real prune (keep = wb//2) keeps high recall on clustered data; heads
    survive save/load (rebuilt as derived data)."""
    x = _data(n=4000, seed=6)
    batch = DenseBatch(np.arange(len(x), dtype=np.int32), x)
    idx = IVFFlatIndex(target_cluster=128, nprobe=8, iters=6, win=16,
                       refine=256, head_pool=8, keep=0).fit(batch)
    assert idx.state.heads is not None
    q = x[:64]
    from similaritysearchbyrdf_tpu.ops.ivf import ivf_window_budget
    wb = ivf_window_budget(idx.state.starts, idx.state.ends, 8, 16)
    ids0, s0 = idx.query(q, k=10, query_ids=np.arange(64))      # keep=0
    ids1, s1 = idx.query(q, k=10, query_ids=np.arange(64), keep=wb + 5)
    np.testing.assert_array_equal(ids0, ids1)                   # disabled
    np.testing.assert_array_equal(s0, s1)
    ids2, _ = idx.query(q, k=10, query_ids=np.arange(64), keep=max(wb // 2, 1))
    gt_ids, _ = exact_search(x, q, k=10, exclude_self=True)
    hits = sum(len(set(map(int, ids2[i])) & set(map(int, gt_ids[i])))
               for i in range(64))
    assert hits / 640 >= 0.85, hits / 640

    import tempfile

    from similaritysearchbyrdf_tpu.storage.persist import load_ivf, save_ivf
    with tempfile.TemporaryDirectory() as td:
        idx.keep = max(wb // 2, 1)
        save_ivf(idx, td + "/ivf")
        idx2 = load_ivf(td + "/ivf")
        assert idx2.state.heads is not None and idx2.keep == idx.keep
        ids3, _ = idx2.query(q, k=10, query_ids=np.arange(64))
        np.testing.assert_array_equal(ids2, ids3)
