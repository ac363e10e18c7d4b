"""Smoke run of the main path on one GPU: hashing, the forest, flat and IVF
engines at the ann-benchmarks GloVe-100 shape, and the sparse forest and
sparse flat engine at 1M x 4096d, each checked against exact search.

    python chip_smoke.py [--seed N]           # one card
    python chip_smoke.py --four-cards         # the sharded engines, 4 cards

Each phase prints one `[smoke]` line (its wall time is smoke output taken
with compilation included, not a benchmark number). The last line is one
JSON object naming the device. The script exits non-zero, before printing
that line, when JAX finds no GPU, when any phase raises, or when any check
misses its tolerance.

The phase functions take their sizes as arguments so the tests can run
them on the CPU at tiny sizes; only `main` insists on the GPU.
"""

from __future__ import annotations

import argparse
import functools
import gc
import json
import os
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# the GloVe-100 shape of ann-benchmarks (glove-100-angular; BASELINE.json
# config 2): 1,183,514 corpus rows, 10,000 queries, 100 dims
GLOVE_N, GLOVE_Q, GLOVE_D = 1_183_514, 10_000, 100
# BASELINE.json config 4: 1M sparse rows, 4096 dims, 64 non-zeros each
SPARSE_N, SPARSE_D, SPARSE_NNZ, SPARSE_Q = 1_000_000, 4096, 64, 1_000
K = 10
PARITY_Q = 64           # queries rerun on the host CPU for parity
TIE_TOL = 1e-5          # |score gap| below which two ids are a near-tie
GT_TIE_TOL = 1e-6       # 10th/11th score gap the f32 GT may order freely
HASH_NEAR_ZERO = 1e-5   # |dot| below which a hash bit may differ

FLOORS = {"forest_steps1": 0.90, "flat": 0.99, "ivf": 0.92,
          "sparse_forest": 0.90, "sparse_flat": 0.90}


class SmokeFailure(RuntimeError):
    """A check missed its tolerance."""


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


# ---------------------------------------------------------------------------
# data, ground truth, metrics
# ---------------------------------------------------------------------------


def make_dense(n: int, nq: int, d: int, seed: int,
               n_centers: int = 50_000) -> Tuple[np.ndarray, np.ndarray]:
    """Corpus rows and held-out queries from one `easy_clustered` draw
    (GloVe-like geometry: unit rows around shared centers)."""
    from similaritysearchbyrdf_tpu.utils.datasets import easy_clustered

    x = easy_clustered(n + nq, d, seed=seed, n_centers=n_centers)
    return x[:n], x[n:]


def make_sparse(n: int, dim: int, nnz: int, seed: int,
                n_clusters: int = 5000):
    """Support-clustered bag-of-words rows: each row takes one of
    `n_clusters` random supports of `nnz` dims, with unit-norm values in
    [0.8, 1.0) before normalization."""
    from similaritysearchbyrdf_tpu.vectors import SparseBatch

    rng = np.random.default_rng(seed)
    supports = np.argsort(rng.random((n_clusters, dim)), axis=1)[:, :nnz]
    idx = supports[rng.integers(0, n_clusters, n)].astype(np.int32)
    val = (0.8 + 0.2 * rng.random((n, nnz))).astype(np.float32)
    val /= np.linalg.norm(val, axis=1, keepdims=True)
    return SparseBatch(ids=np.arange(n, dtype=np.int32), size=dim,
                       indices=idx, values=val,
                       lengths=np.full(n, nnz, np.int32))


def numpy_topk(x: np.ndarray, q: np.ndarray, k: int,
               chunk: int = 32) -> Tuple[np.ndarray, np.ndarray]:
    """float64 top-(k) ids and scores, plus one more score (the k+1-th)."""
    xt = x.astype(np.float64).T
    ids, scores = [], []
    for s0 in range(0, len(q), chunk):
        s = q[s0:s0 + chunk].astype(np.float64) @ xt
        part = np.argpartition(-s, k + 1, axis=1)[:, :k + 1]
        ps = np.take_along_axis(s, part, axis=1)
        order = np.argsort(-ps, axis=1)
        ids.append(np.take_along_axis(part, order, axis=1))
        scores.append(np.take_along_axis(ps, order, axis=1))
    return np.concatenate(ids), np.concatenate(scores)


def recall(ids: np.ndarray, gt: np.ndarray, k: int = K) -> float:
    hits = sum(len(set(map(int, gt[i, :k]))
                   & set(int(v) for v in ids[i, :k] if v >= 0))
               for i in range(len(gt)))
    return hits / (len(gt) * k)


def gt_mismatches(gt_ids, ref_ids, ref_scores, k=K, tol=GT_TIE_TOL) -> int:
    """Rows whose top-k id set differs from the float64 reference's although
    the reference's k-th and k+1-th scores are more than `tol` apart."""
    bad = 0
    for i in range(len(ref_ids)):
        if set(map(int, gt_ids[i, :k])) != set(map(int, ref_ids[i, :k])):
            if ref_scores[i, k - 1] - ref_scores[i, k] >= tol:
                bad += 1
    return bad


def parity(a_ids, a_sc, b_ids, b_sc, k=K, tol=TIE_TOL) -> Tuple[int, int]:
    """(rows that differ beyond near-ties, rows that differ only at
    near-ties) between two top-k results. An id present on one side only
    is a near-tie when its score is within `tol` of the other side's k-th
    score."""
    bad = ties = 0
    for i in range(len(a_ids)):
        a = {int(v): float(s) for v, s in zip(a_ids[i, :k], a_sc[i, :k])
             if v >= 0}
        b = {int(v): float(s) for v, s in zip(b_ids[i, :k], b_sc[i, :k])
             if v >= 0}
        if a.keys() == b.keys():
            continue
        if len(a) < k or len(b) < k:
            bad += 1
            continue
        near = (all(abs(s - b_sc[i, k - 1]) < tol
                    for v, s in a.items() if v not in b)
                and all(abs(s - a_sc[i, k - 1]) < tol
                        for v, s in b.items() if v not in a))
        if near:
            ties += 1
        else:
            bad += 1
    return bad, ties


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    import jax

    jax.block_until_ready(out)
    return out, time.perf_counter() - t0


def _median_s(fn, reps: int = 10) -> float:
    """Median wall time of `reps` warm calls, each ended by
    block_until_ready."""
    import jax

    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def forest_window_share(forest, q, steps: int) -> Tuple[float, float]:
    """(window gather + coarse score, whole query step) seconds for one
    query chunk: the plain stage that replaced the window-gather kernel,
    timed alone on the chunk's own windows, beside the jitted step."""
    import jax
    import jax.numpy as jnp

    from similaritysearchbyrdf_tpu.index import forest as FO
    from similaritysearchbyrdf_tpu.index.partitioner import partition_of_hash
    from similaritysearchbyrdf_tpu.ops.hashing import hash_dense

    conf, st = forest.conf, forest.state
    bs = conf.query_batch_size
    qc = jnp.asarray(q[:bs])
    h = hash_dense(st.model, qc)
    win = FO.coarse_window_slots(conf.max_candidates, conf.coarse_window)
    base, table, start, end, _, bs_block = FO.gather_blocks(
        st.tables, h, partition_of_hash(h, st.part_proj), forest.layout,
        steps, conf.max_candidates, True, window=win)
    score = jax.jit(lambda s, qq, a, b, c, e: FO._coarse_block_scores(
        s.coarse_by_table, s.coarse_proj, qq, a, b, e, bs_block,
        start_b=c))
    t_score = _median_s(lambda: score(st, qc, base, table, start, end))
    qi = jnp.full((bs,), -1, jnp.int32)
    t_full = _median_s(lambda: FO.query_dense(
        st, qc, qi, forest.layout, steps=steps, m_cap=conf.max_candidates,
        k=K, multiprobe=True, exclude_self=False,
        coarse_refine=conf.coarse_refine, coarse_window=conf.coarse_window,
        window_keep=conf.coarse_keep, head_pool=conf.coarse_head_pool,
        coarse_group=conf.coarse_group, rows_keep=conf.coarse_rows_keep,
        select_mult=conf.coarse_select_mult, stage2=conf.coarse_stage2))
    return t_score, t_full


def ivf_window_share(ivf, q) -> Tuple[float, float]:
    """(window gather + score, whole query step) seconds for one query
    batch of the IVF engine, measured like `forest_window_share`."""
    import jax
    import jax.numpy as jnp

    from similaritysearchbyrdf_tpu.ops import ivf as IV
    from similaritysearchbyrdf_tpu.ops.flat import _pad_lanes, _window_scores

    st = ivf.state
    npad, dp = st.sketch.shape
    b = min(len(q), ivf.query_batch)
    wb = IV.ivf_window_budget(st.starts, st.ends, ivf.nprobe, ivf.win)
    qc = jnp.asarray(q[:b])
    qb = _pad_lanes(qc)[:, :dp].astype(jnp.bfloat16)
    blk, _, _ = IV.probe_windows(qb, st.centroids, st.starts, st.ends,
                                 ivf.nprobe, ivf.win, wb)
    blk = jnp.minimum(blk, npad - ivf.win)
    score = jax.jit(lambda qq, bb: _window_scores(st.sketch, qq, bb,
                                                  ivf.win))
    t_score = _median_s(lambda: score(qb, blk))
    qi = jnp.full((b,), -1, jnp.int32)
    t_full = _median_s(lambda: IV.ivf_topk(
        st.sketch, st.corpus, st.row_ids, st.centroids, st.starts, st.ends,
        qc, qi, K, nprobe=ivf.nprobe, win=ivf.win, wb=wb, refine=ivf.refine,
        exclude_self=False))
    return t_score, t_full


def _host_cpu():
    import jax

    return jax.devices("cpu")[0]


def _on_host(tree):
    import jax

    return jax.device_put(tree, _host_cpu())


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device(platform: str = "gpu", count: int = 1) -> Dict:
    """Check the platform and print the devices and the card's name and
    power limit."""
    import jax

    from similaritysearchbyrdf_tpu.utils.device import (card_line,
                                                        require_platform)

    dev = require_platform(platform)
    devs = jax.devices()
    check(len(devs) >= count,
          f"need {count} {platform} devices, JAX sees {len(devs)}")
    card = card_line() if platform == "gpu" else f"{dev.device_kind} (host)"
    log(f"device: {devs}; kind {dev.device_kind}")
    log(f"card: {card}")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(devs), "card": card}


def phase_hash(n: int, d: int, seed: int, card: str) -> Dict:
    """Hash bits (canonical 10 tables x 3 permutations, chain 32) against
    a numpy float64 sign-hash of the same projections."""
    import jax.numpy as jnp

    from similaritysearchbyrdf_tpu.config import RDFConfig, TableConfig
    from similaritysearchbyrdf_tpu.models.families import generate_model
    from similaritysearchbyrdf_tpu.ops.hashing import (hash_dense,
                                                       hash_dense_with_margins)

    conf = RDFConfig(vector_dim=d, table_num=10, permutation_num=3,
                     lsh_table=TableConfig(chain_length=32), seed=seed)
    model = generate_model(conf)
    x, _ = make_dense(n, 0, d, seed)
    (h, (h2, margins)), secs = _timed(lambda: (
        hash_dense(model, jnp.asarray(x)),
        hash_dense_with_margins(model, jnp.asarray(x))))
    h, h2 = np.asarray(h), np.asarray(h2)
    proj = np.asarray(model.proj, np.float64)           # [T, C, D]
    perm = np.asarray(model.perm)                       # [T, P, C]
    dots = np.einsum("bd,tcd->btc", x.astype(np.float64), proj)
    t, p, c = perm.shape
    pd = np.take_along_axis(dots[:, :, None, :],
                            perm[None].astype(np.int64), axis=-1)  # [B,T,P,C]
    # chain position j of table (t, p) packs at bit 31 - j
    got_bits = (h[..., None] >> np.arange(31, 31 - c, -1).astype(np.uint32)
                ) & 1
    ref_bits = (pd > 0).reshape(n, t * p, c)
    differ = got_bits.astype(bool) != ref_bits
    near = np.abs(pd).reshape(n, t * p, c) < HASH_NEAR_ZERO
    n_diff = int(differ.sum())
    n_near = int((differ & near).sum())
    margin_ref = np.abs(pd).reshape(n, t * p, c)[..., ::-1]
    margin_err = float(np.abs(np.asarray(margins)[..., 32 - c:]
                              - margin_ref).max())
    log(f"hash: {n} rows x {d}d, {t}x{p} tables, chain {c}: {n_diff} bits "
        f"differ from float64, {n_near} of them at |dot| < {HASH_NEAR_ZERO} "
        f"(allowed); margins max err {margin_err:.2e}; {secs:.3f} s on "
        f"{card}")
    check(n_diff == n_near,
          f"{n_diff - n_near} hash bits differ outside |dot| < "
          f"{HASH_NEAR_ZERO}")
    check((h2 == h).all(), "hash_dense_with_margins disagrees with "
          "hash_dense")
    check(margin_err < 1e-4, f"margin error {margin_err}")
    return {"bits_differ": n_diff, "bits_near_zero": n_near}


def phase_gt(x, q, card: str, n_check: int = 256):
    """Exact top-k on the default device at HIGHEST precision
    (`ops/exact.py`), checked against float64."""
    from similaritysearchbyrdf_tpu.ops.exact import exact_search

    (gt_ids, gt_sc), secs = _timed(lambda: exact_search(x, q, K))
    ref_ids, ref_sc = numpy_topk(x, q[:n_check], K)
    bad = gt_mismatches(gt_ids[:n_check], ref_ids, ref_sc)
    log(f"ground truth: {len(q)} queries over {len(x)} rows in {secs:.2f} s "
        f"on {card}; {bad} of {n_check} differ from float64 beyond "
        f"10th/11th gaps < {GT_TIE_TOL}")
    check(bad == 0, f"{bad} ground-truth rows differ from float64")
    return gt_ids


def _parity_log(name, bad, ties, n):
    log(f"{name} parity: GPU vs host CPU on {n} queries: {bad} rows differ "
        f"beyond near-ties (< {TIE_TOL}), {ties} at near-ties")
    check(bad == 0, f"{name}: {bad} rows differ between backends")


def glove_forest_conf(d: int = GLOVE_D, query_batch: int = 128, **kw):
    """The canonical forest (tables 10 x 3, chain 32, overflow 500,
    partition bits 3) with the int8 lane coarse tier in window mode."""
    from similaritysearchbyrdf_tpu.config import RDFConfig, TableConfig

    base = dict(vector_dim=d, table_num=10, permutation_num=3,
                family_size=100, partition_bits=3,
                lsh_table=TableConfig(chain_length=32, bucket_overflow=500),
                query_batch_size=query_batch, max_candidates=65536, top_k=K,
                coarse_dim=32, coarse_dtype="int8", coarse_refine=1024)
    base.update(kw)
    return RDFConfig(**base)


def phase_forest(x, q, gt, conf, card: str, n_parity: int = PARITY_Q,
                 floor: float = FLOORS["forest_steps1"]):
    import copy

    import jax

    from similaritysearchbyrdf_tpu.index.forest import RDFForest
    from similaritysearchbyrdf_tpu.vectors import DenseBatch

    forest = RDFForest(conf)
    _, fit_s = _timed(lambda: forest.fit(
        DenseBatch(np.arange(len(x), dtype=np.int32), x)).state)
    out = {"fit_s": fit_s}
    for steps in (0, 1):
        (ids, sc), first_s = _timed(lambda: forest.query(q, steps=steps))
        (ids, sc), secs = _timed(lambda: forest.query(q, steps=steps))
        r = recall(ids, gt)
        out[steps] = (ids, sc, r)
        t_score, t_full = forest_window_share(forest, q, steps)
        log(f"forest steps={steps}: recall@10 {r:.4f} on {len(q)} queries; "
            f"query {secs:.3f} s warm ({first_s:.1f} s first call), fit "
            f"{fit_s:.1f} s; one {conf.query_batch_size}-query step "
            f"{t_full * 1e3:.3f} ms, its window gather + coarse score alone "
            f"{t_score * 1e3:.3f} ms ({t_score / t_full:.2f}); on {card}")
    check(out[1][2] >= floor, f"forest steps=1 recall {out[1][2]} < {floor}")
    host = copy.copy(forest)
    host.state = _on_host(forest.state)
    with jax.default_device(_host_cpu()):
        c_ids, c_sc = host.query(q[:n_parity], steps=1)
    _parity_log("forest", *parity(out[1][0][:n_parity], out[1][1][:n_parity],
                                  c_ids, c_sc), n_parity)
    out["forest"] = forest
    return out


def phase_flat(x, q, gt, card: str, n_parity: int = PARITY_Q,
               floor: float = FLOORS["flat"]):
    import copy

    import jax

    from similaritysearchbyrdf_tpu.ops.flat import FlatIndex
    from similaritysearchbyrdf_tpu.vectors import DenseBatch

    fi = FlatIndex(mode="grouped")
    _, fit_s = _timed(lambda: fi.fit(
        DenseBatch(np.arange(len(x), dtype=np.int32), x)).sketch)
    (ids, sc), first_s = _timed(lambda: fi.query(q))
    (ids, sc), secs = _timed(lambda: fi.query(q))
    r = recall(ids, gt)
    log(f"flat (grouped): recall@10 {r:.4f} on {len(q)} queries; query "
        f"{secs:.3f} s warm ({first_s:.1f} s first call), fit {fit_s:.1f} s, "
        f"on {card}")
    check(r >= floor, f"flat recall {r} < {floor}")
    host = copy.copy(fi)
    host.sketch, host.corpus, host.row_ids = _on_host(
        (fi.sketch, fi.corpus, fi.row_ids))
    with jax.default_device(_host_cpu()):
        c_ids, c_sc = host.query(q[:n_parity])
    _parity_log("flat", *parity(ids[:n_parity], sc[:n_parity], c_ids, c_sc),
                n_parity)
    return {"recall": r, "query_s": secs, "index": fi}


def phase_ivf(x, q, gt, card: str, n_parity: int = PARITY_Q,
              n_tune: int = 128, floor: float = FLOORS["ivf"]):
    import copy

    import jax

    from similaritysearchbyrdf_tpu.ops.ivf import IVFFlatIndex, tune_nprobe
    from similaritysearchbyrdf_tpu.vectors import DenseBatch

    ivf = IVFFlatIndex(target_cluster=256, win=64, refine=128)
    _, fit_s = _timed(lambda: ivf.fit(
        DenseBatch(np.arange(len(x), dtype=np.int32), x)).state.sketch)
    nprobe = tune_nprobe(ivf, q[:n_tune], 0.95)
    (ids, sc), first_s = _timed(lambda: ivf.query(q))
    (ids, sc), secs = _timed(lambda: ivf.query(q))
    r = recall(ids, gt)
    t_score, t_full = ivf_window_share(ivf, q)
    log(f"ivf: nprobe {nprobe} (tune_nprobe 0.95 on {n_tune} queries), "
        f"recall@10 {r:.4f} on {len(q)} queries; query {secs:.3f} s warm "
        f"({first_s:.1f} s first call), fit {fit_s:.1f} s; one "
        f"{min(len(q), ivf.query_batch)}-query step {t_full * 1e3:.3f} ms, "
        f"its window gather + score alone {t_score * 1e3:.3f} ms "
        f"({t_score / t_full:.2f}); on {card}")
    check(r >= floor, f"ivf recall {r} < {floor}")
    host = copy.copy(ivf)
    host.state = _on_host(ivf.state)
    with jax.default_device(_host_cpu()):
        c_ids, c_sc = host.query(q[:n_parity])
    _parity_log("ivf", *parity(ids[:n_parity], sc[:n_parity], c_ids, c_sc),
                n_parity)
    return {"recall": r, "nprobe": nprobe, "query_s": secs}


# every cluster's ~200 rows share one support and sit in ~200 distinct
# 64-row groups of the flat sketch, so the engine's default 30-group select
# keeps too few of them (recall@10 0.867 at 1M rows, host CPU); the smoke
# keeps more groups than a cluster spans
SPARSE_FLAT = dict(refine=512, r_groups=256, query_batch=64)


def phase_sparse(n: int, dim: int, nnz: int, nq: int, seed: int, card: str,
                 n_clusters: int = 5000, coarse_refine: int = 6144,
                 flat_kw: Optional[dict] = None,
                 floors=(FLOORS["sparse_forest"], FLOORS["sparse_flat"])):
    """deploy.sparse forest and SparseFlatIndex against exact sparse GT
    (queries are the first `nq` corpus rows, self excluded)."""
    import jax.numpy as jnp

    from similaritysearchbyrdf_tpu.config import RDFConfig, TableConfig
    from similaritysearchbyrdf_tpu.deploy.sparse import SparseRDFInit
    from similaritysearchbyrdf_tpu.ops.exact import exact_topk_sparse
    from similaritysearchbyrdf_tpu.ops.flat import SparseFlatIndex

    batch = make_sparse(n, dim, nnz, seed, n_clusters=n_clusters)
    qb = batch.slice(0, nq)
    qd = np.zeros((nq, dim), np.float32)
    np.put_along_axis(qd, qb.indices, qb.values, axis=1)
    c_idx, c_val = jnp.asarray(batch.indices), jnp.asarray(batch.values)
    t0 = time.perf_counter()
    gt = []
    for s0 in range(0, nq, 256):
        g, _ = exact_topk_sparse(c_idx, c_val, jnp.asarray(qd[s0:s0 + 256]),
                                 K, exclude_diag_offset=s0)
        gt.append(np.asarray(g))
    gt = np.concatenate(gt)
    gt_s = time.perf_counter() - t0
    del c_idx, c_val

    conf = RDFConfig(
        vector_dim=dim, table_num=10, permutation_num=3, family_size=100,
        partition_bits=3,
        lsh_table=TableConfig(chain_length=32, bucket_overflow=500),
        query_batch_size=64, max_candidates=16384, top_k=K,
        coarse_dim=64, coarse_dtype="int8", coarse_refine=coarse_refine,
    )
    init = SparseRDFInit()
    init.initialize_rdf_hash_map(conf)
    _, fit_s = _timed(lambda: init.fit_batch(batch))
    qids = batch.ids[:nq]
    (ids, _), first_s = _timed(
        lambda: init.new_multi_thread_query_batch(qids, qb, steps=0))
    (ids, _), secs = _timed(
        lambda: init.new_multi_thread_query_batch(qids, qb, steps=0))
    r_forest = recall(ids, gt)
    log(f"sparse forest: {n} x {dim}d nnz {nnz}, coarse_refine "
        f"{coarse_refine}: recall@10 {r_forest:.4f} on {nq} queries; query "
        f"{secs:.3f} s warm ({first_s:.1f} s first call), fit {fit_s:.1f} s, "
        f"exact GT {gt_s:.1f} s, on {card}")
    init.clear_and_close()
    gc.collect()

    flat_kw = SPARSE_FLAT if flat_kw is None else flat_kw
    sf = SparseFlatIndex(**flat_kw)
    _, sfit_s = _timed(lambda: sf.fit(batch).sketch)
    (ids, _), sfirst_s = _timed(
        lambda: sf.query(qb.indices, qb.values, k=K, query_ids=qids))
    (ids, _), ssecs = _timed(
        lambda: sf.query(qb.indices, qb.values, k=K, query_ids=qids))
    r_flat = recall(ids, gt)
    log(f"sparse flat ({flat_kw}): recall@10 {r_flat:.4f} on {nq} queries; "
        f"query {ssecs:.3f} s warm ({sfirst_s:.1f} s first call), fit "
        f"{sfit_s:.1f} s, on {card}")
    check(r_forest >= floors[0],
          f"sparse forest recall {r_forest} < {floors[0]}")
    check(r_flat >= floors[1], f"sparse flat recall {r_flat} < {floors[1]}")
    return {"forest": r_forest, "flat": r_flat}


def phase_kernel(sketch, q, card: str, wide_d: int = SPARSE_D,
                 wide_rows: int = SPARSE_N, wide_b: int = 64,
                 interpret: bool = False, seed: int = 0):
    """The Triton group-max kernel against its plain reference, bit for bit
    (integer arithmetic): argmax-packed on the flat sketch, and unpacked at
    the sparse flat engine's densified width, row count (over 2 GiB of
    int8) and query batch."""
    import jax
    import jax.numpy as jnp

    from similaritysearchbyrdf_tpu.ops.flat import (_BLOCK_N, _query_lp,
                                                    group_max_plain)
    from similaritysearchbyrdf_tpu.ops.pallas.groupmax import (
        group_max_pallas)

    nrows, d = sketch.shape
    npad = -(-nrows // _BLOCK_N) * _BLOCK_N
    cases = [("flat sketch, packed", jnp.pad(sketch, ((0, npad - nrows),
                                                       (0, 0))),
              _query_lp(jnp.asarray(q), jnp.int8, d), True)]
    k1, k2 = jax.random.split(jax.random.key(seed))
    wpad = -(-wide_rows // _BLOCK_N) * _BLOCK_N
    wsk = jax.random.randint(k1, (wpad, wide_d), -127, 128, jnp.int8)
    wq = jax.random.randint(k2, (wide_b, wide_d), -127, 128, jnp.int8)
    cases.append((f"{wide_d}-wide, unpacked", wsk, wq, False))
    kern = jax.jit(functools.partial(group_max_pallas, interpret=interpret),
                   static_argnames=("pack",))
    plain = jax.jit(group_max_plain, static_argnames=("group", "pack"))
    for name, sk, qq, pack in cases:
        got, k_s = _timed(lambda: kern(qq, sk, pack=pack))
        got, k_s = _timed(lambda: kern(qq, sk, pack=pack))
        ref, p_s = _timed(lambda: plain(qq, sk, pack=pack))
        ref, p_s = _timed(lambda: plain(qq, sk, pack=pack))
        ndiff = int((np.asarray(got) != np.asarray(ref)).sum())
        log(f"kernel flat_group_max ({name}): [{qq.shape[0]} x {sk.shape[1]}]"
            f" x [{sk.shape[0]} rows]: {ndiff} of {got.size} outputs differ "
            f"from the plain version (tolerance 0, int8 x int8 -> int32); "
            f"kernel {k_s * 1e3:.3f} ms, plain {p_s * 1e3:.3f} ms (warm, "
            f"one call) on {card}")
        check(ndiff == 0, f"group-max kernel differs in {ndiff} outputs")
    del wsk


def phase_memory(forest, fi, q, card: str) -> None:
    """`compiled.memory_analysis()` of one forest and one flat query step."""
    import jax.numpy as jnp

    from similaritysearchbyrdf_tpu.index.forest import query_dense_many
    from similaritysearchbyrdf_tpu.ops.flat import flat_topk_grouped

    conf = forest.conf
    bs = conf.query_batch_size
    qd = jnp.asarray(q[:bs])
    qi = jnp.full((bs,), -1, jnp.int32)
    steps = {
        "forest query (steps=1, chunk %d)" % bs: query_dense_many.lower(
            forest.state, qd, qi, forest.layout, steps=1,
            m_cap=conf.max_candidates, k=K, multiprobe=True,
            exclude_self=False, chunk=bs, coarse_refine=conf.coarse_refine,
            coarse_window=conf.coarse_window, window_keep=conf.coarse_keep,
            head_pool=conf.coarse_head_pool, coarse_group=conf.coarse_group,
            rows_keep=conf.coarse_rows_keep,
            select_mult=conf.coarse_select_mult, stage2=conf.coarse_stage2),
    }
    fb = min(fi.query_batch, len(q))
    steps["flat query (grouped, batch %d)" % fb] = flat_topk_grouped.lower(
        fi.sketch, fi.corpus, fi.row_ids, jnp.asarray(q[:fb]),
        jnp.full((fb,), -1, jnp.int32), K, refine=fi.refine,
        r_groups=max(fi.r_groups, 3 * K))
    for name, lowered in steps.items():
        ma = lowered.compile().memory_analysis()
        fields = ("argument_size_in_bytes", "output_size_in_bytes",
                  "temp_size_in_bytes", "generated_code_size_in_bytes")
        desc = ", ".join(f"{f.replace('_in_bytes', '')} "
                         f"{getattr(ma, f, 'n/a')}" for f in fields)
        log(f"memory_analysis {name}: {desc} (bytes) on {card}")


def phase_four_cards(n_per_card: int, nq: int, d: int, seed: int, card: str,
                     ndev: int = 4, n_centers: int = 50_000,
                     query_batch: int = 128,
                     forest_kw: Optional[dict] = None):
    """The sharded forest, flat and IVF engines on a 1-D mesh of `ndev`
    devices, each holding `n_per_card` rows, against exact GT computed on
    one device."""
    import jax
    import jax.numpy as jnp

    from similaritysearchbyrdf_tpu.index.bucket_table import KeyLayout
    from similaritysearchbyrdf_tpu.ops.ivf import tune_nprobe
    from similaritysearchbyrdf_tpu.parallel.mesh import make_forest_mesh
    from similaritysearchbyrdf_tpu.parallel.sharded_flat import (
        fit_flat_sharded, make_flat_query_fn)
    from similaritysearchbyrdf_tpu.parallel.sharded_forest import (
        fit_sharded, make_query_fn)
    from similaritysearchbyrdf_tpu.parallel.sharded_ivf import (
        ShardedIVFIndex)
    from similaritysearchbyrdf_tpu.vectors import DenseBatch

    n = n_per_card * ndev
    x, q = make_dense(n, nq, d, seed, n_centers=n_centers)
    with jax.default_device(jax.devices()[0]):
        gt = phase_gt(x, q, card, n_check=64)
    mesh = make_forest_mesh(ndev)
    devs = set(mesh.devices.flat)
    log(f"mesh: {mesh.shape} over {sorted(d.id for d in devs)}; {n} rows "
        f"({n_per_card} per device)")
    batch = DenseBatch(np.arange(n, dtype=np.int32), x)

    def placed(name, arrays):
        """Each row-sharded array spans the mesh's devices, one distinct
        slice of rows per device."""
        for a in arrays:
            check(a.sharding.device_set == devs,
                  f"{name}: array {a.shape} on {a.sharding.device_set}")
            shards = a.addressable_shards
            check(len({s.device for s in shards}) == ndev,
                  f"{name}: shards of {a.shape} on "
                  f"{[s.device for s in shards]}")
            check(all(s.data.shape[0] * ndev == a.shape[0] for s in shards)
                  and len({str(s.index) for s in shards}) == ndev,
                  f"{name}: shards of {a.shape} are not distinct row slices")
        log(f"{name}: {len(arrays)} row-sharded arrays, each one slice per "
            f"device on {ndev} distinct devices")

    qd = jnp.asarray(q)
    qi = jnp.full((nq,), -1, jnp.int32)
    conf = glove_forest_conf(d, query_batch=query_batch, **(forest_kw or {}))
    (state, _), fit_s = _timed(lambda: fit_sharded(conf, batch, mesh))
    placed("sharded forest", [a for a in (
        state.sorted_ids, state.corpus, state.row_ids,
        state.coarse_by_table) if a is not None])
    layout = KeyLayout.from_config(conf, conf.lsh_table)
    qfn = make_query_fn(mesh, layout, steps=1, m_cap=conf.max_candidates,
                        k=K, exclude_self=False,
                        has_lp=state.corpus_lp is not None,
                        has_coarse=state.coarse_by_table is not None,
                        coarse_refine=conf.coarse_refine)
    r_forest = []
    for s0 in range(0, nq, query_batch):
        ids, _, _ = qfn(state, qd[s0:s0 + query_batch],
                        qi[s0:s0 + query_batch])
        r_forest.append(np.asarray(ids))
    ids = np.concatenate(r_forest)
    r = recall(ids, gt)
    log(f"sharded forest steps=1: recall@10 {r:.4f} on {nq} queries, fit "
        f"{fit_s:.1f} s, on {ndev} x {card}")
    check(r >= FLOORS["forest_steps1"], f"sharded forest recall {r}")
    del state
    gc.collect()

    (fstate, _), fit_s = _timed(lambda: fit_flat_sharded(
        x, np.arange(n, dtype=np.int32), mesh))
    placed("sharded flat", list(fstate))
    fqfn = make_flat_query_fn(mesh, k=K, refine=128, mode="grouped")
    ids = np.concatenate([
        np.asarray(fqfn(fstate, qd[s0:s0 + 1024], qi[s0:s0 + 1024])[0])
        for s0 in range(0, nq, 1024)])
    r = recall(ids, gt)
    log(f"sharded flat (grouped): recall@10 {r:.4f} on {nq} queries, fit "
        f"{fit_s:.1f} s, on {ndev} x {card}")
    check(r >= FLOORS["flat"], f"sharded flat recall {r}")
    del fstate
    gc.collect()

    ivf = ShardedIVFIndex(mesh=mesh, target_cluster=256, win=64, refine=128)
    _, fit_s = _timed(lambda: ivf.fit(batch).state.sketch)
    placed("sharded ivf", (ivf.state.sketch, ivf.state.corpus,
                           ivf.state.row_ids))
    nprobe = tune_nprobe(ivf, q[:64], 0.95)
    ids = np.concatenate([ivf.query(q[s0:s0 + 1024])[0]
                          for s0 in range(0, nq, 1024)])
    r = recall(ids, gt)
    log(f"sharded ivf: nprobe {nprobe}, recall@10 {r:.4f} on {nq} queries, "
        f"fit {fit_s:.1f} s, on {ndev} x {card}")
    check(r >= FLOORS["ivf"], f"sharded ivf recall {r}")


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------


def run_single(seed: int, card: str, n: int = GLOVE_N, nq: int = GLOVE_Q,
               d: int = GLOVE_D, sparse_n: int = SPARSE_N,
               hash_rows: int = 8192, n_centers: int = 50_000,
               interpret: bool = False,
               sparse_kw: Optional[dict] = None) -> None:
    """Every one-card phase after the device check (`interpret` and the
    sizes are for rehearsals on the CPU)."""
    t0 = time.perf_counter()
    phase_hash(hash_rows, d, seed, card)
    x, q = make_dense(n, nq, d, seed, n_centers=n_centers)
    log(f"data: {n} x {d}d corpus + {nq} queries (easy_clustered, seed "
        f"{seed}) in {time.perf_counter() - t0:.1f} s")
    gt = phase_gt(x, q, card)
    fo = phase_forest(x, q, gt, glove_forest_conf(d), card)
    fl = phase_flat(x, q, gt, card)
    phase_kernel(fl["index"].sketch, q[:1024], card, interpret=interpret)
    phase_memory(fo["forest"], fl["index"], q, card)
    del fo, fl
    gc.collect()
    phase_ivf(x, q, gt, card)
    del x, q, gt
    gc.collect()
    if sparse_n < SPARSE_N:
        log(f"sparse rows cut from {SPARSE_N} to {sparse_n}")
    phase_sparse(sparse_n, SPARSE_D, SPARSE_NNZ, SPARSE_Q, seed, card,
                 **(sparse_kw or {}))


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded engines on four cards")
    args = ap.parse_args(argv)

    from similaritysearchbyrdf_tpu.utils.device import enable_compile_cache

    enable_compile_cache(HERE)
    count = 4 if args.four_cards else 1
    dev = phase_device("gpu", count)
    t0 = time.perf_counter()
    if args.four_cards:
        phase_four_cards(GLOVE_N, GLOVE_Q, GLOVE_D, args.seed, dev["card"])
    else:
        run_single(args.seed, dev["card"])
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": dev["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
