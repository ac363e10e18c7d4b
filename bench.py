"""Benchmark: QPS at recall@10 on a GloVe-100d-shaped workload, one chip.

Mirrors the reference's README smoke workload (GloVe twitter 100d, 20k
vectors, batch top-10 query — `/root/reference/README.md:31-43`,
`TestSingleRDFSuite.scala:24-61`) with the canonical index config
(tableNum=10, permutationNum=3, chainLength=32, bufferOverflow=500,
partitionBits=3 — `TestSettings.scala:19-45`). The corpus is synthetic
(zero-egress environment): a clustered mixture matching GloVe-like geometry,
with exact inner-product ground truth computed on device.

Baseline: the reference's published curve (results.png, Fig. 5) shows DPF at
~25 s per 1000 top-10 queries at recall ~0.9 on GloVe → ~40 QPS on a 32
GB-heap CPU host. vs_baseline is measured QPS / 40.

Requires a GPU: without one it fails instead of running on the host.
Prints the card's name and power limit on an earlier line, then ONE JSON
line:
  {"metric": ..., "value": ..., "unit": "qps", "vs_baseline": ...}
"""

import json
import os
import time

import numpy as np


N_CORPUS = 20_000
N_QUERY = 1_000
DIM = 100
TOP_K = 10
BASELINE_QPS = 40.0
STEPS = 0


def make_data(seed=42):
    """Clustered corpus with GloVe-like neighbor geometry: cluster siblings
    at cos ≈ 0.8 (per-dim noise 0.05 ⇒ noise norm ≈ 0.5 vs unit signal),
    which matches the similarity range where the reference reports its
    recall@10 ≈ 0.9 operating point."""
    rng = np.random.default_rng(seed)
    n_clusters = 512
    centers = rng.normal(size=(n_clusters, DIM))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    assign = rng.integers(0, n_clusters, size=N_CORPUS)
    x = centers[assign] + 0.05 * rng.normal(size=(N_CORPUS, DIM))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x.astype(np.float32)


def main():
    import jax
    import jax.numpy as jnp

    from similaritysearchbyrdf_tpu.utils.device import (
        card_line, enable_compile_cache, require_platform)

    enable_compile_cache(os.path.dirname(os.path.abspath(__file__)))
    dev = require_platform("gpu")
    card = card_line()
    print(f"bench: {len(jax.devices())} x {dev.device_kind}; card {card}",
          flush=True)

    from similaritysearchbyrdf_tpu.config import RDFConfig, TableConfig
    from similaritysearchbyrdf_tpu.index.forest import RDFForest
    from similaritysearchbyrdf_tpu.vectors import DenseBatch

    conf = RDFConfig(
        vector_dim=DIM,
        table_num=10,
        permutation_num=3,
        family_size=100,
        partition_bits=3,
        lsh_table=TableConfig(chain_length=32, bucket_overflow=500),
        query_batch_size=1024,
        max_candidates=4096,
        top_k=TOP_K,
        seed=31258,
        # table-ordered int8 coarse tier: candidate scoring gathers one
        # index per 8-row block instead of one per candidate; the cd=32
        # lane-packed tier (G=4 tables per 128-lane row) keeps resident
        # coarse bytes 4x below cd=128
        coarse_dim=32,
        coarse_dtype="int8",
        coarse_refine=384,
    )
    # margin-directed probing: only the 16 smallest-margin bits per table
    probe_kw = dict(probe_mode="margin", probe_budget=16)

    x = make_data()
    ids = np.arange(N_CORPUS, dtype=np.int32)
    queries = x[:N_QUERY]
    qids = ids[:N_QUERY]

    # exact ground truth (self excluded) on device, at HIGHEST precision (a
    # default f32 matmul may run in TF32 and reorder near-ties)
    xd = jnp.asarray(x)
    qd = jnp.asarray(queries)
    sims = jnp.matmul(qd, xd.T, precision=jax.lax.Precision.HIGHEST)
    sims = sims.at[jnp.arange(N_QUERY), jnp.arange(N_QUERY)].set(-jnp.inf)
    _, gt = jax.lax.top_k(sims, TOP_K)
    gt = np.asarray(gt)

    forest = RDFForest(conf)

    # --- index build: first fit compiles, second fit is the steady-state
    # build time (the reference's multithread fit numbers are steady-state
    # JVM too) ---
    forest.fit(DenseBatch(ids, x))
    nb_pad = forest.state.tables.bucket_keys.shape[1]
    from similaritysearchbyrdf_tpu.index.forest import fit_dense

    # Steady-state build rate: best of 3 warm fits from a DEVICE-RESIDENT
    # corpus, with the one-time host->device ingest timed separately (the
    # reference's own fit metric starts from JVM-heap-resident vectors,
    # `DensevectorRDFInit.scala:161-206`).
    t0 = time.perf_counter()
    xd_fit = jnp.asarray(x)
    xd_fit.block_until_ready()
    ingest_s = time.perf_counter() - t0
    build_s = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        forest.state = fit_dense(
            conf, DenseBatch(ids, xd_fit), model=forest.model,
            part_proj=forest.part_proj, nb_pad=nb_pad,
        )
        jax.block_until_ready(forest.state.tables.sorted_keys)
        build_s = min(build_s, time.perf_counter() - t0)
    build_vps = N_CORPUS / build_s

    # --- query: sweep steps until recall >= 0.85 (the reference's headline
    # numbers are at recall ~0.9; QPS is only comparable at matched recall) ---
    def run(steps, reps=4):
        """Pipelined timing: dispatch `reps` full-batch query programs and
        block once — measures device throughput without paying a host
        round trip per call (queries stream in production)."""
        from similaritysearchbyrdf_tpu.index.forest import query_dense_many

        bs = conf.query_batch_size
        pad = (-N_QUERY) % bs
        qd = jnp.asarray(np.pad(queries, ((0, pad), (0, 0))))
        qid_d = jnp.asarray(np.pad(qids, (0, pad), constant_values=-1))
        kw = dict(
            layout=forest.layout, steps=steps, m_cap=conf.max_candidates,
            k=TOP_K, multiprobe=True, exclude_self=True,
            chunk=conf.query_batch_size, coarse_refine=conf.coarse_refine,
            coarse_window=conf.coarse_window, **probe_kw,
        )
        got_ids, _, _ = query_dense_many(forest.state, qd, qid_d, **kw)
        jax.block_until_ready(got_ids)                       # compile + warm
        t0 = time.perf_counter()
        for _ in range(reps):
            got_ids, _, _ = query_dense_many(forest.state, qd, qid_d, **kw)
        jax.block_until_ready(got_ids)
        # padded rows do real work; count them in the rate, score the real ones
        query_s = (time.perf_counter() - t0) / reps * (N_QUERY / qd.shape[0])
        got_ids = np.asarray(got_ids)[:N_QUERY]
        recall = 0.0
        for i in range(N_QUERY):
            recall += len(
                set(gt[i].tolist()) & set(int(v) for v in got_ids[i] if v >= 0)
            )
        recall /= N_QUERY * TOP_K
        return N_QUERY / query_s, recall

    results = {}
    for steps in (0, 1):
        qps, recall = run(steps)
        results[steps] = (qps, recall)
        if recall >= 0.85:
            break
    best_steps = max(results, key=lambda s: (results[s][1] >= 0.85, results[s][0]))
    qps, recall = results[best_steps]

    bytes_per_vec = forest.index_bytes_per_vector()
    coarse_bpv = 0.0
    if forest.state.coarse_by_table is not None:
        cbt = forest.state.coarse_by_table
        coarse_bpv = cbt.size * cbt.dtype.itemsize / N_CORPUS

    # --- flat engine point (ops/flat.py): int8 sketch scan + exact
    # refine; reported alongside the forest metric ---
    from similaritysearchbyrdf_tpu.ops.flat import build_flat_sketch, flat_topk

    sketch, _ = build_flat_sketch(xd, "int8")
    row_ids_d = jnp.asarray(ids)
    pad = (-N_QUERY) % 1024
    qfd = jnp.asarray(np.pad(queries, ((0, pad), (0, 0))))
    qfid = jnp.asarray(np.pad(qids, (0, pad), constant_values=-1))
    f_ids, _ = flat_topk(sketch, xd, row_ids_d, qfd, qfid, TOP_K, refine=128)
    jax.block_until_ready(f_ids)
    t0 = time.perf_counter()
    for _ in range(8):
        f_ids, _ = flat_topk(sketch, xd, row_ids_d, qfd, qfid, TOP_K,
                             refine=128)
    jax.block_until_ready(f_ids)
    flat_s = (time.perf_counter() - t0) / 8 * (N_QUERY / qfd.shape[0])
    f_np = np.asarray(f_ids)[:N_QUERY]
    flat_recall = sum(
        len(set(gt[i].tolist()) & set(int(v) for v in f_np[i] if v >= 0))
        for i in range(N_QUERY)
    ) / (N_QUERY * TOP_K)
    flat_qps = N_QUERY / flat_s

    # headline = best engine at recall >= the reference's ~0.9 operating
    # point; the forest (reference candidate-set semantics) and the flat
    # engine (exhaustive scan) are both part of the framework. The metric
    # name carries the engine so a flat-engine headline is never mistaken
    # for the forest's ANN number.
    if flat_recall >= max(0.85, recall - 0.005) and flat_qps > qps:
        head_qps, head_recall, head_engine = flat_qps, flat_recall, "flat"
    else:
        head_qps, head_recall, head_engine = qps, recall, "forest"
    print(
        json.dumps(
            {
                "metric": f"glove100d_20k_qps_at_recall10_{head_engine}",
                "value": round(head_qps, 2),
                "unit": "qps",
                "vs_baseline": round(head_qps / BASELINE_QPS, 2),
                "engine": head_engine,
                "recall_at_10": round(head_recall, 4),
                "forest_qps": round(qps, 2),
                "forest_recall_at_10": round(recall, 4),
                "build_vectors_per_sec": round(build_vps, 1),
                "build_ingest_s": round(ingest_s, 3),
                "index_bytes_per_vector": round(bytes_per_vec, 1),
                "coarse_tier_bytes_per_vector": round(coarse_bpv, 1),
                "steps": best_steps,
                "query_time_s_per_1000": round(1000.0 / head_qps, 4),
                "all_points": {str(s): [round(q, 1), round(r, 4)] for s, (q, r) in results.items()},
                "flat_qps": round(flat_qps, 1),
                "flat_recall_at_10": round(flat_recall, 4),
                "platform": dev.platform,
                "device_kind": dev.device_kind,
                "device_count": len(jax.devices()),
                "card": card,
            }
        )
    )


if __name__ == "__main__":
    main()
