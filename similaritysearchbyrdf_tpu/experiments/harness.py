"""Experiment/evaluation harness — the reference's L5 tier as a library.

The reference runs experiments as ScalaTest suites that print timings and
precision (`src/test/scala/mclab/Experiments/*`, SURVEY.md §4). Each suite
becomes a function here returning structured results:

  recall_per_step_sweep     ← `TestSingleRDFSuite.scala:103-122`
  step_candidate_growth     ← `TestSingleRDFSuite.scala:95`
  sub_index_distribution    ← `TestSingleRDFSuite.scala:124-142`
  per_query_latency         ← `TestSingleRDFSuite.scala:144-170`
  best_partition_search     ← `PartitionDistributionSuite.scala:76-166`
  gt_hamming_analysis       ← `AnalysisGroundTruthSuite.scala:60-100`
  best_hash_family_search   ← `BestHashFamilySuite.scala:10-39`
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import jax.numpy as jnp
import numpy as np

from ..config import RDFConfig
from ..index.forest import RDFForest
from ..index.partitioner import generate_partition_projections, partition_of_hash
from ..models.families import generate_model
from ..ops.bitops import popcount
from ..ops.hashing import hash_dense
from ..vectors import DenseBatch


def exact_ground_truth(
    corpus: np.ndarray, queries: np.ndarray, k: int, exclude_self: bool = True
) -> np.ndarray:
    """Exact inner-product top-k on device (how GT files for the reference
    were produced offline)."""
    sims = jnp.asarray(queries) @ jnp.asarray(corpus).T
    if exclude_self and queries.shape[0] <= corpus.shape[0]:
        q = queries.shape[0]
        sims = sims.at[jnp.arange(q), jnp.arange(q)].set(-jnp.inf)
    import jax

    _, idx = jax.lax.top_k(sims, k)
    return np.asarray(idx)


def recall_at_k(ids: np.ndarray, gt: np.ndarray) -> float:
    k = gt.shape[1]
    hits = 0
    for i in range(gt.shape[0]):
        hits += len(set(gt[i].tolist()) & set(int(v) for v in ids[i] if v >= 0))
    return hits / (gt.shape[0] * k)


def error_ratio(found_scores: np.ndarray, gt_scores: np.ndarray) -> float:
    """Mean approximation ratio of the returned neighbors' similarities vs
    the true top-k similarities (rank-aligned). 1.0 = exact; the metric the
    reference's KNN-distance files exist for (`Vectors.KNNFromPython`,
    `Vector.scala:266-275`). Missing results (-inf) count as ratio 0."""
    fs = np.asarray(found_scores, dtype=np.float64)
    gs = np.asarray(gt_scores, dtype=np.float64)
    ratios = np.where(
        np.isfinite(fs) & (np.abs(gs) > 1e-12), fs / gs, 0.0
    )
    return float(np.clip(ratios, 0.0, None).mean())


@dataclasses.dataclass
class StepSweepResult:
    steps: int
    recall: float
    qps: float
    mean_candidates: float


def recall_per_step_sweep(
    forest: RDFForest,
    queries: np.ndarray,
    gt: np.ndarray,
    steps_list: Sequence[int] = (0, 1, 2),
    query_ids: Optional[np.ndarray] = None,
) -> List[StepSweepResult]:
    """Precision-per-step sweep (`TestSingleRDFSuite.scala:103-122`)."""
    from ..index.forest import query_dense

    out = []
    for steps in steps_list:
        t0 = time.perf_counter()
        ids, _ = forest.query(queries, steps=steps, query_ids=query_ids)
        dt = time.perf_counter() - t0
        # candidate counts
        b = min(len(queries), forest.conf.query_batch_size)
        _, _, ncand = query_dense(
            forest.state,
            jnp.asarray(queries[:b], jnp.float32),
            jnp.full((b,), -1, jnp.int32),
            forest.layout,
            steps=steps,
            m_cap=forest.conf.max_candidates,
            k=forest.conf.top_k,
        )
        out.append(
            StepSweepResult(
                steps=steps,
                recall=recall_at_k(ids, gt),
                qps=len(queries) / dt,
                mean_candidates=float(jnp.mean(ncand)),
            )
        )
    return out


def per_query_latency(
    forest: RDFForest, queries: np.ndarray, steps: int = 0, repeats: int = 3
) -> Dict[str, float]:
    """Mean per-query latency at the configured batch size
    (`TestSingleRDFSuite.scala:144-170`)."""
    forest.query(queries[:1], steps=steps)  # compile
    t0 = time.perf_counter()
    for _ in range(repeats):
        forest.query(queries, steps=steps)
    dt = (time.perf_counter() - t0) / repeats
    return {
        "total_s": dt,
        "per_query_ms": dt * 1000.0 / len(queries),
        "qps": len(queries) / dt,
    }


def best_partition_search(
    conf: RDFConfig,
    corpus: np.ndarray,
    queries: np.ndarray,
    gt: np.ndarray,
    n_candidates: int = 50,
    seed0: int = 0,
    out_path: "Optional[str]" = None,
) -> Tuple[int, np.ndarray]:
    """Pick the partition hash whose sub-indexes concentrate each query's
    ground-truth top-k into the query's home partition
    (`PartitionDistributionSuite.scala:76-166` scores 50 candidate
    partitioners the same way). Returns (best_seed, concentration_scores).

    With `out_path`, the winning projections are written in the reference's
    partition-checkpoint text format (the `partition-bestHashFamily-angle`
    flow) — directly loadable via `conf.partition_family_file_path`."""
    model = generate_model(conf)
    hq = hash_dense(model, jnp.asarray(queries, jnp.float32))    # [Q, L]
    hc = hash_dense(model, jnp.asarray(corpus, jnp.float32))     # [N, L]
    scores = np.zeros(n_candidates)
    for c in range(n_candidates):
        pp = generate_partition_projections(conf, seed=seed0 + 7717 * (c + 1))
        pq = np.asarray(partition_of_hash(hq, pp))               # [Q, L]
        pc = np.asarray(partition_of_hash(hc, pp))               # [N, L]
        # concentration: fraction of GT neighbors landing in the query's
        # home partition, averaged over tables
        same = (pc[gt] == pq[:, None, :]).mean()
        scores[c] = same
    best = int(np.argmax(scores))
    best_seed = seed0 + 7717 * (best + 1)
    if out_path is not None:
        from ..index.partitioner import save_partition_file

        save_partition_file(
            generate_partition_projections(conf, seed=best_seed), out_path
        )
    return best_seed, scores


def gt_hamming_analysis(
    conf: RDFConfig, corpus: np.ndarray, queries: np.ndarray, gt: np.ndarray
) -> Dict[str, float]:
    """Average Hamming distance between query hashes and their ground-truth
    neighbors' hashes vs random pairs (`AnalysisGroundTruthSuite.scala:
    60-100`) — the diagnostic for whether a hash family is locality
    sensitive on a dataset."""
    model = generate_model(conf)
    hq = hash_dense(model, jnp.asarray(queries, jnp.float32))
    hc = hash_dense(model, jnp.asarray(corpus, jnp.float32))
    gt_h = np.asarray(popcount(hq[:, None, :] ^ hc[jnp.asarray(gt)]))
    rng = np.random.default_rng(0)
    rand_idx = rng.integers(0, corpus.shape[0], size=gt.shape)
    rand_h = np.asarray(popcount(hq[:, None, :] ^ hc[jnp.asarray(rand_idx)]))
    return {
        "gt_mean_hamming": float(gt_h.mean()),
        "random_mean_hamming": float(rand_h.mean()),
        "separation": float(rand_h.mean() - gt_h.mean()),
    }


def recall_time_curve(
    forest: RDFForest,
    queries: np.ndarray,
    gt: np.ndarray,
    configs: Optional[Sequence[dict]] = None,
    query_ids: Optional[np.ndarray] = None,
    reps: int = 3,
) -> List[dict]:
    """Recall@k vs time operating-point curve — the framework's equivalent
    of the reference's results.png (time per 1000 queries vs recall, Fig. 5
    of the DPF paper). Each config is a kwargs dict for `RDFForest.query`
    (steps / multiprobe / probe_mode / probe_budget). Returns one point per
    config: {config, qps, time_s_per_1000, recall}.

    Timing is pipelined device-side (queries resident, dispatch `reps`
    full-batch programs, block once — the same methodology as bench.py):
    a blocked call pays a dispatch round trip that a streaming serving
    loop would not."""
    import jax
    import jax.numpy as jnp

    from ..index.forest import query_dense_many

    if configs is None:
        configs = [
            {"steps": 0, "multiprobe": False},
            {"steps": 0, "probe_mode": "margin", "probe_budget": 4},
            {"steps": 0, "probe_mode": "margin", "probe_budget": 8},
            {"steps": 0},
            {"steps": 1},
            {"steps": 2},
        ]
    conf = forest.conf
    nq = len(queries)
    bs = conf.query_batch_size
    pad = (-nq) % bs
    qd = jnp.asarray(np.pad(np.asarray(queries, np.float32),
                            ((0, pad), (0, 0))))
    qids_np = (
        np.asarray(query_ids, np.int32)
        if query_ids is not None
        else np.full((nq,), -1, np.int32)
    )
    qid_d = jnp.asarray(np.pad(qids_np, (0, pad), constant_values=-1))
    points = []
    for cfg in configs:
        kw = dict(
            layout=forest.layout,
            steps=cfg.get("steps", 0),
            m_cap=cfg.get("m_cap", conf.max_candidates),
            k=conf.top_k,
            multiprobe=cfg.get("multiprobe", True),
            exclude_self=query_ids is not None,
            chunk=bs,
            probe_mode=cfg.get("probe_mode", "reference"),
            probe_budget=cfg.get("probe_budget", 8),
            coarse_refine=cfg.get("coarse_refine", conf.coarse_refine),
            coarse_window=conf.coarse_window,
        )
        ids_d, _, _ = query_dense_many(forest.state, qd, qid_d, **kw)
        jax.block_until_ready(ids_d)                    # compile + warm
        t0 = time.perf_counter()
        for _ in range(reps):
            ids_d, _, _ = query_dense_many(forest.state, qd, qid_d, **kw)
        jax.block_until_ready(ids_d)
        # padded rows do real work; count them in the rate
        dt = (time.perf_counter() - t0) / reps * (nq / qd.shape[0])
        ids = np.asarray(ids_d)[:nq]
        points.append({
            "config": dict(cfg),
            "qps": len(queries) / dt,
            "time_s_per_1000": dt * 1000.0 / len(queries),
            "recall": recall_at_k(ids, gt),
        })
    return points


def best_hash_family_search(
    conf: RDFConfig,
    corpus_batch: DenseBatch,
    queries: np.ndarray,
    gt: np.ndarray,
    restarts: int = 10,
    steps: int = 0,
) -> Tuple[RDFForest, float, List[float]]:
    """N-restart search for the best-performing hash family
    (`BestHashFamilySuite.scala:10-39`: 10 restarts, keep the best by
    precision; the kept family can then be exported with
    `models.families.save_model_file` — the reference's
    `outPutTheHashFunctionsIntoFile`)."""
    best_forest, best_recall, history = None, -1.0, []
    for r in range(restarts):
        forest = RDFForest(conf, seed=conf.seed + 1013 * r)
        forest.fit(corpus_batch)
        ids, _ = forest.query(queries, steps=steps)
        rec = recall_at_k(ids, gt)
        history.append(rec)
        if rec > best_recall:
            best_forest, best_recall = forest, rec
    return best_forest, best_recall, history
