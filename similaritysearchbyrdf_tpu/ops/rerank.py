"""Exact top-k re-ranking of candidate sets.

Replaces the reference's breeze `argsort(dataMatrix * queryVec)` re-rank
(HOT LOOP #4, `DensevectorRDFInit.scala:487-490`) with a batched
gather → dot → sort-select → narrow dedup → top-k. Scoring is inner-product
similarity, matching the reference.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

# plain Python scalars, not jnp constants: creating a device array at import
# time would initialize the XLA backend, which must not happen before
# jax.distributed.initialize() in multi-process runs
NEG_INF = float("-inf")


_SENTINEL = 2**31 - 1

# Largest sparse feature-space size the sort-merge re-rank supports: keys
# pack as index*2(+1) in int32 with pad sentinels 2**31-2 / 2**31-1, so
# every real index must satisfy idx*2+1 < 2**31-2.
MAX_MERGE_FEATURE_SIZE = 2**30 - 1


def check_sparse_size_for_merge(size: int) -> None:
    """Guard (call at fit time) that feature indices can never collide with
    the sort-merge pad sentinels of `sparse_merge_scores`."""
    if size > MAX_MERGE_FEATURE_SIZE:
        raise ValueError(
            f"sparse feature-space size {size} exceeds the sort-merge "
            f"re-rank limit {MAX_MERGE_FEATURE_SIZE} (int32 key packing)"
        )


def score_candidates(
    corpus: jax.Array, cand: jax.Array, queries: jax.Array,
    compute_dtype=jnp.float32,
) -> jax.Array:
    """Masked inner-product scores f32[B, M] of candidate rows. The corpus
    may be LANE-PADDED (minor dim a 128 multiple, zero columns); queries
    pad here to match — zero lanes add nothing to the dot."""
    valid = cand >= 0
    safe = jnp.maximum(cand, 0)
    vecs = jnp.take(corpus, safe, axis=0)  # [B, M, D]
    if corpus.shape[1] != queries.shape[1]:
        queries = jnp.pad(
            queries, ((0, 0), (0, corpus.shape[1] - queries.shape[1]))
        )
    # HIGHEST: a default-precision f32 matmul may round its operands (TF32
    # on the GPU), which flips near-ties against true-f32 ordering (see
    # ops/flat._exact_refine). The candidate slab is tiny.
    scores = jnp.einsum(
        "bmd,bd->bm",
        vecs.astype(compute_dtype),
        queries.astype(compute_dtype),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    return jnp.where(valid, scores, NEG_INF)


def dedup_topk(cand: jax.Array, scores: jax.Array, k: int) -> Tuple[jax.Array, jax.Array]:
    """Top-k of (id, score) pairs with duplicate ids collapsed. Duplicates
    carry equal scores (same vector scored from different tables/probes), so
    keeping any one copy is exact. Sorting is over the SMALL post-top-m
    buffer — the candidate buffer itself is never id-sorted."""
    ids_s, sc_s = jax.lax.sort(
        (jnp.where(cand >= 0, cand, _SENTINEL), scores), dimension=1, num_keys=1
    )
    dup = jnp.concatenate(
        [jnp.zeros_like(ids_s[:, :1], dtype=bool), ids_s[:, 1:] == ids_s[:, :-1]],
        axis=1,
    )
    sc_s = jnp.where(dup | (ids_s == _SENTINEL), NEG_INF, sc_s)
    top_scores, ti = jax.lax.top_k(sc_s, k)
    top_ids = jnp.take_along_axis(ids_s, ti, axis=1)
    top_ids = jnp.where(top_scores > NEG_INF, top_ids, -1)
    return top_ids, top_scores


def _dedup_width(m: int, k: int, dup_bound: int) -> int:
    """Every id appears at most `dup_bound` times in the candidate buffer
    (once per table after bucket-range dedup), so the unique top-k is
    guaranteed inside the top (k+1)*dup_bound scored slots."""
    return min(m, (k + 1) * max(1, dup_bound))


def _select_top(scores: jax.Array, cand: jax.Array, m2: int):
    """(top scores, their candidate ids) for the widest slice. lax.top_k is
    O(n*k) — for the wide dedup slice a full descending sort is cheaper."""
    if m2 <= 32:
        s2, idx = jax.lax.top_k(scores, m2)
        return s2, jnp.take_along_axis(cand, idx, axis=1)
    neg, c2 = jax.lax.sort((-scores, cand), dimension=1, num_keys=1)
    return -neg[:, :m2], c2[:, :m2]


@functools.partial(jax.jit, static_argnames=("k", "dup_bound", "compute_dtype"))
def rerank_dense(
    corpus: jax.Array,      # f32[N, D]
    cand: jax.Array,        # i32[B, M] candidate row positions (-1 = invalid)
    queries: jax.Array,     # f32[B, D]
    k: int,
    dup_bound: int = 1,
    compute_dtype=jnp.float32,
) -> Tuple[jax.Array, jax.Array]:
    """Returns (ids i32[B, k] with -1 padding, scores f32[B, k]).
    `dup_bound` is the max copies of one id in `cand` (the table count); the
    full buffer is scored once and only the top slice is dedup-sorted."""
    scores = score_candidates(corpus, cand, queries, compute_dtype)
    m2 = _dedup_width(cand.shape[1], k, dup_bound)
    s2, c2 = _select_top(scores, cand, m2)
    return dedup_topk(c2, s2, k)


@functools.partial(jax.jit, static_argnames=("k", "dup_bound", "refine"))
def rerank_dense_two_stage(
    corpus_lp: jax.Array,    # bf16[N, D] low-precision copy (coarse pass)
    corpus: jax.Array,       # f32[N, D] exact copy (refinement pass)
    cand: jax.Array,         # i32[B, M] (-1 = invalid)
    queries: jax.Array,      # f32[B, D]
    k: int,
    dup_bound: int = 1,
    refine: int = 128,
) -> Tuple[jax.Array, jax.Array]:
    """Coarse bf16 scoring of all M candidates (half the gather traffic),
    then exact f32 re-scoring + dedup of the top slice — exact final ranking
    as long as the true unique top-k sits within the bf16 top slice (bf16
    relative error ~0.4%; the slice is at least `refine` wide)."""
    m2 = max(_dedup_width(cand.shape[1], k, dup_bound), min(refine, cand.shape[1]))
    coarse = score_candidates(corpus_lp, cand, queries, jnp.bfloat16)
    _, c2 = _select_top(coarse, cand, m2)                       # [B, m2]
    exact = score_candidates(corpus, c2, queries)
    return dedup_topk(c2, exact, k)


@functools.partial(jax.jit, static_argnames=("k", "dup_bound"))
def rerank_sparse(
    corpus_indices: jax.Array,  # i32[N, NNZ]
    corpus_values: jax.Array,   # f32[N, NNZ]
    cand: jax.Array,            # i32[B, M] (-1 = invalid)
    query_dense: jax.Array,     # f32[B, D] (densified queries)
    k: int,
    dup_bound: int = 1,
) -> Tuple[jax.Array, jax.Array]:
    """Sparse-corpus re-rank: gather candidate rows' (idx, val) pairs and
    accumulate val * query[idx]. The query side is densified (queries are a
    small batch; the corpus stays sparse). This computes the *correct*
    sparse·dense dot — deliberately not the reference's positional-zip bug
    (`SimilarityCalculator.scala:40-49`, flagged by SURVEY.md §7(f))."""
    valid = cand >= 0
    safe = jnp.maximum(cand, 0)
    c_idx = jnp.take(corpus_indices, safe, axis=0)  # [B, M, NNZ]
    c_val = jnp.take(corpus_values, safe, axis=0)   # [B, M, NNZ]
    q_gather = jnp.take_along_axis(
        query_dense[:, None, :], c_idx, axis=2
    )                                                # [B, M, NNZ]
    scores = jnp.sum(c_val * q_gather, axis=-1)
    scores = jnp.where(valid, scores, NEG_INF)
    m2 = _dedup_width(cand.shape[1], k, dup_bound)
    s2, c2 = _select_top(scores, cand, m2)
    return dedup_topk(c2, s2, k)


def sparse_merge_scores(
    corpus_indices: jax.Array,  # i32[N, NNZ]
    corpus_values: jax.Array,   # f32[N, NNZ]
    cand: jax.Array,            # i32[B, M] (-1 = invalid)
    q_indices: jax.Array,       # i32[B, NNZq]
    q_values: jax.Array,        # f32[B, NNZq]
) -> jax.Array:
    """Exact sparse·sparse scores f32[B, M] by sort-merge (-inf invalid);
    the scoring core of `rerank_sparse_merge`, reusable by other engines
    (the sparse flat engine's exact tail)."""
    valid = cand >= 0
    safe = jnp.maximum(cand, 0)
    c_idx = jnp.take(corpus_indices, safe, axis=0)   # [B, M, NNZ]
    c_val = jnp.take(corpus_values, safe, axis=0)
    b, m, nnz = c_idx.shape
    nnzq = q_indices.shape[1]
    # pad keys sit at the very top of int32 so no real feature index can
    # collide: idx*2(+1) for idx < 2**30-1 stays below 2**31-3 (callers
    # guard the feature-space size via check_sparse_size_for_merge)
    big = jnp.int32(2**31 - 2)
    kc = jnp.where(c_val != 0.0, c_idx * 2, big)
    kq_row = jnp.where(q_values != 0.0, q_indices * 2 + 1, big + 1)
    kq = jnp.broadcast_to(kq_row[:, None, :], (b, m, nnzq))
    vq = jnp.broadcast_to(q_values[:, None, :], (b, m, nnzq))
    keys = jnp.concatenate([kc, kq], axis=-1)        # [B, M, NNZ+NNZq]
    vals = jnp.concatenate([c_val, vq], axis=-1)
    keys_s, vals_s = jax.lax.sort((keys, vals), dimension=2, num_keys=1)
    is_c = (keys_s & 1) == 0
    match = (
        ((keys_s[..., 1:] >> 1) == (keys_s[..., :-1] >> 1))
        & is_c[..., :-1]
        & ~is_c[..., 1:]
    )
    scores = jnp.sum(
        jnp.where(match, vals_s[..., 1:] * vals_s[..., :-1], 0.0), axis=-1
    )
    return jnp.where(valid, scores, NEG_INF)


def rerank_sparse_merge(
    corpus_indices: jax.Array,  # i32[N, NNZ]
    corpus_values: jax.Array,   # f32[N, NNZ]
    cand: jax.Array,            # i32[B, M] (-1 = invalid)
    q_indices: jax.Array,       # i32[B, NNZq]
    q_values: jax.Array,        # f32[B, NNZq]
    k: int,
    dup_bound: int = 1,
) -> Tuple[jax.Array, jax.Array]:
    """Sparse·sparse re-rank by SORT-MERGE — the gather-free formulation.

    `rerank_sparse` pays one per-element gather for every (candidate, nnz)
    cell (`query_dense[b, c_idx]`), M×NNZ cells per query. Here both sides'
    (index, value) pairs are concatenated per candidate and sorted by
    (index, side); an index present on both sides becomes an adjacent
    (corpus, query) pair whose product contributes to the dot, so the
    whole re-rank costs one 2-operand sort over [B, M, NNZ+NNZq].

    Exactness: assumes indices are unique within a row — the reference's
    `SparseVector` guarantees this (`Vector.scala:374-417` keeps
    `indexToMap` a HashMap). Zero-valued entries (incl. padding) are routed
    to an out-of-range key so they can never break a real pair's adjacency."""
    scores = sparse_merge_scores(
        corpus_indices, corpus_values, cand, q_indices, q_values
    )
    m2 = _dedup_width(cand.shape[1], k, dup_bound)
    s2, c2 = _select_top(scores, cand, m2)
    return dedup_topk(c2, s2, k)


def dedup_sorted(cand: jax.Array, sentinel: int = 2**31 - 1) -> jax.Array:
    """Sort candidate ids per row and mark duplicates invalid (-1).

    The reference unions per-table candidate lists into a scala Set
    (`DensevectorRDFInit.scala:426-429`). The query hot path no longer uses
    this full-width sort (see `dedup_topk`); kept for utility callers.
    """
    x = jnp.where(cand >= 0, cand, sentinel)
    x = jnp.sort(x, axis=-1)
    dup = jnp.concatenate(
        [jnp.zeros_like(x[..., :1], dtype=bool), x[..., 1:] == x[..., :-1]], axis=-1
    )
    return jnp.where((x == sentinel) | dup, -1, x)
