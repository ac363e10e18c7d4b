"""Exact (brute-force) search — the framework's ground-truth engine.

The reference computes ground truth offline in python and loads it from
files (`getTopKGroundTruth`); here it is produced on the device.
`exact_topk` streams the corpus in chunks (peak memory bounded by
`chunk × B` scores, never `N × B`), scoring with a matmul and keeping a
running top-k. Also the honest baseline ANN must beat: on small corpora brute force
IS the fastest search.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def _top_k(scores: jax.Array, ids: jax.Array, k: int) -> Tuple[jax.Array, jax.Array]:
    """top-k of (scores, ids) along the last axis. lax.top_k costs O(n*k);
    beyond small k a full descending sort is cheaper."""
    if k <= 32:
        s, ti = jax.lax.top_k(scores, k)
        return s, jnp.take_along_axis(ids, ti, axis=-1)
    neg, ids_s = jax.lax.sort((-scores, ids), dimension=-1, num_keys=1)
    return -neg[..., :k], ids_s[..., :k]


@functools.partial(jax.jit, static_argnames=("k", "chunk", "exclude_diag_offset"))
def exact_topk(
    corpus: jax.Array,       # f32/bf16 [N, D]
    queries: jax.Array,      # f32 [B, D]
    k: int,
    chunk: int = 8192,
    exclude_diag_offset: Optional[int] = None,
) -> Tuple[jax.Array, jax.Array]:
    """Streaming exact inner-product top-k. Returns (ids i32[B,k],
    scores f32[B,k]). `exclude_diag_offset=j` masks corpus row (j + i) for
    query i (self-exclusion when queries are corpus rows starting at j)."""
    n, d = corpus.shape
    b = queries.shape[0]
    chunk = min(chunk, n)
    n_pad = int(np.ceil(n / chunk)) * chunk
    corpus_p = jnp.pad(corpus, ((0, n_pad - n), (0, 0)))
    n_chunks = n_pad // chunk
    q = queries.astype(corpus.dtype)

    def body(carry, ci):
        best_s, best_i = carry
        rows = jax.lax.dynamic_slice_in_dim(corpus_p, ci * chunk, chunk)
        # HIGHEST: ground truth must be TRUE f32 ordering — a
        # default-precision f32 matmul may round its operands (TF32 on the
        # GPU), and a GT computed that way cannot detect the same rounding
        # in an engine's "exact" tier (see ops/flat._exact_refine).
        scores = jnp.einsum(
            "nd,bd->bn", rows, q, preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )                                           # [B, chunk]
        ids = ci * chunk + jnp.arange(chunk, dtype=jnp.int32)[None, :]
        valid = ids < n
        if exclude_diag_offset is not None:
            qidx = jnp.arange(b, dtype=jnp.int32)[:, None] + exclude_diag_offset
            valid = valid & (ids != qidx)
        scores = jnp.where(valid, scores, -jnp.inf)
        cat_s = jnp.concatenate([best_s, scores], axis=1)
        cat_i = jnp.concatenate([best_i, jnp.broadcast_to(ids, (b, chunk))], axis=1)
        top_s, top_i = _top_k(cat_s, cat_i, k)
        return (top_s, top_i), None

    init = (
        jnp.full((b, k), -jnp.inf, dtype=jnp.float32),
        jnp.full((b, k), -1, dtype=jnp.int32),
    )
    (best_s, best_i), _ = jax.lax.scan(
        body, init, jnp.arange(n_chunks, dtype=jnp.int32)
    )
    return best_i, best_s


@functools.partial(jax.jit, static_argnames=("k", "chunk", "exclude_diag_offset"))
def exact_topk_sparse(
    corpus_indices: jax.Array,   # i32[N, NNZ]
    corpus_values: jax.Array,    # f32[N, NNZ] (padding values 0)
    query_dense: jax.Array,      # f32[B, V] densified queries
    k: int,
    chunk: int = 4096,
    exclude_diag_offset: Optional[int] = None,
) -> Tuple[jax.Array, jax.Array]:
    """Streaming exact top-k over a sparse corpus: per chunk, gather the
    query values at each row's indices and accumulate — the correct
    sparse·sparse dot at scale (GT generator for the sparse path)."""
    n = corpus_indices.shape[0]
    b = query_dense.shape[0]
    chunk = min(chunk, n)
    n_pad = int(np.ceil(n / chunk)) * chunk
    idx_p = jnp.pad(corpus_indices, ((0, n_pad - n), (0, 0)))
    val_p = jnp.pad(corpus_values, ((0, n_pad - n), (0, 0)))
    n_chunks = n_pad // chunk

    def body(carry, ci):
        best_s, best_i = carry
        rows_i = jax.lax.dynamic_slice_in_dim(idx_p, ci * chunk, chunk)
        rows_v = jax.lax.dynamic_slice_in_dim(val_p, ci * chunk, chunk)
        qg = jnp.take(query_dense, rows_i, axis=1)       # [B, chunk, NNZ]
        scores = jnp.einsum("bcn,cn->bc", qg, rows_v)
        ids = ci * chunk + jnp.arange(chunk, dtype=jnp.int32)[None, :]
        valid = ids < n
        if exclude_diag_offset is not None:
            qidx = jnp.arange(b, dtype=jnp.int32)[:, None] + exclude_diag_offset
            valid = valid & (ids != qidx)
        scores = jnp.where(valid, scores, -jnp.inf)
        cat_s = jnp.concatenate([best_s, scores], axis=1)
        cat_i = jnp.concatenate([best_i, jnp.broadcast_to(ids, (b, chunk))], axis=1)
        top_s, top_i = _top_k(cat_s, cat_i, k)
        return (top_s, top_i), None

    init = (
        jnp.full((b, k), -jnp.inf, dtype=jnp.float32),
        jnp.full((b, k), -1, dtype=jnp.int32),
    )
    (best_s, best_i), _ = jax.lax.scan(
        body, init, jnp.arange(n_chunks, dtype=jnp.int32)
    )
    return best_i, best_s


def exact_search(
    corpus: np.ndarray,
    queries: np.ndarray,
    k: int,
    batch: int = 1024,
    exclude_self: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Host-facing exact search over query batches."""
    corpus_d = jnp.asarray(corpus)
    out_i, out_s = [], []
    q = np.asarray(queries, dtype=np.float32)
    for s0 in range(0, len(q), batch):
        s1 = min(s0 + batch, len(q))
        pad = batch - (s1 - s0)
        qc = jnp.asarray(np.pad(q[s0:s1], ((0, pad), (0, 0))))
        ids, scores = exact_topk(
            corpus_d, qc, k,
            exclude_diag_offset=s0 if exclude_self else None,
        )
        out_i.append(np.asarray(ids[: s1 - s0]))
        out_s.append(np.asarray(scores[: s1 - s0]))
    return np.concatenate(out_i), np.concatenate(out_s)
