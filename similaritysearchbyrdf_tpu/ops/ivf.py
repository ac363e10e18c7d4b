"""Clustered-flat (IVF-style) engine: k-means pruning + contiguous window scan.

The grouped flat engine (`ops/flat.py`) streams the WHOLE int8 sketch
through the matrix units per query batch. The way to beat a full scan is
not a faster scan but *reading less*:

  build  k-means the corpus (Lloyd as matmuls: assignment is one [N, K]
         matmul per iteration), then store sketch + exact rows
         CLUSTER-ORDERED so each cluster is one contiguous, 8-aligned row
         range.
  query  score centroids (a [B, K] matmul), pick the top `nprobe`
         clusters, score their contiguous row windows, then exact-refine
         the top `refine` rows — identical tail to the grouped scan.

This is the classic IVF-flat design with the "inverted lists" as
contiguous slices of a sorted array (no pointers), and every stage a
matmul, a gather of contiguous rows or a masked top-k. Recall is governed
by `nprobe` exactly as in IVF; the exact refine keeps the top-k ordering
bit-identical to brute force over the probed rows.

No reference counterpart (the reference prunes with LSH trees because CPU
exhaustive scoring is unaffordable, `DensevectorRDFInit.scala:487-490`);
this is a deliberate extension like the flat engine itself
(COVERAGE.md divergence #9).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .flat import (_exact_refine, _pad_lanes, _window_scores,
                   build_flat_sketch, effective_query_batch)


# ---------------------------------------------------------------------------
# k-means (Lloyd) as matmuls
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("chunk",), donate_argnums=(1,))
def _kmeans_iter(
    x: jax.Array,          # bf16[N, Dp] (unit-ish rows; padding rows 0)
    centroids: jax.Array,  # bf16[K, Dp]
    valid: jax.Array,      # bool[N]
    chunk: int,
) -> Tuple[jax.Array, jax.Array]:
    """One Lloyd iteration: assign by max inner product, update by mean.
    Both steps are chunked matmuls (assignment [chunk, K]; update via a
    one-hot [chunk, K]^T @ x segment-sum) — no scatters."""
    n, dp = x.shape
    k = centroids.shape[0]
    nc = n // chunk

    def assign_one(xc):
        s = jnp.einsum("nd,kd->nk", xc, centroids,
                       preferred_element_type=jnp.float32)
        return jnp.argmax(s, axis=1).astype(jnp.int32)

    assign = jax.lax.map(
        assign_one, x.reshape(nc, chunk, dp)
    ).reshape(n)
    assign = jnp.where(valid, assign, -1)

    def update_one(carry, args):
        sums, counts = carry
        xc, ac = args
        onehot = (
            ac[:, None] == jnp.arange(k, dtype=jnp.int32)[None, :]
        ).astype(jnp.bfloat16)                      # [chunk, K]
        sums = sums + jnp.einsum(
            "nk,nd->kd", onehot, xc, preferred_element_type=jnp.float32
        )
        counts = counts + jnp.sum(onehot.astype(jnp.float32), axis=0)
        return (sums, counts), None

    (sums, counts), _ = jax.lax.scan(
        update_one,
        (jnp.zeros((k, dp), jnp.float32), jnp.zeros((k,), jnp.float32)),
        (x.reshape(nc, chunk, dp), assign.reshape(nc, chunk)),
    )
    # empty clusters keep their previous centroid (avoids NaN + lets them
    # be re-captured later)
    new_c = jnp.where(
        (counts > 0)[:, None], sums / jnp.maximum(counts, 1.0)[:, None],
        centroids.astype(jnp.float32),
    )
    # spherical normalization: assignment is by inner product, so centroids
    # must be unit-norm or long centroids swallow everything
    norm = jnp.linalg.norm(new_c, axis=1, keepdims=True)
    new_c = new_c / jnp.maximum(norm, 1e-20)
    return new_c.astype(jnp.bfloat16), assign


def kmeans(
    x: jax.Array,            # f32/bf16[N, Dp] corpus (lane-padded)
    valid: jax.Array,        # bool[N]
    k: int,
    iters: int = 8,
    seed: int = 0,
    chunk: int = 65536,
) -> Tuple[jax.Array, jax.Array]:
    """Spherical Lloyd k-means. Returns (centroids bf16[K, Dp],
    assign i32[N]; -1 for invalid rows)."""
    n, dp = x.shape
    if n == 0:
        raise ValueError("kmeans: empty corpus")
    rng = np.random.default_rng(seed ^ 0xC1)
    # sample initial centroids from the VALID rows (the mask is not
    # guaranteed to be a prefix)
    pool = np.flatnonzero(np.asarray(valid))
    if pool.size == 0:
        raise ValueError("kmeans: no valid rows")
    init_rows = rng.choice(pool, size=k, replace=pool.size < k)
    xb = x.astype(jnp.bfloat16)
    centroids = xb[jnp.asarray(init_rows.astype(np.int32))]
    # pad rows (masked invalid) up to a chunk multiple — searching for a
    # divisor instead can collapse to chunk=1 for odd N (one lax.map step
    # per ROW)
    chunk = min(chunk, n)
    npad2 = (n + chunk - 1) // chunk * chunk
    if npad2 != n:
        xb = jnp.pad(xb, ((0, npad2 - n), (0, 0)))
        valid = jnp.pad(valid, (0, npad2 - n))
    assign = None
    for _ in range(iters):
        centroids, assign = _kmeans_iter(xb, centroids, valid, chunk)
    return centroids, assign[:n]


@functools.partial(jax.jit, static_argnames=("chunk",))
def _kmeans_assign(x, centroids, chunk):
    """Assignment-only pass (chunked [chunk, K] matmul + argmax)."""
    n, dp = x.shape
    nc = n // chunk

    def assign_one(xc):
        s = jnp.einsum("nd,kd->nk", xc.astype(jnp.bfloat16), centroids,
                       preferred_element_type=jnp.float32)
        return jnp.argmax(s, axis=1).astype(jnp.int32)

    return jax.lax.map(assign_one, x.reshape(nc, chunk, dp)).reshape(n)


def kmeans_sampled(
    x: jax.Array,            # f32/bf16[N, Dp] corpus (lane-padded)
    k: int,
    train_sample: int,
    iters: int = 8,
    seed: int = 0,
    chunk: int = 65536,
) -> Tuple[jax.Array, jax.Array]:
    """Lloyd on a uniform row subsample, then ONE full assignment pass —
    cuts build cost ~(iters·N)→(iters·S + N) matmul traffic with no
    measurable recall change at S ≳ 32 rows/cluster (standard IVF practice;
    all rows assumed valid)."""
    n, dp = x.shape
    s = min(train_sample, n)
    rng = np.random.default_rng(seed ^ 0x5A)
    sel = np.sort(rng.choice(n, size=s, replace=False)).astype(np.int32)
    xs = x[jnp.asarray(sel)]
    centroids, _ = kmeans(xs, jnp.ones((s,), bool), k, iters=iters,
                          seed=seed, chunk=chunk)
    del xs
    # assignment pass WITHOUT a second whole-corpus copy (a padded f32
    # duplicate of an 8M x 128 corpus is +4.1 GB) — chunk from the
    # original rows instead, padding only the tail chunk
    chunk = min(chunk, n)
    parts = []
    for s0 in range(0, n, chunk):
        s1 = min(s0 + chunk, n)
        xc = x[s0:s1]
        if s1 - s0 < chunk:
            xc = jnp.pad(xc, ((0, chunk - (s1 - s0)), (0, 0)))
        parts.append(_kmeans_assign(xc, centroids, chunk)[: s1 - s0])
    return centroids, jnp.concatenate(parts)


# ---------------------------------------------------------------------------
# build: cluster-ordered layout
# ---------------------------------------------------------------------------


class IVFState(NamedTuple):
    sketch: jax.Array      # int8 [Npad, Dp]  cluster-ordered scoring copy
    corpus: jax.Array      # f32  [Npad, Dp]  cluster-ordered exact tier
    row_ids: jax.Array     # i32  [Npad]      user ids (-1 = pad/dead)
    centroids: jax.Array   # bf16 [K, Dp]     unit-norm cluster centers
    starts: jax.Array      # i32  [K+1]       8-aligned cluster offsets
    ends: jax.Array        # i32  [K]         TRUE (unpadded) cluster ends —
    #                        alignment pad rows are all-zero and score 0,
    #                        which would otherwise beat real negative-
    #                        scoring candidates into the refine set
    heads: Optional[jax.Array] = None
    #                        bf16 [H, Dp] mean-pooled head tier for two-phase
    #                        window pruning (head_pool rows per head row);
    #                        DERIVED from sketch — rebuilt on load, never
    #                        persisted (see build_ivf_heads)


@functools.partial(jax.jit, static_argnames=("hp",))
def build_ivf_heads(sketch: jax.Array, row_ids: jax.Array,
                    hp: int) -> jax.Array:
    """Mean-pooled head tier over the cluster-ordered int8 sketch: one bf16
    row per `hp` consecutive sketch rows (masked mean over LIVE rows — the
    8-alignment pad rows are zero and would dilute boundary pools). Same
    design as the forest's `build_head_tier` (index/forest.py), applied to
    the IVF layout: the head score is a PROXY for "does this window hold a
    strong candidate" — phase 1 of the query ranks every candidate window
    by cheap full-row gathers from this tier and only the survivors pay the
    window gather + wide select. Pool groups that straddle a cluster boundary
    mix rows of both clusters — acceptable for a proxy, masked per-window
    at query time by head-row/window overlap. Returns bf16[ceil(Npad/hp),
    Dp]."""
    n, dp = sketch.shape
    h = (n + hp - 1) // hp
    npad = h * hp
    s = jnp.pad(sketch, ((0, npad - n), (0, 0))) if npad != n else sketch
    lv = (row_ids >= 0)
    lv = jnp.pad(lv, (0, npad - n)) if npad != n else lv
    s3 = s.reshape(h, hp, dp).astype(jnp.float32)
    m = lv.reshape(h, hp, 1).astype(jnp.float32)
    return ((s3 * m).sum(axis=1)
            / jnp.maximum(m.sum(axis=1), 1.0)).astype(jnp.bfloat16)


def default_train_sample(n: int, k: int) -> Optional[int]:
    """Opt-in sampled-Lloyd policy: train on max(1M, 32 rows/cluster)
    sampled rows + ONE full assignment (the standard IVF recipe). Not the
    default: it pays an extra compile for the sample-shape kmeans and a
    recall sliver. Use it when k or iters grow enough that Lloyd device
    work dominates the build."""
    if n <= 2_000_000:
        return None
    return min(n, max(1_000_000, 32 * k))


def build_ivf(
    corpus: jax.Array,       # f32[N, D] (unpadded ok)
    row_ids: np.ndarray,     # i32[N]
    target_cluster: int = 256,
    iters: int = 8,
    seed: int = 0,
    sketch_dtype: str = "int8",
    k: Optional[int] = None,
    train_sample: "Optional[int] | str" = None,
) -> IVFState:
    """Cluster the corpus and lay both tiers out cluster-ordered, every
    cluster padded to an 8-row multiple so each cluster is a whole number
    of 8-aligned windows. `train_sample`: run Lloyd on that many
    uniformly-sampled rows and only assign the full corpus once (big-N
    build speedup when Lloyd dominates; None = train on everything;
    "auto" = the `default_train_sample` policy)."""
    n = corpus.shape[0]
    corpus_p = _pad_lanes(jnp.asarray(corpus, jnp.float32))
    # drop the unpadded device reference (callers usually pass an inline
    # jnp.asarray temp): at Deep scale that is ~3 GB of HBM the rest of
    # the build would otherwise carry dead
    corpus = None
    if k is None:
        k = int(np.clip(n // target_cluster, 16, 65536))
    if train_sample == "auto":
        train_sample = default_train_sample(n, k)
    if train_sample is not None and train_sample < n:
        centroids, assign = kmeans_sampled(
            corpus_p, k, train_sample, iters=iters, seed=seed)
    else:
        valid = jnp.ones((n,), bool)
        centroids, assign = kmeans(corpus_p, valid, k, iters=iters,
                                   seed=seed)
    a = np.asarray(assign)

    # cluster-ordered permutation with per-cluster 8-row padding (host-side
    # integer work; N-sized numpy ops)
    order = np.argsort(a, kind="stable")
    counts = np.bincount(a, minlength=k)
    padded = ((counts + 7) // 8) * 8
    starts = np.zeros(k + 1, np.int64)
    starts[1:] = np.cumsum(padded)
    npad_total = int(starts[-1])
    perm = np.full(npad_total, -1, np.int64)
    src_off = np.zeros(k + 1, np.int64)
    src_off[1:] = np.cumsum(counts)
    for c in range(k):
        perm[starts[c] : starts[c] + counts[c]] = order[
            src_off[c] : src_off[c + 1]
        ]

    perm_d = jnp.asarray(perm.astype(np.int32))
    live = perm_d >= 0
    safe = jnp.maximum(perm_d, 0)
    corpus_o = jnp.where(live[:, None], corpus_p[safe], 0.0)
    sketch_full, _ = build_flat_sketch(corpus_o, sketch_dtype)
    rid = np.asarray(row_ids, np.int32)
    rid_o = jnp.where(live, jnp.asarray(rid)[safe], -1)
    return IVFState(
        sketch=sketch_full,
        corpus=corpus_o,
        row_ids=rid_o,
        centroids=centroids,
        starts=jnp.asarray(starts.astype(np.int32)),
        ends=jnp.asarray((starts[:-1] + counts).astype(np.int32)),
    )


def _cluster_perm(
    assign: np.ndarray, k: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Cluster-ordered permutation with per-cluster 8-row alignment padding.
    Returns (perm i64[npad_total] source rows (-1 = pad), starts i64[K+1],
    counts i64[K])."""
    order = np.argsort(assign, kind="stable")
    counts = np.bincount(assign, minlength=k)
    padded = ((counts + 7) // 8) * 8
    starts = np.zeros(k + 1, np.int64)
    starts[1:] = np.cumsum(padded)
    perm = np.full(int(starts[-1]), -1, np.int64)
    src_off = np.zeros(k + 1, np.int64)
    src_off[1:] = np.cumsum(counts)
    for c in range(k):
        perm[starts[c] : starts[c] + counts[c]] = order[
            src_off[c] : src_off[c + 1]
        ]
    return perm, starts, counts


@functools.partial(jax.jit, donate_argnums=(0, 1, 2))
def _assemble_chunk(sketch, corpus, rids, rows, ids_chunk, scale, off):
    """Write one cluster-ordered chunk into the preallocated tiers (donated:
    updates happen in place, never two whole-corpus copies on device)."""
    q = jnp.clip(jnp.round(rows * scale), -127, 127).astype(jnp.int8)
    sketch = jax.lax.dynamic_update_slice(sketch, q, (off, 0))
    corpus = jax.lax.dynamic_update_slice(
        corpus, rows.astype(corpus.dtype), (off, 0))
    rids = jax.lax.dynamic_update_slice(rids, ids_chunk, (off,))
    return sketch, corpus, rids


def build_ivf_streamed(
    corpus_np: np.ndarray,    # f32[N, D] HOST corpus (never fully on device)
    row_ids: np.ndarray,      # i32[N]
    target_cluster: int = 256,
    iters: int = 6,
    seed: int = 0,
    train_sample: int = 2_000_000,
    corpus_dtype: str = "bfloat16",
    chunk_rows: int = 1 << 20,
    k: Optional[int] = None,
    kmeans_chunk: int = 8192,
) -> IVFState:
    """Big-N IVF build with LOW-PRECISION corpus residency (the Deep-100M
    plan's memory model): the f32 corpus stays on
    host; the device holds only the int8 window-scoring sketch plus a
    `corpus_dtype` (bf16 by default) refine tier — 30M×96d takes 3.9 + 7.9
    GB of device memory where `build_ivf`'s f32 tier alone would need
    15.7 GB.

    Lloyd trains on `train_sample` uniformly-sampled rows; assignment and
    the cluster-ordered relayout stream host→device in `chunk_rows` chunks
    into donated, preallocated tiers. Refine re-scores candidates from the
    bf16 tier with f32 accumulation (the int8 sketch still gates)."""
    n, d = corpus_np.shape
    dp = int(np.ceil(d / 128.0) * 128)
    if k is None:
        k = int(np.clip(n // target_cluster, 16, 65536))
    rng = np.random.default_rng(seed ^ 0x5A)
    s = min(train_sample, n)
    sel = np.sort(rng.choice(n, size=s, replace=False))
    xs = np.zeros((s, dp), np.float32)
    xs[:, :d] = corpus_np[sel]
    centroids, _ = kmeans(jnp.asarray(xs), jnp.ones((s,), bool), k,
                          iters=iters, seed=seed, chunk=kmeans_chunk)
    del xs

    # full assignment pass, streamed from host
    assign = np.empty(n, np.int32)
    for s0 in range(0, n, chunk_rows):
        s1 = min(s0 + chunk_rows, n)
        cr = ((s1 - s0 + kmeans_chunk - 1) // kmeans_chunk) * kmeans_chunk
        xc = np.zeros((cr, dp), np.float32)
        xc[: s1 - s0, :d] = corpus_np[s0:s1]
        a = _kmeans_assign(jnp.asarray(xc), centroids, kmeans_chunk)
        assign[s0:s1] = np.asarray(a)[: s1 - s0]

    perm, starts, counts = _cluster_perm(assign, k)
    npad_total = int(starts[-1])
    amax = 0.0
    for s0 in range(0, n, chunk_rows):     # host amax pass (no big temp)
        amax = max(amax, float(np.abs(corpus_np[s0:min(s0 + chunk_rows, n)]).max()))
    scale = jnp.float32(127.0 / max(amax, 1e-30))

    cdt = jnp.bfloat16 if corpus_dtype == "bfloat16" else jnp.float32
    # allocate a whole number of fixed-size chunks: dynamic_update_slice
    # CLAMPS out-of-bounds starts, so a final overhanging chunk would
    # otherwise silently overwrite earlier rows; the overhang rows stay
    # dead (row_id -1, zero scores, positions >= ends are masked)
    npad_alloc = int(np.ceil(npad_total / chunk_rows)) * chunk_rows
    sketch = jnp.zeros((npad_alloc, dp), jnp.int8)
    corpus_o = jnp.zeros((npad_alloc, dp), cdt)
    rids_o = jnp.full((npad_alloc,), -1, jnp.int32)
    rid = np.asarray(row_ids, np.int32)
    for s0 in range(0, npad_total, chunk_rows):
        s1 = min(s0 + chunk_rows, npad_total)
        cr = chunk_rows                      # fixed shape: one program
        pc = perm[s0:s1]
        rows_h = np.zeros((cr, dp), np.float32)
        ids_h = np.full((cr,), -1, np.int32)
        live = pc >= 0
        rows_h[: s1 - s0][live, :d] = corpus_np[pc[live]]
        ids_h[: s1 - s0][live] = rid[pc[live]]
        sketch, corpus_o, rids_o = _assemble_chunk(
            sketch, corpus_o, rids_o, jnp.asarray(rows_h),
            jnp.asarray(ids_h), scale, jnp.int32(s0))
    return IVFState(
        sketch=sketch,
        corpus=corpus_o,
        row_ids=rids_o,
        centroids=centroids,
        starts=jnp.asarray(starts.astype(np.int32)),
        ends=jnp.asarray((starts[:-1] + counts).astype(np.int32)),
    )


# ---------------------------------------------------------------------------
# query
# ---------------------------------------------------------------------------


def ivf_window_budget(
    starts, ends, nprobe: int, win: int, cap: int = 4096
) -> int:
    """Window budget that cannot truncate a probed cluster: the sum of the
    `nprobe` LARGEST clusters' window counts — the exact worst case over
    any probe set (the previous 2*nprobe heuristic silently dropped ~half
    the probed rows whenever clusters spanned more than two windows).
    Beyond `cap`, _flatten_windows truncates farthest-selected clusters
    first (windows are filled in selection order)."""
    st = np.asarray(starts)
    en = np.asarray(ends)
    lens = en - st[..., :-1]                 # works for [K+1] and [S, K+1]
    if lens.size == 0:
        return nprobe
    wc = -np.sort(-((lens + win - 1) // win), axis=-1)[..., :nprobe]
    need = int(wc.sum(axis=-1).max())        # worst shard, worst probe set
    return int(min(max(need, nprobe), cap))


def _flatten_windows(
    sel_start: jax.Array,    # i32[B, P] selected clusters' starts (8-aligned)
    sel_end: jax.Array,      # i32[B, P] their ends
    win: int,
    wb: int,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Ragged flatten of selected clusters into `wb` fixed `win`-row
    windows per query, cluster-priority order (selection order): window j
    belongs to the cluster whose cumulative window count first exceeds j.
    Returns (blk_start i32[B, WB], end i32[B, WB], live bool[B, WB])."""
    b, p = sel_start.shape
    wc = (sel_end - sel_start + win - 1) // win           # [B, P]
    cum = jnp.cumsum(wc, axis=1)                          # [B, P]
    base = cum - wc
    j = jnp.arange(wb, dtype=jnp.int32)[None, :]          # [1, WB]
    # idx[b, j] = first cluster with cum > j  (vmapped merge-searchsorted)
    idx = jax.vmap(
        lambda c, q: jnp.searchsorted(c, q, side="right", method="sort")
    )(cum, jnp.broadcast_to(j, (b, wb))).astype(jnp.int32)
    live = idx < p
    safe = jnp.minimum(idx, p - 1)
    s = jnp.take_along_axis(sel_start, safe, axis=1)
    e = jnp.take_along_axis(sel_end, safe, axis=1)
    bse = jnp.take_along_axis(base, safe, axis=1)
    blk = s + (j - bse) * win
    return blk, e, live & (blk < e)


def probe_windows(
    qb: jax.Array,           # bf16[B, Dp] lane-padded queries
    centroids: jax.Array,    # bf16[K, Dp]
    starts: jax.Array,       # i32[K+1]
    ends: jax.Array,         # i32[K] true (unpadded) cluster ends
    nprobe: int,
    win: int,
    wb: int,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """The `wb` windows of each query's top-`nprobe` clusters: centroid
    matmul → top-nprobe → ragged flatten. Returns (blk_start i32[B, WB],
    end i32[B, WB], live bool[B, WB])."""
    c_scores = jnp.einsum("bd,kd->bk", qb, centroids,
                          preferred_element_type=jnp.float32)   # [B, K]
    _, sel = jax.lax.top_k(c_scores, min(nprobe, centroids.shape[0]))
    # TRUE ends: pad rows never score as valid
    return _flatten_windows(starts[sel], ends[sel], win, wb)


def _ivf_prune_windows(
    heads: jax.Array,    # bf16[H, Dp] pooled head tier
    hp: int,
    qb: jax.Array,       # bf16[B, Dp]
    blk: jax.Array,      # i32[B, WB] window starts (8-aligned)
    end_b: jax.Array,    # i32[B, WB] owning cluster's true end
    live: jax.Array,     # bool[B, WB]
    win: int,
    keep: int,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Phase 1 of the two-phase IVF window gather (the forest's
    `_prune_windows` recast for the flat cluster layout): score every
    candidate window by its pooled-head proxy (max over the head rows it
    overlaps) via batched full-row gathers, and keep only the top `keep`
    windows per query, re-sorted to slot order. The head score is a
    proxy, not a bound: recall governed by `keep`
    (COVERAGE.md divergence #12 applies to IVF the same way)."""
    h = heads.shape[0]
    b, wbf = blk.shape
    r_head = win // hp + 1   # starts are 8-aligned, not hp-aligned: one
    #                          extra row covers the straddle
    g0 = blk // hp
    j = jnp.arange(r_head, dtype=jnp.int32)
    gidx = g0[:, :, None] + j[None, None, :]                  # [B, WB, R]
    rows = jnp.take(heads, jnp.clip(gidx, 0, h - 1), axis=0)  # [B,WB,R,Dp]
    sc = jnp.einsum("bwrd,bd->bwr", rows, qb,
                    preferred_element_type=jnp.float32)
    # head row g covers sketch rows [g*hp, (g+1)*hp); mask rows wholly
    # outside the window's live range [blk, min(blk+win, end))
    row_lo = gidx * hp
    lo = blk[:, :, None]
    hi = jnp.minimum(blk + win, end_b)[:, :, None]
    hvalid = (row_lo + hp > lo) & (row_lo < hi)
    wscore = jnp.max(jnp.where(hvalid, sc, -jnp.inf), axis=2)
    wscore = jnp.where(live, wscore, -jnp.inf)
    iota = jnp.broadcast_to(
        jnp.arange(wbf, dtype=jnp.int32)[None, :], (b, wbf))
    _, wi = jax.lax.sort((-wscore, iota), dimension=1, num_keys=1)
    wi = jnp.sort(wi[:, :keep], axis=1)
    return (jnp.take_along_axis(blk, wi, axis=1),
            jnp.take_along_axis(end_b, wi, axis=1),
            jnp.take_along_axis(live, wi, axis=1))


@functools.partial(
    jax.jit,
    static_argnames=("k", "nprobe", "win", "wb", "refine", "exclude_self",
                     "head_pool", "keep"),
)
def ivf_topk(
    sketch: jax.Array,       # int8 [Npad, Dp] cluster-ordered
    corpus: jax.Array,       # f32  [Npad, Dp]
    row_ids: jax.Array,      # i32  [Npad]
    centroids: jax.Array,    # bf16 [K, Dp]
    starts: jax.Array,       # i32  [K+1]
    ends: jax.Array,         # i32  [K] true (unpadded) cluster ends
    queries: jax.Array,      # f32[B, D]
    query_ids: jax.Array,    # i32[B]
    k: int,
    nprobe: int = 32,
    win: int = 256,
    wb: Optional[int] = None,
    refine: int = 128,
    exclude_self: bool = True,
    heads: Optional[jax.Array] = None,
    head_pool: int = 0,
    keep: int = 0,
) -> Tuple[jax.Array, jax.Array]:
    """IVF query: centroid matmul → top-nprobe clusters → window sketch
    scoring → exact refine. Returns (ids i32[B,k], scores f32[B,k]).

    With `heads`/`head_pool`/`keep` set (and keep < wb), a phase-1 pooled-
    head pass prunes the flattened windows to the top `keep` per query
    before the window gather + wide select (two-phase gather;
    `_ivf_prune_windows`).
    keep >= wb or keep=0 is bit-identical to the single-phase path."""
    npad, dp = sketch.shape
    kc = centroids.shape[0]
    b = queries.shape[0]
    # default budget: whole-corpus window coverage PLUS one round-up window
    # per cluster (each probed cluster needs ceil(len/win) windows) — safe
    # (cannot truncate any probe set) but wide; real callers pass
    # ivf_window_budget(...)
    wb = wb or max((npad + win - 1) // win + kc, 1)
    qp = _pad_lanes(queries.astype(jnp.float32))[:, :dp]
    qb = qp.astype(jnp.bfloat16)

    blk, end_b, live = probe_windows(qb, centroids, starts, ends, nprobe,
                                     win, wb)
    if (keep > 0 and keep < wb and heads is not None and head_pool > 0
            and win % head_pool == 0):
        blk, end_b, live = _ivf_prune_windows(
            heads, head_pool, qb, blk, end_b, live, win, keep)
        wb = keep
    # windows read at min(blk, npad - win): a tail window of a
    # not-win-multiple layout shifts left to stay inside the table, and
    # its extra leading rows (earlier clusters) are masked by pos >= blk.
    blk_read = jnp.minimum(blk, max(npad - win, 0))
    w_scores = _window_scores(sketch, qb, blk_read, win)       # [B, WB, win]
    pos = (blk_read[:, :, None]
           + jnp.arange(win, dtype=jnp.int32)[None, None, :])
    valid = (live[:, :, None] & (pos < end_b[:, :, None])
             & (pos >= blk[:, :, None]))
    m = wb * win
    w_scores = jnp.where(valid, w_scores, -jnp.inf).reshape(b, m)
    pos = jnp.where(valid, pos, npad).reshape(b, m)

    r2 = min(refine, m)
    _, si = jax.lax.approx_max_k(w_scores, r2, recall_target=0.998)
    cand = jnp.take_along_axis(pos, si, axis=1)
    sel_s = jnp.take_along_axis(w_scores, si, axis=1)
    cand = jnp.where(jnp.isfinite(sel_s), cand, npad)
    return _exact_refine(corpus, row_ids, qp, jnp.clip(cand, 0, npad - 1),
                         jnp.isfinite(sel_s), query_ids, k, exclude_self)


def tune_nprobe(
    index,
    sample_queries: np.ndarray,
    target_recall: float = 0.95,
    k: int = 10,
    candidates: Tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64, 128, 256),
) -> int:
    """Smallest `nprobe` whose top-k matches a FULL-probe pass on the same
    index at `target_recall` — a ground-truth-free operating-point tuner
    (the full-probe pass scores every cluster, so it is the index's own
    recall ceiling; cluster-coverage loss is the only thing nprobe trades
    away). Sets `index.nprobe` and returns it. The reference tunes its
    operating points the same way — by experiment sweeps
    (`TestSingleRDFSuite.scala:103-122`), just with a human in the loop."""
    st = index.state
    assert st is not None, "fit first"
    kc = int(st.centroids.shape[0])
    q = np.asarray(sample_queries, np.float32)
    ref_ids, _ = index.query(q, k=k, exclude_self=False, nprobe=kc)
    ref_sets = [set(map(int, r[r >= 0])) for r in ref_ids]
    denom = max(sum(len(s) for s in ref_sets), 1)
    for p in sorted(set(min(c, kc) for c in candidates)):
        ids, _ = index.query(q, k=k, exclude_self=False, nprobe=p)
        hits = sum(
            len(ref_sets[i] & set(map(int, ids[i][ids[i] >= 0])))
            for i in range(len(ref_sets))
        )
        if hits / denom >= target_recall:
            index.nprobe = p
            return p
    index.nprobe = kc
    return kc


class IVFFlatIndex:
    """Host orchestrator for the clustered-flat engine (same query surface
    as `FlatIndex`; `nprobe` is the recall knob)."""

    def __init__(self, target_cluster: int = 256, nprobe: int = 32,
                 win: int = 256, refine: int = 128, iters: int = 8,
                 query_batch: int = 1024, seed: int = 0,
                 train_sample: "Optional[int] | str" = None,
                 wb: Optional[int] = None,
                 head_pool: int = 0, keep: int = 0):
        self.target_cluster = target_cluster
        self.nprobe = nprobe
        self.win = win
        self.refine = refine
        self.iters = iters
        self.query_batch = query_batch
        self.seed = seed
        self.train_sample = train_sample
        # None = exact no-truncation budget (ivf_window_budget); an int
        # caps windows per query — _flatten_windows drops FARTHEST-selected
        # clusters first, so a tuned cap trades bounded tail recall for the
        # smaller top-k the select stage has to chew
        self.wb = wb
        # two-phase window pruning: head_pool rows per pooled head row
        # (must divide win), keep windows surviving phase 1 per query
        # (0 = single-phase). See _ivf_prune_windows.
        self.head_pool = head_pool
        self.keep = keep
        self.state: Optional[IVFState] = None

    def fit(self, batch) -> "IVFFlatIndex":
        """batch: vectors.DenseBatch."""
        self.state = build_ivf(
            jnp.asarray(batch.values, jnp.float32),
            np.asarray(batch.ids, np.int32),
            target_cluster=self.target_cluster, iters=self.iters,
            seed=self.seed, train_sample=self.train_sample,
        )
        self.ensure_heads()
        return self

    def ensure_heads(self) -> None:
        """Build (or rebuild) the derived head tier when two-phase pruning
        is configured — called by fit and by the load path (heads are never
        persisted; like the forest's coarse/head tiers they are derived
        data rebuilt on load)."""
        if self.state is None or not self.head_pool:
            return
        self.state = self.state._replace(heads=build_ivf_heads(
            self.state.sketch, self.state.row_ids, self.head_pool))

    def query(
        self,
        queries: np.ndarray,
        k: int = 10,
        query_ids: Optional[np.ndarray] = None,
        exclude_self: bool = True,
        nprobe: Optional[int] = None,
        keep: Optional[int] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        if self.state is None:
            print("need to fit the data first")
            return (np.full((len(queries), k), -1, np.int32),
                    np.full((len(queries), k), -np.inf, np.float32))
        q = np.asarray(queries, dtype=np.float32)
        nq = len(q)
        qids = (np.asarray(query_ids, dtype=np.int32)
                if query_ids is not None
                else np.full((nq,), -1, np.int32))
        st = self.state
        npb = nprobe or self.nprobe
        bsz = effective_query_batch(nq, self.query_batch)
        wb = self.wb or ivf_window_budget(st.starts, st.ends, npb, self.win)
        kp = self.keep if keep is None else keep
        out_i, out_s = [], []
        for s0 in range(0, nq, bsz):
            s1 = min(s0 + bsz, nq)
            pad = bsz - (s1 - s0)
            qc = jnp.asarray(np.pad(q[s0:s1], ((0, pad), (0, 0))))
            qi = jnp.asarray(np.pad(qids[s0:s1], (0, pad),
                                    constant_values=-1))
            ids, scores = ivf_topk(
                st.sketch, st.corpus, st.row_ids, st.centroids, st.starts,
                st.ends, qc, qi, k, nprobe=npb, win=self.win, wb=wb,
                refine=self.refine, exclude_self=exclude_self,
                heads=st.heads, head_pool=self.head_pool, keep=kp,
            )
            # keep per-batch outputs on device: converting inside the loop
            # would wait for each batch before dispatching the next; the
            # tiny [bsz, k] slices convert together at the end
            out_i.append(ids[: s1 - s0])
            out_s.append(scores[: s1 - s0])
        return (np.concatenate([np.asarray(a) for a in out_i]),
                np.concatenate([np.asarray(a) for a in out_s]))
