"""Quantized-flat engine: brute-force sketch scan + exact refine.

The reference's whole design (LSH forest, partitions, multi-step search —
`RandomDrawTreeMap.java`, `LSH.scala`) exists because exhaustive scoring is
unaffordable on a CPU (its published 1.2M GloVe operating point is ~40 QPS,
`results.png`). An accelerator inverts that calculus: a low-precision copy
of the corpus streams through the matrix units at device-memory bandwidth,
so scoring EVERY vector costs ~N·D bytes of reads per query batch — less
than any pruning structure whose per-candidate cost is a random gather.
This module is that engine:

  stage 1  scores = q̂ · sketchᵀ      (int8 or bf16 matmul)
  stage 2  per-group maxima → top groups (or per-block top-`refine`)
  stage 3  exact f32 re-score of the merged survivors, final top-k

It is a deliberate extension (COVERAGE.md divergence #9), not a reference
behavior: same query surface as the forest, recall ≈ exact. The forest
remains the engine with reference candidate-set semantics, dynamic
insert/remove, sparse data, and tiered persistence.

int8 notes: corpus rows quantize with one global scale (127/max|x|); each
query quantizes with its own scale — a per-query positive factor that
leaves per-query ranking unchanged. int8 scores fit int32 exactly.
"""

from __future__ import annotations

import functools
import os
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .exact import _top_k
from .pallas.groupmax import group_max_pallas

# group-select stage knobs. Modes: "exact2" two-level exact (supergroup
# max -> top-rg supergroups -> row-gather children -> top-rg;
# FLAT_SELECT_SG sets the supergroup width), "approx" flat approx_max_k
# over [B, NG], "topk" flat exact lax.top_k, "argpack" argmax-packed group
# maxima (int8 only: the top-refine groups' best rows are the candidates —
# no window rescore), "auto" = argpack at large N (where the per-group
# collision loss is negligible), exact2 otherwise.
_SELECT_MODE = os.environ.get("FLAT_SELECT_MODE", "auto")
# supergroup width default is MODE-dependent when the env is unset: 64 for
# the exact2 two-level select, 32 for argpack
_SELECT_SG_ENV = os.environ.get("FLAT_SELECT_SG")
_SELECT_SG = int(_SELECT_SG_ENV) if _SELECT_SG_ENV is not None else 64


def _default_select_sg(mode: str) -> int:
    if _SELECT_SG_ENV is not None:
        return int(_SELECT_SG_ENV)
    return 32 if mode == "argpack" else 64


# argpack level-2 formulation: "approx" (approx_max_k on the f32 score) or
# "sort" (exact 2-operand descending sort on the packed i32 key)
_ARGPACK_L2 = os.environ.get("FLAT_ARGPACK_L2", "sort")

# argpack trades non-argmax rows of multiply-hit groups for more groups;
# the per-query chance that two true top-10 rows share a 64-row group is
# ~C(10,2)/NG, so gate "auto" on NG >= 16384 (N >= 1M): loss < 0.03%/10,
# far below int8 sketch ordering noise.
_ARGPACK_MIN_ROWS = 1 << 20


def _resolve_select_mode(mode: str, sketch_dtype, nrows: int,
                         d: int = 0) -> str:
    # packed = score*64 + member must fit int32: |score| <= d*127^2, so
    # argpack is only sound for d <= ~2081 lanes (the sparse flat engine's
    # densified 4096d sketches stay on exact2)
    pack_ok = sketch_dtype == jnp.int8 and d * 127 * 127 * _GROUP < 2**31
    if mode != "auto":
        if mode == "argpack" and not pack_ok:
            return "exact2"
        return mode
    if pack_ok and nrows >= _ARGPACK_MIN_ROWS:
        return "argpack"
    return "exact2"

_GROUP = 64          # rows per group == window rows (win floor 64)
_BLOCK_N = 8192      # grouped paths pad the sketch rows to this multiple


def _pad_lanes(a: jax.Array) -> jax.Array:
    """Pad the minor dim to a 128-lane multiple. Zero columns add nothing
    to dots; the group-max kernel contracts in 128-wide slices."""
    d = a.shape[-1]
    dp = int(np.ceil(d / 128.0) * 128)
    return a if dp == d else jnp.pad(a, ((0, 0), (0, dp - d)))


def effective_query_batch(nq: int, query_batch: int) -> int:
    """Clamp the padded dispatch batch to the work actually present: the
    next power of two >= nq (floor 32), capped at `query_batch`. Large
    callers (nq >= query_batch) are unchanged — benches keep their exact
    warmed shapes — but a 32-query call no longer pays for 1024 padded
    rows of window gathers (32x wasted work on small probes/tests). The
    pow2 rounding bounds the number of distinct compiled programs."""
    if nq >= query_batch:
        return query_batch
    b = 32
    while b < nq:
        b <<= 1
    return min(b, query_batch)


def build_flat_sketch(
    corpus: jax.Array,            # f32[N, D]
    dtype: str = "int8",
) -> Tuple[jax.Array, float]:
    """Low-precision scoring copy of the corpus, lane-padded to 128.
    Returns (sketch, scale); scale is the int8 quantization factor
    (1.0 for bf16)."""
    if dtype == "bfloat16":
        return _pad_lanes(corpus.astype(jnp.bfloat16)), 1.0
    if dtype != "int8":
        raise ValueError(f"unsupported flat sketch dtype: {dtype}")
    amax = float(jnp.max(jnp.abs(corpus)))
    scale = 127.0 / max(amax, 1e-30)
    # fused quantize: eager op-by-op dispatch would materialize TWO
    # full-size f32 temporaries (mul, round); one jit emits a single
    # read-f32/write-i8 pass
    q = _quantize_int8(corpus, jnp.float32(scale))
    return _pad_lanes(q), scale


@jax.jit
def _quantize_int8(corpus: jax.Array, scale: jax.Array) -> jax.Array:
    return jnp.clip(jnp.round(corpus * scale), -127, 127).astype(jnp.int8)


def _query_lp(queries: jax.Array, sketch_dtype, d: int) -> jax.Array:
    """Queries in the sketch's dtype and lane width: int8 with a per-query
    scale (order-preserving), bf16 by a cast."""
    if sketch_dtype == jnp.int8:
        qs = 127.0 / jnp.maximum(jnp.max(jnp.abs(queries), axis=1,
                                         keepdims=True), 1e-30)
        q_lp = jnp.clip(jnp.round(queries * qs), -127, 127).astype(jnp.int8)
    else:
        q_lp = queries.astype(sketch_dtype)
    return _pad_lanes(q_lp)[:, :d]


def _exact_refine(corpus, row_ids, queries, cand, pre_valid, query_ids, k,
                  exclude_self):
    """Exact f32 re-score + final top-k, tolerant of a lane-padded corpus
    (zero columns add nothing to the dot; queries pad to match)."""
    n = row_ids.shape[0]
    safe = jnp.clip(cand, 0, n - 1)
    rows = corpus[safe]
    qx = queries
    if corpus.shape[1] != queries.shape[1]:
        qx = jnp.pad(queries,
                     ((0, 0), (0, corpus.shape[1] - queries.shape[1])))
    # HIGHEST: a default-precision f32 matmul may round its operands (TF32
    # on the GPU), which reorders near-ties against true f32 ordering; the
    # refine slab is [B, refine, D], small next to the scan, so the exact
    # tier is made actually exact.
    exact = jnp.einsum("brd,bd->br", rows, qx,
                       preferred_element_type=jnp.float32,
                       precision=jax.lax.Precision.HIGHEST)
    uid = row_ids[safe]
    valid = pre_valid & (uid >= 0)
    if exclude_self:
        valid &= uid != query_ids[:, None]
    exact = jnp.where(valid, exact, -jnp.inf)
    top_s, top_u = _top_k(exact, uid, k)
    return jnp.where(jnp.isfinite(top_s), top_u, -1), top_s


@functools.partial(
    jax.jit, static_argnames=("k", "refine", "block", "exclude_self")
)
def flat_topk(
    sketch: jax.Array,            # int8/bf16 [N, D]
    corpus: jax.Array,            # f32[N, D] (exact tier)
    row_ids: jax.Array,           # i32[N] user ids (-1 = dead row)
    queries: jax.Array,           # f32[B, D]
    query_ids: jax.Array,         # i32[B] (-1 = no self-exclusion)
    k: int,
    refine: int = 128,
    block: int = 1 << 20,
    exclude_self: bool = True,
) -> Tuple[jax.Array, jax.Array]:
    """Returns (ids i32[B,k] user ids, scores f32[B,k]); -1 pads. One jit
    program; peak memory is one [B, block] score tile plus the running
    [B, refine] survivor set."""
    n, d = sketch.shape
    b = queries.shape[0]
    block = min(block, n)
    n_pad = int(np.ceil(n / block)) * block
    sk = jnp.pad(sketch, ((0, n_pad - n), (0, 0)))
    n_blocks = n_pad // block
    q_lp = _query_lp(queries, sketch.dtype, d)
    refine_blk = min(refine, block)

    def body(carry, ci):
        best_s, best_i = carry
        rows = jax.lax.dynamic_slice_in_dim(sk, ci * block, block)
        scores = jnp.einsum(
            "bd,nd->bn", q_lp, rows, preferred_element_type=jnp.float32
        )                                               # [B, block] f32
        ids = ci * block + jnp.arange(block, dtype=jnp.int32)[None, :]
        scores = jnp.where(ids < n, scores, -jnp.inf)
        s_blk, ti = jax.lax.approx_max_k(scores, refine_blk)
        i_blk = jnp.take_along_axis(
            jnp.broadcast_to(ids, (b, block)), ti, axis=1
        )
        cat_s = jnp.concatenate([best_s, s_blk], axis=1)
        cat_i = jnp.concatenate([best_i, i_blk], axis=1)
        return _top_k(cat_s, cat_i, refine), None

    init = (
        jnp.full((b, refine), -jnp.inf, dtype=jnp.float32),
        jnp.full((b, refine), -1, dtype=jnp.int32),
    )
    (sk_s, cand), _ = jax.lax.scan(
        body, init, jnp.arange(n_blocks, dtype=jnp.int32)
    )

    # exact refine: f32 row gather + rescore
    return _exact_refine(corpus, row_ids, queries, cand,
                         (cand >= 0) & jnp.isfinite(sk_s), query_ids, k,
                         exclude_self)


class FlatIndex:
    """Host orchestrator for the quantized-flat engine — the fast path for
    device-resident dense corpora (same query surface as `RDFForest`)."""

    def __init__(self, sketch_dtype: str = "int8", refine: int = 128,
                 block: int = 1 << 20, query_batch: int = 1024,
                 mode: str = "grouped", r_groups: int = 24,
                 corpus_dtype: str = "float32"):
        self.sketch_dtype = sketch_dtype
        self.refine = refine
        self.block = block
        self.query_batch = query_batch
        self.mode = mode            # "grouped" (fused group max) | "scan"
        self.r_groups = r_groups
        # exact-tier residency: "bfloat16" halves the refine-gather traffic
        # AND the engine's dominant memory term; refine dots accumulate in
        # f32, so only near-ties below bf16's ~3-digit mantissa can reorder
        self.corpus_dtype = corpus_dtype
        self.corpus = None
        self.sketch = None
        self.row_ids = None

    def fit(self, batch) -> "FlatIndex":
        """batch: vectors.DenseBatch."""
        corpus = jnp.asarray(batch.values, dtype=jnp.float32)
        self.sketch, self.scale = build_flat_sketch(
            corpus, self.sketch_dtype
        )
        # the exact tier is lane-padded like the sketch
        self.corpus = _pad_lanes(corpus)
        if self.corpus_dtype == "bfloat16":
            self.corpus = self.corpus.astype(jnp.bfloat16)
        self.row_ids = jnp.asarray(np.asarray(batch.ids, dtype=np.int32))
        return self

    def query(
        self,
        queries: np.ndarray,
        k: int = 10,
        query_ids: Optional[np.ndarray] = None,
        exclude_self: bool = True,
    ) -> Tuple[np.ndarray, np.ndarray]:
        if self.corpus is None:
            print("need to fit the data first")
            return (np.full((len(queries), k), -1, np.int32),
                    np.full((len(queries), k), -np.inf, np.float32))
        q = np.asarray(queries, dtype=np.float32)
        nq = len(q)
        qids = (np.asarray(query_ids, dtype=np.int32)
                if query_ids is not None
                else np.full((nq,), -1, np.int32))
        bsz = effective_query_batch(nq, self.query_batch)
        out_i, out_s = [], []
        for s0 in range(0, nq, bsz):
            s1 = min(s0 + bsz, nq)
            pad = bsz - (s1 - s0)
            qc = jnp.asarray(np.pad(q[s0:s1], ((0, pad), (0, 0))))
            qi = jnp.asarray(np.pad(qids[s0:s1], (0, pad),
                                    constant_values=-1))
            if self.mode == "grouped":
                # no-drop guideline for group-max preselection: >= 3k groups
                # (see _grouped_candidates) — derive from k so a caller's
                # larger top_k can't silently under-select
                ids, scores = flat_topk_grouped(
                    self.sketch, self.corpus, self.row_ids, qc, qi, k,
                    refine=self.refine, r_groups=max(self.r_groups, 3 * k),
                    exclude_self=exclude_self,
                )
            else:
                ids, scores = flat_topk(
                    self.sketch, self.corpus, self.row_ids, qc, qi, k,
                    refine=self.refine, block=self.block,
                    exclude_self=exclude_self,
                )
            # keep per-batch outputs on device: converting inside the loop
            # would wait for each batch before dispatching the next; the
            # tiny [bsz, k] slices convert together at the end
            out_i.append(ids[: s1 - s0])
            out_s.append(scores[: s1 - s0])
        return (np.concatenate([np.asarray(a) for a in out_i]),
                np.concatenate([np.asarray(a) for a in out_s]))


_I32_DEAD = -(2**31 - 1)     # dead-group sentinel; negation-safe (not MIN)


def group_max_plain(
    q_lp: jax.Array,      # int8/bf16 [B, D]
    sk: jax.Array,        # same dtype [Npad, D], Npad % group == 0
    group: int = _GROUP,
    pack: bool = False,
) -> jax.Array:
    """Plain XLA group maxima [B, Npad/group] of q_lp · skᵀ: int32 for
    int8 inputs (argmax-packed `(score << log2 group) | member` when
    `pack`), float32 for bf16. The reference for the fused kernel, and the
    path on every platform but CUDA."""
    b = q_lp.shape[0]
    npad = sk.shape[0]
    acc_t = jnp.int32 if q_lp.dtype == jnp.int8 else jnp.float32
    s = jax.lax.dot_general(q_lp, sk, (((1,), (1,)), ((), ())),
                            preferred_element_type=acc_t)
    if pack:
        member = jnp.arange(npad, dtype=jnp.int32) & (group - 1)
        s = (s << (group.bit_length() - 1)) | member[None, :]
    return s.reshape(b, npad // group, group).max(axis=-1)


def group_max(
    q_lp: jax.Array,      # int8/bf16 [B, D], D % 128 == 0
    sk: jax.Array,        # same dtype [Npad, D], Npad % _BLOCK_N == 0
    group: int = _GROUP,
    pack: bool = False,
) -> jax.Array:
    """Group maxima of the sketch scan (see `group_max_plain`). Lowered as
    the fused Triton kernel on CUDA devices and as the plain version
    elsewhere; the choice follows the device the computation is compiled
    for, so a state moved to the host CPU still runs."""
    return jax.lax.platform_dependent(
        q_lp, sk,
        cuda=functools.partial(group_max_pallas, group=group, pack=pack),
        default=functools.partial(group_max_plain, group=group, pack=pack),
    )


def _argpack_candidates(
    sketch: jax.Array,            # int8 [N, D]
    queries: jax.Array,           # f32[B, D]
    refine: int,
    group: int,
    select_sg: Optional[int] = None,
    n_live: Optional[int] = None,
    l2: str = _ARGPACK_L2,
) -> Tuple[jax.Array, jax.Array]:
    """Argmax-packed grouped preselection: the group max carries
    int32 `score*group + member` per group, so the top-`refine` GROUPS by
    packed key directly name their best rows — no window re-score, no
    second select.

    Candidate-set quality: any global sketch-top-`refine` row that is its
    group's argmax IS captured (its group's gmax ≥ its score, and at most
    refine-1 groups can rank above it, each needing a strictly better row).
    Only non-argmax rows of multiply-hit groups are traded for the next
    best groups' argmaxes — at corpus-random row order the chance that two
    true top-10 rows share one 64-row group is ~refine/NG per pair
    (≈0.03% at 8M), far below the int8 sketch's own ordering noise.

    Returns (cand i32[B, refine] row positions, sel_s f32[B, refine];
    -inf = invalid)."""
    assert sketch.dtype == jnp.int8, "argpack needs the int8 sketch"
    assert group & (group - 1) == 0, group
    nrows, d = sketch.shape
    n = nrows if n_live is None else n_live
    npad = int(np.ceil(nrows / _BLOCK_N)) * _BLOCK_N
    sk = jnp.pad(sketch, ((0, npad - nrows), (0, 0)))
    q_lp = _query_lp(queries, sketch.dtype, d)
    ng = npad // group
    packed = group_max(q_lp, sk, group, pack=True)          # i32 [B, NG]
    g_live = (jnp.arange(ng, dtype=jnp.int32) * group) < n
    packed = jnp.where(g_live[None, :], packed, _I32_DEAD)
    return select_packed_rows(
        packed, group=group, refine=refine, n=n, select_sg=select_sg, l2=l2,
    )


def select_packed_rows(
    packed: jax.Array,    # i32[B, NG] argmax-packed group maxima
    group: int,
    refine: int,
    n: int,               # live row count (cand >= n masked out)
    select_sg: Optional[int] = None,
    l2: str = _ARGPACK_L2,
) -> Tuple[jax.Array, jax.Array]:
    """Two-level exact top-`refine` row select over an argmax-packed slab
    (the consumer half of the argpack pipeline; see `_argpack_candidates`
    for the containment proof). Returns (cand i32[B, refine] row
    positions, sel_s f32[B, refine]; -inf = invalid)."""
    b, ng = packed.shape
    shift = group.bit_length() - 1
    rg = min(refine, ng)
    sg = (select_sg if select_sg is not None
          else _default_select_sg("argpack"))
    if ng % sg == 0 and ng // sg >= 2 * rg:
        # two-level EXACT select (same containment proof as exact2: every
        # top-rg group's supergroup max beats the rg-th best group, and at
        # most rg supergroups can)
        nsg = ng // sg
        p3 = packed.reshape(b, nsg, sg)
        sgmax = p3.max(axis=-1)                          # [B, NSG]
        _, sgi = jax.lax.sort((-sgmax, jnp.broadcast_to(
            jnp.arange(nsg, dtype=jnp.int32), (b, nsg))), num_keys=1)
        sgi = sgi[:, :rg]                                # [B, RG]
        cg = jnp.take_along_axis(p3, sgi[:, :, None], axis=1).reshape(
            b, rg * sg)
        child = (sgi[:, :, None] * sg
                 + jnp.arange(sg, dtype=jnp.int32)).reshape(b, rg * sg)
        # level-2 over the [B, rg*sg] child slab. Two formulations:
        #   approx: approx_max_k over the UNSHIFTED score as f32 — int8
        #     scores are < 2^24 so the f32 value is exact (ordering
        #     identical up to member tie-breaks).
        #   sort: one 2-operand descending sort keyed on the packed i32 —
        #     exact. The payload packs (level-1 rank, child slot) into one
        #     int32 so the sort stays 2-operand.
        if l2 == "sort":
            slot = jnp.broadcast_to(
                jnp.arange(rg * sg, dtype=jnp.int32), cg.shape)
            _, slot_s = jax.lax.sort((-cg, slot), dimension=1, num_keys=1)
            li = slot_s[:, :rg]
        else:
            sc_f = (cg >> shift).astype(jnp.float32)
            _, li = jax.lax.approx_max_k(sc_f, rg, recall_target=0.998)
        gidx = jnp.take_along_axis(child, li, axis=1)
        gpk = jnp.take_along_axis(cg, li, axis=1)
    else:
        sc_f = (packed >> shift).astype(jnp.float32)
        _, li = jax.lax.approx_max_k(sc_f, rg, recall_target=0.998)
        gidx = li
        gpk = jnp.take_along_axis(packed, li, axis=1)

    cand = gidx * group + (gpk & (group - 1))
    sel_s = (gpk >> shift).astype(jnp.float32)
    sel_s = jnp.where((gpk > _I32_DEAD) & (cand < n), sel_s, -jnp.inf)
    if rg < refine:
        cand = jnp.pad(cand, ((0, 0), (0, refine - rg)))
        sel_s = jnp.pad(sel_s, ((0, 0), (0, refine - rg)),
                        constant_values=-np.inf)
    return cand, sel_s


def _window_scores(
    sk: jax.Array,            # int8/bf16 [Npad, D]
    queries: jax.Array,       # f32[B, D'] (D' <= D)
    blk_start: jax.Array,     # i32[B, W] window start rows
    win: int,
) -> jax.Array:
    """bf16 scores f32[B, W, win] of `win` contiguous sketch rows from each
    window start (starts clipped to the table)."""
    npad, d = sk.shape
    rows_i = blk_start[:, :, None] + jnp.arange(win, dtype=jnp.int32)
    w_rows = sk[jnp.clip(rows_i, 0, npad - 1)]          # [B, W, win, D]
    return jnp.einsum(
        "brgd,bd->brg", w_rows.astype(jnp.bfloat16),
        _pad_lanes(queries.astype(jnp.bfloat16))[:, :d],
        preferred_element_type=jnp.float32,
    )


def _grouped_candidates(
    sketch: jax.Array,            # int8/bf16 [N, D]
    queries: jax.Array,           # f32[B, D] (dense or densified)
    refine: int,
    r_groups: int,
    group: int,
    recall_target: float,
    select_mode: str = _SELECT_MODE,
    select_sg: Optional[int] = None,
    n_live: Optional[int] = None,
) -> Tuple[jax.Array, jax.Array]:
    """Shared grouped preselection: fused matmul+group-max → top groups →
    row-wise window re-score → (cand i32[B, refine] row positions,
    sel_s f32[B, refine] sketch scores; -inf = invalid). Engine-specific
    exact tails (dense f32 rows / sparse merge) consume the output.
    Group-max preselection with r_groups ≥ 3k cannot drop a true top-k
    row: a row in the sketch top-k lies in a group whose max is at least
    its score, and at most k-1 other groups can beat it.

    `n_live` is the true row count when `sketch` arrives pre-padded
    (masking uses it, not the padded shape)."""
    if select_mode in ("auto", "argpack"):     # callers resolve; be safe
        select_mode = "exact2"
    nrows, d = sketch.shape
    n = nrows if n_live is None else n_live
    b = queries.shape[0]
    npad = int(np.ceil(nrows / _BLOCK_N)) * _BLOCK_N
    sk = jnp.pad(sketch, ((0, npad - nrows), (0, 0)))
    q_lp = _query_lp(queries, sketch.dtype, d)
    gmax = group_max(q_lp, sk, group).astype(jnp.float32)     # [B, NG]
    ng = npad // group
    # mask all-padding groups (first padded group may be partial — its real
    # rows keep it live; pure-pad groups score garbage zeros → mask)
    g_live = (jnp.arange(ng, dtype=jnp.int32) * group) < n
    gmax = jnp.where(g_live[None, :], gmax, -jnp.inf)
    rg = min(r_groups, ng)
    # the group select bounds end recall: a missed group loses all its rows
    # (refine can't recover it). Two-level EXACT select: any top-rg group's
    # sg-group supergroup has super-max >= the rg-th best group max, and at
    # most rg supergroups can (each needs a >= rg-th-best group inside), so
    # the top-rg supergroups provably contain every top-rg group.
    sg = (select_sg if select_sg is not None
          else _default_select_sg(select_mode))
    if (select_mode == "exact2" and ng % sg == 0
            and ng // sg >= 4 * rg):
        nsg = ng // sg
        g3 = gmax.reshape(b, nsg, sg)
        sgmax = g3.max(axis=-1)                           # [B, NSG]
        _, sgi = jax.lax.top_k(sgmax, rg)                 # exact, [B, RG]
        # row-gather the selected supergroups' children: rg*sg elements per
        # query is the stage's whole cost, so sg trades gather bytes against
        # the level-1 top_k's O(nsg*rg) scan
        cg = jnp.take_along_axis(
            g3, sgi[:, :, None], axis=1
        ).reshape(b, rg * sg)                             # [B, RG*sg]
        child = (
            sgi[:, :, None] * sg + jnp.arange(sg, dtype=jnp.int32)
        ).reshape(b, rg * sg)
        _, ci = jax.lax.top_k(cg, rg)
        gidx = jnp.take_along_axis(child, ci, axis=1)     # [B, RG]
    elif select_mode == "topk":
        _, gidx = jax.lax.top_k(gmax, rg)
    else:
        _, gidx = jax.lax.approx_max_k(gmax, rg,
                                       recall_target=recall_target)

    # row-wise sketch re-score of every selected group's rows, as 64-row
    # windows (groups wider than 64 rows expand into several windows)
    win = min(group, 64)
    wpg = group // win                                  # windows per group
    blk_start = (
        (gidx * group)[:, :, None]
        + (jnp.arange(wpg, dtype=jnp.int32) * win)[None, None, :]
    ).reshape(b, rg * wpg)
    w_scores = _window_scores(sk, queries, blk_start, win)
    pos = (blk_start[:, :, None]
           + jnp.arange(win, dtype=jnp.int32)[None, None, :])
    m = rg * group
    w_scores = jnp.where(pos < n, w_scores, -jnp.inf).reshape(b, m)
    pos = pos.reshape(b, m)
    r2 = min(refine, m)
    _, sel = jax.lax.approx_max_k(w_scores, r2, recall_target=recall_target)
    cand = jnp.take_along_axis(pos, sel, axis=1)        # [B, refine]
    sel_s = jnp.take_along_axis(w_scores, sel, axis=1)
    sel_s = jnp.where(cand < n, sel_s, -jnp.inf)
    return cand, sel_s


@functools.partial(
    jax.jit,
    static_argnames=("k", "refine", "r_groups", "group", "exclude_self",
                     "recall_target", "select_mode", "select_sg",
                     "argpack_l2"),
)
def flat_topk_grouped(
    sketch: jax.Array,            # int8/bf16 [N, D]
    corpus: jax.Array,            # f32[N, D] (may be lane-padded)
    row_ids: jax.Array,           # i32[N]
    queries: jax.Array,           # f32[B, D]
    query_ids: jax.Array,         # i32[B]
    k: int,
    refine: int = 128,
    r_groups: int = 32,
    group: int = 64,
    exclude_self: bool = True,
    recall_target: float = 0.998,
    select_mode: str = _SELECT_MODE,
    select_sg: Optional[int] = None,
    argpack_l2: str = _ARGPACK_L2,
) -> Tuple[jax.Array, jax.Array]:
    """Grouped flat scan: fused matmul+group-max (the kernel never writes
    the [B, N] scores — a `group`× cut of score traffic vs `flat_topk`),
    then top `r_groups` groups per query are re-scored row-wise (contiguous
    64-row windows) and the top `refine` rows get the exact f32 re-score.
    Recall is int8-sketch-bound, same as `flat_topk`.

    select_mode="argpack" (int8 sketches only) replaces the select →
    window-rescore → select2 tail with the argmax-packed group maxima
    (`_argpack_candidates`): top-`refine` groups each contribute their
    best row directly."""
    select_mode = _resolve_select_mode(select_mode, sketch.dtype,
                                       sketch.shape[0], sketch.shape[1])
    if select_mode == "argpack" and sketch.dtype == jnp.int8:
        cand, sel_s = _argpack_candidates(
            sketch, queries, refine, group, select_sg=select_sg,
            n_live=row_ids.shape[0], l2=argpack_l2,
        )
    else:
        cand, sel_s = _grouped_candidates(
            sketch, queries, refine, r_groups, group, recall_target,
            select_mode, select_sg, n_live=row_ids.shape[0],
        )
    return _exact_refine(corpus, row_ids, queries, cand,
                         jnp.isfinite(sel_s), query_ids, k, exclude_self)


# ---------------------------------------------------------------------------
# Sparse flat engine: densified int8 sketch scan + exact sparse-merge refine
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("size", "chunk"))
def _densify_quantize(
    indices: jax.Array,   # i32[N, NNZ]
    values: jax.Array,    # f32[N, NNZ] (padding values 0)
    scale: jax.Array,     # f32 scalar
    size: int,
    chunk: int = 65536,
) -> jax.Array:
    """int8[N, size_pad] densified sketch, built in row chunks so the f32
    dense intermediate never exceeds chunk×size."""
    n, nnz = indices.shape
    size_pad = int(np.ceil(size / 128.0) * 128)
    npad = int(np.ceil(n / chunk)) * chunk
    idx = jnp.pad(indices, ((0, npad - n), (0, 0)))
    val = jnp.pad(values, ((0, npad - n), (0, 0)))

    def one(args):
        ic, vc = args
        rows = jnp.zeros((chunk, size_pad), jnp.float32)
        rows = rows.at[
            jnp.arange(chunk, dtype=jnp.int32)[:, None], ic
        ].add(vc)
        return jnp.clip(jnp.round(rows * scale), -127, 127).astype(jnp.int8)

    out = jax.lax.map(
        one, (idx.reshape(-1, chunk, nnz), val.reshape(-1, chunk, nnz))
    )
    return out.reshape(npad, size_pad)[:n]


def build_flat_sketch_sparse(
    indices: jax.Array, values: jax.Array, size: int,
) -> Tuple[jax.Array, float]:
    """Densified int8 sketch of a padded-COO sparse corpus. The densified
    copy costs N × pad128(size) bytes (1M × 4096d → 4.1 GB) — affordable
    exactly because int8 is 4× smaller than the f32 densification the
    sparse path could never hold. Returns (sketch, scale)."""
    amax = float(jnp.max(jnp.abs(values)))
    scale = 127.0 / max(amax, 1e-30)
    return (
        _densify_quantize(indices, values, jnp.float32(scale), size),
        scale,
    )


def _densify_queries(q_indices, q_values, size_pad):
    b = q_indices.shape[0]
    q = jnp.zeros((b, size_pad), jnp.float32)
    return q.at[jnp.arange(b, dtype=jnp.int32)[:, None], q_indices].add(
        q_values
    )


@functools.partial(
    jax.jit,
    static_argnames=("k", "refine", "r_groups", "group", "exclude_self",
                     "recall_target"),
)
def flat_topk_sparse(
    sketch: jax.Array,            # int8[N, size_pad] densified corpus
    corpus_indices: jax.Array,    # i32[N, NNZ] exact tier (sparse)
    corpus_values: jax.Array,     # f32[N, NNZ]
    row_ids: jax.Array,           # i32[N]
    q_indices: jax.Array,         # i32[B, NNZq]
    q_values: jax.Array,          # f32[B, NNZq]
    query_ids: jax.Array,         # i32[B]
    k: int,
    refine: int = 128,
    r_groups: int = 24,
    group: int = 64,
    exclude_self: bool = True,
    recall_target: float = 0.998,
) -> Tuple[jax.Array, jax.Array]:
    """Sparse flat search: queries densify to the sketch's dense space, the
    grouped sketch scan preselects candidates, and the exact tail is the
    sort-merge sparse·sparse dot (`rerank.sparse_merge_scores`) — the
    sparse corpus itself is never densified at f32."""
    from .rerank import sparse_merge_scores

    qd = _densify_queries(q_indices, q_values, sketch.shape[1])
    mode = _resolve_select_mode(_SELECT_MODE, sketch.dtype,
                                sketch.shape[0], sketch.shape[1])
    if mode == "argpack" and sketch.dtype == jnp.int8:
        cand, sel_s = _argpack_candidates(
            sketch, qd, refine, group, n_live=row_ids.shape[0],
        )
    else:
        cand, sel_s = _grouped_candidates(
            sketch, qd, refine, r_groups, group, recall_target,
            select_mode=mode,
        )
    exact = sparse_merge_scores(
        corpus_indices, corpus_values,
        jnp.where(jnp.isfinite(sel_s), cand, -1), q_indices, q_values,
    )
    n = row_ids.shape[0]
    safe = jnp.clip(cand, 0, n - 1)
    uid = row_ids[safe]
    valid = jnp.isfinite(sel_s) & jnp.isfinite(exact) & (uid >= 0)
    if exclude_self:
        valid &= uid != query_ids[:, None]
    exact = jnp.where(valid, exact, -jnp.inf)
    top_s, top_u = _top_k(exact, uid, k)
    return jnp.where(jnp.isfinite(top_s), top_u, -1), top_s


class SparseFlatIndex:
    """Host orchestrator for the sparse flat engine (same query surface as
    `SparseRDFForest`; `steps` has no meaning — every row is scored)."""

    def __init__(self, refine: int = 128, r_groups: int = 24,
                 query_batch: int = 1024):
        self.refine = refine
        self.r_groups = r_groups
        self.query_batch = query_batch
        self.sketch = None

    def fit(self, batch) -> "SparseFlatIndex":
        """batch: vectors.SparseBatch."""
        from .rerank import check_sparse_size_for_merge

        check_sparse_size_for_merge(int(batch.size))
        self.c_idx = jnp.asarray(batch.indices)
        self.c_val = jnp.asarray(batch.values)
        self.size = int(batch.size)
        self.sketch, self.scale = build_flat_sketch_sparse(
            self.c_idx, self.c_val, self.size
        )
        self.row_ids = jnp.asarray(np.asarray(batch.ids, dtype=np.int32))
        return self

    def query(
        self,
        q_indices: np.ndarray,
        q_values: np.ndarray,
        k: int = 10,
        query_ids: Optional[np.ndarray] = None,
        exclude_self: bool = True,
    ) -> Tuple[np.ndarray, np.ndarray]:
        if self.sketch is None:
            print("need to fit the data first")
            return (np.full((len(q_indices), k), -1, np.int32),
                    np.full((len(q_indices), k), -np.inf, np.float32))
        nq = len(q_indices)
        qids = (np.asarray(query_ids, dtype=np.int32)
                if query_ids is not None
                else np.full((nq,), -1, np.int32))
        bsz = effective_query_batch(nq, self.query_batch)
        out_i, out_s = [], []
        for s0 in range(0, nq, bsz):
            s1 = min(s0 + bsz, nq)
            pad = bsz - (s1 - s0)
            qi = jnp.asarray(np.pad(np.asarray(q_indices[s0:s1], np.int32),
                                    ((0, pad), (0, 0))))
            qv = jnp.asarray(np.pad(np.asarray(q_values[s0:s1], np.float32),
                                    ((0, pad), (0, 0))))
            qid = jnp.asarray(np.pad(qids[s0:s1], (0, pad),
                                     constant_values=-1))
            ids, scores = flat_topk_sparse(
                self.sketch, self.c_idx, self.c_val, self.row_ids,
                qi, qv, qid, k, refine=self.refine,
                r_groups=max(self.r_groups, 3 * k),
                exclude_self=exclude_self,
            )
            # keep per-batch outputs on device: converting inside the loop
            # would wait for each batch before dispatching the next; the
            # tiny [bsz, k] slices convert together at the end
            out_i.append(ids[: s1 - s0])
            out_s.append(scores[: s1 - s0])
        return (np.concatenate([np.asarray(a) for a in out_i]),
                np.concatenate([np.asarray(a) for a in out_s]))
