"""RDFForest — the Dynamic Partition Forest as one jitted pipeline.

Replaces the reference's orchestration stack (`DensevectorRDFInit` thread
pools over `RandomDrawTreeMap.getSimilarWithStepWiseFaster`,
`DensevectorRDFInit.scala:335-432`) with two device programs:

fit   (SURVEY.md §7.3): hash all vectors `[N, L]` → partition-hash →
      composite keys → per-table sort → overflow-rule leaf buckets (CSR).
query (SURVEY.md §7.4): hash `[B, L]` → step-wise partition fan-out ×
      multi-probe flips → merge-rank bucket lookup → bucket-range dedup with
      step-distance priority → merge-sort ragged flatten → exact top-k
      re-rank with post-top-slice dedup. Every stage is sort/scan-shaped,
      with few scatters.

The reference's parallelism P1 (thread-per-table-range) disappears: the table
axis is just a tensor dimension. P2-P6 are reproduced as tensor ops (see
`partitioner.py`, probe generation below).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import RDFConfig
from ..models.families import HashModel, generate_model
from ..ops import rerank as rerank_ops
from ..ops.bitops import clz
from ..ops.hashing import hash_dense
from ..vectors import DenseBatch
from .bucket_table import (
    BucketTables,
    KeyLayout,
    build_tables,
    composite_keys,
    lookup_ranges,
)
from .partitioner import (
    generate_partition_projections,
    partition_of_hash,
    stepwise_patterns,
)


# Test hook: force the unpacked (multi-operand-sort) range dedup path that
# large capacities take, so its semantics can be asserted equal to the packed
# path on small corpora (see tests/test_edge_cases.py).
_FORCE_UNPACKED_RANGES = False

import os as _os

# Coarse-select schedule knob (see _select_m2): approx_max_k is used when
# m2 * FACTOR <= slab width, the packed sort otherwise.
_SELECT_APPROX_FACTOR = int(_os.environ.get("FOREST_SELECT_APPROX_FACTOR",
                                            "16"))
# folded groupmax path: single-operand packed sorts for the group select
# and the select_mult dedup (sort cost scales with operand count); both
# fall back to the exact 2-operand sorts when the bit budget does not fit
_FOLD_PACK_SELECT = _os.environ.get("FOLD_PACK_SELECT", "1") == "1"
_FOLD_PACK_DEDUP = _os.environ.get("FOLD_PACK_DEDUP", "1") == "1"

# dead-row sentinel of the packed folded rows: NOT int32 min, so `-pk`
# sort keys never overflow
I32_DEAD = -(2**31 - 1)


# ---------------------------------------------------------------------------
# Device state
# ---------------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ForestState:
    """All device arrays of a fitted dense forest (a JAX pytree, so the whole
    index moves through jit/shard_map as one value)."""

    model: HashModel
    part_proj: jax.Array        # f32[L, pbits, 32]
    tables: BucketTables
    corpus: jax.Array           # f32[Npad, D] (padding rows = 0)
    row_ids: jax.Array          # i32[Npad] user vector ids (padding = -1)
    # optional bf16 copy: coarse-pass rerank at half the gather traffic,
    # refined exactly from `corpus` (rerank_dtype="bfloat16")
    corpus_lp: Optional[jax.Array] = None
    # table-ordered coarse tier (conf.coarse_dim): per-table, bucket-sorted
    # low-dim projections so coarse scoring gathers CONTIGUOUS blocks
    coarse_proj: Optional[jax.Array] = None      # f32[D, Cd]
    coarse_by_table: Optional[jax.Array] = None  # int8/bf16[Lg, Npad+ID_PAD, G*cs] lane-packed
    # mean-pooled head tier for two-phase window pruning (coarse_head_pool):
    # row r = masked mean of coarse rows [r*hp, (r+1)*hp) per lane segment
    coarse_head: Optional[jax.Array] = None      # bf16[Lg, ceil(caprows/hp), G*cs]
    # SLOT-FOLDED coarse tier (conf.coarse_layout="folded"): fold = 128//cs
    # CONSECUTIVE slots of one table per 128-lane row, queried through the
    # groupmax path (`_query_groupmax` / `rowmax_packed`)
    coarse_folded: Optional[jax.Array] = None    # i8[L, caprows/fold, 128]
    # 128-lane row view of sorted_ids for the folded id fetch, cached at
    # fit/load time: building it in-jit re-pays a pad + relayout copy of
    # sorted_ids on EVERY query chunk.
    # Derived data — rebuilt, never persisted; None falls back to in-jit
    # construction (sharded per-shard states, legacy checkpoints).
    ids128: Optional[jax.Array] = None           # i32[L*ceil(cap/128), 128]

    @property
    def capacity(self) -> int:
        return self.corpus.shape[0]


# ---------------------------------------------------------------------------
# fit
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("layout", "chunk"))
def _keys_for_corpus(
    model: HashModel,
    part_proj: jax.Array,
    values: jax.Array,        # f32[Npad, D]
    valid: jax.Array,         # bool[Npad]
    layout: KeyLayout,
    chunk: int,
) -> jax.Array:
    """Composite sort keys `[L, Npad]` for the whole corpus, hashed in
    `chunk`-sized pieces so the `[N, L, C]` projection intermediate never
    materializes (ref hot loop #1 `RandomDrawTreeMap:1498-1521`
    re-hashed every vector per table, per insert)."""
    n, d = values.shape
    n_chunks = n // chunk

    def one(xc):
        h = hash_dense(model, xc)                      # [chunk, L]
        p = partition_of_hash(h, part_proj)            # [chunk, L]
        return composite_keys(h, p, layout)            # [chunk, L] u32

    keys = jax.lax.map(one, values.reshape(n_chunks, chunk, d))
    keys = keys.reshape(n, -1)
    keys = jnp.where(valid[:, None], keys, jnp.uint32(0xFFFFFFFF))
    return keys.T                                       # [L, Npad]


def _pad_to(n: int, multiple: int) -> int:
    return int(np.ceil(max(n, 1) / multiple) * multiple)


def fit_dense(
    conf: RDFConfig,
    batch: DenseBatch,
    model: Optional[HashModel] = None,
    part_proj: Optional[jax.Array] = None,
    nb_pad: Optional[int] = None,
) -> ForestState:
    """Build a forest over a dense corpus — the one-pass replacement for
    `newFastFit`/`newMultiThreadFit` (`DensevectorRDFInit.scala:127-206`)."""
    layout = KeyLayout.from_config(conf, conf.lsh_table)
    model = model if model is not None else generate_model(conf)
    part_proj = (
        part_proj
        if part_proj is not None
        else generate_partition_projections(conf)
    )
    n = batch.n
    chunk = min(conf.fit_batch_size, _pad_to(n, 256))
    npad = _pad_to(n, chunk)
    row_ids = np.full((npad,), -1, dtype=np.int32)
    row_ids[:n] = batch.ids
    valid = np.zeros((npad,), dtype=bool)
    valid[:n] = True

    if isinstance(batch.values, jax.Array):
        # device-resident corpus (steady-state refits, streaming updates):
        # skip the host staging copy + upload
        values_d = batch.values
        if values_d.shape[0] != npad:
            values_d = jnp.pad(
                values_d, ((0, npad - values_d.shape[0]), (0, 0)))
    else:
        values = np.zeros((npad, batch.dim), dtype=np.float32)
        values[:n] = batch.values
        values_d = jnp.asarray(values)
    keys = _keys_for_corpus(
        model, part_proj, values_d, jnp.asarray(valid), layout, chunk
    )
    ids = jnp.broadcast_to(
        jnp.where(jnp.asarray(valid), jnp.arange(npad, dtype=jnp.int32), -1)[None, :],
        keys.shape,
    )
    tables = build_tables(
        keys, ids, layout, conf.lsh_table.bucket_overflow, nb_pad=nb_pad
    )
    del keys, ids
    # the stored scoring copies are LANE-PADDED to a 128 multiple; rerank
    # pads queries to match. Built after the build's big sort temporaries
    # and the unpadded values dropped right after, so the padded and
    # unpadded copies never coexist through build_tables.
    dpad = _pad_to(batch.dim, 128)
    corpus_store = (
        jnp.pad(values_d, ((0, 0), (0, dpad - batch.dim)))
        if dpad != batch.dim else values_d
    )
    del values_d
    if dpad != batch.dim:
        corpus_store.block_until_ready()   # let the unpadded buffer free
    # the coarse tier (itself bytes-per-vector scale) builds FROM the padded
    # scoring copy — with a row-padded projection — so it never coexists
    # with both corpus copies (the 8M x 96 Deep bench OOMed otherwise)
    coarse_proj = coarse_by_table = coarse_head = coarse_folded = None
    if conf.coarse_dim:
        if conf.coarse_layout == "folded":
            coarse_proj, coarse_folded = _build_folded_tier(
                corpus_store, tables.sorted_ids, conf.coarse_dim,
                conf.coarse_dtype, conf.seed, dim=batch.dim,
                proj_mode=conf.coarse_proj_mode,
            )
        else:
            coarse_proj, coarse_by_table = _build_coarse_tier(
                corpus_store, tables.sorted_ids, conf.coarse_dim,
                conf.coarse_dtype, conf.seed, dim=batch.dim,
                proj_mode=conf.coarse_proj_mode,
            )
            if conf.coarse_head_pool:
                coarse_head = build_head_tier(
                    coarse_by_table, tables.sorted_ids, conf.coarse_head_pool,
                    groups=max(1, 128 // coarse_proj.shape[1]),
                )
    corpus_lp = (
        corpus_store.astype(jnp.bfloat16)
        if conf.rerank_dtype == "bfloat16" else None
    )
    return ForestState(
        model=model,
        part_proj=part_proj,
        tables=tables,
        corpus=corpus_store,
        row_ids=jnp.asarray(row_ids),
        corpus_lp=corpus_lp,
        coarse_proj=coarse_proj,
        coarse_by_table=coarse_by_table,
        coarse_head=coarse_head,
        coarse_folded=coarse_folded,
        ids128=(ids128_view(tables.sorted_ids)
                if coarse_folded is not None else None),
    )


@jax.jit
def ids128_view(sorted_ids: jax.Array) -> jax.Array:
    """[L, cap] -> [L*ceil(cap/128), 128] row view of the per-table sorted
    ids (pad = -1): the folded id fetch gathers a group's parent 128-lane
    row (lane-full, so the gather rides the vectorized fast path) and
    extracts the gsl slice with a static select chain."""
    l_n, id_cap = sorted_ids.shape
    idw = -(-id_cap // 128) * 128
    if idw != id_cap:
        sorted_ids = jnp.pad(
            sorted_ids, ((0, 0), (0, idw - id_cap)), constant_values=-1
        )
    return sorted_ids.reshape(l_n * (idw // 128), 128)


def coarse_seg_width(cd: int) -> int:
    """Lane-segment width for the packed coarse tier: the smallest divisor
    of 128 holding a cd-dim row (8/16/32/64), or a 128 multiple when cd is
    too wide to pack. 128 // seg_width tables share one 128-lane row."""
    for cs in (8, 16, 32, 64):
        if cd <= cs:
            return cs
    return int(np.ceil(cd / 128.0) * 128)


def _coarse_projection(
    corpus: jax.Array,   # f32[Npad, Dpad] (zero rows beyond the live corpus)
    d: int,              # true vector dim
    cd: int,
    seed: int,
    mode: str = "random",
) -> np.ndarray:
    """[d, cd] orthonormal projection for the coarse tier.

    mode="random": seed-deterministic QR of a Gaussian (the default).
    mode="pca": top-cd eigenvectors of the corpus's (uncentered) second
    moment — the rank-cd basis minimizing ||X - X P Pᵀ||_F, so int8 coarse
    dots rank candidates closer to the true f32 order than a random basis
    at the same cd (smaller coarse_refine for equal recall). Computed from
    a strided ≤128k-row device sample (one [S, D]ᵀ[S, D] matmul + a host
    96×96 eigh); deterministic in the corpus, so checkpoint loads rebuild
    the identical tier (`storage/persist.load_forest`). Mean is NOT
    subtracted: search scores are inner products, and the uncentered
    moment is the right target for preserving x·q."""
    if mode == "pca":
        n = corpus.shape[0]
        stride = max(1, n // 131072)
        xs = corpus[::stride, :d]
        mom = np.asarray(jnp.einsum("nd,ne->de", xs, xs,
                                    preferred_element_type=jnp.float32))
        w, v = np.linalg.eigh(mom.astype(np.float64))
        proj = v[:, np.argsort(-w)[:cd]].astype(np.float32)
        # deterministic sign convention (eigh sign is arbitrary per column)
        flip = np.sign(proj[np.argmax(np.abs(proj), axis=0),
                            np.arange(cd)])
        return proj * np.where(flip == 0, 1.0, flip)[None, :]
    assert mode == "random", mode
    rng = np.random.default_rng(seed ^ 0x5EED)
    return np.linalg.qr(rng.normal(size=(d, d)))[0][:, :cd].astype(
        np.float32)


def _build_coarse_tier(
    corpus: jax.Array,       # f32[Npad, Dpad] (lane-padded scoring copy)
    sorted_ids: jax.Array,   # i32[L, Npad+ID_PAD]
    coarse_dim: int,
    coarse_dtype: str,
    seed: int,
    dim: Optional[int] = None,   # true vector dim (<= corpus.shape[1])
    proj_mode: str = "random",
    proj: Optional[np.ndarray] = None,   # persisted projection (load path)
) -> Tuple[jax.Array, jax.Array]:
    """Coarse rows replicated per table in BUCKET-SORTED order (padding
    rows = 0), so a query block's coarse rows are one contiguous slice.
    coarse_dim == D keeps full dimensionality (identity projection — no
    ordering loss beyond quantization); smaller dims use a random
    orthonormal projection. int8 storage quantizes with one global scale —
    scores scale uniformly per query, so coarse ORDER is preserved to ~0.8%.

    LANE PACKING: G = 128//seg_width tables share each 128-lane row —
    table t's rows live in lane segment t % G of group t // G — so a
    cd<=64 tier stores G× fewer rows (4× at cd=32); scoring zero-pads the
    query into the right segment so foreign segments contribute nothing to
    the dot.
    One-time fit cost: one [N, D] x [D, Cd] matmul + L gathers of N rows."""
    d = dim if dim is not None else corpus.shape[1]
    cd = min(coarse_dim, d)
    if proj is not None:
        # persisted projection (checkpoint load) — see _build_folded_tier
        proj = np.asarray(proj, dtype=np.float32)
    elif cd == d:
        proj = np.eye(d, dtype=np.float32)
    else:
        proj = _coarse_projection(corpus, d, cd, seed, proj_mode)
    cs = coarse_seg_width(cd)
    if cs != proj.shape[1]:
        proj = np.pad(proj, ((0, 0), (0, cs - proj.shape[1])))
    coarse_proj = jnp.asarray(proj)                            # [D, cs]
    # zero-pad projection ROWS up to the lane-padded corpus width: padding
    # dims contribute 0, so the tier is identical to projecting the true-D
    # corpus (queries keep using the [D, cs] projection)
    proj_build = (
        jnp.asarray(np.pad(proj, ((0, corpus.shape[1] - d), (0, 0))))
        if corpus.shape[1] != d else coarse_proj
    )
    store_int8 = coarse_dtype == "int8"
    return coarse_proj, _coarse_tier_build(
        proj_build, corpus, sorted_ids, store_int8
    )


def _pack_tables_by_lane(low: jax.Array, si: jax.Array) -> jax.Array:
    """Gather each table's rows in its sort order and pack G = 128//cs
    tables per 128-lane row. low [Npad, cs] → [ceil(L/G), caprows, G*cs]."""
    l = si.shape[0]
    cs = low.shape[1]
    g = max(1, 128 // cs)

    def per_table(si_t):
        rows = jnp.take(low, jnp.maximum(si_t, 0), axis=0)
        return jnp.where((si_t >= 0)[:, None], rows, 0)

    groups = []
    for lg in range(int(np.ceil(l / g))):
        segs = [
            per_table(si[lg * g + s]) if lg * g + s < l
            else jnp.zeros((si.shape[1], cs), low.dtype)
            for s in range(g)
        ]
        groups.append(jnp.concatenate(segs, axis=1) if g > 1 else segs[0])
    return jnp.stack(groups)                     # [Lg, caprows, G*cs]


@functools.partial(jax.jit, static_argnames=("store_int8",))
def _coarse_low(cp, c, store_int8):
    """Project + quantize the corpus once: [Npad, Dpad] → [Npad, cs]."""
    low = _coarse_query(c, cp)                                 # [Npad, cs] f32
    if store_int8:
        scale = jnp.float32(127.0) / jnp.maximum(jnp.max(jnp.abs(low)), 1e-20)
        return jnp.clip(jnp.round(low * scale), -127, 127).astype(jnp.int8)
    return low.astype(jnp.bfloat16)


@functools.partial(jax.jit, donate_argnums=(0,))
def _fill_coarse_group(out, low, si_g, lg):
    """Write ONE lane-packed group into the donated tier buffer (gather
    each of the G tables' rows in sort order, concatenate along lanes,
    dynamic-update slice lg). Donation keeps the peak at one output buffer
    plus one group of transients — `jnp.stack` over all groups inside a
    single program double-buffers the full tier and OOMed the 8M x 96
    Deep fit. One compiled program serves every group (lg is traced)."""
    g = si_g.shape[0]

    def per_table(si_t):
        rows = jnp.take(low, jnp.maximum(si_t, 0), axis=0)
        return jnp.where((si_t >= 0)[:, None], rows, 0)

    segs = [per_table(si_g[s]) for s in range(g)]
    grp = jnp.concatenate(segs, axis=1) if g > 1 else segs[0]
    return jax.lax.dynamic_update_slice(
        out, grp[None], (lg, jnp.int32(0), jnp.int32(0))
    )


def _coarse_tier_build(cp, c, si, store_int8):
    """Pack G = 128//cs tables per 128-lane row → [ceil(L/G), Npad+P, G*cs].
    Module-level jits (a closure-local jit would recompile on every fit
    call)."""
    low = _coarse_low(cp, c, store_int8)
    l, caprows = si.shape
    cs = low.shape[1]
    g = max(1, 128 // cs)
    lg_n = int(np.ceil(l / g))
    if l % g:                                    # ragged last group: -1 pad
        si = jnp.concatenate(
            [si, jnp.full((lg_n * g - l, caprows), -1, si.dtype)], axis=0
        )
    out = jnp.zeros((lg_n, caprows, g * cs), low.dtype)
    for lg in range(lg_n):
        out = _fill_coarse_group(
            out, low,
            jax.lax.slice_in_dim(si, lg * g, (lg + 1) * g, axis=0),
            jnp.int32(lg),
        )
    return out                                   # [Lg, Npad+P, G*cs]


def coarse_fold_factor(cs: int) -> int:
    """Slots per 128-lane physical row of the FOLDED tier: consecutive
    same-table slots fill the lanes (128//cs for the packable widths; 1
    when cs is already a 128 multiple)."""
    return max(1, 128 // cs)


@functools.partial(
    jax.jit, donate_argnums=(0,), static_argnames=("fold",)
)
def _fill_folded(out, low, si_t, t, fold):
    """Write ONE table's folded rows into the donated tier buffer: gather
    the table's coarse rows in sort order and fold `fold` consecutive slots
    per physical row (a pure row-major reshape — slot j lands at
    [j // fold, (j % fold) * cs)). Donation keeps the peak at one output
    buffer plus one table of transients (same rationale as
    `_fill_coarse_group`)."""
    caprows = si_t.shape[0]
    cs = low.shape[1]
    rows = jnp.take(low, jnp.maximum(si_t, 0), axis=0)
    rows = jnp.where((si_t >= 0)[:, None], rows, 0)
    folded_t = rows.reshape(caprows // fold, fold * cs)
    return jax.lax.dynamic_update_slice(
        out, folded_t[None], (t, jnp.int32(0), jnp.int32(0))
    )


def _build_folded_tier(
    corpus: jax.Array,       # f32[Npad, Dpad] (lane-padded scoring copy)
    sorted_ids: jax.Array,   # i32[L, Npad+ID_PAD]
    coarse_dim: int,
    coarse_dtype: str,
    seed: int,
    dim: Optional[int] = None,
    proj_mode: str = "random",
    proj: Optional[np.ndarray] = None,   # persisted projection (load path)
) -> Tuple[jax.Array, jax.Array]:
    """SLOT-FOLDED coarse tier [L, caprows/fold, fold*cs]: same projection,
    quantization and bytes as the lane-packed tier (`_build_coarse_tier` —
    the two layouts differ only in which rows share a 128-lane line), laid
    out so a window read's every byte is a candidate byte and the groupmax
    path (`rowmax_packed`) can argmax-pack in place. int8 only: it packs
    integer scores."""
    assert coarse_dtype == "int8", (
        "coarse_layout='folded' requires coarse_dtype='int8' (the groupmax "
        "path packs integer scores)", coarse_dtype)
    d = dim if dim is not None else corpus.shape[1]
    cd = min(coarse_dim, d)
    if proj is not None:
        # persisted projection (checkpoint load): reusing it keeps the
        # rebuilt tier bit-identical to the fitted one across backends —
        # the pca moment matmul is only deterministic on ONE backend —
        # and skips the O(N*d^2) recompute
        proj = np.asarray(proj, dtype=np.float32)
    elif cd == d:
        proj = np.eye(d, dtype=np.float32)
    else:
        proj = _coarse_projection(corpus, d, cd, seed, proj_mode)
    cs = coarse_seg_width(cd)
    if cs != proj.shape[1]:
        proj = np.pad(proj, ((0, 0), (0, cs - proj.shape[1])))
    coarse_proj = jnp.asarray(proj)                            # [D, cs]
    proj_build = (
        jnp.asarray(np.pad(proj, ((0, corpus.shape[1] - d), (0, 0))))
        if corpus.shape[1] != d else coarse_proj
    )
    low = _coarse_low(proj_build, corpus, True)                # i8[Npad, cs]
    l, caprows = sorted_ids.shape
    fold = coarse_fold_factor(cs)
    assert caprows % fold == 0, (caprows, fold)
    out = jnp.zeros((l, caprows // fold, fold * cs), low.dtype)
    for t in range(l):
        out = _fill_folded(out, low, sorted_ids[t], jnp.int32(t), fold)
    return coarse_proj, out


@functools.partial(jax.jit, static_argnames=("hp",))
def _head_pool_group(tier_g, cnt_g, hp):
    """Masked mean-pool ONE lane-packed group: [caprows, lanes] →
    [ceil(caprows/hp), lanes] bf16. cnt_g i32[hr, G] = live rows per pool
    group per lane segment (padding rows are zero in the tier, so the sum
    only needs dividing by the LIVE count to be the mean of live rows)."""
    caprows, lanes = tier_g.shape
    hr = (caprows + hp - 1) // hp
    pad = hr * hp - caprows
    if pad:
        tier_g = jnp.pad(tier_g, ((0, pad), (0, 0)))
    s = jnp.sum(
        tier_g.reshape(hr, hp, lanes).astype(jnp.float32), axis=1
    )                                                   # [hr, lanes]
    g = cnt_g.shape[1]
    cnt_l = jnp.repeat(cnt_g, lanes // g, axis=1)       # [hr, lanes]
    return (s / jnp.maximum(cnt_l, 1).astype(jnp.float32)).astype(
        jnp.bfloat16
    )


def head_tier_traced(
    cbt: jax.Array,      # int8/bf16[Lg, caprows, G*cs] (traced ok)
    si: jax.Array,       # i32[L, caprows]
    hp: int,
    groups: int,
) -> jax.Array:
    """Pure-jnp head-tier build (shard_map-safe: no host numpy, no
    collectives) — same masked-mean semantics as :func:`build_head_tier`."""
    lg_n, caprows, lanes = cbt.shape
    l = si.shape[0]
    g = groups
    hr = -(-caprows // hp)
    pad = hr * hp - caprows
    t = jnp.pad(cbt, ((0, 0), (0, pad), (0, 0))) if pad else cbt
    sums = jnp.sum(
        t.reshape(lg_n, hr, hp, lanes).astype(jnp.float32), axis=2
    )                                                  # [Lg, hr, lanes]
    valid = (si >= 0).astype(jnp.int32)
    if pad:
        valid = jnp.pad(valid, ((0, 0), (0, pad)))
    cnt = valid.reshape(l, hr, hp).sum(axis=2)         # [L, hr]
    if lg_n * g != l:
        cnt = jnp.concatenate(
            [cnt, jnp.zeros((lg_n * g - l, hr), jnp.int32)], axis=0
        )
    cnt = cnt.reshape(lg_n, g, hr).transpose(0, 2, 1)  # [Lg, hr, G]
    cnt_l = jnp.repeat(cnt, lanes // g, axis=2)
    return (sums / jnp.maximum(cnt_l, 1).astype(jnp.float32)).astype(
        jnp.bfloat16
    )


def build_head_tier(
    coarse_by_table: jax.Array,   # int8/bf16[Lg, caprows, G*cs]
    sorted_ids: jax.Array,        # i32[L, caprows]
    hp: int,
    groups: Optional[int] = None,  # G (tables per 128-lane row); default
    #                                ceil(L / Lg) — exact whenever Lg was
    #                                derived as ceil(L/G) with G | 128
) -> jax.Array:
    """Head tier for two-phase window pruning: one bf16 row per `hp`
    consecutive table-ordered coarse rows (masked mean over live rows, per
    lane segment). 1/(hp·sizeof) of the coarse tier's bytes; scored with
    fast row gathers, it ranks candidate windows per query so only the top
    `coarse_keep` pay the window gather + wide-select cost."""
    lg_n, caprows, lanes = coarse_by_table.shape
    l = sorted_ids.shape[0]
    g = groups if groups else max(1, int(np.ceil(l / lg_n)))
    # live-count per (group, pool row, segment); fully-padded segments of a
    # ragged last group have zero rows in the tier, so any divisor works
    hr = (caprows + hp - 1) // hp
    valid = (np.asarray(sorted_ids) >= 0).astype(np.int32)     # [L, caprows]
    if hr * hp != caprows:
        valid = np.pad(valid, ((0, 0), (0, hr * hp - caprows)))
    cnt = valid.reshape(l, hr, hp).sum(axis=2)                 # [L, hr]
    if lg_n * g != l:
        cnt = np.concatenate(
            [cnt, np.zeros((lg_n * g - l, hr), np.int32)], axis=0
        )
    cnt = cnt.reshape(lg_n, g, hr).transpose(0, 2, 1)          # [Lg, hr, G]
    cnt_d = jnp.asarray(cnt)
    return jnp.stack([
        _head_pool_group(coarse_by_table[lg], cnt_d[lg], hp)
        for lg in range(lg_n)
    ])                                            # [Lg, hr, lanes]


# ---------------------------------------------------------------------------
# query
# ---------------------------------------------------------------------------


def _probe_hashes_margin(
    h: jax.Array,          # u32[B, L]
    margins: jax.Array,    # f32[B, L, 32]
    layout: KeyLayout,
    budget: int,
) -> Tuple[jax.Array, jax.Array]:
    """Query-directed probing (the Multi-probe LSH refinement the reference
    lacks): flip only the `budget` trie-consumed bits with the smallest
    hyperplane margins — the bits most likely to differ for true neighbors —
    plus the self-probe. Cuts probe fan-out ~3x at equal or better recall
    than blind low-bit flips; opt-in via probe_mode='margin'."""
    eligible = margins[..., : layout.consumed_bits]            # [B, L, CB]
    neg, bit_idx = jax.lax.top_k(-eligible, min(budget, layout.consumed_bits))
    flip_valid = jnp.isfinite(-neg)                            # margin < inf
    probes = h[..., None] ^ (jnp.uint32(1) << bit_idx.astype(jnp.uint32))
    self_probe = h[..., None]
    self_valid = jnp.ones(h.shape + (1,), dtype=bool)
    return (
        jnp.concatenate([probes, self_probe], axis=-1),
        jnp.concatenate([flip_valid, self_valid], axis=-1),
    )


def _probe_hashes(
    h: jax.Array, layout: KeyLayout, multiprobe: bool
) -> Tuple[jax.Array, jax.Array]:
    """Multi-probe set generation (P5). Dense queries probe `h ^ (1<<i)` for
    every i < 32 - nlz(h) - seg_bits — and, faithfully to the reference, NOT
    h itself (`RandomDrawTreeMap.java:753-756`; h's own bucket is still
    reached whenever a flipped bit lies in the trie's skipped bits). Sparse
    queries probe only h (`:686-732`).

    Key-space optimization: flips of the trie's *skipped* bits (bits
    [consumed, bucket_bits), e.g. 25-27 in the canonical layout) all map to
    the identical composite key as h itself, so they are statically
    collapsed into one self-probe whose validity is "any skipped-bit flip
    was in range" (limit > consumed_bits — exactly equivalent to the
    reference's probe set in key space, at 26 lookups instead of 28).

    Returns (probes u32[B, L, P], valid bool[B, L, P]).
    """
    if not multiprobe:
        return h[..., None], jnp.ones(h.shape + (1,), dtype=bool)
    pmax = layout.consumed_bits
    i = jnp.arange(pmax, dtype=jnp.uint32)
    flips = h[..., None] ^ (jnp.uint32(1) << i)
    limit = 32 - clz(h) - layout.seg_bits           # [B, L]
    flip_valid = i[None, None, :].astype(jnp.int32) < limit[..., None]
    self_probe = h[..., None]
    self_valid = (limit > layout.consumed_bits)[..., None]
    probes = jnp.concatenate([flips, self_probe], axis=-1)
    valid = jnp.concatenate([flip_valid, self_valid], axis=-1)
    return probes, valid


def stepwise_pattern_count(partition_bits: int, steps: int) -> int:
    """Number of XOR patterns within Hamming distance <= steps."""
    return len(stepwise_patterns(partition_bits, steps))


def probe_key_set(
    h: jax.Array,                # u32[B, L]
    home: jax.Array,             # i32[B, L]
    layout: KeyLayout,
    steps: int,
    multiprobe: bool,
    probes: Optional[jax.Array] = None,       # u32[B, L, P] (override)
    probe_valid: Optional[jax.Array] = None,  # bool[B, L, P]
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """The full composite probe-key fan-out of a query batch: step-wise
    partition patterns (P3) x multi-probe bit flips (P5), flattened
    table-major. Returns (probe_keys u32[B, R], table_of i32[R],
    valid bool[B, R]) with R = L * S * P. Shared by `gather_blocks` and the
    tiered store's generation gate (`storage/persist.py`)."""
    b, l = h.shape
    patterns = jnp.asarray(
        stepwise_patterns(layout.partition_bits, steps), dtype=jnp.uint32
    )                                                           # [S]
    s = patterns.shape[0]
    parts = home.astype(jnp.uint32)[..., None] ^ patterns[None, None, :]  # [B,L,S]
    if probes is None:
        probes, probe_valid = _probe_hashes(h, layout, multiprobe)  # [B, L, P]
    p = probes.shape[-1]
    # composite probe keys [B, L, S, P]; seg always comes from the original
    # h (probe flips never touch seg bits: i < bucket_bits)
    probe_keys = composite_keys(
        probes[:, :, None, :], parts[..., None].astype(jnp.int32), layout
    )
    r = l * s * p
    table_of = jnp.repeat(jnp.arange(l, dtype=jnp.int32), s * p)  # [R]
    valid_r = jnp.broadcast_to(
        probe_valid[:, :, None, :], (b, l, s, p)
    ).reshape(b, r)
    return probe_keys.reshape(b, r), table_of, valid_r


def gather_blocks(
    tables: BucketTables,
    h: jax.Array,                # u32[B, L]
    home: jax.Array,             # i32[B, L]
    layout: KeyLayout,
    steps: int,
    m_cap: int,
    multiprobe: bool,
    probes: Optional[jax.Array] = None,       # u32[B, L, P] (override)
    probe_valid: Optional[jax.Array] = None,  # bool[B, L, P]
    window: int = 0,
    align: int = 8,
) -> Tuple[jax.Array, jax.Array, Optional[jax.Array], jax.Array, jax.Array, int]:
    """Probe fan-out → bucket ranges → dedup/priority → ragged flatten at
    BLOCK granularity. Returns (base i32[B, MB], table i32[B, MB],
    start i32[B, MB] or None, end i32[B, MB], total i32[B], bs): block mb
    covers sorted-order positions [base[mb] + mb*bs, base[mb] + (mb+1)*bs)
    of its table; a slot's position is valid while pos < end[mb] (and
    pos >= start[mb] in window mode). Callers expand to per-slot candidates
    (`gather_candidates`) or consume blocks directly (the table-ordered
    coarse rerank, which gathers CONTIGUOUS coarse rows per block).

    window > 0 switches to ALIGNED-WINDOW mode: each range's allocation
    starts at its `align`-aligned head (start & ~(align-1), default 8) and
    rounds up to `window` slots, so every block's position range is aligned
    and `window` long — one contiguous slice per block (the groupmax path
    passes align=64+ so folded physical-row starts stay 8-row aligned and
    group boundaries land on the member grid). Rows before the range's true
    `start` are masked via the extra start channel. Slot budget inflation
    ≈ (head + round-up) per range; size m_cap accordingly (e.g. 2x the
    block-mode cap)."""
    b, l = h.shape
    probe_keys, table_of, probe_valid = probe_key_set(
        h, home, layout, steps, multiprobe, probes, probe_valid
    )
    r = probe_keys.shape[1]
    s = stepwise_pattern_count(layout.partition_bits, steps)
    p = r // (l * s)

    start, length = lookup_ranges(tables, probe_keys, table_of)
    length = jnp.where(probe_valid, length, 0)

    # --- range dedup + priority: many probes resolve to the SAME bucket
    # (shallow buckets ignore most flipped bits), so dedupe (table, start)
    # ranges per query. Surviving ranges are then ordered by step distance
    # (home partition first) so that when the M_cap truncates, the FARTHEST
    # partitions' buckets are dropped first — more steps can then never
    # reduce recall (the reference has no cap; this makes the cap bind
    # gracefully).
    cap = tables.capacity
    table_b = jnp.broadcast_to(table_of[None, :], (b, r))
    # priority = step distance (home partition first), then probe quality
    # within a step: the self-probe (the query's own bucket) outranks every
    # flip, and flips rank by flip order — ascending bit index for reference
    # probes (low-bit flips share the longest trie prefix), margin order for
    # margin probes (both generators emit [flips..., self]). When m_cap
    # truncates, the LOWEST-VALUE buckets are dropped first.
    patterns = jnp.asarray(
        stepwise_patterns(layout.partition_bits, steps), dtype=jnp.uint32
    )
    dist = jax.lax.population_count(patterns).astype(jnp.int32)       # [S]
    probe_rank = jnp.concatenate(
        [jnp.arange(1, p, dtype=jnp.int32), jnp.zeros((1,), jnp.int32)]
    ) if p > 1 else jnp.zeros((p,), jnp.int32)
    prio_sp = (dist[:, None] * jnp.int32(p) + probe_rank[None, :]).reshape(-1)
    prio_r = jnp.broadcast_to(jnp.tile(prio_sp, l)[None, :], (b, r))
    # Packing (bucket id → one int32 key; (start, table) → one int32 value)
    # halves the sort operand count but silently overflows once
    # l*(cap+1) or cap*64+l exceed int32 — exactly the ≥2^25-rows/table
    # regime of the Deep-100M target. Guard it and fall back to
    # multi-operand sorts (same semantics, one extra operand per sort).
    can_pack_ranges = (
        l * (cap + 1) < 2**31 and cap * 64 + l < 2**31 and l <= 64
    ) and not _FORCE_UNPACKED_RANGES
    if can_pack_ranges:
        rkey = table_b * jnp.int32(cap + 1) + start             # unique per bucket
        rkey = jnp.where(length > 0, rkey, jnp.int32(2**31 - 1))  # empties last
        st_packed = start * 64 + table_b
        rkey, prio_s, st_s, length_s = jax.lax.sort(
            (rkey, prio_r, st_packed, length), dimension=1, num_keys=2
        )
        dup = jnp.concatenate(
            [jnp.zeros((b, 1), dtype=bool), rkey[:, 1:] == rkey[:, :-1]], axis=1
        )
        length_s = jnp.where(dup, 0, length_s)
        # reorder by priority (dead/dup ranges last)
        prio_s = jnp.where(length_s > 0, prio_s, jnp.int32(2**30))
        _, st_s, length_s = jax.lax.sort(
            (prio_s, st_s, length_s), dimension=1, num_keys=1
        )
        start_s = st_s // 64
        table_s = st_s % 64
    else:
        big = jnp.int32(2**31 - 1)
        tkey = jnp.where(length > 0, table_b, big)
        skey = jnp.where(length > 0, start, big)
        tkey, skey, prio_s, start_u, table_u, length_s = jax.lax.sort(
            (tkey, skey, prio_r, start, table_b, length),
            dimension=1, num_keys=3,
        )
        dup = jnp.concatenate(
            [
                jnp.zeros((b, 1), dtype=bool),
                (tkey[:, 1:] == tkey[:, :-1]) & (skey[:, 1:] == skey[:, :-1]),
            ],
            axis=1,
        )
        length_s = jnp.where(dup, 0, length_s)
        prio_s = jnp.where(length_s > 0, prio_s, jnp.int32(2**30))
        _, start_s, table_s, length_s = jax.lax.sort(
            (prio_s, start_u, table_u, length_s), dimension=1, num_keys=1
        )

    # NOTE a touching-range merge (coalescing buckets consecutive in the
    # table layout) does not belong here: merged chains inherit their best
    # member's priority, so low-value tail buckets jump the m_cap
    # truncation queue and displace mid-priority good buckets, which costs
    # recall at identical configs.

    # --- ragged flatten (SURVEY.md §7 hard part (b)) into fixed M_cap slots.
    # Per-slot values (source position, source table) are piecewise constant
    # over slot ranges, so they are built GATHER- AND SCATTER-FREE by a
    # merge: sort range-delta markers
    # together with the slot indices, prefix-sum the deltas so every slot
    # accumulates exactly the deltas of ranges starting at or before it,
    # then compact the slot entries back out with a second (stable) sort.
    #   pos[m]  = block_base[r(m)] + m  where block_base[r] = start[r] - cum[r-1]
    #   tab[m]  = table[r(m)]
    #
    # Sort cost scales with width, so for large caps the merge runs at BLOCK
    # granularity: each range's slot allocation is rounded up to BS slots and
    # the merged sort covers R + M/BS block entries instead of R + M slots
    # (~5x cheaper at the 1.2M bench shapes). Rows past a range's true end
    # land inside its padding blocks and are masked by a per-block `end`
    # channel. BS=1 degenerates to the exact slot-level merge.
    if window:
        bs_block = window
        assert m_cap % window == 0, (m_cap, window)
    else:
        bs_block = 8 if (m_cap % 8 == 0 and m_cap >= 4096) else 1
    mb_cap = m_cap // bs_block
    total = jnp.cumsum(length_s, axis=1)[:, -1]
    if window:
        # aligned-window allocation: the range occupies
        # [start & ~(align-1), end), rounded up to whole windows; empty
        # ranges allocate nothing
        assert window % align == 0, (window, align)
        head = start_s & (align - 1)
        astart = start_s - head
        alen = jnp.where(
            length_s > 0,
            (head + length_s + (window - 1)) // window * window,
            0,
        )
        alloc_start = astart
    else:
        head = None
        alen = (
            (length_s + (bs_block - 1)) // bs_block * bs_block
            if bs_block > 1
            else length_s
        )
        alloc_start = start_s
    cum = jnp.cumsum(alen, axis=1)                              # [B, R]
    first_block = jnp.minimum((cum - alen) // bs_block, mb_cap)  # [B, R]
    block_base = alloc_start - (cum - alen)                     # [B, R]
    end_r = start_s + length_s                                  # [B, R]
    # deltas vs previous range (range order == block order since cum is
    # nondecreasing). Zero-length ranges share their successor's first block,
    # so their deltas telescope away as long as every delta participates.
    pb_delta = jnp.diff(block_base, axis=1, prepend=0)
    tb_delta = jnp.diff(table_s, axis=1, prepend=0)
    en_delta = jnp.diff(end_r, axis=1, prepend=0)
    st_delta = jnp.diff(start_s, axis=1, prepend=0) if window else None

    mb = jnp.arange(mb_cap, dtype=jnp.int32)
    # merged keys: range markers sort BEFORE the block with the same index
    # (bit 0 distinguishes block entries — no separate is_block operand).
    # The (base, table) channels pack into one int32:
    # (delta + offset) * 64 + (table_delta + 32); floor div/mod recover
    # signed deltas. Valid while cap + m_cap < 2^23 and L <= 32.
    range_keys = first_block * 2                                 # [B, R]
    block_keys = jnp.broadcast_to(mb * 2 + 1, (b, mb_cap))
    keys = jnp.concatenate([range_keys, block_keys], axis=1)     # [B, R+MB]
    zeros_mb = jnp.zeros((b, mb_cap), jnp.int32)
    can_pack = (cap + m_cap + 1) < (1 << 23) and l <= 32
    dstart = (
        jnp.concatenate([st_delta, zeros_mb], axis=1) if window else None
    )
    if can_pack:
        off = jnp.int32(cap + m_cap + 1)
        packed_rng = (pb_delta + off) * 64 + (tb_delta + 32)
        packed_blk = jnp.broadcast_to(off * 64 + 32, (b, mb_cap))  # zero deltas
        packed = jnp.concatenate([packed_rng, packed_blk], axis=1)
        dend = jnp.concatenate([en_delta, zeros_mb], axis=1)
        if window:
            keys_s, packed_s, dend_s, dstart_s = jax.lax.sort(
                (keys, packed, dend, dstart), dimension=1, num_keys=1
            )
        else:
            keys_s, packed_s, dend_s = jax.lax.sort(
                (keys, packed, dend), dimension=1, num_keys=1
            )
            dstart_s = None
        dpos_s = packed_s // 64 - off
        dtab_s = packed_s % 64 - 32
    else:
        dpos = jnp.concatenate([pb_delta, zeros_mb], axis=1)
        dtab = jnp.concatenate([tb_delta, zeros_mb], axis=1)
        dend = jnp.concatenate([en_delta, zeros_mb], axis=1)
        if window:
            keys_s, dpos_s, dtab_s, dend_s, dstart_s = jax.lax.sort(
                (keys, dpos, dtab, dend, dstart), dimension=1, num_keys=1
            )
        else:
            keys_s, dpos_s, dtab_s, dend_s = jax.lax.sort(
                (keys, dpos, dtab, dend), dimension=1, num_keys=1
            )
            dstart_s = None
    pos_fill = jnp.cumsum(dpos_s, axis=1)
    tab_fill = jnp.cumsum(dtab_s, axis=1)
    end_fill = jnp.cumsum(dend_s, axis=1)
    start_fill = jnp.cumsum(dstart_s, axis=1) if window else None
    # compact blocks back out (stable: blocks stay in mb order)
    if can_pack:
        packed2 = (pos_fill + jnp.int32(m_cap)) * 64 + tab_fill
        if window:
            _, packed2_s, end_out, start_out = jax.lax.sort(
                (1 - (keys_s & 1), packed2, end_fill, start_fill),
                dimension=1, num_keys=1, is_stable=True,
            )
        else:
            _, packed2_s, end_out = jax.lax.sort(
                (1 - (keys_s & 1), packed2, end_fill), dimension=1,
                num_keys=1, is_stable=True,
            )
            start_out = None
        base_b = packed2_s[:, :mb_cap] // 64 - jnp.int32(m_cap)   # [B, MB]
        table_b2 = packed2_s[:, :mb_cap] % 64
    else:
        if window:
            _, pos_out, tab_out, end_out, start_out = jax.lax.sort(
                (1 - (keys_s & 1), pos_fill, tab_fill, end_fill, start_fill),
                dimension=1, num_keys=1, is_stable=True,
            )
        else:
            _, pos_out, tab_out, end_out = jax.lax.sort(
                (1 - (keys_s & 1), pos_fill, tab_fill, end_fill), dimension=1,
                num_keys=1, is_stable=True,
            )
            start_out = None
        base_b = pos_out[:, :mb_cap]
        table_b2 = tab_out[:, :mb_cap]
    end_b = end_out[:, :mb_cap]
    start_b = start_out[:, :mb_cap] if window else None
    return (base_b, table_b2, start_b, end_b,
            jnp.minimum(total, m_cap), bs_block)


def _gather_id_blocks(
    sorted_ids: jax.Array,   # i32[L, cap]
    base_b: jax.Array,       # i32[B, MB]
    table_b2: jax.Array,     # i32[B, MB]
    bs_block: int,
) -> jax.Array:
    """Candidate row ids for every block via a FLAT ELEMENT gather (one
    index per candidate slot). Returns i32[B, MB*bs]."""
    l, cap = sorted_ids.shape
    b, mb_cap = base_b.shape
    mb = jnp.arange(mb_cap, dtype=jnp.int32)
    blk_start = base_b + mb[None, :] * bs_block              # [B, MB]
    j = jnp.arange(bs_block, dtype=jnp.int32)
    pos = (
        jnp.clip(blk_start, 0, cap - bs_block)[:, :, None] + j[None, None, :]
    )                                                         # [B, MB, bs]
    t = jnp.clip(table_b2, 0, l - 1)
    if l * cap < 2**31:
        idx = (t[:, :, None] * cap + pos).reshape(b, mb_cap * bs_block)
        out = jnp.take(sorted_ids.reshape(-1), idx, mode="clip")
    else:
        # flat int32 index would overflow (needs ≥71M rows/table at L=30 —
        # beyond one card's memory, but keep the semantics correct): per-dim
        # element gather from the 2D operand
        out = sorted_ids[t[:, :, None], pos].reshape(b, mb_cap * bs_block)
    # clip shifted positions for blocks near the end; the caller masks by
    # true position (pos >= end slots are invalid anyway, and base+mb*bs is
    # only clipped when the block is entirely padding)
    return out


def gather_candidates(
    tables: BucketTables,
    h: jax.Array,                # u32[B, L]
    home: jax.Array,             # i32[B, L]
    layout: KeyLayout,
    steps: int,
    m_cap: int,
    multiprobe: bool,
    probes: Optional[jax.Array] = None,       # u32[B, L, P] (override)
    probe_valid: Optional[jax.Array] = None,  # bool[B, L, P]
) -> Tuple[jax.Array, jax.Array]:
    """Probe fan-out → bucket ranges → ragged flatten into a fixed candidate
    buffer. Returns (cand i32[B, m_cap] row positions with -1 invalid,
    total i32[B] pre-cap candidate count). Shared by the dense, sparse and
    sharded query paths. Pass explicit (probes, probe_valid) to override the
    reference probe generator (e.g. margin-guided probing)."""
    b, l = h.shape
    cap = tables.capacity
    base_b, table_b2, _, end_b, total, bs_block = gather_blocks(
        tables, h, home, layout, steps, m_cap, multiprobe,
        probes=probes, probe_valid=probe_valid,
    )
    mb_cap = m_cap // bs_block
    mb = jnp.arange(mb_cap, dtype=jnp.int32)
    if bs_block > 1:
        j = jnp.arange(bs_block, dtype=jnp.int32)
        pos = (
            base_b[:, :, None] + (mb * bs_block)[None, :, None] + j[None, None, :]
        ).reshape(b, m_cap)
        slot_end = jnp.repeat(end_b, bs_block, axis=1)
        cand = _gather_id_blocks(tables.sorted_ids, base_b, table_b2, bs_block)
        # a clipped block start shifts its slice; recompute validity against
        # the unclipped positions and re-read nothing: clipped blocks are
        # fully masked (their pos >= end)
    else:
        pos = base_b + mb[None, :]
        slot_end = end_b
        cand = _gather_id_blocks(tables.sorted_ids, base_b, table_b2, 1)
    slot_valid = pos < slot_end                 # masks block padding AND
    cand = jnp.where(slot_valid & (cand >= 0), cand, -1)  # slots past the data
    return cand, total


def _coarse_query(x: jax.Array, coarse_proj: jax.Array) -> jax.Array:
    """x @ coarse_proj at HIGHEST precision: a default-precision f32
    matmul may round its operands (TF32 on the GPU), so the coarse order
    would differ between backends; the projection is [B, D] x [D, cs]."""
    return jnp.matmul(x, coarse_proj, precision=jax.lax.Precision.HIGHEST)


def _coarse_block_scores(
    coarse_by_table: jax.Array,  # int8/bf16[Lg, caprows, G*cs] (lane-packed)
    coarse_proj: jax.Array,      # f32[D, cs]
    queries: jax.Array,          # f32[B, D]
    base_b: jax.Array,           # i32[B, MB]
    table_b2: jax.Array,         # i32[B, MB]
    end_b: jax.Array,            # i32[B, MB]
    bs_block: int,
    start_b: Optional[jax.Array] = None,   # i32[B, MB] (window mode)
    abs_starts: bool = False,  # base_b already holds ABSOLUTE window starts
    #                            (post-pruning subset; skip the +mb*bs)
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Coarse inner-product scores for every candidate slot, gathered as
    CONTIGUOUS (1, bs, lanes) slices from the table-ordered coarse tier —
    one gather index per BLOCK instead of per candidate. Returns
    (scores f32[B, M] with -inf invalid, pos i32[B, M], table i32[B, M]).

    The tier is LANE-PACKED (`_build_coarse_tier`): table t's rows occupy
    lane segment t % G of group t // G. Scoring places the query's coarse
    vector into the block's segment (zero elsewhere), so the full-row dot
    equals the table's cs-dim dot exactly.

    In window mode (start_b given) rows before a range's true start are
    masked."""
    lg_n, caprows, lanes = coarse_by_table.shape
    # G recovered from the projection's segment width (ceil(L/Lg) is wrong
    # when L % G != 0); legacy round-1 states have cs == lanes → G = 1
    cs = coarse_proj.shape[1]
    g = lanes // cs
    b, mb_cap = base_b.shape
    mb = jnp.arange(mb_cap, dtype=jnp.int32)
    blk_start = base_b if abs_starts else base_b + mb[None, :] * bs_block
    if start_b is not None:
        # clamp BEFORE positions are derived (window mode only; block mode
        # keeps exact per-slot starts): a live window within `win` of the
        # table's end would otherwise be CLIPPED inside the gather
        # while `pos` kept the unclipped start — scores off by the shift
        # for its live rows. The clamped window still covers its range:
        # clipping only engages when start > caprows - win, and
        # end <= caprows - ID_PAD, so [start, end) ⊂ [caprows-win, caprows).
        blk_start = jnp.minimum(blk_start, caprows - bs_block)
    q_low = _coarse_query(queries, coarse_proj).astype(jnp.bfloat16)
    if g > 1:
        lg_b = table_b2 // g
        seg_b = table_b2 % g
        # q placed per segment: [B, G, G*cs]; row (b, s) holds q_low at
        # lanes [s*cs, (s+1)*cs)
        q_seg = jnp.stack(
            [
                jnp.pad(q_low, ((0, 0), (s * cs, (g - 1 - s) * cs)))
                for s in range(g)
            ],
            axis=1,
        )
    else:
        lg_b, seg_b, q_seg = table_b2, None, None
    idx = jnp.stack(
        [
            jnp.clip(lg_b, 0, lg_n - 1),
            jnp.clip(blk_start, 0, caprows - bs_block),
        ],
        axis=-1,
    )
    dn = jax.lax.GatherDimensionNumbers(
        offset_dims=(2, 3), collapsed_slice_dims=(0,),
        start_index_map=(0, 1)
    )
    rows = jax.lax.gather(
        coarse_by_table, idx, dn, slice_sizes=(1, bs_block, lanes),
        mode=jax.lax.GatherScatterMode.CLIP,
    )                                                     # [B, MB, bs, lanes]
    if g > 1:
        # contract against ALL G segment placements at once — the rhs
        # [B, G, lanes] is shared across blocks, so XLA lowers ONE matmul
        # per query instead of a tiny matvec per (query, block) — then
        # pick each block's segment from the [.., G] output with a
        # one-hot sum.
        scores_g = jnp.einsum(
            "bmjc,bsc->bmjs", rows.astype(jnp.bfloat16), q_seg,
            preferred_element_type=jnp.float32,
        )                                                 # [B, MB, bs, G]
        onehot = jax.nn.one_hot(seg_b, g, dtype=scores_g.dtype)
        scores = (scores_g * onehot[:, :, None, :]).sum(axis=-1)
    else:
        scores = jnp.einsum(
            "bmjc,bc->bmj", rows.astype(jnp.bfloat16), q_low,
            preferred_element_type=jnp.float32,
        )                                                      # [B, MB, bs]
    j = jnp.arange(bs_block, dtype=jnp.int32)
    pos = blk_start[:, :, None] + j[None, None, :]             # [B, MB, bs]
    valid = pos < end_b[:, :, None]
    if start_b is not None:
        valid &= pos >= start_b[:, :, None]
    m = mb_cap * bs_block
    scores = jnp.where(valid, scores, NEG_INF_F32).reshape(b, m)
    pos = pos.reshape(b, m)
    table_slot = jnp.repeat(table_b2, bs_block, axis=1)
    return scores, pos, table_slot


NEG_INF_F32 = float("-inf")


def _prune_windows(
    coarse_head: jax.Array,      # bf16[Lg, hr, lanes]
    head_pool: int,              # hp (pool rows per head row)
    q_low: jax.Array,            # bf16[B, cs]
    q_seg: Optional[jax.Array],  # bf16[B, G, lanes] (None when G == 1)
    base_b: jax.Array,           # i32[B, MB]
    table_b2: jax.Array,         # i32[B, MB]
    start_b: jax.Array,          # i32[B, MB]
    end_b: jax.Array,            # i32[B, MB]
    win: int,
    keep: int,
    groups: int,
) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Phase 1 of the two-phase coarse gather: score each candidate window
    by its pooled-head proxy (max over the masked mean rows it covers) via
    row gathers, and keep only the top `keep` windows per query. Returns
    the pruned (blk_start, table, start, end), each i32[B, keep], with blk_start
    ABSOLUTE (feed `_coarse_block_scores(..., abs_starts=True)`).

    The head score is a proxy (mean of hp hash-sorted rows), not a bound:
    windows whose best member hides in a poor pool group can be dropped, so
    `keep` trades recall for gathered windows (COVERAGE divergence
    #12)."""
    lg_n, hr, lanes = coarse_head.shape
    b, mb_cap = base_b.shape
    hp = head_pool
    mb = jnp.arange(mb_cap, dtype=jnp.int32)
    blk_start = base_b + mb[None, :] * win                    # [B, MB]
    live = (blk_start < end_b) & (blk_start + win > start_b)
    g = groups
    lg_b = table_b2 // g if g > 1 else table_b2
    # head rows overlapping [blk_start, blk_start+win): starts are 8-aligned
    # (not hp-aligned), so one extra row covers the straddle
    r_head = win // hp + 1
    g0 = blk_start // hp                                      # [B, MB]
    j = jnp.arange(r_head, dtype=jnp.int32)
    gidx = g0[:, :, None] + j[None, None, :]                  # [B, MB, R]
    flat = (
        jnp.clip(lg_b, 0, lg_n - 1)[:, :, None] * hr
        + jnp.clip(gidx, 0, hr - 1)
    )
    rows = jnp.take(
        coarse_head.reshape(lg_n * hr, lanes), flat, axis=0
    )                                                         # [B, MB, R, lanes]
    if g > 1:
        # shared-rhs contraction against ALL G segment placements, then
        # one-hot segment select (the per-block-rhs einsum lowers to tiny
        # batched matvecs — 12.8x slower end-to-end; see _coarse_block_scores)
        sc_g = jnp.einsum(
            "bmrc,bsc->bmrs", rows, q_seg,
            preferred_element_type=jnp.float32,
        )                                                     # [B, MB, R, G]
        seg_b = table_b2 % g
        onehot = jax.nn.one_hot(seg_b, g, dtype=sc_g.dtype)
        sc = (sc_g * onehot[:, :, None, :]).sum(axis=-1)      # [B, MB, R]
    else:
        sc = jnp.einsum(
            "bmrc,bc->bmr", rows, q_low,
            preferred_element_type=jnp.float32,
        )
    # head row g0+j covers tier rows [(g0+j)*hp, (g0+j+1)*hp); mask rows
    # wholly outside the window's live range
    row_lo = gidx * hp
    lo = jnp.maximum(blk_start, start_b)[:, :, None]
    hi = jnp.minimum(blk_start + win, end_b)[:, :, None]
    hvalid = (row_lo + hp > lo) & (row_lo < hi)
    wscore = jnp.max(
        jnp.where(hvalid, sc, NEG_INF_F32), axis=2
    )                                                         # [B, MB]
    wscore = jnp.where(live, wscore, NEG_INF_F32)
    # exact top-keep by window score: a 2-operand descending sort (top_k is
    # O(n*k) — at keep ~ MB/4 the sort wins; MB is narrow, sorts are cheap)
    _, wi = jax.lax.sort(
        (-wscore, jnp.broadcast_to(mb[None, :], (b, mb_cap))),
        dimension=1, num_keys=1,
    )
    # restore SLOT order among survivors: the window flatten lays ranges out
    # as adjacent slots = adjacent source rows
    wi = jnp.sort(wi[:, :keep], axis=1)
    return (
        jnp.take_along_axis(blk_start, wi, axis=1),
        jnp.take_along_axis(table_b2, wi, axis=1),
        jnp.take_along_axis(start_b, wi, axis=1),
        jnp.take_along_axis(end_b, wi, axis=1),
    )


def _strided_tournament(
    scores: jax.Array,      # f32[B, m_slab]
    pos: jax.Array,         # i32[B, m_slab]
    table_slot: jax.Array,  # i32[B, m_slab]
    win: int,
    m_slab: int,
    m2: int,
    m_cap: int,
    l: int,
    cap: int,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Window-mode prefilter: STRIDED 4-WAY MAX TOURNAMENT. Each window's
    slots regroup into win/4 groups of 4 members spaced win/4 apart
    ([B, MB, 4, win/4], reduce axis 2 — max + one-hot payload select,
    all O(n) elementwise/reduce passes), so the wide select below runs
    over a 4x narrower slab. The STRIDE matters: a bucket's rows are
    CONSECUTIVE slots and a query's true neighbors cluster in its home
    bucket, so consecutive grouping makes them eliminate each other; strided
    members are bucket rows ~win/4 apart, so the bucket's coarse-top-j
    row survives with p ≈ (1 - 3(j-1)/win) — ~0.95 for j=10 at win
    512 — per APPEARANCE, and close neighbors appear in most of the L
    tables' probed buckets with ~independent groupings. Replaces a
    per-window lax.top_k(r≈win/16) (O(n*r)). Skipped (identity) when m2
    is within 2x of m_slab/4 (incl.
    the exhaustive refine >= m_cap parity case — bit-equal there)."""
    if not (win and win % 4 == 0 and m2 * 8 <= m_slab):
        return scores, pos, table_slot
    b = scores.shape[0]
    gs = 4
    mb_n = m_slab // win
    wq = win // gs
    ng = mb_n * wq
    s4 = scores.reshape(b, mb_n, gs, wq)
    am = jnp.argmax(s4, axis=2)                        # [B, MB, WQ]
    onehot = (
        jax.lax.broadcasted_iota(jnp.int32, (b, mb_n, gs, wq), 2)
        == am[:, :, None, :]
    )
    scores = jnp.max(s4, axis=2).reshape(b, ng)
    # pos on dead tail windows can exceed cap by up to m_cap before
    # the downstream clip — include that margin in the overflow guard
    if l * (cap + 1) + m_cap < 2**31:
        packed = table_slot * jnp.int32(cap + 1) + pos
        packed = jnp.sum(
            jnp.where(onehot, packed.reshape(b, mb_n, gs, wq), 0),
            axis=2,
        ).reshape(b, ng)
        pos = packed % jnp.int32(cap + 1)
        table_slot = packed // jnp.int32(cap + 1)
    else:
        pos = jnp.sum(
            jnp.where(onehot, pos.reshape(b, mb_n, gs, wq), 0), axis=2
        ).reshape(b, ng)
        table_slot = jnp.sum(
            jnp.where(onehot, table_slot.reshape(b, mb_n, gs, wq), 0),
            axis=2,
        ).reshape(b, ng)
    return scores, pos, table_slot


def _select_m2(
    scores: jax.Array,      # f32[B, W]
    pos: jax.Array,         # i32[B, W]
    table_slot: jax.Array,  # i32[B, W]
    m2: int,
    l: int,
    cap: int,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Top-m2 by coarse score → (t2, p2, sel_valid). For narrow slices
    `approx_max_k` replaces the full-width sort (the refine slice is itself
    a coarse pre-selection); on the GPU and the CPU it lowers to an exact
    top-k.
    FOREST_SELECT_APPROX_FACTOR: approx_max_k is used when
    m2 * FACTOR <= W, the packed 2-operand sort otherwise."""
    use_approx = m2 * _SELECT_APPROX_FACTOR <= scores.shape[1]
    can_pack = l * (cap + 1) < 2**31 and not _FORCE_UNPACKED_RANGES
    if use_approx:
        vals, idxs = jax.lax.approx_max_k(scores, m2, recall_target=0.98)
        t2 = jnp.take_along_axis(table_slot, idxs, axis=1)
        p2 = jnp.take_along_axis(pos, idxs, axis=1)
        sel_valid = jnp.isfinite(vals)
    elif can_pack:
        payload = table_slot * jnp.int32(cap + 1) + pos
        neg_s, payload_s = jax.lax.sort((-scores, payload), dimension=1,
                                        num_keys=1)
        t2 = payload_s[:, :m2] // jnp.int32(cap + 1)
        p2 = payload_s[:, :m2] % jnp.int32(cap + 1)
        sel_valid = jnp.isfinite(-neg_s[:, :m2])
    else:
        neg_s, t_s, p_s = jax.lax.sort((-scores, table_slot, pos),
                                       dimension=1, num_keys=1)
        t2, p2 = t_s[:, :m2], p_s[:, :m2]
        sel_valid = jnp.isfinite(-neg_s[:, :m2])
    return t2, p2, sel_valid


def coarse_window_slots(m_cap: int, window: int) -> int:
    """Window size (slots) of the lane coarse tier's aligned-window flatten;
    0 = block mode. Each nonempty bucket range rounds its slot allocation
    up to a whole window, so windows only pay off when m_cap dwarfs the
    probe-range count (at small m_cap the round-up truncates candidates).
    window: -1 = auto threshold (64-slot windows at m_cap >= 32768, a rule
    set on another accelerator that waits for a measurement on this one),
    0 = block mode, >0 = explicit window size (slots; multiple of 8)."""
    if window < 0:
        return 64 if m_cap % 64 == 0 and m_cap >= 32768 else 0
    return window if (window and m_cap % window == 0) else 0


def _query_dense_coarse(
    state: ForestState,
    queries: jax.Array,
    query_ids: jax.Array,
    layout: KeyLayout,
    steps: int,
    m_cap: int,
    k: int,
    multiprobe: bool,
    exclude_self: bool,
    refine: int,
    probes: Optional[jax.Array] = None,
    probe_valid: Optional[jax.Array] = None,
    h: Optional[jax.Array] = None,
    window: int = -1,
    window_keep: int = 0,
    head_pool: int = 0,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Query via the table-ordered coarse tier: block-contiguous coarse
    scoring of ALL candidates, then exact full-precision re-scoring of the
    top `refine` slice only. With refine >= m_cap this is exhaustive and
    matches `_query_dense` bit-for-bit on the surviving candidate set.

    window_keep > 0 (with a head tier, `conf.coarse_head_pool`) enables
    TWO-PHASE window pruning: pooled-head proxy scores rank the windows
    and only the top `window_keep` pay the window gather + wide select
    (`_prune_windows`). window_keep >= m_cap//win degenerates to a reorder
    (same candidate set)."""
    if h is None:
        h = hash_dense(state.model, queries)
    home = partition_of_hash(h, state.part_proj)
    win = coarse_window_slots(m_cap, window)
    base_b, table_b2, start_b, end_b, total, bs_block = gather_blocks(
        state.tables, h, home, layout, steps, m_cap, multiprobe,
        probes=probes, probe_valid=probe_valid, window=win,
    )
    m_slab = m_cap
    abs_starts = False
    prune = (
        window_keep > 0 and win > 0 and state.coarse_head is not None
        and head_pool > 0 and win % head_pool == 0
        and window_keep < m_cap // win
    )
    if prune:
        lanes = state.coarse_by_table.shape[2]
        cs = state.coarse_proj.shape[1]
        g = lanes // cs
        q_low = _coarse_query(queries, state.coarse_proj).astype(
            jnp.bfloat16)
        q_seg = (
            jnp.stack(
                [
                    jnp.pad(q_low, ((0, 0), (s * cs, (g - 1 - s) * cs)))
                    for s in range(g)
                ],
                axis=1,
            )
            if g > 1 else None
        )
        base_b, table_b2, start_b, end_b = _prune_windows(
            state.coarse_head, head_pool, q_low, q_seg,
            base_b, table_b2, start_b, end_b, win, window_keep, g,
        )
        m_slab = window_keep * win
        abs_starts = True
    scores, pos, table_slot = _coarse_block_scores(
        state.coarse_by_table, state.coarse_proj, queries,
        base_b, table_b2, end_b, bs_block, start_b=start_b,
        abs_starts=abs_starts,
    )
    b = queries.shape[0]
    l = state.tables.num_tables
    cap = state.tables.capacity
    m2 = min(max(refine, (k + 1) * l), m_slab)

    scores, pos, table_slot = _strided_tournament(
        scores, pos, table_slot, win, m_slab, m2, m_cap, l, cap
    )
    t2, p2, sel_valid = _select_m2(scores, pos, table_slot, m2, l, cap)

    cand2 = state.tables.sorted_ids[
        jnp.clip(t2, 0, l - 1), jnp.clip(p2, 0, cap - 1)
    ]
    cand2 = jnp.where(sel_valid & (cand2 >= 0), cand2, -1)
    if exclude_self:
        cand2 = _exclude_self(cand2, state.row_ids, query_ids)
    if state.corpus_lp is not None:
        # two-stage exact tail (rerank_dtype="bfloat16"): bf16 prescore of
        # the refine slab (half gather bytes, one bf16 pass vs HIGHEST's
        # multi-pass f32), f32 HIGHEST re-score of the top slice — ranking
        # exact while the true top-k sits in the bf16 top-256
        ids_k, sc_k = rerank_ops.rerank_dense_two_stage(
            state.corpus_lp, state.corpus, cand2, queries, k,
            dup_bound=l, refine=256,
        )
        ids = jnp.where(ids_k >= 0, state.row_ids[jnp.maximum(ids_k, 0)], -1)
        return ids, sc_k, total
    exact = rerank_ops.score_candidates(state.corpus, cand2, queries)
    ids_k, sc_k = rerank_ops.dedup_topk(cand2, exact, k)
    ids = jnp.where(ids_k >= 0, state.row_ids[jnp.maximum(ids_k, 0)], -1)
    return ids, sc_k, total


def rowmax_packed(
    folded: jax.Array,       # i8[L, capf, lanes] slot-folded coarse tier
    qmat: jax.Array,         # i8[B, fold, lanes] block-diagonal query rows
    table_b2: jax.Array,     # i32[B, MB]
    row_start: jax.Array,    # i32[B, MB] physical row start; -1 = dead
    wpr: int,                # physical rows per window (win // fold)
    rpg: int,                # rows per member group (gsl // fold)
    mshift: int,             # member bits (log2 gsl)
    emit2: bool = False,     # also return per-row SECOND-best packed value
):
    """Per-row packed maxima i32[B, MB * wpr] for every candidate window of
    the folded tier. Row j of window m covers slots [start + j*fold, +fold);
    its output is max over those slots of `(score << mshift) | member`
    (member = slot index within the row's gsl-slot group), with integer
    int8 x int8 scores. Starts clip to the table end; dead windows
    (row_start < 0) emit I32_DEAD. emit2 adds each row's second-best
    packed value (the max over its other fold segments)."""
    l_n, capf, lanes = folded.shape
    b, mb_cap = table_b2.shape
    fold = qmat.shape[1]
    rs = jnp.clip(row_start, 0, capf - wpr)
    idx = jnp.stack(
        [jnp.clip(table_b2, 0, l_n - 1), rs], axis=-1
    ).astype(jnp.int32)
    dn = jax.lax.GatherDimensionNumbers(
        offset_dims=(2, 3), collapsed_slice_dims=(0,), start_index_map=(0, 1)
    )
    rows = jax.lax.gather(
        folded, idx, dn, slice_sizes=(1, wpr, lanes),
        mode=jax.lax.GatherScatterMode.CLIP,
    )                                                  # [B, MB, wpr, lanes]
    scores = jnp.einsum(
        "bmrl,bfl->bmrf", rows, qmat, preferred_element_type=jnp.int32
    )                                                  # [B, MB, wpr, fold]
    r_i = jnp.arange(wpr, dtype=jnp.int32) % rpg
    s_i = jnp.arange(fold, dtype=jnp.int32)
    member = (r_i[:, None] * fold) | s_i[None, :]      # [wpr, fold]
    pk = (scores << mshift) | member[None, None]
    rowpk = jnp.max(pk, axis=3)                        # [B, MB, wpr]
    live = (row_start >= 0)[:, :, None]
    dead = jnp.int32(I32_DEAD)
    rowpk = jnp.where(live, rowpk, dead)
    if not emit2:
        return rowpk.reshape(b, mb_cap * wpr)
    # packed values are unique per segment (member bits differ), so
    # equality identifies exactly the argmax segment
    pk2 = jnp.where(pk == rowpk[..., None], dead, pk)
    rowpk2 = jnp.where(live, jnp.max(pk2, axis=3), dead)
    return (rowpk.reshape(b, mb_cap * wpr),
            rowpk2.reshape(b, mb_cap * wpr))


def _query_groupmax(
    state: ForestState,
    queries: jax.Array,
    query_ids: jax.Array,
    layout: KeyLayout,
    steps: int,
    m_cap: int,
    k: int,
    multiprobe: bool,
    exclude_self: bool,
    refine: int,
    probes: Optional[jax.Array] = None,
    probe_valid: Optional[jax.Array] = None,
    h: Optional[jax.Array] = None,
    window: int = -1,
    group_slots: int = 64,
    rows_keep: int = 1,
    select_mult: int = 1,
    stage2: int = 0,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Query via the SLOT-FOLDED coarse tier: aligned-window reads of folded
    rows (fold = 128/cs candidates per 128-lane line — every fetched byte a
    candidate byte) with argmax packing per row, so the select stage sees
    one int32 per `group_slots` candidates instead of one f32 per slot.
    rows_keep=0 (the default operating point): groups are only the
    SELECTION unit — every slot of a top-`refine/group_slots` group is
    exactly re-ranked, with contiguous positions (fast element gathers).
    rows_keep=1|2 re-rank only the per-group winner row(s): cheaper at the
    re-rank, but bucket-sorted layouts co-locate true neighbors inside a
    group (within-bucket order is id order in EVERY table), so argmax-only
    re-rank measurably under-recalls there (the forest analogue of the
    flat engine's argpack select, `ops/flat.select_packed_rows`, whose
    id-ordered groups don't co-locate).

    Candidate-set contract: the window flatten is the same as the lane-
    packed path (equal or superset of the reference's probed buckets,
    farthest-step partitions truncate first); the groupmax select then
    re-ranks a coarse-score-chosen SUBSET of it, like `coarse_refine`
    always has. Replaces the exhaustive candidate re-rank of
    `RandomDrawTreeMap.java:742-797`."""
    if h is None:
        h = hash_dense(state.model, queries)
    home = partition_of_hash(h, state.part_proj)
    folded = state.coarse_folded                 # i8[L, capf, lanes]
    l_n, capf, lanes = folded.shape
    cs = state.coarse_proj.shape[1]
    fold = lanes // cs
    gsl = group_slots
    rpg = gsl // fold
    assert rpg * fold == gsl and gsl & (gsl - 1) == 0, (gsl, fold)
    mshift = gsl.bit_length() - 1
    # window start alignment: 64-slot group grid AND 8-physical-row
    # starts (8 * fold slots)
    align = max(gsl, 8 * fold)
    capslots = capf * fold
    if window > 0:
        win = window
    else:
        # default: the largest pow2 window <= min(4096, m_cap/8, table
        # size) — a window must not swallow the whole candidate budget
        # (each probed range needs its own window to be covered)
        win = align
        while win * 2 <= min(4096, max(align, m_cap // 8), capslots):
            win *= 2
    assert win % align == 0 and m_cap % win == 0, (win, align, m_cap)
    assert capslots >= win, (
        "folded coarse window exceeds the table capacity — lower "
        "coarse_window", win, capslots)
    base_b, table_b2, start_b, end_b, total, _ = gather_blocks(
        state.tables, h, home, layout, steps, m_cap, multiprobe,
        probes=probes, probe_valid=probe_valid, window=win, align=align,
    )
    b = queries.shape[0]
    mb_cap = m_cap // win
    mb = jnp.arange(mb_cap, dtype=jnp.int32)
    # clamp BEFORE positions are derived: a window near the table's end
    # keeps covering its (earlier) range, and scores always match pos
    blk = jnp.clip(base_b + mb[None, :] * win, 0, capslots - win)
    live = (blk < end_b) & (blk + win > start_b)
    # per-query int8 quantization of the coarse query vector: any positive
    # per-query scale preserves that query's coarse order
    q_low = _coarse_query(queries, state.coarse_proj)          # f32[B, cs]
    qscale = jnp.float32(127.0) / jnp.maximum(
        jnp.max(jnp.abs(q_low), axis=1, keepdims=True), 1e-20
    )
    qi8 = jnp.clip(jnp.round(q_low * qscale), -127, 127).astype(jnp.int8)
    # block-diagonal placement: qmat[b, s, s*cs:(s+1)*cs] = qi8[b], so one
    # [fold, lanes] x [rows, lanes] dot yields every slot's dot (no
    # lane-splitting reshape)
    qmat = jnp.stack(
        [
            jnp.pad(qi8, ((0, 0), (s * cs, (fold - 1 - s) * cs)))
            for s in range(fold)
        ],
        axis=1,
    )                                                          # [B, fold, lanes]
    wpr = win // fold
    rs = jnp.where(live, blk // fold, -1)
    # slot-level rerank (rows_keep == 2 at rpg == 1): the row max also
    # emits each row's SECOND-best packed slot, so the refine budget buys
    # 2 slots from each of refine/2 groups instead of gsl slots from
    # refine/gsl groups — gsl/2 x the group coverage at the same exact-
    # gather cost
    emit2 = rows_keep == 2 and rpg == 1
    rowpk2 = None
    out = rowmax_packed(
        folded, qmat, table_b2, rs, wpr=wpr, rpg=rpg, mshift=mshift,
        emit2=emit2,
    )
    if emit2:
        rowpk, rowpk2 = out
        rowpk2 = rowpk2.reshape(b, mb_cap, wpr)
    else:
        rowpk = out
    rowpk = rowpk.reshape(b, mb_cap, wpr)
    # The (score << mshift) | member pack must fit int32 on EVERY folded
    # path (rows_keep 0/1/2 alike) — hoisted above the branch so a
    # coarse_dim/gsl combination that overflows fails loudly instead of
    # silently corrupting the select.
    score_bits = (cs * 127 * 127).bit_length() + 1       # signed int8 dot
    assert score_bits + mshift <= 32, (
        "folded groupmax pack overflow: score_bits + mshift > 32",
        score_bits, mshift,
    )
    # mask rows with NO live slot (stale scratch of dead windows; flatten
    # round-up past `end`; aligned head before `start`). Rows straddling a
    # boundary keep their max — a fold-granular superset, allowed by the
    # candidate contract (the extra rows are real corpus rows).
    j = jnp.arange(wpr, dtype=jnp.int32)
    slot0 = blk[:, :, None] + j[None, None, :] * fold
    row_live = (
        live[:, :, None]
        & (slot0 < end_b[:, :, None])
        & (slot0 + fold > start_b[:, :, None])
    )
    dead = jnp.int32(I32_DEAD)
    rowpk = jnp.where(row_live, rowpk, dead)
    if rowpk2 is not None:
        rowpk2 = jnp.where(row_live, rowpk2, dead)
    ngw = win // gsl
    g4 = rowpk.reshape(b, mb_cap, ngw, rpg)
    g1 = jnp.max(g4, axis=-1)                                  # [B, MB, NGW]
    cap = state.tables.capacity
    if rows_keep == 0:
        # WHOLE-GROUP rerank: groups are the selection unit (one packed
        # int32 each), but every slot of a selected group reaches the
        # exact rerank — positions are contiguous, so the id gather rides
        # the fast element path, and a neighbor shadowed by its group's
        # argmax is still recovered (bucket-sorted layouts co-locate true
        # neighbors, which makes argmax-only rerank lossy there)
        width = mb_cap * ngw
        flat = g1.reshape(b, width)
        rtarget = max(1, min(refine // gsl, width))
        # select_mult > 1: over-select groups, dedup candidate ids, then
        # truncate back — the exact rerank pays per SLOT, but the same
        # corpus row reaches the selected set once per table whose probed
        # bucket holds it, so deduplication widens the
        # EFFECTIVE refine at fixed exact-scoring cost for two sorts.
        rgg = max(1, min(rtarget * select_mult, width))
        bits_w = max(1, (width - 1).bit_length())
        sh = max(0, score_bits + mshift - (32 - bits_w))
        # The gate below (sh <= mshift + 8) keeps the dead-window sentinel
        # strictly below `lo` only because sh <= bits_w, which holds iff
        # the row max's rowpk pack invariant score_bits + mshift
        # <= 32 holds — asserted above the rows_keep branch.
        if _FOLD_PACK_SELECT and sh <= mshift + 8:
            # SINGLE-OPERAND select sort: quantize the packed group value
            # to the top 32-bits_w bits (drops sh-mshift score LSBs — ties
            # broaden by <= 2^(sh-mshift) of a +-cs*127^2 dot; the member
            # bits are unused at rows_keep=0) and pack the group index
            # into the low bits. Sort cost scales with operand count, so
            # this halves the [B, mb_cap*ngw] select wall vs the 2-operand
            # (value, index) sort. ~pack ascending == pack descending
            # without the -INT32_MIN negation overflow.
            lo = jnp.int32(-(1 << (31 - bits_w)))
            qv = jnp.maximum(
                jax.lax.shift_right_arithmetic(flat, sh), lo
            )                    # dead I32_DEAD clamps to lo (< any live)
            gidx = jax.lax.broadcasted_iota(jnp.int32, (b, width), 1)
            pack = jax.lax.shift_left(qv, bits_w) | gidx
            pack_s = ~jax.lax.sort(~pack, dimension=1)[:, :rgg]
            sel = pack_s & jnp.int32((1 << bits_w) - 1)
            live_sel = jax.lax.shift_right_arithmetic(pack_s, bits_w) > lo
        else:
            gidx = jnp.broadcast_to(
                jnp.arange(width, dtype=jnp.int32)[None, :], (b, width)
            )
            neg_s, gidx_s = jax.lax.sort((-flat, gidx), dimension=1,
                                         num_keys=1)
            sel = gidx_s[:, :rgg]
            live_sel = -neg_s[:, :rgg] != dead
        mbi = sel // ngw
        gi = sel % ngw
        base = jnp.take_along_axis(blk, mbi, axis=1) + gi * gsl  # [B, RGG]
        t2 = jnp.take_along_axis(table_b2, mbi, axis=1)
        sel_valid = jnp.repeat(live_sel, gsl, axis=1)
        # Id fetch: gather cost is per OPERATION (~20 ns) roughly
        # independent of row width (the exact-rerank stage fetches 96-wide
        # corpus rows at ~18 ns/row), so fetch each selected group's
        # PARENT 128-LANE ROW of sorted_ids (gsl | 128 and groups are
        # gsl-aligned, so a group never straddles a row) and extract the
        # gsl-slice with a static select chain: refine/gsl row gathers
        # instead of refine element gathers. The view keeps a 128-lane
        # minor dim (a [L*id_cap/gsl, gsl] view can be padded to 128 lanes
        # by the layout, a 128/gsl x blow-up per call).
        id_cap = state.tables.sorted_ids.shape[1]    # npad + ID_PAD
        gpr = 128 // gsl                             # groups per 128-row
        if gsl <= 128:
            idw = -(-id_cap // 128) * 128
            ids128 = (
                state.ids128 if state.ids128 is not None
                else ids128_view(state.tables.sorted_ids)
            )
            # clamp with gsl-alignment preserved (base is gsl-aligned, so
            # (base % 128) + gsl <= 128 and the row always covers the
            # group); the bound includes the trailing ID_PAD -1 columns,
            # so straddling tail groups read real ids then -1s (masked by
            # the cand2 >= 0 check below) and rowi stays in range
            basec = jnp.clip(base, 0, ((id_cap - gsl) // gsl) * gsl)
            rowi = (
                jnp.clip(t2, 0, l_n - 1) * (idw // 128) + basec // 128
            )                                                  # [B, RGG]
            rows = jnp.take(ids128, rowi, axis=0)        # [B, RGG, 128]
            off = (basec // gsl) % gpr                         # [B, RGG]
            ext = rows[..., :gsl]
            for p in range(1, gpr):
                ext = jnp.where(
                    (off == p)[..., None],
                    rows[..., p * gsl:(p + 1) * gsl], ext,
                )
            cand2 = ext.reshape(b, rgg * gsl)
        else:
            sl = jnp.arange(gsl, dtype=jnp.int32)
            pos = (base[:, :, None] + sl[None, None, :]).reshape(
                b, rgg * gsl
            )
            t2r = jnp.repeat(t2, gsl, axis=1)
            cand2 = state.tables.sorted_ids[
                jnp.clip(t2r, 0, l_n - 1), jnp.clip(pos, 0, cap - 1)
            ]
        cand2 = jnp.where(sel_valid & (cand2 >= 0), cand2, -1)
        if 0 < stage2 < rgg * gsl:
            # STAGED RERANK: the exact stage pays per fetched corpus row,
            # so cut exact rows refine -> stage2 by re-scoring every slot
            # of the selected groups with the SAME int8 coarse dots the row
            # max reduced away: re-gather the groups' folded tier rows
            # (lane-full 128-wide rows), one batched int8 matmul against
            # the query's block-diagonal qmat, then dedup ids in
            # coarse-score order and keep the best `stage2` unique ids for the f32 rerank.
            # Candidate contract: still a coarse-chosen SUBSET of the
            # probed buckets, exactly like coarse_refine always was.
            gbase = jnp.clip(base, 0, capslots - gsl)      # [B, RGG]
            rowf = gbase // fold
            tf = jnp.clip(t2, 0, l_n - 1)
            if rpg > 1:
                rowf = (
                    rowf[:, :, None]
                    + jnp.arange(rpg, dtype=jnp.int32)[None, None, :]
                ).reshape(b, rgg * rpg)
                tf = jnp.repeat(tf, rpg, axis=1)
            frows = jnp.take(
                folded.reshape(l_n * capf, lanes), tf * capf + rowf,
                axis=0,
            )                                              # [B, R2, lanes]
            sc = jax.lax.dot_general(
                frows.astype(jnp.int32), qmat.astype(jnp.int32),
                dimension_numbers=(((2,), (2,)), ((0,), (0,))),
                preferred_element_type=jnp.int32,
            )                                              # [B, R2, fold]
            # (row, seg) reshape order == member order == cand2 slot order
            slot_sc = sc.reshape(b, rgg * gsl)
            # sort 1: (id asc, -score asc) — each id's best copy leads;
            # sort 2: unique ids by coarse score desc, truncate to stage2.
            # Sentinel 2^30 clears every real row index (< npad) and every
            # negated score (|score| <= cs*127^2 < 2^20).
            sent = jnp.int32(1 << 30)
            idk = jnp.where(cand2 >= 0, cand2, sent)
            negsc = jnp.where(cand2 >= 0, -slot_sc, sent)
            id_s, neg_s = jax.lax.sort((idk, negsc), dimension=1,
                                       num_keys=2)
            dup = jnp.concatenate(
                [jnp.zeros((b, 1), dtype=bool),
                 id_s[:, 1:] == id_s[:, :-1]], axis=1,
            )
            neg_s = jnp.where(dup | (id_s == sent), sent, neg_s)
            neg2, id2 = jax.lax.sort((neg_s, id_s), dimension=1,
                                     num_keys=1)
            cand2 = jnp.where(neg2 != sent, id2, -1)[:, :stage2]
        elif rgg > rtarget:
            # dedup by id keeping select-order priority, then truncate to
            # the refine budget: sort so the best-ranked copy of each id
            # leads, mark later copies, then unique-first / rank-ordered
            # compaction
            m = rgg * gsl
            big = jnp.int32(2**31 - 1)
            bits_id = cap.bit_length()
            rank_bits = 31 - bits_id
            if _FOLD_PACK_DEDUP and rank_bits >= 4:
                # SINGLE-OPERAND packed variant: candidate row index in
                # the high bits (cap < 2^bits_id), select rank quantized
                # to rank_bits in the low bits — both dedup sorts run on
                # one i32 operand instead of two. Truncation priority is
                # rank >> rq_sh (2^rq_sh-slot blocks, id tie-break): only
                # the refine-boundary ordering moves, within one block.
                rq_sh = max(0, (m - 1).bit_length() - rank_bits)
                sent = jnp.int32((1 << bits_id) - 1)   # > any real row id
                idk = jnp.where(cand2 >= 0, cand2, sent)
                rank = jax.lax.broadcasted_iota(jnp.int32, (b, m), 1)
                k1 = jax.lax.shift_left(idk, rank_bits) | (rank >> rq_sh)
                k1 = jax.lax.sort(k1, dimension=1)
                id_s = jax.lax.shift_right_logical(k1, rank_bits)
                dup = jnp.concatenate(
                    [jnp.zeros((b, 1), dtype=bool),
                     id_s[:, 1:] == id_s[:, :-1]], axis=1
                )
                rq = k1 & jnp.int32((1 << rank_bits) - 1)
                k2 = jnp.where(
                    dup | (id_s == sent), big,
                    jax.lax.shift_left(rq, bits_id) | id_s,
                )
                k2 = jax.lax.sort(k2, dimension=1)[:, :rtarget * gsl]
                cand2 = jnp.where(
                    k2 == big, -1, k2 & jnp.int32((1 << bits_id) - 1)
                )
            else:
                rank = jnp.broadcast_to(
                    jnp.arange(m, dtype=jnp.int32)[None, :], (b, m)
                )
                idk = jnp.where(cand2 >= 0, cand2, big)
                idk_s, rank_s = jax.lax.sort((idk, rank), dimension=1,
                                             num_keys=2)
                dup = jnp.concatenate(
                    [jnp.zeros((b, 1), dtype=bool),
                     idk_s[:, 1:] == idk_s[:, :-1]], axis=1
                )
                key2 = jnp.where(
                    dup | (idk_s == big), rank_s + jnp.int32(1 << 30),
                    rank_s
                )
                _, cand2 = jax.lax.sort((key2, idk_s), dimension=1,
                                        num_keys=1)
                cand2 = cand2[:, :rtarget * gsl]
                cand2 = jnp.where(cand2 == big, -1, cand2)
    else:
        if rows_keep == 2:
            if rowpk2 is not None:
                # rpg == 1: a group IS one physical row — the second
                # candidate is the row's second-best SLOT, emitted by the
                # row max (emit2); the row-masking formula below would be
                # degenerate (a group has no second row)
                g2 = rowpk2.reshape(b, mb_cap, ngw)
            else:
                # second-best ROW of the group (distinct member bits make
                # packed values unique, equality identifies the winner row)
                g2 = jnp.max(
                    jnp.where(g4 == g1[..., None], dead, g4), axis=-1
                )
            gsel = jnp.concatenate([g1, g2], axis=2)           # [B, MB, 2*NGW]
        else:
            gsel = g1
        keep = gsel.shape[2] // ngw
        width = mb_cap * ngw * keep
        flat = gsel.reshape(b, width)
        rg = min(refine, width)
        bits_w = max(1, (width - 1).bit_length())
        q_bits = 32 - bits_w - mshift
        # sh >= 0 in the gate: at tiny widths score_bits + mshift < q_bits
        # and a NEGATIVE arithmetic shift is implementation-defined — fall
        # back to the exact 2-operand sort there
        if _FOLD_PACK_SELECT and 0 <= score_bits + mshift - q_bits <= 10 \
                and q_bits >= 8:
            # SINGLE-OPERAND select sort for the slot-keep path: quantize
            # the packed (score, member) to the top q_bits, then carry the
            # MEMBER bits and the flat index in the low bits — unlike the
            # rows_keep=0 variant the member must survive selection (it
            # addresses the slot within the group), so it rides between
            # the quantized score and the index. Sort cost scales with
            # operand count; this halves the [B, width] sort.
            sh = score_bits + mshift - q_bits
            lo = jnp.int32(-(1 << (q_bits - 1)))
            # dead stays STRICTLY below every live value: the minimum live
            # pk can quantize exactly to lo, so live clamps to lo+1 and
            # only dead entries carry lo itself
            qv = jnp.where(
                flat == dead, lo,
                jnp.maximum(jax.lax.shift_right_arithmetic(flat, sh),
                            lo + 1),
            )
            memb = flat & jnp.int32(gsl - 1)
            gidx = jax.lax.broadcasted_iota(jnp.int32, (b, width), 1)
            pack = (
                jax.lax.shift_left(qv, bits_w + mshift)
                | jax.lax.shift_left(memb, bits_w)
                | gidx
            )
            pack_s = ~jax.lax.sort(~pack, dimension=1)[:, :rg]
            sel = pack_s & jnp.int32((1 << bits_w) - 1)
            member = jax.lax.shift_right_logical(pack_s, bits_w) & jnp.int32(
                gsl - 1)
            sel_valid = jax.lax.shift_right_arithmetic(
                pack_s, bits_w + mshift) > lo
        else:
            gidx = jnp.broadcast_to(
                jnp.arange(width, dtype=jnp.int32)[None, :], (b, width)
            )
            neg_s, gidx_s = jax.lax.sort((-flat, gidx), dimension=1,
                                         num_keys=1)
            selpk = -neg_s[:, :rg]
            sel = gidx_s[:, :rg]
            member = selpk & jnp.int32(gsl - 1)
            sel_valid = selpk != dead
        mbi = sel // (ngw * keep)
        gi = sel % ngw
        pos = jnp.take_along_axis(blk, mbi, axis=1) + gi * gsl + member
        t2 = jnp.take_along_axis(table_b2, mbi, axis=1)
        cand2 = state.tables.sorted_ids[
            jnp.clip(t2, 0, l_n - 1), jnp.clip(pos, 0, cap - 1)
        ]
        cand2 = jnp.where(sel_valid & (cand2 >= 0), cand2, -1)
    if exclude_self:
        cand2 = _exclude_self(cand2, state.row_ids, query_ids)
    if state.corpus_lp is not None:
        # two-stage exact tail (rerank_dtype="bfloat16"): bf16 prescore of
        # the refine slab (half gather bytes, one bf16 pass vs HIGHEST's
        # multi-pass f32), f32 HIGHEST re-score of the top slice — ranking
        # exact while the true top-k sits in the bf16 top-256
        ids_k, sc_k = rerank_ops.rerank_dense_two_stage(
            state.corpus_lp, state.corpus, cand2, queries, k,
            dup_bound=l_n, refine=256,
        )
    else:
        exact = rerank_ops.score_candidates(state.corpus, cand2, queries)
        ids_k, sc_k = rerank_ops.dedup_topk(cand2, exact, k)
    ids = jnp.where(ids_k >= 0, state.row_ids[jnp.maximum(ids_k, 0)], -1)
    return ids, sc_k, total


def _exclude_self(cand: jax.Array, row_ids: jax.Array, query_ids: jax.Array) -> jax.Array:
    """Drop candidates whose *user id* equals the query's key — the
    reference excludes the query key from its own bucket chain
    (`searchWithSimilarity`, `RandomDrawTreeMap.java:982`)."""
    cand_uid = row_ids[jnp.maximum(cand, 0)]
    return jnp.where((cand >= 0) & (cand_uid == query_ids[:, None]), -1, cand)


def _query_dense(
    state: ForestState,
    queries: jax.Array,          # f32[B, D]
    query_ids: jax.Array,        # i32[B] (-1 = no self-exclusion for that row)
    layout: KeyLayout,
    steps: int = 0,
    m_cap: int = 4096,
    k: int = 10,
    multiprobe: bool = True,
    exclude_self: bool = True,
    probe_mode: str = "reference",
    probe_budget: int = 8,
    coarse_refine: int = 2048,
    coarse_window: int = -1,
    window_keep: int = 0,
    head_pool: int = 0,
    coarse_group: int = 64,
    rows_keep: int = 1,
    select_mult: int = 1,
    stage2: int = 0,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Batched ANN query core. Returns (ids i32[B,k], scores f32[B,k],
    n_candidates i32[B]). ids are user vector ids; -1 pads short results.

    probe_mode: "reference" reproduces the reference's blind low-bit flips;
    "margin" probes only the `probe_budget` smallest-margin bits per table
    (query-directed probing — fewer probes, equal or better recall).
    When the state carries a table-ordered coarse tier (conf.coarse_dim),
    scoring runs coarse-first with `coarse_refine` exact re-scores."""
    probes = probe_valid = None
    if probe_mode == "margin" and multiprobe:
        from ..ops.hashing import hash_dense_with_margins

        h, margins = hash_dense_with_margins(state.model, queries)
        probes, probe_valid = _probe_hashes_margin(
            h, margins, layout, probe_budget
        )
    else:
        h = hash_dense(state.model, queries)                    # [B, L] u32
    if state.coarse_folded is not None:
        return _query_groupmax(
            state, queries, query_ids, layout, steps, m_cap, k,
            multiprobe, exclude_self, refine=coarse_refine,
            probes=probes, probe_valid=probe_valid, h=h,
            window=coarse_window, group_slots=coarse_group,
            rows_keep=rows_keep, select_mult=select_mult, stage2=stage2,
        )
    if state.coarse_by_table is not None:
        return _query_dense_coarse(
            state, queries, query_ids, layout, steps, m_cap, k,
            multiprobe, exclude_self, refine=coarse_refine,
            probes=probes, probe_valid=probe_valid, h=h,
            window=coarse_window, window_keep=window_keep,
            head_pool=head_pool,
        )
    home = partition_of_hash(h, state.part_proj)                # [B, L] i32
    cand, total = gather_candidates(
        state.tables, h, home, layout, steps, m_cap, multiprobe,
        probes=probes, probe_valid=probe_valid,
    )
    if exclude_self:
        cand = _exclude_self(cand, state.row_ids, query_ids)
    # no full-width dedup: after bucket-range dedup each id appears at most
    # once per table, so the unique top-k is recovered inside the top
    # (k+1)*L scored slots (`rerank_ops.dedup_topk`)
    l = h.shape[1]
    if state.corpus_lp is not None:
        rows, scores = rerank_ops.rerank_dense_two_stage(
            state.corpus_lp, state.corpus, cand, queries, k, dup_bound=l
        )
    else:
        rows, scores = rerank_ops.rerank_dense(
            state.corpus, cand, queries, k, dup_bound=l
        )
    ids = jnp.where(rows >= 0, state.row_ids[jnp.maximum(rows, 0)], -1)
    return ids, scores, total


query_dense = jax.jit(
    _query_dense,
    static_argnames=(
        "layout", "steps", "m_cap", "k", "multiprobe", "exclude_self",
        "probe_mode", "probe_budget", "coarse_refine", "coarse_window",
        "window_keep", "head_pool", "coarse_group", "rows_keep",
        "select_mult", "stage2",
    ),
)


@functools.partial(
    jax.jit,
    static_argnames=(
        "layout", "steps", "m_cap", "k", "multiprobe", "exclude_self", "chunk",
        "probe_mode", "probe_budget", "coarse_refine", "coarse_window",
        "window_keep", "head_pool", "coarse_group", "rows_keep",
        "select_mult", "stage2",
    ),
)
def query_dense_many(
    state: ForestState,
    queries: jax.Array,          # f32[Q, D], Q a multiple of `chunk`
    query_ids: jax.Array,        # i32[Q]
    layout: KeyLayout,
    steps: int = 0,
    m_cap: int = 4096,
    k: int = 10,
    multiprobe: bool = True,
    exclude_self: bool = True,
    chunk: int = 256,
    probe_mode: str = "reference",
    probe_budget: int = 8,
    coarse_refine: int = 2048,
    coarse_window: int = -1,
    window_keep: int = 0,
    head_pool: int = 0,
    coarse_group: int = 64,
    rows_keep: int = 1,
    select_mult: int = 1,
    stage2: int = 0,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Whole-query-set search in ONE device program: `lax.map` over
    `chunk`-sized pieces bounds peak memory to a single chunk's buffers
    while avoiding per-chunk dispatch latency (the reference pays a thread
    pool per batch)."""
    q = queries.shape[0]
    nc = q // chunk

    def one(args):
        qs, qi = args
        return _query_dense(
            state, qs, qi, layout, steps=steps, m_cap=m_cap, k=k,
            multiprobe=multiprobe, exclude_self=exclude_self,
            probe_mode=probe_mode, probe_budget=probe_budget,
            coarse_refine=coarse_refine, coarse_window=coarse_window,
            window_keep=window_keep, head_pool=head_pool,
            coarse_group=coarse_group, rows_keep=rows_keep,
            select_mult=select_mult, stage2=stage2,
        )

    ids, scores, total = jax.lax.map(
        one,
        (
            queries.reshape(nc, chunk, -1),
            query_ids.reshape(nc, chunk),
        ),
    )
    return ids.reshape(q, k), scores.reshape(q, k), total.reshape(q)


# ---------------------------------------------------------------------------
# Host-facing forest
# ---------------------------------------------------------------------------


class RDFForest:
    """Host orchestrator for a dense forest (the `DensevectorRDFInit`
    equivalent at the index layer; the deploy layer wraps this with the
    reference's method names)."""

    def __init__(
        self,
        conf: RDFConfig,
        model: Optional[HashModel] = None,
        seed: Optional[int] = None,
    ):
        self.conf = conf
        self.layout = KeyLayout.from_config(conf, conf.lsh_table)
        self.model = model if model is not None else generate_model(conf, seed)
        self.part_proj = generate_partition_projections(conf, seed)
        self.state: Optional[ForestState] = None
        self._pending: list = []

    # -- fit ---------------------------------------------------------------
    def fit(self, batch: DenseBatch) -> "RDFForest":
        self.state = fit_dense(
            self.conf, batch, model=self.model, part_proj=self.part_proj
        )
        return self

    def add(self, batch: DenseBatch) -> "RDFForest":
        """Incremental insert: accumulate and rebuild. The reference supports
        point `put`s into the trie (`RandomDrawTreeMap.put:1557`); the array
        encoding instead re-sorts — a full rebuild is a single device sort,
        far cheaper than the reference's per-point path."""
        if self.state is None:
            return self.fit(batch)
        old_n = int(jnp.sum(self.state.row_ids >= 0))
        values = np.concatenate(
            [np.asarray(self.state.corpus[:old_n, : batch.dim]),
             batch.values], axis=0
        )
        ids = np.concatenate(
            [np.asarray(self.state.row_ids[:old_n]), batch.ids], axis=0
        )
        return self.fit(DenseBatch(ids, values))

    # -- query -------------------------------------------------------------
    def query(
        self,
        queries: np.ndarray,
        steps: int = 0,
        query_ids: Optional[np.ndarray] = None,
        k: Optional[int] = None,
        multiprobe: bool = True,
        probe_mode: str = "reference",
        probe_budget: int = 8,
        coarse_refine: Optional[int] = None,
        m_cap: Optional[int] = None,
        coarse_window: Optional[int] = None,
        window_keep: Optional[int] = None,
        coarse_group: Optional[int] = None,
        rows_keep: Optional[int] = None,
        select_mult: Optional[int] = None,
        stage2: Optional[int] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Batch query; chunks the batch on host to bound device memory.
        Returns (ids [Q,k], scores [Q,k]). coarse_refine / m_cap /
        coarse_window / window_keep / coarse_group / rows_keep default to
        the config's values (per-call overrides let operating-point sweeps
        reuse one fitted forest)."""
        ids, scores = self.query_device(
            queries, steps=steps, query_ids=query_ids, k=k,
            multiprobe=multiprobe, probe_mode=probe_mode,
            probe_budget=probe_budget, coarse_refine=coarse_refine,
            m_cap=m_cap, coarse_window=coarse_window,
            window_keep=window_keep, coarse_group=coarse_group,
            rows_keep=rows_keep, select_mult=select_mult, stage2=stage2,
        )
        return np.asarray(ids), np.asarray(scores)

    def query_device(
        self,
        queries: np.ndarray,
        steps: int = 0,
        query_ids: Optional[np.ndarray] = None,
        k: Optional[int] = None,
        multiprobe: bool = True,
        probe_mode: str = "reference",
        probe_budget: int = 8,
        coarse_refine: Optional[int] = None,
        m_cap: Optional[int] = None,
        coarse_window: Optional[int] = None,
        window_keep: Optional[int] = None,
        coarse_group: Optional[int] = None,
        rows_keep: Optional[int] = None,
        select_mult: Optional[int] = None,
        stage2: Optional[int] = None,
    ) -> Tuple[jax.Array, jax.Array]:
        """`query` without the final host transfer: returns device arrays so
        multi-tier callers (`storage.persist.TieredForest`) can merge many
        forests' top-ks in one device program and transfer once."""
        assert self.state is not None, "need to fit the data first"
        k = k or self.conf.top_k
        queries = np.asarray(queries, dtype=np.float32)
        q = queries.shape[0]
        exclude = query_ids is not None
        qids = (
            np.asarray(query_ids, dtype=np.int32)
            if query_ids is not None
            else np.full((q,), -1, dtype=np.int32)
        )
        bs = self.conf.query_batch_size
        nb = (q + bs - 1) // bs
        # one transfer, one device program: lax.map over chunks inside
        qd = jnp.asarray(np.pad(queries, ((0, nb * bs - q), (0, 0))))
        id_d = jnp.asarray(np.pad(qids, (0, nb * bs - q), constant_values=-1))
        ids, scores, _ = query_dense_many(
            self.state, qd, id_d, self.layout,
            steps=steps, m_cap=m_cap or self.conf.max_candidates, k=k,
            multiprobe=multiprobe, exclude_self=exclude, chunk=bs,
            probe_mode=probe_mode, probe_budget=probe_budget,
            coarse_refine=coarse_refine or self.conf.coarse_refine,
            coarse_window=(coarse_window if coarse_window is not None
                           else self.conf.coarse_window),
            window_keep=(window_keep if window_keep is not None
                         else self.conf.coarse_keep),
            head_pool=self.conf.coarse_head_pool,
            coarse_group=coarse_group or self.conf.coarse_group,
            rows_keep=(rows_keep if rows_keep is not None
                       else self.conf.coarse_rows_keep),
            select_mult=select_mult or self.conf.coarse_select_mult,
            stage2=(stage2 if stage2 is not None
                    else self.conf.coarse_stage2),
        )
        thr = self.conf.similarity_threshold
        if thr > 0.0:
            # score post-filter: the live equivalent of the reference's dead
            # hash-distance filter (`RandomDrawTreeMap.java:856-868`) —
            # exact similarity, not hash Hamming distance (config.py)
            keep = scores >= thr
            ids = jnp.where(keep, ids, -1)
            scores = jnp.where(keep, scores, -jnp.inf)
        return ids[:q], scores[:q]

    # -- introspection ------------------------------------------------------
    def size(self) -> int:
        if self.state is None:
            return 0
        return int(jnp.sum(self.state.row_ids >= 0))

    def index_bytes_per_vector(self) -> float:
        assert self.state is not None
        return self.state.tables.index_bytes() / max(1, self.size())

    def sub_index_distribution(self) -> np.ndarray:
        """Objects per (table, sub-index) — the reference's
        `allSubIndexObjectsNumberDistribution` (`RandomDrawTreeMap.java:
        2793-2802`) / `getDtAndHtNumDistribution`."""
        assert self.state is not None
        keys = np.asarray(self.state.tables.sorted_keys)
        ids = np.asarray(self.state.tables.sorted_ids)[:, : keys.shape[1]]
        parts = (keys >> (self.layout.seg_bits + self.layout.consumed_bits)).astype(
            np.int64
        )
        l = keys.shape[0]
        np_parts = 1 << self.layout.partition_bits
        dist = np.zeros((l, np_parts), dtype=np.int64)
        for t in range(l):
            vals, counts = np.unique(parts[t][ids[t] >= 0], return_counts=True)
            dist[t, vals] = counts
        return dist
