"""Sparse-vector forest — the `SparsevectorRDFInit` capability.

The reference's sparse path (`SparsevectorRDFInit.scala`,
`RandomDrawTreeMap.getSimilarWithStepWiseFaster` sparse overload
`RandomDrawTreeMap.java:686-732`) differs from the dense path in two ways:
hashing uses the sparse dot (BitSet intersect in the reference) and the
query does step-wise partition fan-out but NO multi-probe. Both are
reproduced here over the padded-COO batch layout (SURVEY.md §7 hard part (c):
fixed-nnz padding).
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
from ..ops.hashing import hash_sparse, hash_sparse_densify
from ..vectors import SparseBatch
from .bucket_table import BucketTables, KeyLayout, build_tables, composite_keys
from .forest import _pad_to, gather_candidates, _exclude_self
from .partitioner import generate_partition_projections, partition_of_hash


# When the dimensionality is small enough, scattering the batch dense and
# using a matmul beats the gather path.
_DENSIFY_DIM_LIMIT = 4096


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SparseForestState:
    model: HashModel
    part_proj: jax.Array         # f32[L, pbits, 32]
    tables: BucketTables
    corpus_indices: jax.Array    # i32[Npad, NNZ]
    corpus_values: jax.Array     # f32[Npad, NNZ]
    row_ids: jax.Array           # i32[Npad]
    # table-ordered coarse tier (conf.coarse_dim): DENSE low-dim projections
    # of the sparse rows, per table in bucket-sorted order — coarse scoring
    # of a candidate block is one contiguous slice gather + a dense dot,
    # instead of [B, M, NNZ] per-element gathers (the sparse hot spot)
    coarse_proj: Optional[jax.Array] = None      # f32[dim, Cd]
    coarse_by_table: Optional[jax.Array] = None  # int8/bf16[Lg, Npad+P, G*cs] lane-packed

    @property
    def capacity(self) -> int:
        return self.corpus_indices.shape[0]


def _hash_batch(model: HashModel, idx: jax.Array, val: jax.Array, dim: int) -> jax.Array:
    if dim <= _DENSIFY_DIM_LIMIT:
        return hash_sparse_densify(model, idx, val)
    return hash_sparse(model, idx, val)


@functools.partial(jax.jit, static_argnames=("layout", "chunk", "dim"))
def _keys_for_sparse_corpus(
    model: HashModel,
    part_proj: jax.Array,
    indices: jax.Array,       # i32[Npad, NNZ]
    values: jax.Array,        # f32[Npad, NNZ]
    valid: jax.Array,         # bool[Npad]
    layout: KeyLayout,
    chunk: int,
    dim: int,
) -> jax.Array:
    n = indices.shape[0]
    n_chunks = n // chunk

    def one(args):
        ic, vc = args
        h = _hash_batch(model, ic, vc, dim)
        p = partition_of_hash(h, part_proj)
        return composite_keys(h, p, layout)

    keys = jax.lax.map(
        one,
        (
            indices.reshape(n_chunks, chunk, -1),
            values.reshape(n_chunks, chunk, -1),
        ),
    )
    keys = keys.reshape(n, -1)
    keys = jnp.where(valid[:, None], keys, jnp.uint32(0xFFFFFFFF))
    return keys.T


def fit_sparse(
    conf: RDFConfig,
    batch: SparseBatch,
    model: Optional[HashModel] = None,
    part_proj: Optional[jax.Array] = None,
    nb_pad: Optional[int] = None,
) -> SparseForestState:
    """Build a forest over a sparse corpus — replacement for
    `SparsevectorRDFInit.newMultiThreadFit` (`SparsevectorRDFInit.scala:
    124-200`)."""
    layout = KeyLayout.from_config(conf, conf.lsh_table)
    rerank_ops.check_sparse_size_for_merge(batch.size)
    model = model if model is not None else generate_model(conf)
    part_proj = (
        part_proj if part_proj is not None else generate_partition_projections(conf)
    )
    n = batch.n
    chunk = min(conf.fit_batch_size, _pad_to(n, 256))
    if batch.size > _DENSIFY_DIM_LIMIT:
        # gather-path hashing materializes [chunk, NNZ, T*C]; bound it to
        # ~512 MB per chunk
        per_row = batch.nnz_pad * conf.table_num * conf.lsh_table.chain_length * 4
        chunk = min(chunk, _pad_to(max(256, (512 << 20) // max(per_row, 1)), 256))
    npad = _pad_to(n, chunk)
    row_ids = np.full((npad,), -1, dtype=np.int32)
    row_ids[:n] = batch.ids
    valid = np.zeros((npad,), dtype=bool)
    valid[:n] = True

    if isinstance(batch.indices, jax.Array):
        # device-resident COO rows (steady-state refits): skip the host
        # staging + upload (same as the dense path)
        idx_d, val_d = batch.indices, batch.values
        if idx_d.shape[0] != npad:
            padr = ((0, npad - idx_d.shape[0]), (0, 0))
            idx_d = jnp.pad(idx_d, padr)
            val_d = jnp.pad(val_d, padr)
    else:
        idx = np.zeros((npad, batch.nnz_pad), dtype=np.int32)
        val = np.zeros((npad, batch.nnz_pad), dtype=np.float32)
        idx[:n] = batch.indices
        val[:n] = batch.values
        idx_d, val_d = jnp.asarray(idx), jnp.asarray(val)
    keys = _keys_for_sparse_corpus(
        model, part_proj, idx_d, val_d, jnp.asarray(valid), layout, chunk,
        batch.size,
    )
    ids = jnp.broadcast_to(
        jnp.where(jnp.asarray(valid), jnp.arange(npad, dtype=jnp.int32), -1)[None, :],
        keys.shape,
    )
    tables = build_tables(
        keys, ids, layout, conf.lsh_table.bucket_overflow, nb_pad=nb_pad
    )
    coarse_proj = coarse_by_table = None
    if conf.coarse_dim:
        coarse_proj, coarse_by_table = _build_sparse_coarse_tier(
            idx_d, val_d, tables.sorted_ids, batch.size,
            min(conf.coarse_dim, batch.size), conf.coarse_dtype, conf.seed,
            chunk,
        )
    return SparseForestState(
        model=model,
        part_proj=part_proj,
        tables=tables,
        corpus_indices=idx_d,
        corpus_values=val_d,
        row_ids=jnp.asarray(row_ids),
        coarse_proj=coarse_proj,
        coarse_by_table=coarse_by_table,
    )


def _build_sparse_coarse_tier(
    indices: jax.Array,      # i32[Npad, NNZ]
    values: jax.Array,       # f32[Npad, NNZ]
    sorted_ids: jax.Array,   # i32[L, Npad+ID_PAD]
    dim: int,
    coarse_dim: int,
    coarse_dtype: str,
    seed: int,
    chunk: int,
) -> Tuple[jax.Array, jax.Array]:
    """Dense low-dim projection of every sparse row (low[n] = Σ_j v[n,j] ·
    P[idx[n,j]]), replicated per table in bucket-sorted order. The random
    Gaussian projection preserves inner products in expectation
    (Johnson–Lindenstrauss); the exact refine pass corrects any coarse
    misordering inside the top slice."""
    from .forest import coarse_seg_width

    rng = np.random.default_rng(seed ^ 0x5EED)
    p = (rng.normal(size=(dim, coarse_dim)) / np.sqrt(coarse_dim)).astype(
        np.float32
    )
    # pad to the lane-segment width; G = 128//cs tables share each 128-lane
    # row (see forest._build_coarse_tier lane packing)
    cs = coarse_seg_width(coarse_dim)
    if cs != p.shape[1]:
        p = np.pad(p, ((0, 0), (0, cs - p.shape[1])))
    coarse_proj = jnp.asarray(p)
    store_int8 = coarse_dtype == "int8"
    cbt = _sparse_coarse_build(
        coarse_proj, indices, values, sorted_ids, chunk, store_int8
    )
    return coarse_proj, cbt


@functools.partial(jax.jit, static_argnames=("chunk", "store_int8"))
def _sparse_coarse_build(cp, idx, val, sorted_ids, chunk, store_int8):
    """Module-level jit (closure-local jits recompile on every fit)."""
    n = idx.shape[0]
    nc = n // chunk

    def one(args):
        ic, vc = args
        rows = jnp.take(cp, ic, axis=0)            # [chunk, NNZ, Cd]
        return jnp.einsum("bnc,bn->bc", rows, vc,  # [chunk, Cd]
                          precision=jax.lax.Precision.HIGHEST)

    low = jax.lax.map(
        one, (idx.reshape(nc, chunk, -1), val.reshape(nc, chunk, -1))
    ).reshape(n, -1)
    if store_int8:
        scale = jnp.float32(127.0) / jnp.maximum(jnp.max(jnp.abs(low)), 1e-20)
        low = jnp.clip(jnp.round(low * scale), -127, 127).astype(jnp.int8)
    else:
        low = low.astype(jnp.bfloat16)
    from .forest import _pack_tables_by_lane

    return _pack_tables_by_lane(low, sorted_ids)


def _query_sparse(
    state: SparseForestState,
    q_indices: jax.Array,        # i32[B, NNZq]
    q_values: jax.Array,         # f32[B, NNZq]
    query_ids: jax.Array,        # i32[B]
    layout: KeyLayout,
    dim: int,
    steps: int = 0,
    m_cap: int = 4096,
    k: int = 10,
    multiprobe: bool = False,    # the reference's sparse path has no probes
    exclude_self: bool = True,
    coarse_refine: int = 2048,
    coarse_window: int = -1,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    h = _hash_batch(state.model, q_indices, q_values, dim)
    home = partition_of_hash(h, state.part_proj)

    # densified query side for the correct sparse·sparse dot
    b, nnzq = q_indices.shape
    q_dense = jnp.zeros((b, dim), dtype=jnp.float32)
    rows = jnp.broadcast_to(jnp.arange(b)[:, None], (b, nnzq))
    q_dense = q_dense.at[rows, q_indices].add(q_values)

    if state.coarse_by_table is not None:
        from .forest import _coarse_block_scores, gather_blocks

        if coarse_window < 0:
            win = 64 if m_cap % 64 == 0 and m_cap >= 32768 else 0
        else:
            win = (
                coarse_window
                if (coarse_window and m_cap % coarse_window == 0)
                else 0
            )
        base_b, table_b2, start_b, end_b, total, bs_block = gather_blocks(
            state.tables, h, home, layout, steps, m_cap, multiprobe,
            window=win,
        )
        scores_c, pos, table_slot = _coarse_block_scores(
            state.coarse_by_table, state.coarse_proj, q_dense,
            base_b, table_b2, end_b, bs_block, start_b=start_b,
        )
        l = state.tables.num_tables
        cap = state.tables.capacity
        m2 = min(max(coarse_refine, (k + 1) * l), m_cap)
        from .forest import _FORCE_UNPACKED_RANGES

        if m2 * 8 <= scores_c.shape[1]:
            vals, idxs = jax.lax.approx_max_k(scores_c, m2,
                                              recall_target=0.98)
            t2 = jnp.take_along_axis(table_slot, idxs, axis=1)
            p2 = jnp.take_along_axis(pos, idxs, axis=1)
            sel_valid = jnp.isfinite(vals)
        elif l * (cap + 1) < 2**31 and not _FORCE_UNPACKED_RANGES:
            payload = table_slot * jnp.int32(cap + 1) + pos
            neg_s, payload_s = jax.lax.sort((-scores_c, payload),
                                            dimension=1, num_keys=1)
            t2 = payload_s[:, :m2] // jnp.int32(cap + 1)
            p2 = payload_s[:, :m2] % jnp.int32(cap + 1)
            sel_valid = jnp.isfinite(-neg_s[:, :m2])
        else:
            neg_s, t_s, p_s = jax.lax.sort((-scores_c, table_slot, pos),
                                           dimension=1, num_keys=1)
            t2, p2 = t_s[:, :m2], p_s[:, :m2]
            sel_valid = jnp.isfinite(-neg_s[:, :m2])
        cand = state.tables.sorted_ids[
            jnp.clip(t2, 0, l - 1), jnp.clip(p2, 0, cap - 1)
        ]
        cand = jnp.where(sel_valid & (cand >= 0), cand, -1)
    else:
        cand, total = gather_candidates(
            state.tables, h, home, layout, steps, m_cap, multiprobe
        )
    if exclude_self:
        cand = _exclude_self(cand, state.row_ids, query_ids)

    rows_out, scores = rerank_ops.rerank_sparse_merge(
        state.corpus_indices, state.corpus_values, cand,
        q_indices, q_values, k, dup_bound=h.shape[1],
    )
    ids = jnp.where(rows_out >= 0, state.row_ids[jnp.maximum(rows_out, 0)], -1)
    return ids, scores, total


query_sparse = jax.jit(
    _query_sparse,
    static_argnames=(
        "layout", "steps", "m_cap", "k", "dim", "multiprobe", "exclude_self",
        "coarse_refine", "coarse_window",
    ),
)


@functools.partial(
    jax.jit,
    static_argnames=(
        "layout", "steps", "m_cap", "k", "dim", "multiprobe", "exclude_self",
        "chunk", "coarse_refine", "coarse_window",
    ),
)
def query_sparse_many(
    state: SparseForestState,
    q_indices: jax.Array,        # i32[Q, NNZq], Q a multiple of chunk
    q_values: jax.Array,         # f32[Q, NNZq]
    query_ids: jax.Array,        # i32[Q]
    layout: KeyLayout,
    dim: int,
    steps: int = 0,
    m_cap: int = 4096,
    k: int = 10,
    multiprobe: bool = False,
    exclude_self: bool = True,
    chunk: int = 256,
    coarse_refine: int = 2048,
    coarse_window: int = -1,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Whole-query-set sparse search in one device program (lax.map over
    chunks — see `query_dense_many`)."""
    q = q_indices.shape[0]
    nc = q // chunk

    def one(args):
        qi, qv, qid = args
        return _query_sparse(
            state, qi, qv, qid, layout, dim, steps=steps, m_cap=m_cap, k=k,
            multiprobe=multiprobe, exclude_self=exclude_self,
            coarse_refine=coarse_refine, coarse_window=coarse_window,
        )

    ids, scores, total = jax.lax.map(
        one,
        (
            q_indices.reshape(nc, chunk, -1),
            q_values.reshape(nc, chunk, -1),
            query_ids.reshape(nc, chunk),
        ),
    )
    return ids.reshape(q, k), scores.reshape(q, k), total.reshape(q)


class SparseRDFForest:
    """Host orchestrator for the sparse forest."""

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
        self.state: Optional[SparseForestState] = None
        self.dim = conf.vector_dim

    def fit(self, batch: SparseBatch) -> "SparseRDFForest":
        self.dim = batch.size
        self.state = fit_sparse(
            self.conf, batch, model=self.model, part_proj=self.part_proj
        )
        return self

    def query(
        self,
        queries: SparseBatch,
        steps: int = 0,
        query_ids: Optional[np.ndarray] = None,
        k: Optional[int] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        assert self.state is not None, "need to fit the data first"
        k = k or self.conf.top_k
        q = queries.n
        exclude = query_ids is not None
        qids = (
            np.asarray(query_ids, dtype=np.int32)
            if query_ids is not None
            else np.full((q,), -1, dtype=np.int32)
        )
        bs = self.conf.query_batch_size
        nb = (q + bs - 1) // bs
        pad = nb * bs - q
        qi = jnp.asarray(np.pad(queries.indices, ((0, pad), (0, 0))))
        qv = jnp.asarray(np.pad(queries.values, ((0, pad), (0, 0))))
        ic = jnp.asarray(np.pad(qids, (0, pad), constant_values=-1))
        ids, scores, _ = query_sparse_many(
            self.state, qi, qv, ic, self.layout, self.dim,
            steps=steps, m_cap=self.conf.max_candidates, k=k,
            exclude_self=exclude, chunk=bs,
            coarse_refine=self.conf.coarse_refine,
            coarse_window=self.conf.coarse_window,
        )
        thr = self.conf.similarity_threshold
        if thr > 0.0:
            # score post-filter (see config.similarity_threshold): the live
            # equivalent of `RandomDrawTreeMap.java:856-868`
            keep = scores >= thr
            ids = jnp.where(keep, ids, -1)
            scores = jnp.where(keep, scores, -jnp.inf)
        return np.asarray(ids)[:q], np.asarray(scores)[:q]

    def size(self) -> int:
        if self.state is None:
            return 0
        return int(jnp.sum(self.state.row_ids >= 0))

    def sub_index_distribution(self) -> np.ndarray:
        """Objects per (table, sub-index) — the sparse mirror of the dense
        forest's `allSubIndexObjectsNumberDistribution`
        (`RandomDrawTreeMap.java:2793-2802`; surfaced by the sparse
        front-end's `getDtAndHtNumDistribution`,
        `SparsevectorRDFInit.scala:505-530`)."""
        assert self.state is not None
        keys = np.asarray(self.state.tables.sorted_keys)
        ids = np.asarray(self.state.tables.sorted_ids)[:, : keys.shape[1]]
        parts = (
            keys >> (self.layout.seg_bits + self.layout.consumed_bits)
        ).astype(np.int64)
        l = keys.shape[0]
        np_parts = 1 << self.layout.partition_bits
        dist = np.zeros((l, np_parts), dtype=np.int64)
        for t in range(l):
            vals, counts = np.unique(parts[t][ids[t] >= 0], return_counts=True)
            dist[t, vals] = counts
        return dist
