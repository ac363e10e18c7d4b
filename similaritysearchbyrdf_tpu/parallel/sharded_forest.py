"""Mesh-sharded forest: corpus shards per device, all-gather top-k merge.

The distributed design the reference paper sketches (content-partitioned
sub-indexes spread over nodes; Akka remoting configured but dead in the code,
SURVEY.md §2.5 P7) rebuilt as one SPMD program (SURVEY.md §7.5):

  * the corpus is sharded across a 1-D `Mesh` axis; every device builds a
    complete forest (all L tables) over its rows — building needs zero
    communication;
  * a query batch is replicated; candidate generation + exact re-rank are
    shard-local (the heavy part rides device-memory bandwidth);
  * the only collective is one `all_gather` of per-shard top-k (k·ndev tiny
    rows), followed by a replicated merge top-k.

State arrays carry a leading device axis sharded with
`PartitionSpec('shard')`, so the same pytree works single-host (virtual CPU
mesh) and multi-chip.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import RDFConfig
from ..index.bucket_table import (
    ID_PAD,
    BucketTables,
    KeyLayout,
    _build_records,
    _compact_buckets,
    _sort_and_depths,
    composite_keys,
)
from ..index.forest import (_coarse_query, _exclude_self, _pad_to,
                            gather_candidates)
from ..index.partitioner import generate_partition_projections, partition_of_hash
from ..models.families import HashModel, generate_model
from ..ops import rerank as rerank_ops
from ..ops.hashing import hash_dense
from ..vectors import DenseBatch
from .mesh import SHARD_AXIS, make_forest_mesh


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ShardedForestState:
    """Per-device forest shards; every array has a leading [ndev] axis
    sharded over the mesh."""

    model: HashModel            # replicated
    part_proj: jax.Array        # replicated f32[L, pbits, 32]
    sorted_keys: jax.Array      # u32[ndev, L, Nloc]
    sorted_ids: jax.Array       # i32[ndev, L, Nloc]
    bucket_keys: jax.Array      # u32[ndev, L, NB]
    bucket_starts: jax.Array    # i32[ndev, L, NB+1]
    bucket_shifts: jax.Array    # u32[ndev, L, NB]
    records: jax.Array          # i32[ndev, L, NB, 4]
    corpus: jax.Array           # f32[ndev, Nloc, D]
    row_ids: jax.Array          # i32[ndev, Nloc]
    corpus_lp: Optional[jax.Array] = None  # bf16[ndev, Nloc, D] coarse copy
    coarse_proj: Optional[jax.Array] = None      # replicated f32[D, cs]
    coarse_by_table: Optional[jax.Array] = None  # [ndev, Lg, Nloc+ID_PAD, G*cs] lane-packed
    coarse_head: Optional[jax.Array] = None      # bf16[ndev, Lg, ceil/hp, G*cs]
    coarse_folded: Optional[jax.Array] = None    # i8[ndev, L, caprows/fold, 128]
    # fit-time 128-lane row view of sorted_ids for the folded id fetch
    # (same rationale as ForestState.ids128: building it in-jit re-pays a
    # pad + relayout per query chunk)
    ids128: Optional[jax.Array] = None           # i32[ndev, L*ceil(cap/128), 128]

    def local_tables(self) -> BucketTables:
        """View of this (traced, per-shard) state's tables without the
        device axis — call inside shard_map only."""
        return BucketTables(
            sorted_keys=self.sorted_keys[0],
            sorted_ids=self.sorted_ids[0],
            bucket_keys=self.bucket_keys[0],
            bucket_starts=self.bucket_starts[0],
            bucket_shifts=self.bucket_shifts[0],
            records=self.records[0],
        )

    def local_forest_state(self) -> "ForestState":
        """This shard's slice as a single-device ForestState (inside
        shard_map only) — the sharded query runs the SAME `_query_dense`
        pipeline as one chip, then merges top-k over the mesh."""
        from ..index.forest import ForestState

        return ForestState(
            model=self.model,
            part_proj=self.part_proj,
            tables=self.local_tables(),
            corpus=self.corpus[0],
            row_ids=self.row_ids[0],
            corpus_lp=None if self.corpus_lp is None else self.corpus_lp[0],
            coarse_proj=self.coarse_proj,
            coarse_by_table=(
                None if self.coarse_by_table is None
                else self.coarse_by_table[0]
            ),
            coarse_head=(
                None if self.coarse_head is None else self.coarse_head[0]
            ),
            coarse_folded=(
                None if self.coarse_folded is None else self.coarse_folded[0]
            ),
            ids128=None if self.ids128 is None else self.ids128[0],
        )


# ---------------------------------------------------------------------------
# fit
# ---------------------------------------------------------------------------


def _local_fit(
    values: jax.Array,     # [1, Nloc, D] (block of the sharded global)
    row_ids: jax.Array,    # [1, Nloc]
    model: HashModel,
    part_proj: jax.Array,
    coarse_proj,           # f32[D, Cd] or None (replicated)
    layout: KeyLayout,
    overflow: int,
    nb_pad: int,
    coarse_int8: bool,
    head_pool: int = 0,
    folded: bool = False,
):
    v = values[0]
    rid = row_ids[0]
    valid = rid >= 0
    h = hash_dense(model, v)                      # [Nloc, L]
    p = partition_of_hash(h, part_proj)
    keys = composite_keys(h, p, layout)
    keys = jnp.where(valid[:, None], keys, jnp.uint32(0xFFFFFFFF)).T  # [L, Nloc]
    nloc = v.shape[0]
    ids = jnp.broadcast_to(
        jnp.where(valid, jnp.arange(nloc, dtype=jnp.int32), -1)[None, :], keys.shape
    )
    sk, si, elem_start, elem_shift = _sort_and_depths(keys, ids, layout, overflow)
    si = jnp.concatenate(
        [si, jnp.full((si.shape[0], ID_PAD), -1, jnp.int32)], axis=1
    )
    bk, bs, bsh = _compact_buckets(sk, elem_start, elem_shift, nb_pad)
    rec = _build_records(bk, bs, bsh)
    out = (sk[None], si[None], bk[None], bs[None], bsh[None], rec[None])
    if coarse_proj is not None:
        low = _coarse_query(v, coarse_proj)                     # [Nloc, Cd]
        if coarse_int8:
            # per-shard scale: coarse scores are compared only within a
            # shard's own candidate list before its exact re-rank, so the
            # scale constant cancels
            scale = jnp.float32(127.0) / jnp.maximum(
                jnp.max(jnp.abs(low)), 1e-20)
            low = jnp.clip(jnp.round(low * scale), -127, 127).astype(jnp.int8)
        else:
            low = low.astype(jnp.bfloat16)
        if folded:
            # SLOT-FOLDED tier (conf.coarse_layout="folded"): fold = 128/cs
            # consecutive same-table slots per physical row — a row-major
            # reshape of this shard's table-ordered coarse rows (the
            # shard-local mirror of `forest._build_folded_tier`)
            from ..index.forest import coarse_fold_factor

            cs = low.shape[1]
            fold = coarse_fold_factor(cs)
            lcnt, caprows = si.shape
            rows = jnp.take(low, jnp.maximum(si, 0), axis=0)  # [L, cap, cs]
            rows = jnp.where((si >= 0)[:, :, None], rows, 0)
            cft = rows.reshape(lcnt, caprows // fold, fold * cs)
            out = out + (cft[None],)
        else:
            from ..index.forest import _pack_tables_by_lane

            cbt = _pack_tables_by_lane(low, si)          # [Lg, Nloc+P, G*cs]
            out = out + (cbt[None],)
            if head_pool:
                from ..index.forest import head_tier_traced

                g = max(1, 128 // low.shape[1])
                out = out + (head_tier_traced(cbt, si, head_pool, g)[None],)
    return out


def _fit_from_device_arrays(
    conf: RDFConfig,
    values_d: jax.Array,     # [ndev, Nloc, D] sharded over SHARD_AXIS
    row_ids_d: jax.Array,    # [ndev, Nloc] sharded
    mesh: Mesh,
    model: Optional[HashModel],
    part_proj: Optional[jax.Array],
) -> ShardedForestState:
    """Build every shard's forest in one collective-free shard_map over
    already-placed device arrays (shared by the single- and multi-process
    fit paths)."""
    layout = KeyLayout.from_config(conf, conf.lsh_table)
    model = model if model is not None else generate_model(conf)
    part_proj = (
        part_proj if part_proj is not None else generate_partition_projections(conf)
    )
    # NB can approach Nloc (singleton buckets with 32-bit chains); a static
    # Nloc-sized pad keeps the build collective- and sync-free per shard.
    nb_pad = values_d.shape[1]

    coarse_proj = None
    if conf.coarse_dim:
        d = values_d.shape[2]
        cd = min(conf.coarse_dim, d)
        if cd == d:
            proj = np.eye(d, dtype=np.float32)
        else:
            rng = np.random.default_rng(conf.seed ^ 0x5EED)
            proj = np.linalg.qr(rng.normal(size=(d, d)))[0][:, :cd].astype(
                np.float32)
        from ..index.forest import coarse_seg_width

        cs = coarse_seg_width(cd)               # lane packing (forest tier)
        if cs != proj.shape[1]:
            proj = np.pad(proj, ((0, 0), (0, cs - proj.shape[1])))
        coarse_proj = jnp.asarray(proj)
    folded = conf.coarse_layout == "folded" and coarse_proj is not None
    if folded:
        assert conf.coarse_dtype == "int8", (
            "coarse_layout='folded' requires coarse_dtype='int8' (the "
            "groupmax kernel packs integer scores)", conf.coarse_dtype)
    head_pool = (
        conf.coarse_head_pool if coarse_proj is not None and not folded else 0
    )
    n_out = 6 + (coarse_proj is not None) + (head_pool > 0)

    body = functools.partial(
        _local_fit,
        layout=layout,
        overflow=conf.lsh_table.bucket_overflow,
        nb_pad=nb_pad,
        coarse_int8=conf.coarse_dtype == "int8",
        head_pool=head_pool,
        folded=folded,
    )
    if coarse_proj is None:
        fit_fn = jax.jit(
            jax.shard_map(
                lambda v, r, m, pp: body(v, r, m, pp, None),
                mesh=mesh,
                in_specs=(P(SHARD_AXIS), P(SHARD_AXIS), P(), P()),
                out_specs=(P(SHARD_AXIS),) * n_out,
            )
        )
        out = fit_fn(values_d, row_ids_d, model, part_proj)
    else:
        fit_fn = jax.jit(
            jax.shard_map(
                body,
                mesh=mesh,
                in_specs=(P(SHARD_AXIS), P(SHARD_AXIS), P(), P(), P()),
                out_specs=(P(SHARD_AXIS),) * n_out,
            )
        )
        out = fit_fn(values_d, row_ids_d, model, part_proj, coarse_proj)
    sk, si, bk, bs, bsh, rec = out[:6]
    cbt = out[6] if coarse_proj is not None else None
    chd = out[7] if head_pool else None
    # store LANE-PADDED scoring copies (hashing above used the true-D
    # values): 128-multiple rows gather faster; rerank pads queries to match
    d = values_d.shape[2]
    dpad = int(np.ceil(d / 128.0) * 128)
    corpus_store = (
        jnp.pad(values_d, ((0, 0), (0, 0), (0, dpad - d)))
        if dpad != d else values_d
    )
    return ShardedForestState(
        model=model,
        part_proj=part_proj,
        sorted_keys=sk,
        sorted_ids=si,
        bucket_keys=bk,
        bucket_starts=bs,
        bucket_shifts=bsh,
        records=rec,
        corpus=corpus_store,
        row_ids=row_ids_d,
        # hashing used the f32 values; only the coarse rerank copy is bf16
        corpus_lp=(
            corpus_store.astype(jnp.bfloat16)
            if conf.rerank_dtype == "bfloat16"
            else None
        ),
        coarse_proj=coarse_proj,
        coarse_by_table=None if folded else cbt,
        coarse_head=chd,
        coarse_folded=cbt if folded else None,
        ids128=(
            jax.jit(
                jax.shard_map(
                    lambda s: _ids128_local(s),
                    mesh=mesh,
                    in_specs=P(SHARD_AXIS),
                    out_specs=P(SHARD_AXIS),
                )
            )(si)
            if folded
            else None
        ),
    )


def _ids128_local(si: jax.Array) -> jax.Array:
    """Per-shard ids128 view ([1, L, cap] block -> [1, L*ceil/128, 128])."""
    from ..index.forest import ids128_view

    return ids128_view(si[0])[None]


def fit_sharded(
    conf: RDFConfig,
    batch: DenseBatch,
    mesh: Optional[Mesh] = None,
    model: Optional[HashModel] = None,
    part_proj: Optional[jax.Array] = None,
) -> Tuple[ShardedForestState, Mesh]:
    """Single-process fit: shard the (host-resident) corpus over the mesh.
    For multi-host runs where no host can hold the global corpus, use
    :func:`fit_sharded_distributed`."""
    mesh = mesh or make_forest_mesh()
    ndev = mesh.shape[SHARD_AXIS]
    n = batch.n
    nloc = _pad_to(int(np.ceil(n / ndev)), 128)
    values = np.zeros((ndev, nloc, batch.dim), dtype=np.float32)
    row_ids = np.full((ndev, nloc), -1, dtype=np.int32)
    flat_v = values.reshape(ndev * nloc, -1)
    flat_i = row_ids.reshape(ndev * nloc)
    flat_v[:n] = batch.values
    flat_i[:n] = batch.ids

    shard = NamedSharding(mesh, P(SHARD_AXIS))
    values_d = jax.device_put(values, shard)
    row_ids_d = jax.device_put(row_ids, shard)
    state = _fit_from_device_arrays(conf, values_d, row_ids_d, mesh, model, part_proj)
    return state, mesh


def fit_sharded_distributed(
    conf: RDFConfig,
    local_batch: DenseBatch,
    mesh: Optional[Mesh] = None,
    model: Optional[HashModel] = None,
    part_proj: Optional[jax.Array] = None,
    nloc: Optional[int] = None,
) -> Tuple[ShardedForestState, Mesh]:
    """Multi-process fit: every process supplies only ITS host-local rows;
    the global [ndev, Nloc, D] corpus is assembled as a distributed
    `jax.Array` from per-device shards and never exists on any single host
    (at Deep-100M the global corpus is ~38 GB — SURVEY.md §7.5, BASELINE
    configs[4]). Call `parallel.mesh.init_distributed` first; the model and
    partition projections must be seeded identically in every process (they
    are, by conf.seed).

    `nloc` (rows per device) must agree across processes; when None it is
    derived from the LARGEST per-process load via a process allgather."""
    mesh = mesh or make_forest_mesh()
    ndev = mesh.shape[SHARD_AXIS]
    my_proc = jax.process_index()
    local_devs = [d for d in mesh.devices.flat if d.process_index == my_proc]
    if not local_devs:
        raise ValueError(f"process {my_proc} owns no devices of the mesh")
    ndev_local = len(local_devs)

    n = local_batch.n
    if nloc is None:
        need = int(np.ceil(n / ndev_local))
        if jax.process_count() > 1:
            from jax.experimental import multihost_utils

            all_need = multihost_utils.process_allgather(
                np.asarray([need], dtype=np.int64)
            )
            need = int(np.max(all_need))
        nloc = _pad_to(need, 128)

    d = local_batch.dim
    values = np.zeros((ndev_local, nloc, d), dtype=np.float32)
    row_ids = np.full((ndev_local, nloc), -1, dtype=np.int32)
    values.reshape(ndev_local * nloc, d)[:n] = local_batch.values
    row_ids.reshape(ndev_local * nloc)[:n] = local_batch.ids

    shard = NamedSharding(mesh, P(SHARD_AXIS))
    values_d = jax.make_array_from_single_device_arrays(
        (ndev, nloc, d), shard,
        [jax.device_put(values[i : i + 1], dev) for i, dev in enumerate(local_devs)],
    )
    row_ids_d = jax.make_array_from_single_device_arrays(
        (ndev, nloc), shard,
        [jax.device_put(row_ids[i : i + 1], dev) for i, dev in enumerate(local_devs)],
    )
    state = _fit_from_device_arrays(conf, values_d, row_ids_d, mesh, model, part_proj)
    return state, mesh


# ---------------------------------------------------------------------------
# query
# ---------------------------------------------------------------------------


def _local_query(
    state: ShardedForestState,   # per-shard block (leading axes size 1)
    queries: jax.Array,          # [B, D] replicated
    query_ids: jax.Array,        # [B] replicated
    layout: KeyLayout,
    steps: int,
    m_cap: int,
    k: int,
    multiprobe: bool,
    exclude_self: bool,
    probe_mode: str = "reference",
    probe_budget: int = 8,
    coarse_refine: int = 2048,
    coarse_window: int = -1,
    window_keep: int = 0,
    head_pool: int = 0,
    coarse_group: int = 64,
    rows_keep: int = 0,
    select_mult: int = 1,
    stage2: int = 0,
):
    # the shard-local search IS the single-chip pipeline (classic, margin
    # probes, the table-ordered coarse tier, the two-phase pruned window
    # path, or the slot-folded groupmax path — whatever the state carries)
    from ..index.forest import _query_dense

    ids, scores, total = _query_dense(
        state.local_forest_state(), queries, query_ids, layout,
        steps=steps, m_cap=m_cap, k=k, multiprobe=multiprobe,
        exclude_self=exclude_self, probe_mode=probe_mode,
        probe_budget=probe_budget, coarse_refine=coarse_refine,
        coarse_window=coarse_window, window_keep=window_keep,
        head_pool=head_pool, coarse_group=coarse_group, rows_keep=rows_keep,
        select_mult=select_mult, stage2=stage2,
    )

    # merge: all-gather each shard's top-k, then a replicated merge —
    # the collective counterpart of the reference's synchronized result-set
    # union (`DensevectorRDFInit.scala:426-429`)
    g_ids = jax.lax.all_gather(ids, SHARD_AXIS)        # [ndev, B, k]
    g_scores = jax.lax.all_gather(scores, SHARD_AXIS)  # [ndev, B, k]
    ndev = g_ids.shape[0]
    b = queries.shape[0]
    flat_ids = jnp.moveaxis(g_ids, 0, 1).reshape(b, ndev * k)
    flat_scores = jnp.moveaxis(g_scores, 0, 1).reshape(b, ndev * k)
    m_scores, m_idx = jax.lax.top_k(flat_scores, k)
    m_ids = jnp.take_along_axis(flat_ids, m_idx, axis=1)
    m_ids = jnp.where(m_scores > rerank_ops.NEG_INF, m_ids, -1)
    total_all = jax.lax.psum(total, SHARD_AXIS)
    return m_ids, m_scores, total_all


def make_query_fn(
    mesh: Mesh,
    layout: KeyLayout,
    steps: int = 0,
    m_cap: int = 4096,
    k: int = 10,
    multiprobe: bool = True,
    exclude_self: bool = True,
    has_lp: bool = False,
    has_coarse: bool = False,
    probe_mode: str = "reference",
    probe_budget: int = 8,
    coarse_refine: int = 2048,
    coarse_window: int = -1,
    window_keep: int = 0,
    head_pool: int = 0,
    has_head: bool = False,
    has_folded: bool = False,
    coarse_group: int = 64,
    rows_keep: int = 0,
    select_mult: int = 1,
    stage2: int = 0,
):
    """Compile the sharded query step for a mesh. The returned function maps
    (state, queries [B, D], query_ids [B]) → (ids [B, k], scores [B, k],
    total [B]), all replicated outputs. `has_lp`/`has_coarse` must match
    whether the state carries the bf16 rerank copy / coarse tier."""
    state_specs = ShardedForestState(
        model=P(),  # type: ignore[arg-type]
        part_proj=P(),
        sorted_keys=P(SHARD_AXIS),
        sorted_ids=P(SHARD_AXIS),
        bucket_keys=P(SHARD_AXIS),
        bucket_starts=P(SHARD_AXIS),
        bucket_shifts=P(SHARD_AXIS),
        records=P(SHARD_AXIS),
        corpus=P(SHARD_AXIS),
        row_ids=P(SHARD_AXIS),
        corpus_lp=P(SHARD_AXIS) if has_lp else None,
        coarse_proj=P() if has_coarse or has_folded else None,
        coarse_by_table=P(SHARD_AXIS) if has_coarse else None,
        coarse_head=P(SHARD_AXIS) if has_head else None,
        coarse_folded=P(SHARD_AXIS) if has_folded else None,
        ids128=P(SHARD_AXIS) if has_folded else None,
    )
    fn = jax.shard_map(
        functools.partial(
            _local_query,
            layout=layout,
            steps=steps,
            m_cap=m_cap,
            k=k,
            multiprobe=multiprobe,
            exclude_self=exclude_self,
            probe_mode=probe_mode,
            probe_budget=probe_budget,
            coarse_refine=coarse_refine,
            coarse_window=coarse_window,
            window_keep=window_keep,
            head_pool=head_pool,
            coarse_group=coarse_group,
            rows_keep=rows_keep,
            select_mult=select_mult,
            stage2=stage2,
        ),
        mesh=mesh,
        in_specs=(state_specs, P(), P()),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )

    def many(state, queries, query_ids, chunk=None):
        """Whole query set in one program; `chunk` bounds per-step memory."""
        q = queries.shape[0]
        if chunk is None or chunk >= q:
            return fn(state, queries, query_ids)
        nc = q // chunk
        ids, scores, total = jax.lax.map(
            lambda a: fn(state, a[0], a[1]),
            (queries.reshape(nc, chunk, -1), query_ids.reshape(nc, chunk)),
        )
        return ids.reshape(q, k), scores.reshape(q, k), total.reshape(q)

    return jax.jit(many, static_argnames=("chunk",))


class ShardedRDFForest:
    """Host orchestrator for the mesh-sharded forest."""

    def __init__(self, conf: RDFConfig, mesh: Optional[Mesh] = None,
                 seed: Optional[int] = None):
        self.conf = conf
        self.mesh = mesh or make_forest_mesh()
        self.layout = KeyLayout.from_config(conf, conf.lsh_table)
        self.model = generate_model(conf, seed)
        self.part_proj = generate_partition_projections(conf, seed)
        self.state: Optional[ShardedForestState] = None
        self._query_fns = {}

    def fit(self, batch: DenseBatch) -> "ShardedRDFForest":
        self.state, _ = fit_sharded(
            self.conf, batch, self.mesh, self.model, self.part_proj
        )
        return self

    def query(
        self,
        queries: np.ndarray,
        steps: int = 0,
        query_ids: Optional[np.ndarray] = None,
        k: Optional[int] = None,
        multiprobe: bool = True,
        probe_mode: str = "reference",
        probe_budget: int = 8,
        window_keep: Optional[int] = None,
        rows_keep: Optional[int] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
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
        keep = window_keep if window_keep is not None else self.conf.coarse_keep
        rkeep = (rows_keep if rows_keep is not None
                 else self.conf.coarse_rows_keep)
        key = (steps, k, multiprobe, exclude, probe_mode, probe_budget,
               keep, rkeep)
        if key not in self._query_fns:
            self._query_fns[key] = make_query_fn(
                self.mesh, self.layout, steps=steps,
                m_cap=self.conf.max_candidates, k=k,
                multiprobe=multiprobe, exclude_self=exclude,
                has_lp=self.state.corpus_lp is not None,
                has_coarse=self.state.coarse_by_table is not None,
                coarse_refine=self.conf.coarse_refine,
                probe_mode=probe_mode, probe_budget=probe_budget,
                coarse_window=self.conf.coarse_window,
                window_keep=keep, head_pool=self.conf.coarse_head_pool,
                has_head=self.state.coarse_head is not None,
                has_folded=self.state.coarse_folded is not None,
                coarse_group=self.conf.coarse_group,
                rows_keep=rkeep,
                select_mult=self.conf.coarse_select_mult,
                stage2=self.conf.coarse_stage2,
            )
        fn = self._query_fns[key]
        nb = (q + bs - 1) // bs
        pad = nb * bs - q
        qd = jnp.asarray(np.pad(queries, ((0, pad), (0, 0))))
        id_d = jnp.asarray(np.pad(qids, (0, pad), constant_values=-1))
        ids, scores, _ = fn(self.state, qd, id_d, chunk=bs)
        return np.asarray(ids)[:q], np.asarray(scores)[:q]


# ---------------------------------------------------------------------------
# Sparse-corpus sharding (P7 covers both data formats: the reference's
# SparsevectorRDFInit is a full mirror of the dense front-end)
# ---------------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ShardedSparseForestState:
    """Per-device sparse forest shards (leading [ndev] axis sharded)."""

    model: HashModel             # replicated
    part_proj: jax.Array         # replicated
    sorted_keys: jax.Array       # u32[ndev, L, Nloc]
    sorted_ids: jax.Array        # i32[ndev, L, Nloc]
    bucket_keys: jax.Array       # u32[ndev, L, NB]
    bucket_starts: jax.Array     # i32[ndev, L, NB+1]
    bucket_shifts: jax.Array     # u32[ndev, L, NB]
    records: jax.Array           # i32[ndev, L, NB, 4]
    corpus_indices: jax.Array    # i32[ndev, Nloc, NNZ]
    corpus_values: jax.Array     # f32[ndev, Nloc, NNZ]
    row_ids: jax.Array           # i32[ndev, Nloc]

    def local_tables(self) -> BucketTables:
        return BucketTables(
            sorted_keys=self.sorted_keys[0],
            sorted_ids=self.sorted_ids[0],
            bucket_keys=self.bucket_keys[0],
            bucket_starts=self.bucket_starts[0],
            bucket_shifts=self.bucket_shifts[0],
            records=self.records[0],
        )


def _local_sparse_fit(
    indices: jax.Array,    # [1, Nloc, NNZ]
    values: jax.Array,     # [1, Nloc, NNZ]
    row_ids: jax.Array,    # [1, Nloc]
    model: HashModel,
    part_proj: jax.Array,
    layout: KeyLayout,
    overflow: int,
    nb_pad: int,
    dim: int,
):
    from ..index.sparse_forest import _hash_batch

    idx, val, rid = indices[0], values[0], row_ids[0]
    valid = rid >= 0
    h = _hash_batch(model, idx, val, dim)              # [Nloc, L]
    p = partition_of_hash(h, part_proj)
    keys = composite_keys(h, p, layout)
    keys = jnp.where(valid[:, None], keys, jnp.uint32(0xFFFFFFFF)).T
    nloc = idx.shape[0]
    ids = jnp.broadcast_to(
        jnp.where(valid, jnp.arange(nloc, dtype=jnp.int32), -1)[None, :],
        keys.shape,
    )
    sk, si, elem_start, elem_shift = _sort_and_depths(keys, ids, layout, overflow)
    si = jnp.concatenate(
        [si, jnp.full((si.shape[0], ID_PAD), -1, jnp.int32)], axis=1
    )
    bk, bs, bsh = _compact_buckets(sk, elem_start, elem_shift, nb_pad)
    rec = _build_records(bk, bs, bsh)
    return (sk[None], si[None], bk[None], bs[None], bsh[None], rec[None])


def fit_sparse_sharded(
    conf: RDFConfig,
    batch,  # SparseBatch
    mesh: Optional[Mesh] = None,
    model: Optional[HashModel] = None,
    part_proj: Optional[jax.Array] = None,
) -> Tuple[ShardedSparseForestState, Mesh]:
    """Shard a sparse corpus over the mesh; every shard builds all L tables
    locally (collective-free, like the dense fit)."""
    mesh = mesh or make_forest_mesh()
    layout = KeyLayout.from_config(conf, conf.lsh_table)
    rerank_ops.check_sparse_size_for_merge(batch.size)
    model = model if model is not None else generate_model(conf)
    part_proj = (
        part_proj if part_proj is not None else generate_partition_projections(conf)
    )
    ndev = mesh.shape[SHARD_AXIS]
    n = batch.n
    nloc = _pad_to(int(np.ceil(n / ndev)), 128)
    nnz = batch.nnz_pad
    idx = np.zeros((ndev, nloc, nnz), dtype=np.int32)
    val = np.zeros((ndev, nloc, nnz), dtype=np.float32)
    row_ids = np.full((ndev, nloc), -1, dtype=np.int32)
    idx.reshape(ndev * nloc, nnz)[:n] = batch.indices
    val.reshape(ndev * nloc, nnz)[:n] = batch.values
    row_ids.reshape(ndev * nloc)[:n] = batch.ids

    shard = NamedSharding(mesh, P(SHARD_AXIS))
    idx_d = jax.device_put(idx, shard)
    val_d = jax.device_put(val, shard)
    row_ids_d = jax.device_put(row_ids, shard)
    nb_pad = nloc

    fit_fn = jax.jit(
        jax.shard_map(
            functools.partial(
                _local_sparse_fit,
                layout=layout,
                overflow=conf.lsh_table.bucket_overflow,
                nb_pad=nb_pad,
                dim=batch.size,
            ),
            mesh=mesh,
            in_specs=(P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS), P(), P()),
            out_specs=(P(SHARD_AXIS),) * 6,
        )
    )
    sk, si, bk, bs, bsh, rec = fit_fn(idx_d, val_d, row_ids_d, model, part_proj)
    state = ShardedSparseForestState(
        model=model,
        part_proj=part_proj,
        sorted_keys=sk,
        sorted_ids=si,
        bucket_keys=bk,
        bucket_starts=bs,
        bucket_shifts=bsh,
        records=rec,
        corpus_indices=idx_d,
        corpus_values=val_d,
        row_ids=row_ids_d,
    )
    return state, mesh


def _local_sparse_query(
    state: ShardedSparseForestState,
    q_indices: jax.Array,        # [B, NNZq] replicated
    q_values: jax.Array,         # [B, NNZq] replicated
    query_ids: jax.Array,        # [B] replicated
    layout: KeyLayout,
    dim: int,
    steps: int,
    m_cap: int,
    k: int,
    exclude_self: bool,
):
    from ..index.sparse_forest import _hash_batch

    tables = state.local_tables()
    h = _hash_batch(state.model, q_indices, q_values, dim)
    home = partition_of_hash(h, state.part_proj)
    # the reference's sparse query has no multi-probe (`:686-732`)
    cand, total = gather_candidates(
        tables, h, home, layout, steps, m_cap, multiprobe=False
    )
    row_ids = state.row_ids[0]
    if exclude_self:
        cand = _exclude_self(cand, row_ids, query_ids)

    b = q_indices.shape[0]
    rows_out, scores = rerank_ops.rerank_sparse_merge(
        state.corpus_indices[0], state.corpus_values[0], cand,
        q_indices, q_values, k, dup_bound=h.shape[1],
    )
    ids = jnp.where(rows_out >= 0, row_ids[jnp.maximum(rows_out, 0)], -1)

    g_ids = jax.lax.all_gather(ids, SHARD_AXIS)
    g_scores = jax.lax.all_gather(scores, SHARD_AXIS)
    ndev = g_ids.shape[0]
    flat_ids = jnp.moveaxis(g_ids, 0, 1).reshape(b, ndev * k)
    flat_scores = jnp.moveaxis(g_scores, 0, 1).reshape(b, ndev * k)
    m_scores, m_idx = jax.lax.top_k(flat_scores, k)
    m_ids = jnp.take_along_axis(flat_ids, m_idx, axis=1)
    m_ids = jnp.where(m_scores > rerank_ops.NEG_INF, m_ids, -1)
    total_all = jax.lax.psum(total, SHARD_AXIS)
    return m_ids, m_scores, total_all


def make_sparse_query_fn(
    mesh: Mesh,
    layout: KeyLayout,
    dim: int,
    steps: int = 0,
    m_cap: int = 4096,
    k: int = 10,
    exclude_self: bool = True,
):
    """Compiled sharded sparse query: (state, q_indices [B,NNZ], q_values,
    query_ids) → replicated (ids [B,k], scores [B,k], total [B])."""
    state_specs = ShardedSparseForestState(
        model=P(),  # type: ignore[arg-type]
        part_proj=P(),
        sorted_keys=P(SHARD_AXIS),
        sorted_ids=P(SHARD_AXIS),
        bucket_keys=P(SHARD_AXIS),
        bucket_starts=P(SHARD_AXIS),
        bucket_shifts=P(SHARD_AXIS),
        records=P(SHARD_AXIS),
        corpus_indices=P(SHARD_AXIS),
        corpus_values=P(SHARD_AXIS),
        row_ids=P(SHARD_AXIS),
    )
    fn = jax.shard_map(
        functools.partial(
            _local_sparse_query,
            layout=layout,
            dim=dim,
            steps=steps,
            m_cap=m_cap,
            k=k,
            exclude_self=exclude_self,
        ),
        mesh=mesh,
        in_specs=(state_specs, P(), P(), P()),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )
    return jax.jit(fn)
