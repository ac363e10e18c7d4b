"""Mesh-sharded quantized-flat engine: P7 distribution for `ops/flat.py`.

Each device holds a row shard of the int8/bf16 sketch + f32 corpus
(Deep-100M at 96d, lane-padded to 128, over four cards: 3.2 GB sketch
+ 12.8 GB corpus per card); queries are replicated, the shard-local scan+refine is the
single-device `flat_topk`, and the only collective is one all-gather of
per-shard top-k (k·ndev tiny) followed by a replicated merge — the same
merge contract as the sharded forest (`sharded_forest._local_query`).

The int8 quantization scale is computed GLOBALLY before sharding: a
per-shard scale would make scores incomparable across shards and corrupt
the merged ranking.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.flat import (flat_topk, flat_topk_grouped, flat_topk_sparse,
                        _densify_quantize)
from .mesh import SHARD_AXIS, make_forest_mesh


class ShardedFlatState(NamedTuple):
    sketch: jax.Array     # int8/bf16 [ndev*Nloc, D], row-sharded
    corpus: jax.Array     # f32     [ndev*Nloc, D], row-sharded
    row_ids: jax.Array    # i32     [ndev*Nloc], row-sharded (-1 = pad)


def fit_flat_sharded(
    values: np.ndarray,            # f32[N, D]
    ids: np.ndarray,               # i32[N] user ids
    mesh: Optional[Mesh] = None,
    sketch_dtype: str = "int8",
) -> Tuple[ShardedFlatState, Mesh]:
    mesh = mesh or make_forest_mesh()
    ndev = mesh.shape[SHARD_AXIS]
    n, d = values.shape
    nloc = int(np.ceil(n / ndev))
    npad = nloc * ndev
    x = np.zeros((npad, d), dtype=np.float32)
    x[:n] = values
    rid = np.full((npad,), -1, dtype=np.int32)
    rid[:n] = ids
    dp = int(np.ceil(d / 128.0) * 128)       # 128-lane rows, as the
    x = np.pad(x, ((0, 0), (0, dp - d)))      # single-device sketch
    if sketch_dtype == "int8":
        scale = 127.0 / max(float(np.max(np.abs(values))), 1e-30)
        sk = np.clip(np.round(x * scale), -127, 127).astype(np.int8)
    elif sketch_dtype == "bfloat16":
        sk = jnp.asarray(x).astype(jnp.bfloat16)
    else:
        raise ValueError(f"unsupported flat sketch dtype: {sketch_dtype}")
    shard = NamedSharding(mesh, P(SHARD_AXIS))
    state = ShardedFlatState(
        sketch=jax.device_put(sk, shard),
        corpus=jax.device_put(x, shard),
        row_ids=jax.device_put(rid, shard),
    )
    return state, mesh


def _pad_to(n: int, m: int) -> int:
    return int(np.ceil(n / m)) * m


def _distributed_rows(
    mesh: Mesh, arrays_local: "list[np.ndarray]", nloc: int
) -> "list[jax.Array]":
    """Assemble row-sharded distributed jax.Arrays from THIS process's
    host-local per-device chunks (the `fit_sharded_distributed` pattern:
    the global array never exists on any single host)."""
    my_proc = jax.process_index()
    local_devs = [d for d in mesh.devices.flat if d.process_index == my_proc]
    ndev = mesh.shape[SHARD_AXIS]
    shard = NamedSharding(mesh, P(SHARD_AXIS))
    out = []
    for a in arrays_local:
        gshape = (ndev * nloc,) + a.shape[2:]
        out.append(
            jax.make_array_from_single_device_arrays(
                gshape, shard,
                [jax.device_put(a[i], dev)
                 for i, dev in enumerate(local_devs)],
            )
        )
    return out


def _global_nloc_and_amax(n_local: int, amax_local: float,
                          ndev_local: int) -> Tuple[int, float]:
    """Agree on rows-per-device and the GLOBAL quantization scale input
    across processes (per-shard scales would corrupt the merged ranking)."""
    need = int(np.ceil(n_local / ndev_local))
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        g = multihost_utils.process_allgather(
            np.asarray([need, amax_local], dtype=np.float64)
        )
        need = int(np.max(g[..., 0]))
        amax_local = float(np.max(g[..., 1]))
    return _pad_to(need, 128), amax_local


def fit_flat_sharded_distributed(
    local_values: np.ndarray,        # f32[n_local, D] THIS process's rows
    local_ids: np.ndarray,           # i32[n_local]
    mesh: Optional[Mesh] = None,
    sketch_dtype: str = "int8",
) -> Tuple[ShardedFlatState, Mesh]:
    """Multi-process flat-engine fit: every process supplies only its
    host-local rows; sketch/corpus/row_ids are assembled as distributed
    arrays that never exist globally on any host (the Deep-100M contract,
    BASELINE configs[4])."""
    mesh = mesh or make_forest_mesh()
    my_proc = jax.process_index()
    ndev_local = sum(
        1 for d in mesh.devices.flat if d.process_index == my_proc
    )
    if ndev_local == 0:
        raise ValueError(f"process {my_proc} owns no devices of the mesh")
    n, d = local_values.shape
    nloc, amax = _global_nloc_and_amax(
        n, float(np.max(np.abs(local_values))) if n else 0.0, ndev_local
    )
    dp = _pad_to(d, 128)
    x = np.zeros((ndev_local, nloc, dp), dtype=np.float32)
    rid = np.full((ndev_local, nloc), -1, dtype=np.int32)
    x.reshape(ndev_local * nloc, dp)[:n, :d] = local_values
    rid.reshape(ndev_local * nloc)[:n] = local_ids
    if sketch_dtype == "int8":
        scale = 127.0 / max(amax, 1e-30)
        sk = np.clip(np.round(x * scale), -127, 127).astype(np.int8)
    elif sketch_dtype == "bfloat16":
        sk = x  # cast below, after assembly (npz/np has no bf16)
    else:
        raise ValueError(f"unsupported flat sketch dtype: {sketch_dtype}")
    sk_d, x_d, rid_d = _distributed_rows(mesh, [sk, x, rid], nloc)
    if sketch_dtype == "bfloat16":
        cast = jax.jit(
            lambda a: a.astype(jnp.bfloat16),
            out_shardings=NamedSharding(mesh, P(SHARD_AXIS)),
        )
        sk_d = cast(sk_d)
    return ShardedFlatState(sketch=sk_d, corpus=x_d, row_ids=rid_d), mesh


def _gather_merge_topk(ids, scores, k):
    """All-gather of per-shard top-k + replicated merge — the single
    collective of every sharded engine's read path."""
    g_ids = jax.lax.all_gather(ids, SHARD_AXIS)          # [ndev, B, k]
    g_scores = jax.lax.all_gather(scores, SHARD_AXIS)
    ndev, b = g_ids.shape[0], g_ids.shape[1]
    flat_ids = jnp.moveaxis(g_ids, 0, 1).reshape(b, ndev * k)
    flat_scores = jnp.moveaxis(g_scores, 0, 1).reshape(b, ndev * k)
    m_scores, m_idx = jax.lax.top_k(flat_scores, k)
    m_ids = jnp.take_along_axis(flat_ids, m_idx, axis=1)
    m_ids = jnp.where(jnp.isfinite(m_scores), m_ids, -1)
    return m_ids, m_scores


def _local_flat_query(sketch, corpus, row_ids, queries, query_ids,
                      *, k, refine, block, exclude_self, mode="scan",
                      r_groups=24):
    if mode == "grouped":
        # shard-local grouped pipeline (fused group max + window rescore,
        # ops/flat.flat_topk_grouped) — the per-device fast path
        ids, scores = flat_topk_grouped(
            sketch, corpus, row_ids, queries, query_ids, k,
            refine=refine, r_groups=max(r_groups, 3 * k),
            exclude_self=exclude_self,
        )
    else:
        ids, scores = flat_topk(
            sketch, corpus, row_ids, queries, query_ids, k,
            refine=refine, block=block, exclude_self=exclude_self,
        )
    return _gather_merge_topk(ids, scores, k)


def make_flat_query_fn(
    mesh: Mesh,
    k: int = 10,
    refine: int = 128,
    block: int = 1 << 15,
    exclude_self: bool = True,
    mode: str = "scan",
    r_groups: int = 24,
):
    """(state, queries [B, D] replicated, query_ids [B]) → (ids, scores)."""
    kw = dict(k=k, refine=refine, block=block, exclude_self=exclude_self,
              mode=mode, r_groups=r_groups)
    fn = jax.shard_map(
        functools.partial(_local_flat_query, **kw),
        mesh=mesh,
        in_specs=(P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS), P(), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return jax.jit(
        lambda state, q, qi: fn(state.sketch, state.corpus, state.row_ids,
                                q, qi)
    )


class ShardedSparseFlatState(NamedTuple):
    sketch: jax.Array     # int8 [ndev*Nloc, size_pad], row-sharded
    c_idx: jax.Array      # i32  [ndev*Nloc, NNZ], row-sharded (exact tier)
    c_val: jax.Array      # f32  [ndev*Nloc, NNZ], row-sharded
    row_ids: jax.Array    # i32  [ndev*Nloc], row-sharded (-1 = pad)


def fit_sparse_flat_sharded(
    batch,                           # vectors.SparseBatch
    mesh: Optional[Mesh] = None,
) -> Tuple[ShardedSparseFlatState, Mesh]:
    """Shard the sparse flat engine (`ops.flat.SparseFlatIndex`) over the
    mesh: the padded-COO exact tier and the densified int8 sketch are
    row-sharded; densification runs SPMD inside shard_map so the f32 dense
    intermediate never exceeds one shard's chunk on any device. The int8
    scale is global (per-shard scales would corrupt the merged ranking)."""
    from ..ops.rerank import check_sparse_size_for_merge

    mesh = mesh or make_forest_mesh()
    check_sparse_size_for_merge(int(batch.size))
    ndev = mesh.shape[SHARD_AXIS]
    n, nnz = batch.indices.shape
    nloc = int(np.ceil(n / ndev))
    npad = nloc * ndev
    idx = np.zeros((npad, nnz), dtype=np.int32)
    val = np.zeros((npad, nnz), dtype=np.float32)
    rid = np.full((npad,), -1, dtype=np.int32)
    idx[:n] = batch.indices
    val[:n] = batch.values
    rid[:n] = batch.ids
    scale = 127.0 / max(float(np.max(np.abs(batch.values))), 1e-30)

    shard = NamedSharding(mesh, P(SHARD_AXIS))
    idx_d = jax.device_put(idx, shard)
    val_d = jax.device_put(val, shard)
    rid_d = jax.device_put(rid, shard)

    densify = jax.jit(
        jax.shard_map(
            lambda ic, vc: _densify_quantize(
                ic, vc, jnp.float32(scale), int(batch.size),
                chunk=min(65536, nloc),
            ),
            mesh=mesh,
            in_specs=(P(SHARD_AXIS), P(SHARD_AXIS)),
            out_specs=P(SHARD_AXIS),
        )
    )
    sketch = densify(idx_d, val_d)
    return (
        ShardedSparseFlatState(
            sketch=sketch, c_idx=idx_d, c_val=val_d, row_ids=rid_d
        ),
        mesh,
    )


def fit_sparse_flat_sharded_distributed(
    local_batch,                     # vectors.SparseBatch (host-local rows)
    mesh: Optional[Mesh] = None,
) -> Tuple[ShardedSparseFlatState, Mesh]:
    """Multi-process sparse flat fit: host-local padded-COO rows per
    process; the densified int8 sketch is built SPMD per shard so neither
    the dense intermediate nor the global COO ever exist on one host."""
    from ..ops.rerank import check_sparse_size_for_merge

    mesh = mesh or make_forest_mesh()
    check_sparse_size_for_merge(int(local_batch.size))
    my_proc = jax.process_index()
    ndev_local = sum(
        1 for d in mesh.devices.flat if d.process_index == my_proc
    )
    if ndev_local == 0:
        raise ValueError(f"process {my_proc} owns no devices of the mesh")
    n, nnz = local_batch.indices.shape
    nloc, amax = _global_nloc_and_amax(
        n, float(np.max(np.abs(local_batch.values))) if n else 0.0,
        ndev_local,
    )
    scale = 127.0 / max(amax, 1e-30)
    idx = np.zeros((ndev_local, nloc, nnz), dtype=np.int32)
    val = np.zeros((ndev_local, nloc, nnz), dtype=np.float32)
    rid = np.full((ndev_local, nloc), -1, dtype=np.int32)
    idx.reshape(ndev_local * nloc, nnz)[:n] = local_batch.indices
    val.reshape(ndev_local * nloc, nnz)[:n] = local_batch.values
    rid.reshape(ndev_local * nloc)[:n] = local_batch.ids
    idx_d, val_d, rid_d = _distributed_rows(mesh, [idx, val, rid], nloc)
    densify = jax.jit(
        jax.shard_map(
            lambda ic, vc: _densify_quantize(
                ic, vc, jnp.float32(scale), int(local_batch.size),
                chunk=min(65536, nloc),
            ),
            mesh=mesh,
            in_specs=(P(SHARD_AXIS), P(SHARD_AXIS)),
            out_specs=P(SHARD_AXIS),
        )
    )
    sketch = densify(idx_d, val_d)
    return (
        ShardedSparseFlatState(
            sketch=sketch, c_idx=idx_d, c_val=val_d, row_ids=rid_d
        ),
        mesh,
    )


def _local_sparse_flat_query(sketch, c_idx, c_val, row_ids, q_idx, q_val,
                             query_ids, *, k, refine, r_groups,
                             exclude_self):
    ids, scores = flat_topk_sparse(
        sketch, c_idx, c_val, row_ids, q_idx, q_val, query_ids, k,
        refine=refine, r_groups=r_groups, exclude_self=exclude_self,
    )
    return _gather_merge_topk(ids, scores, k)


def make_sparse_flat_query_fn(
    mesh: Mesh,
    k: int = 10,
    refine: int = 128,
    r_groups: int = 24,
    exclude_self: bool = True,
):
    """(state, q_idx [B, NNZq] replicated, q_val, query_ids) →
    (ids, scores) — the sparse mirror of `make_flat_query_fn`
    (`SparsevectorRDFInit.scala:51-553` is the reference's mirrored sparse
    surface)."""
    fn = jax.shard_map(
        functools.partial(
            _local_sparse_flat_query, k=k, refine=refine,
            r_groups=max(r_groups, 3 * k), exclude_self=exclude_self,
        ),
        mesh=mesh,
        in_specs=(P(SHARD_AXIS),) * 4 + (P(), P(), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return jax.jit(
        lambda state, qi, qv, qids: fn(
            state.sketch, state.c_idx, state.c_val, state.row_ids,
            qi, qv, qids,
        )
    )


class ShardedSparseFlatIndex:
    """Host orchestrator for the mesh-sharded sparse flat engine (same
    query surface as `ops.flat.SparseFlatIndex`)."""

    def __init__(self, mesh: Optional[Mesh] = None, refine: int = 128,
                 r_groups: int = 24):
        self.mesh = mesh
        self.refine = refine
        self.r_groups = r_groups
        self.state = None
        self._qfn = {}

    def fit(self, batch) -> "ShardedSparseFlatIndex":
        self.state, self.mesh = fit_sparse_flat_sharded(batch, self.mesh)
        return self

    def query(self, q_indices: np.ndarray, q_values: np.ndarray,
              k: int = 10, query_ids: Optional[np.ndarray] = None,
              exclude_self: bool = True) -> Tuple[np.ndarray, np.ndarray]:
        if self.state is None:
            print("need to fit the data first")
            kk = max(k, 1)
            return (np.full((len(q_indices), kk), -1, np.int32),
                    np.full((len(q_indices), kk), -np.inf, np.float32))
        key = (k, exclude_self)
        if key not in self._qfn:
            self._qfn[key] = make_sparse_flat_query_fn(
                self.mesh, k=k, refine=self.refine, r_groups=self.r_groups,
                exclude_self=exclude_self,
            )
        qi = jnp.asarray(np.asarray(q_indices, np.int32))
        qv = jnp.asarray(np.asarray(q_values, np.float32))
        qids = (jnp.asarray(np.asarray(query_ids, np.int32))
                if query_ids is not None
                else jnp.full((len(q_indices),), -1, jnp.int32))
        ids, scores = self._qfn[key](self.state, qi, qv, qids)
        return np.asarray(ids), np.asarray(scores)


class ShardedFlatIndex:
    """Host orchestrator for the mesh-sharded flat engine."""

    def __init__(self, mesh: Optional[Mesh] = None,
                 sketch_dtype: str = "int8", refine: int = 128,
                 block: int = 1 << 15, mode: str = "grouped",
                 r_groups: int = 24):
        self.mesh = mesh
        self.sketch_dtype = sketch_dtype
        self.refine = refine
        self.block = block
        self.mode = mode            # "grouped" (per-device fast path) | "scan"
        self.r_groups = r_groups
        self.state = None
        self._qfn = {}

    def fit(self, batch) -> "ShardedFlatIndex":
        self.state, self.mesh = fit_flat_sharded(
            np.asarray(batch.values, np.float32),
            np.asarray(batch.ids, np.int32),
            self.mesh, self.sketch_dtype,
        )
        self._qfn = {}
        return self

    def query(self, queries: np.ndarray, k: int = 10,
              query_ids: Optional[np.ndarray] = None,
              exclude_self: bool = True) -> Tuple[np.ndarray, np.ndarray]:
        if self.state is None:
            print("need to fit the data first")
            kk = max(k, 1)
            return (np.full((len(queries), kk), -1, np.int32),
                    np.full((len(queries), kk), -np.inf, np.float32))
        key = (k, exclude_self, self.mode)
        if key not in self._qfn:
            self._qfn[key] = make_flat_query_fn(
                self.mesh, k=k, refine=self.refine, block=self.block,
                exclude_self=exclude_self, mode=self.mode,
                r_groups=self.r_groups,
            )
        q = jnp.asarray(np.asarray(queries, np.float32))
        qids = (jnp.asarray(np.asarray(query_ids, np.int32))
                if query_ids is not None
                else jnp.full((len(queries),), -1, jnp.int32))
        ids, scores = self._qfn[key](self.state, q, qids)
        return np.asarray(ids), np.asarray(scores)
