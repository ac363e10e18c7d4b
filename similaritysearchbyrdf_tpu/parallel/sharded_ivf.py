"""Mesh-sharded clustered-flat (IVF) engine: P7 distribution for `ops/ivf.py`.

Design (the distributed-IVF classic, recast for a JAX mesh):

  k-means  GLOBAL spherical Lloyd over row-sharded corpus: each shard
           assigns its rows against replicated centroids (chunked
           matmuls) and contributes one-hot partial sums; `psum` over the
           shard axis merges them — one shard_map program per iteration,
           no scatters, no host round-trips inside an iteration.
  layout   every shard lays ITS OWN rows out cluster-ordered (8-aligned
           per-cluster ranges over the GLOBAL cluster ids), so cluster c
           is one contiguous window range on every shard.
  query    centroids are replicated: every shard selects the same top
           `nprobe` clusters (a tiny [B, K] matmul), window-scans its local
           portion of them, exact-refines locally, and the only collective
           is the usual all-gather top-k merge (exact f32 scores are
           comparable across shards; the int8 sketch is only used for
           WITHIN-shard preselection, so per-shard scales would still be
           correct — a global scale is used anyway for uniformity).

Single-process fit here (host holds the corpus, like `fit_flat_sharded`);
the host-local-rows distributed variant follows the
`fit_flat_sharded_distributed` pattern if Deep-100M-scale ingestion needs
it. No reference counterpart (COVERAGE.md divergence #10; distribution
contract mirrors the paper's sub-index scheme, `/root/reference/README.md:5-7`).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.ivf import ivf_topk, ivf_window_budget
from .mesh import SHARD_AXIS, make_forest_mesh
from .sharded_flat import _gather_merge_topk, _pad_to


class ShardedIVFState(NamedTuple):
    sketch: jax.Array      # int8 [ndev, npad_max, Dp], shard axis 0
    corpus: jax.Array      # f32  [ndev, npad_max, Dp], shard axis 0
    row_ids: jax.Array     # i32  [ndev, npad_max], shard axis 0 (-1 = pad)
    centroids: jax.Array   # bf16 [K, Dp], replicated
    starts: jax.Array      # i32  [ndev, K+1], shard axis 0
    ends: jax.Array        # i32  [ndev, K], TRUE per-shard cluster ends
    heads: Optional[jax.Array] = None
    #                        bf16 [ndev, H, Dp] per-shard pooled head tier
    #                        for two-phase window pruning — derived from
    #                        sketch, rebuilt on load (see build_heads_sharded)


def build_heads_sharded(state: ShardedIVFState, mesh: Mesh,
                        head_pool: int) -> ShardedIVFState:
    """Per-shard head tier (ops.ivf.build_ivf_heads under shard_map): every
    shard pools ITS OWN cluster-ordered sketch rows — no collectives; the
    phase-1 prune is a purely shard-local stage of the query."""
    from ..ops.ivf import build_ivf_heads

    fn = jax.jit(jax.shard_map(
        lambda sk, ro: build_ivf_heads(sk[0], ro[0], head_pool)[None],
        mesh=mesh,
        in_specs=(P(SHARD_AXIS), P(SHARD_AXIS)),
        out_specs=P(SHARD_AXIS),
        check_vma=False,
    ))
    return state._replace(heads=fn(state.sketch, state.row_ids))


def _local_kmeans_stats(xc, live, cent, *, chunk):
    """Shard-local Lloyd statistics + psum merge + replicated centroid
    update: returns (new centroids bf16[K, Dp] replicated, local
    assignment i32[nloc]). The update runs INSIDE the mapped program
    (replicated, duplicated per device — tiny) so multi-process fits never
    run eager host ops on distributed arrays. `live` is an EXPLICIT pad
    mask — inferring it from all-zero rows would silently drop genuine
    zero vectors from the index."""
    nloc, dp = xc.shape
    k = cent.shape[0]
    # pad rows (masked dead) up to a chunk multiple — searching for an
    # exact divisor can land on a tiny one (huge [rows, K] score blocks)
    csz = min(chunk, nloc)
    nc = (nloc + csz - 1) // csz
    npl = nc * csz
    if npl != nloc:
        xc = jnp.pad(xc, ((0, npl - nloc), (0, 0)))
        live = jnp.pad(live, (0, npl - nloc))

    def assign_one(xb):
        s = jnp.einsum("nd,kd->nk", xb, cent,
                       preferred_element_type=jnp.float32)
        return jnp.argmax(s, axis=1).astype(jnp.int32)

    assign = jax.lax.map(assign_one, xc.reshape(nc, -1, dp)).reshape(npl)
    assign = jnp.where(live, assign, -1)

    def update_one(carry, args):
        sums, counts = carry
        xb, ab = args
        onehot = (
            ab[:, None] == jnp.arange(k, dtype=jnp.int32)[None, :]
        ).astype(jnp.bfloat16)
        sums = sums + jnp.einsum("nk,nd->kd", onehot, xb,
                                 preferred_element_type=jnp.float32)
        counts = counts + jnp.sum(onehot.astype(jnp.float32), axis=0)
        return (sums, counts), None

    (sums, counts), _ = jax.lax.scan(
        update_one,
        (jnp.zeros((k, dp), jnp.float32), jnp.zeros((k,), jnp.float32)),
        (xc.reshape(nc, -1, dp).astype(jnp.bfloat16),
         assign.reshape(nc, -1)),
    )
    sums = jax.lax.psum(sums, SHARD_AXIS)
    counts = jax.lax.psum(counts, SHARD_AXIS)
    new_c = jnp.where(
        (counts > 0)[:, None],
        sums / jnp.maximum(counts, 1.0)[:, None],
        cent.astype(jnp.float32),
    )
    norm = jnp.linalg.norm(new_c, axis=1, keepdims=True)
    new_c = (new_c / jnp.maximum(norm, 1e-20)).astype(jnp.bfloat16)
    return new_c, assign[:nloc]


def _kmeans_sharded(
    x_d: jax.Array,          # f32[ndev*nloc, Dp] row-sharded
    live_d: jax.Array,       # bool[ndev*nloc] row-sharded pad mask
    mesh: Mesh,
    k: int,
    iters: int,
    seed: int,
    init_cent: np.ndarray,   # f32[K, Dp] host-sampled initial centroids
    chunk: int = 16384,
) -> Tuple[jax.Array, jax.Array]:
    """Global spherical k-means over the mesh. Returns (centroids bf16
    [K, Dp] replicated, assignment i32[ndev*nloc] SHARDED device array;
    -1 pad) — callers pull assignments via `.addressable_shards` so the
    same loop serves single- and multi-process meshes."""
    cent = jnp.asarray(init_cent, jnp.bfloat16)

    step = jax.jit(
        jax.shard_map(
            functools.partial(_local_kmeans_stats, chunk=chunk),
            mesh=mesh,
            in_specs=(P(SHARD_AXIS), P(SHARD_AXIS), P()),
            out_specs=(P(), P(SHARD_AXIS)),
            check_vma=False,
        )
    )
    assign = None
    for _ in range(iters):
        cent, assign = step(x_d, live_d, cent)
    return cent, assign


def _shard_cluster_layout(
    a: np.ndarray, kc: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Cluster-ordered layout for ONE shard's assignment a (-1 = pad row):
    rows of cluster c occupy [starts[c], starts[c]+count_c) of an 8-aligned
    range. Returns (perm i64[tot] source positions (-1 = hole),
    starts i64[kc+1], ends i64[kc] true unpadded cluster ends)."""
    live = a >= 0
    order = np.argsort(np.where(live, a, kc), kind="stable")
    order = order[: int(live.sum())]
    counts = np.bincount(a[live], minlength=kc)
    padded = ((counts + 7) // 8) * 8
    starts = np.zeros(kc + 1, np.int64)
    starts[1:] = np.cumsum(padded)
    perm = np.full(int(starts[-1]), -1, np.int64)
    src = np.zeros(kc + 1, np.int64)
    src[1:] = np.cumsum(counts)
    for c in np.flatnonzero(counts):
        perm[starts[c]: starts[c] + counts[c]] = order[src[c]: src[c + 1]]
    return perm, starts, starts[:-1] + counts


def _fill_shard(perm, starts, rows_src, rid_src, scale, npad_max):
    """Materialize one shard's cluster-ordered arrays →
    (sk int8[npad_max, dp], co f32[npad_max, dp], ro i32[npad_max],
    st i32[kc+1])."""
    dp = rows_src.shape[1]
    sk = np.zeros((npad_max, dp), dtype=np.int8)
    co = np.zeros((npad_max, dp), dtype=np.float32)
    ro = np.full((npad_max,), -1, dtype=np.int32)
    rows = np.where(
        (perm >= 0)[:, None], rows_src[np.maximum(perm, 0)], 0.0
    )
    co[: len(perm)] = rows
    sk[: len(perm)] = np.clip(np.round(rows * scale), -127, 127)
    ro[: len(perm)] = np.where(
        perm >= 0, rid_src[np.maximum(perm, 0)], -1
    )
    return sk, co, ro, np.minimum(starts, npad_max).astype(np.int32)


def fit_ivf_sharded(
    values: np.ndarray,              # f32[N, D]
    ids: np.ndarray,                 # i32[N]
    mesh: Optional[Mesh] = None,
    target_cluster: int = 256,
    iters: int = 6,
    seed: int = 0,
    k_clusters: Optional[int] = None,
) -> Tuple[ShardedIVFState, Mesh]:
    mesh = mesh or make_forest_mesh()
    ndev = mesh.shape[SHARD_AXIS]
    n, d = values.shape
    dp = _pad_to(d, 128)
    nloc = _pad_to(int(np.ceil(n / ndev)), 8)
    npad = nloc * ndev
    x = np.zeros((npad, dp), dtype=np.float32)
    x[:n, :d] = values
    rid = np.full((npad,), -1, dtype=np.int32)
    rid[:n] = ids

    kc = k_clusters or int(np.clip(n // target_cluster, 16, 65536))
    rng = np.random.default_rng(seed ^ 0xC1)
    init_rows = rng.choice(max(n, 1), size=kc, replace=n < kc).astype(np.int32)

    shard = NamedSharding(mesh, P(SHARD_AXIS))
    x_d = jax.device_put(x, shard)
    lv = np.zeros((npad,), bool)
    lv[:n] = True
    centroids, assign_d = _kmeans_sharded(
        x_d, jax.device_put(lv, shard), mesh, kc, iters, seed, x[init_rows],
        chunk=min(16384, nloc),
    )

    # per-shard cluster-ordered layout over GLOBAL cluster ids (host-side
    # integer work, one pass per shard)
    a2 = np.asarray(assign_d).reshape(ndev, nloc)
    scale = 127.0 / max(float(np.max(np.abs(values))) if n else 0.0, 1e-30)
    layouts = [_shard_cluster_layout(a2[s], kc) for s in range(ndev)]
    npad_max = _pad_to(
        max(max((int(st[-1]) for _, st, _ in layouts)), 8), 8
    )

    sk = np.zeros((ndev, npad_max, dp), dtype=np.int8)
    co = np.zeros((ndev, npad_max, dp), dtype=np.float32)
    ro = np.full((ndev, npad_max), -1, dtype=np.int32)
    st = np.zeros((ndev, kc + 1), dtype=np.int32)
    en = np.zeros((ndev, kc), dtype=np.int32)
    for s, (perm, starts, ends) in enumerate(layouts):
        sk[s], co[s], ro[s], st[s] = _fill_shard(
            perm, starts, x[s * nloc: (s + 1) * nloc],
            rid[s * nloc: (s + 1) * nloc], scale, npad_max,
        )
        en[s] = np.minimum(ends, npad_max).astype(np.int32)

    state = ShardedIVFState(
        sketch=jax.device_put(sk, shard),
        corpus=jax.device_put(co, shard),
        row_ids=jax.device_put(ro, shard),
        centroids=centroids,
        starts=jax.device_put(st, shard),
        ends=jax.device_put(en, shard),
    )
    return state, mesh


def fit_ivf_sharded_distributed(
    local_values: np.ndarray,        # f32[n_local, D] THIS process's rows
    local_ids: np.ndarray,           # i32[n_local]
    mesh: Optional[Mesh] = None,
    target_cluster: int = 256,
    iters: int = 6,
    seed: int = 0,
    k_clusters: Optional[int] = None,
) -> Tuple[ShardedIVFState, Mesh]:
    """Multi-process IVF fit: every process supplies only its host-local
    rows (the Deep-100M contract — the global corpus never exists on any
    single host). k-means is the SAME psum-merged global loop; each
    process then lays out only its own devices' shards, agreeing on the
    global quantization scale, cluster count, and per-shard capacity via
    tiny allgathers."""
    from .sharded_flat import _global_nloc_and_amax

    mesh = mesh or make_forest_mesh()
    my_proc = jax.process_index()
    local_devs = [d for d in mesh.devices.flat if d.process_index == my_proc]
    if not local_devs:
        raise ValueError(f"process {my_proc} owns no devices of the mesh")
    ndev_local = len(local_devs)
    ndev = mesh.shape[SHARD_AXIS]
    n, d = local_values.shape
    nloc, amax = _global_nloc_and_amax(
        n, float(np.max(np.abs(local_values))) if n else 0.0, ndev_local
    )
    dp = _pad_to(d, 128)
    x = np.zeros((ndev_local, nloc, dp), dtype=np.float32)
    x.reshape(ndev_local * nloc, dp)[:n, :d] = local_values
    rid = np.full((ndev_local, nloc), -1, dtype=np.int32)
    rid.reshape(ndev_local * nloc)[:n] = local_ids
    shard = NamedSharding(mesh, P(SHARD_AXIS))
    x_d = jax.make_array_from_single_device_arrays(
        (ndev * nloc, dp), shard,
        [jax.device_put(x[i], dev) for i, dev in enumerate(local_devs)],
    )
    lv = np.zeros((ndev_local, nloc), bool)
    lv.reshape(ndev_local * nloc)[:n] = True
    live_d = jax.make_array_from_single_device_arrays(
        (ndev * nloc,), shard,
        [jax.device_put(lv[i], dev) for i, dev in enumerate(local_devs)],
    )

    nproc = jax.process_count()
    n_glob = n
    if nproc > 1:
        from jax.experimental import multihost_utils

        n_glob = int(multihost_utils.process_allgather(
            np.asarray([n], np.int64)).sum())
    kc = k_clusters or int(np.clip(n_glob // target_cluster, 16, 65536))

    # init centroids: each process contributes an equal host-local sample
    rng = np.random.default_rng(seed ^ 0xC1)
    per = int(np.ceil(kc / nproc))
    rows_local = x.reshape(ndev_local * nloc, dp)
    pick = rng.choice(max(n, 1), size=per, replace=n < per)
    mine = rows_local[np.minimum(pick, max(n - 1, 0))]
    if nproc > 1:
        init = multihost_utils.process_allgather(mine).reshape(-1, dp)[:kc]
    else:
        init = mine[:kc]

    centroids, assign_d = _kmeans_sharded(
        x_d, live_d, mesh, kc, iters, seed, init, chunk=min(16384, nloc),
    )
    # this process's shard assignments, keyed by device (shard order is
    # not guaranteed to match local_devs order)
    by_dev = {s.device: np.asarray(s.data)
              for s in assign_d.addressable_shards}
    a_locals = [by_dev[dev] for dev in local_devs]

    layouts = [_shard_cluster_layout(a, kc) for a in a_locals]
    tot_max = max(max((int(st[-1]) for _, st, _ in layouts)), 8)
    if nproc > 1:
        tot_max = int(multihost_utils.process_allgather(
            np.asarray([tot_max], np.int64)).max())
    npad_max = _pad_to(tot_max, 8)
    scale = 127.0 / max(amax, 1e-30)

    sk = np.zeros((ndev_local, npad_max, dp), dtype=np.int8)
    co = np.zeros((ndev_local, npad_max, dp), dtype=np.float32)
    ro = np.full((ndev_local, npad_max), -1, dtype=np.int32)
    st = np.zeros((ndev_local, kc + 1), dtype=np.int32)
    en = np.zeros((ndev_local, kc), dtype=np.int32)
    for i, (perm, starts, ends) in enumerate(layouts):
        sk[i], co[i], ro[i], st[i] = _fill_shard(
            perm, starts, x[i], rid[i], scale, npad_max,
        )
        en[i] = np.minimum(ends, npad_max).astype(np.int32)

    def stack(a):
        gshape = (ndev,) + a.shape[1:]
        return jax.make_array_from_single_device_arrays(
            gshape, shard,
            [jax.device_put(a[i: i + 1], dev)
             for i, dev in enumerate(local_devs)],
        )

    state = ShardedIVFState(
        sketch=stack(sk), corpus=stack(co), row_ids=stack(ro),
        centroids=centroids, starts=stack(st), ends=stack(en),
    )
    return state, mesh


def ivf_window_budget_sharded(
    state: ShardedIVFState, nprobe: int, win: int, cap: int = 4096
) -> int:
    """Global window budget for the sharded engine: the max of every
    shard's `ivf_window_budget` (clusters have different lengths per
    shard; the budget is a STATIC shape so all shards must share the
    worst case). Multi-process safe — allgathers the per-process max."""
    st_by = {s.device: np.asarray(s.data)
             for s in state.starts.addressable_shards}
    en_by = {s.device: np.asarray(s.data)
             for s in state.ends.addressable_shards}
    wb = max(
        ivf_window_budget(st_by[d], en_by[d], nprobe, win, cap)
        for d in st_by
    )
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        wb = int(multihost_utils.process_allgather(
            np.asarray([wb], np.int64)).max())
    return wb


def _local_ivf_query(sketch, corpus, row_ids, starts, ends, centroids,
                     queries, query_ids, heads=None, *, k, nprobe, win, wb,
                     refine, exclude_self, head_pool=0, keep=0):
    if wb is None:
        # safe fallback: enough windows to cover the ENTIRE local shard,
        # plus one round-up window per cluster (probed clusters occupy a
        # whole number of windows each) — fine at test/dryrun scale;
        # production callers pass ivf_window_budget_sharded(state, nprobe,
        # win)
        wb = max((sketch.shape[1] + win - 1) // win
                 + centroids.shape[0], 1)
    ids, scores = ivf_topk(
        sketch[0], corpus[0], row_ids[0], centroids, starts[0], ends[0],
        queries, query_ids, k, nprobe=nprobe, win=win, wb=wb,
        refine=refine, exclude_self=exclude_self,
        heads=None if heads is None else heads[0],
        head_pool=head_pool, keep=keep,
    )
    return _gather_merge_topk(ids, scores, k)


def make_ivf_query_fn(
    mesh: Mesh,
    k: int = 10,
    nprobe: int = 32,
    win: int = 64,
    wb: Optional[int] = None,
    refine: int = 128,
    exclude_self: bool = True,
    head_pool: int = 0,
    keep: int = 0,
):
    """(state, queries [B, D] replicated, query_ids [B]) → (ids, scores).
    Every shard probes the same globally-selected clusters (replicated
    centroids) over its local rows; one all-gather merges the exact top-k.
    `wb=None` falls back to whole-shard window coverage (safe, test-scale
    only); at scale pass `ivf_window_budget_sharded(state, nprobe, win)`.
    head_pool/keep > 0 enables the shard-local two-phase window prune
    (state.heads must be built — `build_heads_sharded`)."""
    prune = head_pool > 0 and keep > 0
    fn = jax.shard_map(
        functools.partial(
            _local_ivf_query, k=k, nprobe=nprobe, win=win,
            wb=wb, refine=refine, exclude_self=exclude_self,
            head_pool=head_pool, keep=keep,
        ),
        mesh=mesh,
        in_specs=(P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS),
                  P(SHARD_AXIS), P(SHARD_AXIS), P(), P(), P())
        + ((P(SHARD_AXIS),) if prune else ()),
        out_specs=(P(), P()),
        check_vma=False,
    )
    if prune:
        return jax.jit(
            lambda state, q, qi: fn(
                state.sketch, state.corpus, state.row_ids, state.starts,
                state.ends, state.centroids, q, qi, state.heads,
            )
        )
    return jax.jit(
        lambda state, q, qi: fn(
            state.sketch, state.corpus, state.row_ids, state.starts,
            state.ends, state.centroids, q, qi,
        )
    )


class ShardedIVFIndex:
    """Host orchestrator for the mesh-sharded clustered-flat engine (same
    query surface as `ops.ivf.IVFFlatIndex`; `nprobe` is the recall knob)."""

    def __init__(self, mesh: Optional[Mesh] = None,
                 target_cluster: int = 256, nprobe: int = 32, win: int = 64,
                 refine: int = 128, iters: int = 6, seed: int = 0,
                 wb: Optional[int] = None,
                 head_pool: int = 0, keep: int = 0):
        self.mesh = mesh
        self.target_cluster = target_cluster
        self.nprobe = nprobe
        self.win = win
        self.refine = refine
        self.iters = iters
        self.seed = seed
        self.wb = wb          # None = exact budget (see IVFFlatIndex.wb)
        # two-phase window pruning (see ops.ivf.IVFFlatIndex): head_pool
        # rows per pooled head row (must divide win), keep surviving
        # windows per query per SHARD (0 = single-phase)
        self.head_pool = head_pool
        self.keep = keep
        self.state: Optional[ShardedIVFState] = None
        self._qfn = {}

    def fit(self, batch) -> "ShardedIVFIndex":
        self.state, self.mesh = fit_ivf_sharded(
            np.asarray(batch.values, np.float32),
            np.asarray(batch.ids, np.int32),
            self.mesh, target_cluster=self.target_cluster,
            iters=self.iters, seed=self.seed,
        )
        self.ensure_heads()
        return self

    def ensure_heads(self) -> None:
        """Build the derived per-shard head tier when pruning is configured
        (called by fit and the load path; heads are never persisted)."""
        if self.state is None or not self.head_pool:
            return
        self.state = build_heads_sharded(self.state, self.mesh,
                                         self.head_pool)

    def query(self, queries: np.ndarray, k: int = 10,
              query_ids: Optional[np.ndarray] = None,
              exclude_self: bool = True,
              nprobe: Optional[int] = None,
              keep: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        if self.state is None:
            print("need to fit the data first")
            kk = max(k, 1)
            return (np.full((len(queries), kk), -1, np.int32),
                    np.full((len(queries), kk), -np.inf, np.float32))
        npb = min(nprobe or self.nprobe, int(self.state.centroids.shape[0]))
        wb = self.wb or ivf_window_budget_sharded(self.state, npb, self.win)
        kp = self.keep if keep is None else keep
        if self.state.heads is None or not self.head_pool:
            kp = 0
        key = (k, npb, exclude_self, wb, kp)
        if key not in self._qfn:
            self._qfn[key] = make_ivf_query_fn(
                self.mesh, k=k, nprobe=npb, win=self.win, wb=wb,
                refine=self.refine, exclude_self=exclude_self,
                head_pool=self.head_pool if kp else 0, keep=kp,
            )
        q = jnp.asarray(np.asarray(queries, np.float32))
        qids = (jnp.asarray(np.asarray(query_ids, np.int32))
                if query_ids is not None
                else jnp.full((len(queries),), -1, jnp.int32))
        ids, scores = self._qfn[key](self.state, q, qids)
        return np.asarray(ids), np.asarray(scores)
