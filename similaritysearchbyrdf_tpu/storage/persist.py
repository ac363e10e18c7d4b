"""Index persistence: save/load + tiered generations with Bloom gating.

The reference persists in two layers (SURVEY.md §5 checkpoint/resume):
  1. the hash functions (its "model") as text files — covered by
     `models.families.save_model_file/load_model_file`;
  2. per-partition RAM→SSD spills into timestamped append-only stores with a
     recid index and Bloom summary (`runPersistTask`,
     `RandomDrawTreeMap.java:2713-2755`) — which are write-only: no path
     loads them in a fresh process.

Here the whole forest state (hash params + bucket CSR + corpus) serializes
to one npz + config JSON, making builds genuinely resumable — and
:class:`GenerationStore` reproduces the *tiered* behavior: spill the current
device index to a timestamped generation on disk, keep a Bloom summary of
its vector ids, and let queries merge the device tier with any generation
whose summary might contain relevant ids.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import List, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from ..config import RDFConfig
from ..index.bucket_table import BucketTables
from ..index.forest import ForestState, RDFForest
from ..models.families import HashModel
from .bloom import BloomFilter


# ---------------------------------------------------------------------------
# Whole-forest save / load
# ---------------------------------------------------------------------------


_WRAP_MAGIC = b"RDFX"


def save_forest(forest: RDFForest, path: str, compress: bool = True,
                password: "bytes | None" = None,
                checksum: bool = False) -> None:
    """Serialize config + model + tables + corpus to `<path>.npz` /
    `<path>.json`.

    `compress` mirrors the reference store's optional per-record LZF
    compression (`Store.java:26-60`, a constructor flag there): True (the
    default) writes a deflate-compressed npz; False writes a raw npz —
    ~3-4x larger on typical float corpora but markedly faster to write,
    the right trade for short-lived spill generations on fast local disk.
    `load_forest` reads either transparently (npz records the encoding
    per member).

    `password` / `checksum` mirror the store's XTEA-encryption and CRC32
    flags (`Store.java:296-316`, `EncryptionXTEA.java`): the npz byte
    stream is wrapped by `storage.crypto.wrap_record` and written with a
    RDFX feature header; `load_forest` must be called with matching
    options (mismatches raise `WrongConfigError`, the reference's
    WrongConfig contract, `Store.java:150-174`)."""
    assert forest.state is not None, "nothing to save: fit first"
    s = forest.state
    arrays = dict(
        proj=np.asarray(s.model.proj),
        perm=np.asarray(s.model.perm),
        b=np.asarray(s.model.b),
        sampling_perm=np.asarray(s.model.sampling_perm),
        part_proj=np.asarray(s.part_proj),
        sorted_keys=np.asarray(s.tables.sorted_keys),
        sorted_ids=np.asarray(s.tables.sorted_ids),
        bucket_keys=np.asarray(s.tables.bucket_keys),
        bucket_starts=np.asarray(s.tables.bucket_starts),
        bucket_shifts=np.asarray(s.tables.bucket_shifts),
        corpus=np.asarray(s.corpus).astype(np.float32),
        row_ids=np.asarray(s.row_ids),
    )
    if s.coarse_proj is not None:
        # persist the coarse projection: reloading it (instead of
        # recomputing, which for proj_mode="pca" is only bit-deterministic
        # on the fitting backend) keeps the rebuilt tier identical to the
        # fitted one and skips the O(N*d^2) moment recompute at load
        arrays["coarse_proj"] = np.asarray(s.coarse_proj)
    if password is not None or checksum:
        import io

        from .crypto import wrap_record

        buf = io.BytesIO()
        (np.savez_compressed if compress else np.savez)(buf, **arrays)
        flags = (1 if password is not None else 0) | (2 if checksum else 0)
        with open(path + ".npz", "wb") as f:
            f.write(_WRAP_MAGIC + bytes([flags])
                    + wrap_record(buf.getvalue(), password=password,
                                  checksum=checksum))
    else:
        (np.savez_compressed if compress else np.savez)(path + ".npz",
                                                        **arrays)
    meta = dict(
        config=json.loads(forest.conf.to_json()),
        family=s.model.family,
        w=s.model.w,
        type_of_index=s.model.type_of_index,
        version=1,
    )
    with open(path + ".json", "w") as f:
        json.dump(meta, f)


def load_forest(path: str, password: "bytes | None" = None,
                checksum: bool = False) -> RDFForest:
    with open(path + ".json") as f:
        meta = json.load(f)
    conf = RDFConfig.from_json(json.dumps(meta["config"]))
    with open(path + ".npz", "rb") as f:
        head = f.read(5)
        if head[:4] == _WRAP_MAGIC:
            import io

            from .crypto import WrongConfigError, unwrap_record

            flags = head[4]
            if bool(flags & 1) != (password is not None):
                raise WrongConfigError(
                    "store was %screated with encryption; password %s"
                    % ("" if flags & 1 else "not ",
                       "missing" if flags & 1 else "given"))
            if bool(flags & 2) != checksum:
                raise WrongConfigError(
                    "store was %screated with CRC32 checksum"
                    % ("" if flags & 2 else "not "))
            z = np.load(io.BytesIO(unwrap_record(
                f.read(), password=password, checksum=checksum)),
                allow_pickle=False)
        else:
            if password is not None or checksum:
                from .crypto import WrongConfigError

                raise WrongConfigError(
                    "password/checksum given, but store is not wrapped")
            z = np.load(path + ".npz")
    model = HashModel(
        proj=jnp.asarray(z["proj"]),
        perm=jnp.asarray(z["perm"]),
        b=jnp.asarray(z["b"]),
        sampling_perm=jnp.asarray(z["sampling_perm"]),
        family=meta["family"],
        w=meta["w"],
        type_of_index=meta["type_of_index"],
    )
    from ..index.bucket_table import _build_records

    bkeys = jnp.asarray(z["bucket_keys"])
    bstarts = jnp.asarray(z["bucket_starts"])
    bshifts = jnp.asarray(z["bucket_shifts"])
    sorted_ids = z["sorted_ids"]
    if sorted_ids.shape[1] == z["sorted_keys"].shape[1]:
        # pre-ID_PAD save: append the trailing -1 pad the block gather needs
        from ..index.bucket_table import ID_PAD

        sorted_ids = np.concatenate(
            [sorted_ids,
             np.full((sorted_ids.shape[0], ID_PAD), -1, np.int32)], axis=1)
    tables = BucketTables(
        sorted_keys=jnp.asarray(z["sorted_keys"]),
        sorted_ids=jnp.asarray(sorted_ids),
        bucket_keys=bkeys,
        bucket_starts=bstarts,
        bucket_shifts=bshifts,
        # packed records are derived data: rebuilt, not serialized
        records=_build_records(bkeys, bstarts, bshifts),
    )
    corpus = jnp.asarray(z["corpus"])
    dpad = int(np.ceil(corpus.shape[1] / 128.0) * 128)
    if dpad != corpus.shape[1]:       # legacy unpadded save: pad on load
        corpus = jnp.pad(corpus, ((0, 0), (0, dpad - corpus.shape[1])))
    # the coarse tier (and its pooled-head tier) is DERIVED data — seeded
    # projection over the saved corpus in the saved sort order — so it is
    # rebuilt rather than serialized (like `records`), keeping checkpoints
    # at corpus + CSR size while loads land on the same query path that a
    # fresh fit would take
    coarse_proj = coarse_by_table = coarse_head = coarse_folded = None
    if conf.coarse_dim:
        from ..index.forest import (
            _build_coarse_tier,
            _build_folded_tier,
            build_head_tier,
            ids128_view,
        )

        # saved projection (if present): guarantees the rebuilt tier
        # matches the fitted one even across backends (pca projections
        # depend on backend matmul precision); legacy saves recompute
        saved_proj = z["coarse_proj"] if "coarse_proj" in z.files else None
        if conf.coarse_layout == "folded":
            coarse_proj, coarse_folded = _build_folded_tier(
                corpus, tables.sorted_ids, conf.coarse_dim,
                conf.coarse_dtype, conf.seed, dim=conf.vector_dim,
                proj_mode=conf.coarse_proj_mode, proj=saved_proj,
            )
        else:
            coarse_proj, coarse_by_table = _build_coarse_tier(
                corpus, tables.sorted_ids, conf.coarse_dim,
                conf.coarse_dtype, conf.seed, dim=conf.vector_dim,
                proj_mode=conf.coarse_proj_mode, proj=saved_proj,
            )
            if conf.coarse_head_pool:
                coarse_head = build_head_tier(
                    coarse_by_table, tables.sorted_ids,
                    conf.coarse_head_pool,
                    groups=max(1, 128 // coarse_proj.shape[1]),
                )
    state = ForestState(
        model=model,
        part_proj=jnp.asarray(z["part_proj"]),
        tables=tables,
        corpus=corpus,
        row_ids=jnp.asarray(z["row_ids"]),
        corpus_lp=(
            corpus.astype(jnp.bfloat16)
            if conf.rerank_dtype == "bfloat16"
            else None
        ),
        coarse_proj=coarse_proj,
        coarse_by_table=coarse_by_table,
        coarse_head=coarse_head,
        coarse_folded=coarse_folded,
        ids128=(None if coarse_folded is None
                else ids128_view(tables.sorted_ids)),
    )
    forest = RDFForest(conf, model=model)
    forest.part_proj = state.part_proj
    forest.state = state
    return forest


# ---------------------------------------------------------------------------
# Tiered generations (HBM tier + spilled disk generations)
# ---------------------------------------------------------------------------


def forest_state_bytes(state: ForestState) -> int:
    """Device bytes held by a fitted forest (corpus + index + model) — the
    `getCurrSize()` equivalent the reference compares against ramThreshold
    (`RandomDrawTreeMap.java:1114,1136`)."""
    total = 0
    for arr in (
        state.corpus, state.corpus_lp, state.row_ids, state.part_proj,
        state.model.proj, state.model.perm, state.model.b,
        state.model.sampling_perm,
        state.tables.sorted_keys, state.tables.sorted_ids,
        state.tables.bucket_keys, state.tables.bucket_starts,
        state.tables.bucket_shifts, state.tables.records,
    ):
        if arr is not None:
            total += int(np.prod(arr.shape)) * arr.dtype.itemsize
    return total


def model_fingerprint(model: HashModel) -> bytes:
    """Deterministic 16-byte identity of a hash model (projection tensors +
    scalar params). Two forests agree on bucket keys for every vector iff
    their fingerprints match — the soundness condition for gating one
    tier's generations with probe keys computed from another's model."""
    import hashlib

    h = hashlib.sha256()
    for arr in (model.proj, model.perm, model.b, model.sampling_perm):
        a = np.asarray(arr)
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    h.update(f"{model.family}|{model.w}|{model.type_of_index}".encode())
    return h.digest()[:16]


class GenerationStore:
    """Timestamped spill generations under `working_dir/name/`, each with a
    Bloom summary of its vector ids — the array-era `StoreAppend` +
    `<ts>-summary` layout (`RandomDrawTreeMap.java:2731-2736`, bloom fpr
    0.001 at `:2764-2773`).

    Loaded generations stay RESIDENT in an LRU keyed by device bytes
    (`cache_bytes` budget): repeated queries re-use the uploaded arrays
    instead of re-reading every npz from disk per call. `disk_loads` counts
    actual npz reads (observability + the zero-reread test contract)."""

    def __init__(
        self,
        working_dir: str,
        name: str = "forest",
        cache_bytes: int = 8 << 30,
        compress: bool = True,
    ) -> None:
        self.dir = os.path.join(working_dir, name)
        os.makedirs(self.dir, exist_ok=True)
        self.cache_bytes = cache_bytes
        # per-store compression knob, like the reference Store's optional
        # LZF (`Store.java:26-60`): False trades disk bytes for spill speed
        self.compress = compress
        self.disk_loads = 0
        self._cache: "dict[str, RDFForest]" = {}
        self._lru: List[str] = []            # least-recent first
        # stem -> (bucket_keys, bucket_shifts, model_fp | None)
        self._key_summaries: "dict[str, tuple]" = {}

    def generations(self) -> List[str]:
        out = []
        for fn in sorted(os.listdir(self.dir)):
            if fn.endswith(".json"):
                out.append(os.path.join(self.dir, fn[: -len(".json")]))
        return out

    def spill(self, forest: RDFForest) -> str:
        """Persist the forest's current state as a new generation and return
        its path stem. (The reference then re-inits the RAM partition; the
        caller decides whether to keep or drop the device tier.)

        Two data summaries are written alongside the payload — the array-era
        `generateDataSummary` (`RandomDrawTreeMap.java:2764-2773`):
          * `-summary.npz`   — Bloom filter over vector ids (gates `get`)
          * `-keysummary.npz`— the generation's bucket boundaries
            (bucket_keys/bucket_shifts, ~KBs), an EXACT summary that gates
            similarity queries: a generation none of whose buckets any probe
            key can land in is never opened (`testInDataSummary`,
            `RandomDrawTreeMap.java:926-938,771-783`).
        """
        assert forest.state is not None
        ts = int(time.time() * 1000)
        stem = os.path.join(self.dir, str(ts))
        save_forest(forest, stem, compress=self.compress)
        ids = np.asarray(forest.state.row_ids)
        ids = ids[ids >= 0]
        bloom = BloomFilter.build(len(ids), fpr=0.001)
        bloom.add(ids.astype(np.uint32))
        np.savez_compressed(
            stem + "-summary.npz", bits=bloom.bits,
            num_hashes=np.int32(bloom.num_hashes),
        )
        np.savez_compressed(
            stem + "-keysummary.npz",
            bucket_keys=np.asarray(forest.state.tables.bucket_keys),
            bucket_shifts=np.asarray(forest.state.tables.bucket_shifts),
            model_fp=np.frombuffer(
                model_fingerprint(forest.state.model), dtype=np.uint8),
        )
        return stem

    def summary(self, stem: str) -> BloomFilter:
        z = np.load(stem + "-summary.npz")
        return BloomFilter(z["bits"], int(z["num_hashes"]))

    def key_summary(
        self, stem: str
    ) -> Optional[Tuple[np.ndarray, np.ndarray, Optional[bytes]]]:
        """(bucket_keys u32[L, NB], bucket_shifts u32[L, NB], model_fp) of a
        generation, or None for legacy spills without the sidecar (which
        must then be treated as might-match). `model_fp` identifies the hash
        model the boundaries were built under (None for pre-fp sidecars) —
        gating with probe keys from a DIFFERENT model would be unsound.
        Host-cached: the sidecar is tiny compared to the payload npz."""
        cached = self._key_summaries.get(stem)
        if cached is not None:
            return cached
        path = stem + "-keysummary.npz"
        if not os.path.exists(path):
            return None
        z = np.load(path)
        out = (
            z["bucket_keys"].astype(np.uint32),
            z["bucket_shifts"].astype(np.uint32),
            z["model_fp"].tobytes() if "model_fp" in z.files else None,
        )
        self._key_summaries[stem] = out
        return out

    def load_generation(self, stem: str) -> RDFForest:
        """LRU-resident load: a cache hit costs zero disk reads and zero
        device uploads."""
        hit = self._cache.get(stem)
        if hit is not None:
            self._lru.remove(stem)
            self._lru.append(stem)
            return hit
        forest = load_forest(stem)
        self.disk_loads += 1
        self._cache[stem] = forest
        self._lru.append(stem)
        self._evict()
        return forest

    def _resident_bytes(self) -> int:
        return sum(
            forest_state_bytes(f.state) for f in self._cache.values()
            if f.state is not None
        )

    def _evict(self) -> None:
        while len(self._lru) > 1 and self._resident_bytes() > self.cache_bytes:
            victim = self._lru.pop(0)
            del self._cache[victim]


@dataclasses.dataclass
class TieredForest:
    """Device tier + spilled generations, queried together.

    Mirrors the reference read path that transparently merges RAM and all
    persisted stores (`RandomDrawTreeMap.java:583-595,1052-1075`) — but with
    a working load path (the reference's persisted stores are unreachable
    from a fresh process, SURVEY.md §5). `spill()` moves the device tier to
    disk; queries search the device tier plus every generation whose Bloom
    summary suggests overlap with ids of interest (or all generations when
    no id filter applies).
    """

    conf: RDFConfig
    store: GenerationStore
    device_tier: Optional[RDFForest] = None

    def fit(self, batch) -> "TieredForest":
        self.device_tier = RDFForest(self.conf).fit(batch)
        self._maybe_spill()
        return self

    def add(self, batch) -> "TieredForest":
        """Insert more vectors into the device tier (a fresh tier if the
        previous one was spilled), then apply the ramThreshold rule."""
        if self.device_tier is None:
            self.device_tier = RDFForest(self.conf).fit(batch)
        else:
            self.device_tier.add(batch)
        self._maybe_spill()
        return self

    def device_bytes(self) -> int:
        if self.device_tier is None or self.device_tier.state is None:
            return 0
        return forest_state_bytes(self.device_tier.state)

    def _maybe_spill(self) -> None:
        """Auto-spill when the device tier crosses `conf.ram_threshold`
        bytes — the reference's `getCurrSize() >= ramThreshold →
        runPersistTask` trigger (`RandomDrawTreeMap.java:1114,1136,
        2713-2755`), fired here on the write path (fit/add)."""
        if self.device_bytes() > self.conf.ram_threshold:
            self.spill()

    def spill(self) -> str:
        assert self.device_tier is not None
        stem = self.store.spill(self.device_tier)
        self.device_tier = None
        return stem

    def get(self, key: int) -> Optional[np.ndarray]:
        """Exact point lookup across tiers, Bloom-gated: a generation whose
        summary says the id cannot be present is never opened — exactly the
        reference's persisted-store read gate (`testInDataSummary`,
        `RandomDrawTreeMap.java:926-938`)."""
        if self.device_tier is not None and self.device_tier.state is not None:
            st = self.device_tier.state
            rows = np.flatnonzero(np.asarray(st.row_ids) == key)
            if len(rows):
                return np.asarray(
                    st.corpus[int(rows[0]), : self.conf.vector_dim],
                    dtype=np.float32)
        for stem in self.store.generations():
            if not self.store.summary(stem).might_contain(
                np.asarray([key], dtype=np.uint32)
            )[0]:
                continue  # Bloom says definitely absent: skip the load
            tier = self.store.load_generation(stem)
            st = tier.state
            rows = np.flatnonzero(np.asarray(st.row_ids) == key)
            if len(rows):
                return np.asarray(
                    st.corpus[int(rows[0]), : self.conf.vector_dim],
                    dtype=np.float32)
        return None

    def _probe_keys_host(
        self, queries: np.ndarray, steps: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """The query batch's composite probe-key SUPERSET (all consumed-bit
        flips + self-probe, every step pattern) on host — the summary probe
        for the generation gate. A superset of both probe modes' valid sets,
        so gating with it can never skip a generation a real query would
        touch. Returns (probe_keys u32[B, R], table_of i32[R])."""
        from ..index.forest import probe_key_set, _probe_hashes
        from ..index.partitioner import partition_of_hash
        from ..ops.hashing import hash_dense

        proto = self._prototype()
        qd = jnp.asarray(np.asarray(queries, dtype=np.float32))
        h = hash_dense(proto.model, qd)
        home = partition_of_hash(h, proto.part_proj)
        probes, _ = _probe_hashes(h, proto.layout, multiprobe=True)
        all_valid = jnp.ones(probes.shape, dtype=bool)
        keys, table_of, _ = probe_key_set(
            h, home, proto.layout, steps, True, probes, all_valid
        )
        return np.asarray(keys), np.asarray(table_of)

    def _prototype(self) -> RDFForest:
        """An unfitted forest carrying the (conf-deterministic) hash model —
        every tier of this store shares it, so probe keys computed once gate
        all generations."""
        if self.device_tier is not None:
            return self.device_tier
        if getattr(self, "_proto", None) is None:
            self._proto = RDFForest(self.conf)
        return self._proto

    @staticmethod
    def _probe_uniques(
        probe_keys: np.ndarray,    # u32[B, R]
        table_of: np.ndarray,      # i32[R]
        num_tables: int,
    ) -> list:
        """Per-table unique probe keys, computed ONCE per query batch: the
        gate loop runs per generation, and recomputing the uniques inside it
        made the host gate O(generations × B·R log) instead of
        O(generations × tables·log)."""
        return [
            np.unique(probe_keys[:, table_of == t])
            for t in range(num_tables)
        ]

    @staticmethod
    def _summary_matches(
        summary: tuple,            # (bucket_keys, bucket_shifts, model_fp)
        probe_keys: np.ndarray,    # u32[B, R]
        table_of: np.ndarray,      # i32[R]
        proto_fp: Optional[bytes] = None,
        probe_uniques: Optional[list] = None,   # from _probe_uniques
    ) -> bool:
        """True iff ANY probe key lands in an existing bucket of the
        generation — the similarity-read analogue of `testInDataSummary`.
        Exact (bucket boundaries, not a Bloom), so false negatives are
        impossible and false positives only arise from padding buckets.
        Soundness requires the probe keys to come from the SAME hash model
        the generation was built under: on a fingerprint mismatch (or a
        legacy sidecar without one) the gate conservatively answers True."""
        bucket_keys, bucket_shifts = summary[0], summary[1]
        gen_fp = summary[2] if len(summary) > 2 else None
        if gen_fp is None or proto_fp is None or gen_fp != proto_fp:
            return True
        for t in range(bucket_keys.shape[0]):
            q = (probe_uniques[t] if probe_uniques is not None
                 else np.unique(probe_keys[:, table_of == t]))
            bk, bs = bucket_keys[t], bucket_shifts[t]
            idx = np.searchsorted(bk, q, side="right").astype(np.int64) - 1
            ok = idx >= 0
            safe = np.maximum(idx, 0)
            sh = bs[safe]
            hit = ok & ((q >> sh) == (bk[safe] >> sh))
            # ignore padding buckets (key 0xFFFFFFFF, shift 0): they hold
            # only masked pad rows
            hit &= ~((bk[safe] == np.uint32(0xFFFFFFFF)) & (sh == 0))
            if bool(hit.any()):
                return True
        return False

    def query(
        self,
        queries: np.ndarray,
        steps: int = 0,
        k: Optional[int] = None,
        query_ids: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Merged similarity search across the device tier and all
        generations that might contain a probed bucket. Generations whose
        key summary proves no probe can land in them are NEVER loaded
        (mirroring the reference's summary-gated persisted reads,
        `RandomDrawTreeMap.java:771-783,926-938`); per-tier top-ks stay on
        device and merge in one program with a single host transfer."""
        k = k or self.conf.top_k
        stems = self.store.generations()
        gated: List[str] = []
        if stems:
            probe_keys, table_of = self._probe_keys_host(queries, steps)
            proto_fp = model_fingerprint(self._prototype().model)
            uniques = self._probe_uniques(
                probe_keys, table_of,
                self.conf.table_num * self.conf.permutation_num,
            )
            for stem in stems:
                summary = self.store.key_summary(stem)
                if summary is None or self._summary_matches(
                    summary, probe_keys, table_of, proto_fp,
                    probe_uniques=uniques,
                ):
                    gated.append(stem)
        tiers: List[RDFForest] = []
        if self.device_tier is not None:
            tiers.append(self.device_tier)
        for stem in gated:
            tiers.append(self.store.load_generation(stem))
        q = np.asarray(queries).shape[0]
        if not tiers:
            return (np.full((q, k), -1, np.int32), np.full((q, k), -np.inf, np.float32))
        per_tier = [
            tier.query_device(queries, steps=steps, query_ids=query_ids, k=k)
            for tier in tiers
        ]
        if len(per_tier) == 1:
            ids_d, scores_d = per_tier[0]
        else:
            from ..ops.exact import _top_k

            cat_i = jnp.concatenate([i for i, _ in per_tier], axis=1)
            cat_s = jnp.concatenate([s for _, s in per_tier], axis=1)
            # merge: global top-k over tier top-ks (ids are disjoint across
            # tiers when the caller spills before re-fitting new data)
            scores_d, ids_d = _top_k(cat_s, cat_i, k)
            ids_d = jnp.where(jnp.isfinite(scores_d), ids_d, -1)
        return np.asarray(ids_d), np.asarray(scores_d)


def save_flat(index, path: str) -> None:
    """Serialize a FlatIndex (sketch + corpus + ids) to `<path>.npz` /
    `<path>.json` — the flat engine's counterpart of `save_forest`."""
    assert index.corpus is not None, "nothing to save: fit first"
    sketch = index.sketch
    if sketch.dtype == jnp.bfloat16:
        sketch = sketch.astype(jnp.float32)   # npz has no bf16; recast on load
    corpus = index.corpus
    if corpus.dtype == jnp.bfloat16:
        corpus = corpus.astype(jnp.float32)
    np.savez_compressed(
        path + ".npz",
        sketch=np.asarray(sketch),
        corpus=np.asarray(corpus),
        row_ids=np.asarray(index.row_ids),
    )
    with open(path + ".json", "w") as f:
        json.dump(
            dict(engine="flat", sketch_dtype=index.sketch_dtype,
                 scale=float(getattr(index, "scale", 1.0)),
                 refine=index.refine, block=index.block,
                 query_batch=index.query_batch, mode=index.mode,
                 r_groups=index.r_groups,
                 corpus_dtype=getattr(index, "corpus_dtype", "float32"),
                 version=1),
            f,
        )


def load_flat(path: str):
    """Load a FlatIndex saved by `save_flat`."""
    from ..ops.flat import FlatIndex

    with open(path + ".json") as f:
        meta = json.load(f)
    assert meta["engine"] == "flat", meta
    z = np.load(path + ".npz")
    idx = FlatIndex(
        sketch_dtype=meta["sketch_dtype"], refine=meta["refine"],
        block=meta["block"], query_batch=meta["query_batch"],
        mode=meta.get("mode", "grouped"),
        r_groups=meta.get("r_groups", 24),
        corpus_dtype=meta.get("corpus_dtype", "float32"),
    )
    dt = jnp.bfloat16 if meta["sketch_dtype"] == "bfloat16" else jnp.int8
    idx.sketch = jnp.asarray(z["sketch"]).astype(dt)
    idx.corpus = jnp.asarray(z["corpus"])
    if idx.corpus_dtype == "bfloat16":
        idx.corpus = idx.corpus.astype(jnp.bfloat16)
    idx.row_ids = jnp.asarray(z["row_ids"])
    idx.scale = meta["scale"]
    return idx

def save_ivf(index, path: str) -> None:
    """Serialize an IVFFlatIndex (cluster-ordered sketch/corpus, centroids,
    starts) to `<path>.npz` / `<path>.json` — the clustered-flat engine's
    counterpart of `save_flat` (the reference has no engine-state load path
    at all, SURVEY.md §5 checkpoint)."""
    st = index.state
    assert st is not None, "nothing to save: fit first"
    np.savez_compressed(
        path + ".npz",
        sketch=np.asarray(st.sketch),
        corpus=np.asarray(st.corpus),
        row_ids=np.asarray(st.row_ids),
        centroids=np.asarray(st.centroids.astype(jnp.float32)),
        starts=np.asarray(st.starts),
        ends=np.asarray(st.ends),
    )
    with open(path + ".json", "w") as f:
        json.dump(
            dict(engine="ivf", target_cluster=index.target_cluster,
                 nprobe=index.nprobe, win=index.win, refine=index.refine,
                 iters=index.iters, query_batch=index.query_batch,
                 seed=index.seed, wb=index.wb,
                 train_sample=index.train_sample,
                 head_pool=index.head_pool, keep=index.keep, version=1),
            f,
        )


def load_ivf(path: str):
    """Load an IVFFlatIndex saved by `save_ivf`."""
    from ..ops.ivf import IVFFlatIndex, IVFState

    with open(path + ".json") as f:
        meta = json.load(f)
    assert meta["engine"] == "ivf", meta
    z = np.load(path + ".npz")
    idx = IVFFlatIndex(
        target_cluster=meta["target_cluster"], nprobe=meta["nprobe"],
        win=meta["win"], refine=meta["refine"], iters=meta["iters"],
        query_batch=meta["query_batch"], seed=meta["seed"],
        wb=meta.get("wb"), train_sample=meta.get("train_sample"),
        head_pool=meta.get("head_pool", 0), keep=meta.get("keep", 0),
    )
    idx.state = IVFState(
        sketch=jnp.asarray(z["sketch"]),
        corpus=jnp.asarray(z["corpus"]),
        row_ids=jnp.asarray(z["row_ids"]),
        centroids=jnp.asarray(z["centroids"]).astype(jnp.bfloat16),
        starts=jnp.asarray(z["starts"]),
        # pre-`ends` files: fall back to padded ends (old query semantics)
        ends=jnp.asarray(z["ends"] if "ends" in z.files
                         else z["starts"][1:]),
    )
    idx.ensure_heads()   # derived tier — rebuilt, never persisted
    return idx


# ---------------------------------------------------------------------------
# Sharded-engine save / load (single-process meshes)
# ---------------------------------------------------------------------------


def save_sharded_flat(index, path: str) -> None:
    """Serialize a ShardedFlatIndex (row-sharded sketch/corpus/ids gathered
    to host) — restart-without-refit for the mesh engine. Single-process
    meshes only (a host gather of a multi-process array would need every
    process's shards)."""
    import jax

    assert index.state is not None, "nothing to save: fit first"
    assert jax.process_count() == 1, "multi-process save not supported"
    st = index.state
    sketch = st.sketch
    if sketch.dtype == jnp.bfloat16:
        sketch = sketch.astype(jnp.float32)
    np.savez_compressed(
        path + ".npz",
        sketch=np.asarray(sketch),
        corpus=np.asarray(st.corpus),
        row_ids=np.asarray(st.row_ids),
    )
    ndev = index.mesh.shape[_shard_axis()]
    with open(path + ".json", "w") as f:
        json.dump(
            dict(engine="sharded_flat", sketch_dtype=index.sketch_dtype,
                 refine=index.refine, block=index.block, ndev=ndev,
                 mode=index.mode, r_groups=index.r_groups,
                 version=1),
            f,
        )


def load_sharded_flat(path: str, mesh=None):
    """Load a ShardedFlatIndex saved by `save_sharded_flat`. Rows are
    independent under the flat engine's local-topk + all-gather merge, so
    the target mesh may have a different device count as long as it divides
    the stored row count."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    import jax

    from ..parallel.mesh import SHARD_AXIS, make_forest_mesh
    from ..parallel.sharded_flat import ShardedFlatIndex, ShardedFlatState

    with open(path + ".json") as f:
        meta = json.load(f)
    assert meta["engine"] == "sharded_flat", meta
    z = np.load(path + ".npz")
    mesh = mesh or make_forest_mesh()
    ndev = mesh.shape[SHARD_AXIS]
    rows = z["row_ids"].shape[0]
    if rows % ndev:
        raise ValueError(
            f"stored rows ({rows}) not divisible by mesh devices ({ndev})")
    # files written before the strided sketch copy was removed carry a
    # "gmax_halved" flag; that copy was derived data and is not rebuilt
    idx = ShardedFlatIndex(mesh=mesh, sketch_dtype=meta["sketch_dtype"],
                           refine=meta["refine"], block=meta["block"],
                           mode=meta.get("mode", "grouped"),
                           r_groups=meta.get("r_groups", 24))
    shard = NamedSharding(mesh, P(SHARD_AXIS))
    sketch = z["sketch"]
    if meta["sketch_dtype"] == "bfloat16":
        sketch = jnp.asarray(sketch).astype(jnp.bfloat16)
    idx.state = ShardedFlatState(
        sketch=jax.device_put(sketch, shard),
        corpus=jax.device_put(z["corpus"], shard),
        row_ids=jax.device_put(z["row_ids"], shard),
    )
    return idx


def save_sharded_ivf(index, path: str) -> None:
    """Serialize a ShardedIVFIndex. The per-shard cluster layouts
    (starts/ends) are tied to the fitted device count, so load requires a
    mesh of the SAME size (recorded in the sidecar)."""
    import jax

    assert index.state is not None, "nothing to save: fit first"
    assert jax.process_count() == 1, "multi-process save not supported"
    st = index.state
    np.savez_compressed(
        path + ".npz",
        sketch=np.asarray(st.sketch),
        corpus=np.asarray(st.corpus),
        row_ids=np.asarray(st.row_ids),
        centroids=np.asarray(st.centroids.astype(jnp.float32)),
        starts=np.asarray(st.starts),
        ends=np.asarray(st.ends),
    )
    with open(path + ".json", "w") as f:
        json.dump(
            dict(engine="sharded_ivf", target_cluster=index.target_cluster,
                 nprobe=index.nprobe, win=index.win, refine=index.refine,
                 iters=index.iters, seed=index.seed, wb=index.wb,
                 head_pool=index.head_pool, keep=index.keep,
                 ndev=int(st.sketch.shape[0]), version=1),
            f,
        )


def load_sharded_ivf(path: str, mesh=None):
    """Load a ShardedIVFIndex saved by `save_sharded_ivf` onto a mesh of
    the same device count."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    import jax

    from ..parallel.mesh import SHARD_AXIS, make_forest_mesh
    from ..parallel.sharded_ivf import ShardedIVFIndex, ShardedIVFState

    with open(path + ".json") as f:
        meta = json.load(f)
    assert meta["engine"] == "sharded_ivf", meta
    z = np.load(path + ".npz")
    mesh = mesh or make_forest_mesh()
    ndev = mesh.shape[SHARD_AXIS]
    if ndev != meta["ndev"]:
        raise ValueError(
            f"saved for {meta['ndev']} devices, mesh has {ndev} "
            "(per-shard cluster layouts are device-count-specific)")
    idx = ShardedIVFIndex(mesh=mesh, target_cluster=meta["target_cluster"],
                          nprobe=meta["nprobe"], win=meta["win"],
                          refine=meta["refine"], iters=meta["iters"],
                          seed=meta["seed"], wb=meta.get("wb"),
                          head_pool=meta.get("head_pool", 0),
                          keep=meta.get("keep", 0))
    shard = NamedSharding(mesh, P(SHARD_AXIS))
    repl = NamedSharding(mesh, P())
    idx.state = ShardedIVFState(
        sketch=jax.device_put(z["sketch"], shard),
        corpus=jax.device_put(z["corpus"], shard),
        row_ids=jax.device_put(z["row_ids"], shard),
        centroids=jax.device_put(
            jnp.asarray(z["centroids"]).astype(jnp.bfloat16), repl),
        starts=jax.device_put(z["starts"], shard),
        ends=jax.device_put(z["ends"], shard),
    )
    idx.ensure_heads()   # derived tier — rebuilt, never persisted
    return idx


def _shard_axis() -> str:
    from ..parallel.mesh import SHARD_AXIS

    return SHARD_AXIS
