"""DynamicForest — incremental inserts with a delta tier.

The reference's trie takes single `put`s cheaply but pays pointer-chasing on
every read; the flattened forest reads fast but a naive insert re-sorts the
world. This keeps both: a large MAIN forest plus a small DELTA forest that
absorbs inserts (rebuilding only the delta — milliseconds), with queries
merged across the two by score. When the delta outgrows
`merge_threshold` × main size, the tiers compact into one build — amortized
O(log) rebuilds, the array-world analogue of the trie's dynamic growth
(`putInner`'s splits, `RandomDrawTreeMap.java:1662-1790`).

Removals are tombstones (the reference's `remove:1817` deletes trie nodes):
removed ids are filtered from results and dropped for good at the next
compaction.
"""

from __future__ import annotations

from typing import Optional, Set, Tuple

import numpy as np

from ..config import RDFConfig
from .forest import RDFForest
from ..vectors import DenseBatch


class DynamicForest:
    # Over-fetch headroom buckets: the per-tier query fetches
    # k + bucket(len(tombstones)) results, where bucket() rounds UP to one
    # of these values — so a removal stream triggers at most
    # len(OVERFETCH_BUCKETS) distinct compiled query shapes instead of one
    # per tombstone count (each new shape recompiles the query).
    OVERFETCH_BUCKETS = (0, 16, 64)
    TOMBSTONE_LIMIT = OVERFETCH_BUCKETS[-1]

    def __init__(self, conf: RDFConfig, merge_threshold: float = 0.25):
        self.conf = conf
        self.merge_threshold = merge_threshold
        self.main = RDFForest(conf)
        self.delta: Optional[RDFForest] = None
        self._delta_ids: list = []
        self._delta_vecs: list = []
        self._tombstones: Set[int] = set()
        self._delta_dirty = False

    # -- mutation ------------------------------------------------------------
    def fit(self, batch: DenseBatch) -> "DynamicForest":
        self.main.fit(batch)
        self.delta = None
        self._delta_ids, self._delta_vecs = [], []
        self._delta_dirty = False
        self._tombstones.clear()
        return self

    def add(self, batch: DenseBatch) -> None:
        """Accumulate host-side; the delta forest is rebuilt lazily at the
        next query (one rebuild per query burst instead of one per add —
        an insert stream is O(n), not O(n^2))."""
        self._delta_ids.extend(int(i) for i in batch.ids)
        self._delta_vecs.extend(np.asarray(batch.values, dtype=np.float32))
        self._tombstones.difference_update(int(i) for i in batch.ids)
        self._delta_dirty = True
        if self._delta_count() > self.merge_threshold * max(1, self.main.size()):
            self.compact()

    def remove(self, key: int) -> None:
        if key in set(self._delta_ids):
            keep = [i for i, kid in enumerate(self._delta_ids) if kid != key]
            self._delta_ids = [self._delta_ids[i] for i in keep]
            self._delta_vecs = [self._delta_vecs[i] for i in keep]
            self._delta_dirty = True
        self._tombstones.add(int(key))
        # Bound the tombstone set so the query over-fetch stays static: past
        # TOMBSTONE_LIMIT the dead rows are folded out in one compaction
        # (the array analogue of the reference's eager node delete,
        # `RandomDrawTreeMap.remove:1817`).
        if len(self._tombstones) > self.TOMBSTONE_LIMIT:
            self.compact()

    def _delta_count(self) -> int:
        return len(self._delta_ids)

    def _rebuild_delta(self) -> None:
        self._delta_dirty = False
        if not self._delta_ids:
            self.delta = None
            return
        delta = RDFForest(self.conf)
        # share hash functions with the main tier so both tiers bucket the
        # same way (one model, two bucket generations)
        delta.model = self.main.model
        delta.part_proj = self.main.part_proj
        delta.fit(DenseBatch(
            np.asarray(self._delta_ids, np.int32),
            np.stack(self._delta_vecs),
        ))
        self.delta = delta

    def compact(self) -> None:
        """Fold the delta (and tombstones) into one main build."""
        parts = []
        if self.main.state is not None and self.main.size() > 0:
            st = self.main.state
            rid = np.asarray(st.row_ids)
            live = rid >= 0
            parts.append((rid[live],
                          np.asarray(st.corpus)[live][:, : self.conf.vector_dim]))
        if self._delta_ids:
            parts.append((
                np.asarray(self._delta_ids, np.int32),
                np.stack(self._delta_vecs),
            ))
        if not parts:
            return
        ids = np.concatenate([p[0] for p in parts])
        vecs = np.concatenate([p[1] for p in parts])
        keep = ~np.isin(ids, np.fromiter(self._tombstones, dtype=np.int32,
                                         count=len(self._tombstones)))
        self.main.fit(DenseBatch(ids[keep], vecs[keep].astype(np.float32)))
        self.delta = None
        self._delta_ids, self._delta_vecs = [], []
        self._delta_dirty = False
        self._tombstones.clear()

    def size(self) -> int:
        n = self.main.size() + self._delta_count()
        return n - len(self._tombstones & self._all_ids())

    def _all_ids(self) -> Set[int]:
        out: Set[int] = set(self._delta_ids)
        if self.main.state is not None:
            rid = np.asarray(self.main.state.row_ids)
            out.update(int(i) for i in rid[rid >= 0])
        return out

    # -- query -----------------------------------------------------------------
    def query(
        self,
        queries: np.ndarray,
        steps: int = 0,
        query_ids: Optional[np.ndarray] = None,
        k: Optional[int] = None,
        **kw,
    ) -> Tuple[np.ndarray, np.ndarray]:
        k = k or self.conf.top_k
        if self._delta_dirty:
            self._rebuild_delta()
        tiers = [t for t in (self.main if self.main.state is not None else None,
                             self.delta) if t is not None]
        # over-fetch so tombstone filtering cannot starve the merge; rounded
        # to a static bucket so the compiled query shape does not depend on
        # the exact tombstone count (remove() compacts past the last bucket,
        # so the bucket always covers every live tombstone)
        live_tombs = min(len(self._tombstones), self.TOMBSTONE_LIMIT)
        extra = next(b for b in self.OVERFETCH_BUCKETS if b >= live_tombs)
        all_ids, all_scores = [], []
        for t in tiers:
            # device arrays: both tiers dispatch before either transfers
            ids, scores = t.query_device(
                queries, steps=steps, query_ids=query_ids, k=k + extra, **kw
            )
            all_ids.append(ids)
            all_scores.append(scores)
        if not all_ids:
            q = np.asarray(queries).shape[0]
            return (np.full((q, k), -1, np.int32),
                    np.full((q, k), -np.inf, np.float32))
        import jax.numpy as jnp

        ids = np.asarray(jnp.concatenate(all_ids, axis=1))
        scores = np.asarray(jnp.concatenate(all_scores, axis=1))
        if self._tombstones:
            dead = np.isin(ids, np.fromiter(self._tombstones, dtype=np.int32,
                                            count=len(self._tombstones)))
            scores = np.where(dead, -np.inf, scores)
            ids = np.where(dead, -1, ids)
        order = np.argsort(-scores, axis=1, kind="stable")[:, :k]
        return (np.take_along_axis(ids, order, axis=1),
                np.take_along_axis(scores, order, axis=1))
