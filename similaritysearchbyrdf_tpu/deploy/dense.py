"""Dense front-end — the `DensevectorRDFInit` API surface.

Method-for-method coverage of the reference front-end
(`deploy/DensevectorRDFInit.scala:50-557`): init, single/multi-"thread" fit
(both collapse to the same batched device fit — the reference's P1
table-range threading is a tensor axis here), key/vector batch query,
ground-truth loading, precision scoring, distribution introspection and
teardown. An explicit `RDFSession`-style object replaces the reference's
singleton object state.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Set, Tuple

import numpy as np

from ..config import RDFConfig
from ..index.forest import RDFForest
from ..vectors import DenseBatch, load_dense_file, load_ground_truth


class _FlatEngineAdapter:
    """RDFForest-shaped facade over :class:`FlatIndex` so the reference
    front-end surface can run on the quantized-flat engine
    (`conf.engine = "flat"`). The forest's pruning knobs (`steps`,
    probe modes, candidate caps) are accepted and ignored — the flat
    engine scores every row, so they have no effect."""

    def __init__(self, conf: RDFConfig) -> None:
        from ..ops.flat import FlatIndex

        self.conf = conf
        self.index = FlatIndex()
        self.state = None          # front-end "fitted" checks

    def fit(self, batch: DenseBatch) -> "_FlatEngineAdapter":
        self.index.fit(batch)
        self.state = self.index
        return self

    def query(self, queries, steps: int = 0, query_ids=None, k=None, **_):
        k = k or self.conf.top_k
        return self.index.query(
            np.asarray(queries, np.float32), k=k, query_ids=query_ids,
            exclude_self=query_ids is not None,
        )

    def size(self) -> int:
        return 0 if self.index.row_ids is None else int(
            (np.asarray(self.index.row_ids) >= 0).sum())

    def sub_index_distribution(self):
        raise RuntimeError(
            "sub-index distribution is a forest concept; use engine='forest'"
        )


class DenseRDFInit:
    """Stateful front-end over :class:`RDFForest` with the reference's
    method names. The reference's `vectorIdToVector` dataTable is the corpus
    array inside the forest state; `vectorDatabase` (the lshTables) are the
    bucket tables."""

    def __init__(self) -> None:
        self.forest: Optional[RDFForest] = None
        self.conf: Optional[RDFConfig] = None
        self._all_vectors: Optional[DenseBatch] = None

    # -- init (`initializeRDFHashMap`, DensevectorRDFInit.scala:50-118) ----
    def initialize_rdf_hash_map(self, conf: RDFConfig) -> None:
        self.conf = conf
        if getattr(conf, "engine", "forest") == "flat":
            self.forest = _FlatEngineAdapter(conf)
        else:
            self.forest = RDFForest(conf)

    initializeRDFHashMap = initialize_rdf_hash_map

    def _require(self) -> RDFForest:
        if self.forest is None:
            raise RuntimeError("initializeRDFHashMap must be called first")
        return self.forest

    # -- fit (`newFastFit` :127-151 / `newMultiThreadFit` :161-206) --------
    def new_fast_fit(self, file_name: str, conf: Optional[RDFConfig] = None,
                     limit: Optional[int] = None) -> DenseBatch:
        """Parse a `[id,[v...]]` file and build the index. Returns the parsed
        batch (the reference returns Array[DenseVector])."""
        if conf is not None and self.forest is None:
            self.initialize_rdf_hash_map(conf)
        forest = self._require()
        batch = load_dense_file(file_name, limit=limit)
        forest.fit(batch)
        self._all_vectors = batch
        return batch

    newFastFit = new_fast_fit

    def new_multi_thread_fit(self, file_name: str,
                             conf: Optional[RDFConfig] = None,
                             limit: Optional[int] = None) -> DenseBatch:
        """Identical to `new_fast_fit`: all tables are hashed by one
        batched einsum, so the reference's thread-per-table-range fit
        (`:161-206`) has no separate fast path."""
        return self.new_fast_fit(file_name, conf, limit)

    newMultiThreadFit = new_multi_thread_fit

    def fit_batch(self, batch: DenseBatch) -> None:
        """Array-native fit (no file) — the natural device entry point."""
        self._require().fit(batch)
        self._all_vectors = batch

    # -- query (`querySingleKey` :284-302 / `queryBatch` :311-317 /
    #           `NewMultiThreadQueryBatch` :335-399 / `query` :533-557) ----
    def query_single_key(self, key: int, steps: int = 0) -> Optional[List[int]]:
        """Candidate ids for one already-fitted vector id (no re-rank),
        like the reference's `querySingleKey`."""
        forest = self._require()
        if self._all_vectors is None:
            print("need to fit the data first")
            return None
        row = np.flatnonzero(self._all_vectors.ids == key)
        if len(row) == 0:
            return None
        ids, _ = forest.query(
            self._all_vectors.values[row], steps=steps,
            query_ids=np.array([key], dtype=np.int32),
            k=self.conf.top_k if self.conf else 10,
        )
        return [int(i) for i in ids[0] if i >= 0]

    querySingleKey = query_single_key

    def query_batch(self, keys: Sequence[int], steps: int = 0) -> List[List[int]]:
        """Batch query by key — `queryBatch` (`:311-317`). The reference
        loops single-key queries; here all requested keys resolve to rows
        host-side and go through ONE batched device query."""
        forest = self._require()
        if self._all_vectors is None:
            print("need to fit the data first")
            return [[] for _ in keys]
        keys_arr = np.asarray(list(keys), dtype=np.int64)
        id_to_row = {int(v): i for i, v in enumerate(self._all_vectors.ids)}
        rows = np.asarray([id_to_row.get(int(k), -1) for k in keys_arr])
        found = rows >= 0
        if not found.any():
            return [[] for _ in keys_arr]
        ids, _ = forest.query(
            self._all_vectors.values[rows[found]], steps=steps,
            query_ids=keys_arr[found].astype(np.int32),
            k=self.conf.top_k if self.conf else 10,
        )
        out: List[List[int]] = []
        j = 0
        for ok in found:
            if ok:
                out.append([int(i) for i in ids[j] if i >= 0])
                j += 1
            else:
                out.append([])
        return out

    queryBatch = query_batch

    def new_multi_thread_query_batch(
        self,
        query_ids: np.ndarray,
        query_vectors: np.ndarray,
        steps: int = 0,
        k: Optional[int] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Batched query by raw vectors (the fast path the reference calls
        `NewMultiThreadQueryBatch`/`threadQueryNew`, `:335-399`). Returns
        (ids [Q,k], scores [Q,k])."""
        forest = self._require()
        return forest.query(
            np.asarray(query_vectors, dtype=np.float32),
            steps=steps,
            query_ids=np.asarray(query_ids, dtype=np.int32),
            k=k,
        )

    NewMultiThreadQueryBatch = new_multi_thread_query_batch

    def query(self, query_ids, query_vectors, steps: int = 0,
              k: Optional[int] = None):
        return self.new_multi_thread_query_batch(query_ids, query_vectors, steps, k)

    # -- evaluation (`topKAndPrecisionScore` :472-507, GT loader :440-447) --
    def get_top_k_ground_truth(self, filename: str, k: int) -> List[Set[int]]:
        gt = load_ground_truth(filename, k)
        return [set(int(x) for x in row) for row in gt]

    getTopKGroundTruth = get_top_k_ground_truth

    def top_k_and_precision_score(
        self,
        all_dense_vectors: DenseBatch,
        ground_truth: Sequence[Set[int]],
        conf: Optional[RDFConfig] = None,
        steps: int = 0,
    ) -> Tuple[np.ndarray, float, float]:
        """Query the first len(ground_truth) vectors, re-rank exactly, score
        precision@topK vs ground truth. Returns (topK ids [Q,k], precision,
        elapsed_ms) — the sparse front-end variant of the reference also
        returns elapsed ms (`SparsevectorRDFInit.scala:458-501`), included
        here for both."""
        conf = conf or self.conf or RDFConfig()
        q = len(ground_truth)
        t0 = time.perf_counter()
        ids, _ = self.new_multi_thread_query_batch(
            all_dense_vectors.ids[:q], all_dense_vectors.values[:q],
            steps=steps, k=conf.top_k,
        )
        elapsed_ms = (time.perf_counter() - t0) * 1000.0
        score = 0.0
        for i in range(q):
            got = set(int(x) for x in ids[i] if x >= 0)
            score += len(got & ground_truth[i]) / conf.top_k
        return ids, score / q, elapsed_ms

    topKAndPrecisionScore = top_k_and_precision_score

    # -- introspection (`getDtAndHtNumDistribution` :515-530) ---------------
    def get_dt_and_ht_num_distribution(self) -> Tuple[np.ndarray, np.ndarray]:
        """(dataTable, hashTable) objects-per-sub-index distributions. The
        dataTable's partition axis is the HashPartitioner modulo
        (`utils/Partitioner.scala:14-18`); the hashTables' is the mean over
        tables of the LSH-partition distribution."""
        forest = self._require()
        assert forest.state is not None and self.conf is not None
        ids = np.asarray(forest.state.row_ids)
        ids = ids[ids >= 0]
        ndp = self.conf.num_data_partitions
        dt = np.bincount(np.abs(ids) % ndp, minlength=ndp).astype(np.float64)
        ht = forest.sub_index_distribution().mean(axis=0).astype(np.float64)
        return dt, ht

    getDtAndHtNumDistribution = get_dt_and_ht_num_distribution

    # -- teardown (`clearAndClose` :453-458) --------------------------------
    def clear_and_close(self) -> None:
        self.forest = None
        self._all_vectors = None

    clearAndClose = clear_and_close
