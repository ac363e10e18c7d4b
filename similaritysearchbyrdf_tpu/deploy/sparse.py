"""Sparse front-end — the `SparsevectorRDFInit` API surface
(`deploy/SparsevectorRDFInit.scala:51-553`, the mirror of the dense
front-end for SparseVector data)."""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Set, Tuple

import numpy as np

from ..config import RDFConfig
from ..index.sparse_forest import SparseRDFForest
from ..vectors import SparseBatch, load_ground_truth, load_sparse_file


class SparseRDFInit:
    def __init__(self) -> None:
        self.forest: Optional[SparseRDFForest] = None
        self.conf: Optional[RDFConfig] = None
        self._all_vectors: Optional[SparseBatch] = None

    # -- init (`initializeRDFHashMap`, SparsevectorRDFInit.scala:51-115) ---
    def initialize_rdf_hash_map(self, conf: RDFConfig) -> None:
        self.conf = conf
        self.forest = SparseRDFForest(conf)

    initializeRDFHashMap = initialize_rdf_hash_map

    def _require(self) -> SparseRDFForest:
        if self.forest is None:
            raise RuntimeError("initializeRDFHashMap must be called first")
        return self.forest

    # -- fit (`newFastFit` :124-160 / `newMultiThreadFit` :164-200) --------
    def new_fast_fit(self, file_name: str, conf: Optional[RDFConfig] = None,
                     limit: Optional[int] = None,
                     nnz_pad: Optional[int] = None) -> SparseBatch:
        if conf is not None and self.forest is None:
            self.initialize_rdf_hash_map(conf)
        forest = self._require()
        batch = load_sparse_file(
            file_name, limit=limit,
            nnz_pad=nnz_pad or (self.conf.sparse_nnz_pad if self.conf else None),
        )
        forest.fit(batch)
        self._all_vectors = batch
        return batch

    newFastFit = new_fast_fit

    def new_multi_thread_fit(self, file_name: str,
                             conf: Optional[RDFConfig] = None,
                             limit: Optional[int] = None) -> SparseBatch:
        return self.new_fast_fit(file_name, conf, limit)

    newMultiThreadFit = new_multi_thread_fit

    def fit_batch(self, batch: SparseBatch) -> None:
        self._require().fit(batch)
        self._all_vectors = batch

    # -- query --------------------------------------------------------------
    def query_single_key(self, key: int, steps: int = 0) -> Optional[List[int]]:
        forest = self._require()
        if self._all_vectors is None:
            print("need to fit the data first")
            return None
        row = np.flatnonzero(self._all_vectors.ids == key)
        if len(row) == 0:
            return None
        sub = self._all_vectors.slice(int(row[0]), int(row[0]) + 1)
        ids, _ = forest.query(
            sub, steps=steps, query_ids=np.array([key], dtype=np.int32),
            k=self.conf.top_k if self.conf else 10,
        )
        return [int(i) for i in ids[0] if i >= 0]

    querySingleKey = query_single_key

    def query_batch(self, keys: Sequence[int], steps: int = 0) -> List[List[int]]:
        """Batch query by key in ONE device call (the reference loops
        single-key queries)."""
        forest = self._require()
        if self._all_vectors is None:
            print("need to fit the data first")
            return [[] for _ in keys]
        av = self._all_vectors
        keys_arr = np.asarray(list(keys), dtype=np.int64)
        id_to_row = {int(v): i for i, v in enumerate(av.ids)}
        rows = np.asarray([id_to_row.get(int(k), -1) for k in keys_arr])
        found = rows >= 0
        if not found.any():
            return [[] for _ in keys_arr]
        sel = rows[found]
        sub = SparseBatch(
            ids=av.ids[sel], size=av.size, indices=av.indices[sel],
            values=av.values[sel], lengths=av.lengths[sel],
        )
        ids, _ = forest.query(
            sub, steps=steps, query_ids=keys_arr[found].astype(np.int32),
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
        queries: SparseBatch,
        steps: int = 0,
        k: Optional[int] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        forest = self._require()
        return forest.query(
            queries, steps=steps,
            query_ids=np.asarray(query_ids, dtype=np.int32), k=k,
        )

    NewMultiThreadQueryBatch = new_multi_thread_query_batch

    # -- evaluation (`topKAndPrecisionScore` :458-501) ----------------------
    def get_top_k_ground_truth(self, filename: str, k: int) -> List[Set[int]]:
        gt = load_ground_truth(filename, k)
        return [set(int(x) for x in row) for row in gt]

    getTopKGroundTruth = get_top_k_ground_truth

    def top_k_and_precision_score(
        self,
        all_vectors: SparseBatch,
        ground_truth: Sequence[Set[int]],
        conf: Optional[RDFConfig] = None,
        steps: int = 0,
    ) -> Tuple[np.ndarray, float, float]:
        conf = conf or self.conf or RDFConfig()
        q = len(ground_truth)
        t0 = time.perf_counter()
        ids, _ = self.new_multi_thread_query_batch(
            all_vectors.ids[:q], all_vectors.slice(0, q),
            steps=steps, k=conf.top_k,
        )
        elapsed_ms = (time.perf_counter() - t0) * 1000.0
        score = 0.0
        for i in range(q):
            got = set(int(x) for x in ids[i] if x >= 0)
            score += len(got & ground_truth[i]) / conf.top_k
        return ids, score / q, elapsed_ms

    topKAndPrecisionScore = top_k_and_precision_score

    # -- introspection (`getDtAndHtNumDistribution`,
    # SparsevectorRDFInit.scala:505-530) ------------------------------------
    def get_dt_and_ht_num_distribution(self) -> Tuple[np.ndarray, np.ndarray]:
        """(dataTable, hashTable) objects-per-sub-index distributions — the
        sparse mirror of the dense front-end's introspection. The
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

    def clear_and_close(self) -> None:
        self.forest = None
        self._all_vectors = None

    clearAndClose = clear_and_close
