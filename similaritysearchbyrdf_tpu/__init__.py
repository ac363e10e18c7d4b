"""similaritysearchbyrdf_tpu — a Dynamic Partition Forest on JAX.

A JAX/XLA implementation of the capabilities of the
Random Draw Forest / Dynamic Partition Forest ANN engine (the reference
Scala/JVM system described in SURVEY.md): LSH compound hashing (angle and
p-stable families), a forest of data-adaptively deepening bucket tables,
content-based partitioning with multiple-step search, multi-probe candidate
expansion, exact top-k re-ranking, mesh-sharded distribution, and persistent
indexes.
"""

from .config import RDFConfig, TableConfig, PStableConfig, from_hocon_dict, from_hocon_file
from .vectors import (
    DenseBatch,
    SparseBatch,
    load_dense_file,
    load_sparse_file,
    load_ground_truth,
    sparse_batch_from_rows,
)
from .models.families import HashModel, generate_model, save_model_file, load_model_file
from .index.forest import RDFForest, ForestState, fit_dense, query_dense
from .index.sparse_forest import SparseRDFForest
from .index.bucket_table import KeyLayout, BucketTables
from .ops.exact import exact_search
from .ops.ivf import IVFFlatIndex, tune_nprobe
from .ops.flat import (FlatIndex, SparseFlatIndex, flat_topk,
                       flat_topk_grouped, flat_topk_sparse,
                       build_flat_sketch)
from .deploy.dense import DenseRDFInit
from .deploy.sparse import SparseRDFInit
from .deploy.multi_feature import MultiFeatureRDFInit
from .storage.persist import (save_forest, load_forest, save_flat,
                              load_flat, save_ivf, load_ivf,
                              save_sharded_flat, load_sharded_flat,
                              save_sharded_ivf, load_sharded_ivf,
                              TieredForest, GenerationStore)

__version__ = "0.1.0"

__all__ = [
    "RDFConfig",
    "TableConfig",
    "PStableConfig",
    "from_hocon_dict",
    "from_hocon_file",
    "DenseBatch",
    "SparseBatch",
    "load_dense_file",
    "load_sparse_file",
    "load_ground_truth",
    "sparse_batch_from_rows",
    "HashModel",
    "generate_model",
    "save_model_file",
    "load_model_file",
    "RDFForest",
    "SparseRDFForest",
    "ForestState",
    "fit_dense",
    "query_dense",
    "KeyLayout",
    "BucketTables",
    "exact_search",
    "FlatIndex",
    "IVFFlatIndex",
    "tune_nprobe",
    "SparseFlatIndex",
    "flat_topk_grouped",
    "flat_topk_sparse",
    "flat_topk",
    "build_flat_sketch",
    "DenseRDFInit",
    "SparseRDFInit",
    "MultiFeatureRDFInit",
    "save_forest",
    "save_flat",
    "load_flat",
    "save_ivf",
    "save_sharded_flat",
    "load_sharded_flat",
    "save_sharded_ivf",
    "load_sharded_ivf",
    "load_ivf",
    "load_forest",
    "TieredForest",
    "GenerationStore",
]


def sharded_forest(*args, **kwargs):
    """Lazy accessor for :class:`parallel.sharded_forest.ShardedRDFForest`
    (imported on demand to keep single-chip imports light)."""
    from .parallel.sharded_forest import ShardedRDFForest

    return ShardedRDFForest(*args, **kwargs)
