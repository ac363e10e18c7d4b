"""Multi-process (multi-host) sharded forest: 2-process CPU validation.

Each process owns 4 virtual CPU devices and supplies only its host-local
half of the corpus (`fit_sharded_distributed` — no global host array); the
8-shard query must answer exactly like a single-process 8-device fit over
the full corpus (SURVEY.md §7.5, the Deep-100M multi-host contract).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

WORKER = r"""
import os, sys
import numpy as np

proc_id = int(sys.argv[1])
port = sys.argv[2]
out = sys.argv[3]

from similaritysearchbyrdf_tpu.parallel.mesh import init_distributed, make_forest_mesh
init_distributed(f"localhost:{port}", num_processes=2, process_id=proc_id)

import jax
assert jax.process_count() == 2
assert len(jax.devices()) == 8

from similaritysearchbyrdf_tpu.config import RDFConfig, TableConfig
from similaritysearchbyrdf_tpu.index.bucket_table import KeyLayout
from similaritysearchbyrdf_tpu.parallel.sharded_forest import (
    fit_sharded_distributed, make_query_fn)
from similaritysearchbyrdf_tpu.vectors import DenseBatch

conf = RDFConfig(
    vector_dim=16, table_num=3, permutation_num=1, family_size=20,
    partition_bits=2, lsh_table=TableConfig(chain_length=12, bucket_overflow=16),
    query_batch_size=16, max_candidates=512, top_k=5, seed=77,
)
rng = np.random.default_rng(0)
centers = rng.normal(size=(16, 16))
x = centers[rng.integers(0, 16, 1024)] + 0.1 * rng.normal(size=(1024, 16))
x = (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)

half = 512
lo, hi = proc_id * half, (proc_id + 1) * half
local = DenseBatch(np.arange(lo, hi, dtype=np.int32), x[lo:hi])

mesh = make_forest_mesh(8)
state, _ = fit_sharded_distributed(conf, local, mesh)
layout = KeyLayout.from_config(conf, conf.lsh_table)
qfn = make_query_fn(mesh, layout, steps=1, m_cap=512, k=5,
                    multiprobe=True, exclude_self=True,
                    has_lp=state.corpus_lp is not None)
import jax.numpy as jnp
q = jnp.asarray(x[:32]); qids = jnp.arange(32, dtype=jnp.int32)
ids, scores, total = qfn(state, q, qids)
ids = np.asarray(jax.device_get(ids))

# --- coarse leg: table-ordered coarse scoring sharded across processes ---
cconf = conf.replace(coarse_dim=16, coarse_refine=64)
cstate, _ = fit_sharded_distributed(cconf, local, mesh)
cqfn = make_query_fn(mesh, layout, steps=0, m_cap=512, k=5, multiprobe=True,
                     exclude_self=True, has_lp=cstate.corpus_lp is not None,
                     has_coarse=True, coarse_refine=64)
cids, _, _ = cqfn(cstate, q, qids)
cids = np.asarray(jax.device_get(cids))

# --- flat leg: host-local rows, distributed sketch/corpus ---
from similaritysearchbyrdf_tpu.parallel.sharded_flat import (
    fit_flat_sharded_distributed, make_flat_query_fn,
    fit_sparse_flat_sharded_distributed, make_sparse_flat_query_fn)
fstate, _ = fit_flat_sharded_distributed(
    x[lo:hi], np.arange(lo, hi, dtype=np.int32), mesh)
fqfn = make_flat_query_fn(mesh, k=5, refine=32, block=64)
fids, _ = fqfn(fstate, q, qids)
fids = np.asarray(jax.device_get(fids))

# --- sparse flat leg ---
from similaritysearchbyrdf_tpu.vectors import SparseBatch
srng = np.random.default_rng(9)
n_sp, dim_sp, nnz = 512, 128, 6
sidx = np.stack([srng.choice(dim_sp, size=nnz, replace=False)
                 for _ in range(n_sp)]).astype(np.int32)
sval = (1.0 + 0.1 * srng.normal(size=(n_sp, nnz))).astype(np.float32)
shalf = n_sp // 2
slo, shi = proc_id * shalf, (proc_id + 1) * shalf
slocal = SparseBatch(ids=np.arange(slo, shi, dtype=np.int32), size=dim_sp,
                     indices=sidx[slo:shi], values=sval[slo:shi],
                     lengths=np.full(shalf, nnz, np.int32))
sfstate, _ = fit_sparse_flat_sharded_distributed(slocal, mesh)
sffn = make_sparse_flat_query_fn(mesh, k=5, refine=32)
sfids, _ = sffn(sfstate, jnp.asarray(sidx[:16]), jnp.asarray(sval[:16]),
                jnp.arange(16, dtype=jnp.int32))
sfids = np.asarray(jax.device_get(sfids))

# --- IVF leg: psum-merged global k-means over host-local rows; full
# probe + wide refine makes the result exact regardless of clustering ---
from similaritysearchbyrdf_tpu.parallel.sharded_ivf import (
    fit_ivf_sharded_distributed, make_ivf_query_fn)
ist, _ = fit_ivf_sharded_distributed(
    x[lo:hi], np.arange(lo, hi, dtype=np.int32), mesh,
    target_cluster=32, iters=3)
kc = int(ist.centroids.shape[0])
iqfn = make_ivf_query_fn(mesh, k=5, nprobe=kc, win=8, refine=512)
iids, _ = iqfn(ist, q, qids)
iids = np.asarray(jax.device_get(iids))

if proc_id == 0:
    np.savez(out, ids=ids, cids=cids, fids=fids, sfids=sfids, iids=iids)
print("WORKER", proc_id, "OK", flush=True)
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_distributed_fit_matches_single(tmp_path):
    port = _free_port()
    out = str(tmp_path / "ids0.npz")
    env = dict(os.environ)
    env.update(
        JAX_PLATFORMS="cpu",
        XLA_FLAGS=env.get("XLA_FLAGS", "").replace(
            "--xla_force_host_platform_device_count=8", ""
        )
        + " --xla_force_host_platform_device_count=4",
    )
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", WORKER, str(pid), str(port), out],
            env=env, cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for pid in (0, 1)
    ]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    for pid, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{log[-4000:]}"

    # single-process reference: same corpus, same seeds, 8-device mesh
    import jax.numpy as jnp

    from similaritysearchbyrdf_tpu.config import RDFConfig, TableConfig
    from similaritysearchbyrdf_tpu.index.bucket_table import KeyLayout
    from similaritysearchbyrdf_tpu.parallel.mesh import make_forest_mesh
    from similaritysearchbyrdf_tpu.parallel.sharded_forest import (
        fit_sharded, make_query_fn)
    from similaritysearchbyrdf_tpu.vectors import DenseBatch

    conf = RDFConfig(
        vector_dim=16, table_num=3, permutation_num=1, family_size=20,
        partition_bits=2, lsh_table=TableConfig(chain_length=12,
                                                bucket_overflow=16),
        query_batch_size=16, max_candidates=512, top_k=5, seed=77,
    )
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(16, 16))
    x = centers[rng.integers(0, 16, 1024)] + 0.1 * rng.normal(size=(1024, 16))
    x = (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)

    mesh = make_forest_mesh(8)
    batch = DenseBatch(np.arange(1024, dtype=np.int32), x)
    state, _ = fit_sharded(conf, batch, mesh)
    layout = KeyLayout.from_config(conf, conf.lsh_table)
    qfn = make_query_fn(mesh, layout, steps=1, m_cap=512, k=5,
                        multiprobe=True, exclude_self=True,
                        has_lp=state.corpus_lp is not None)
    q = jnp.asarray(x[:32])
    qids = jnp.arange(32, dtype=jnp.int32)
    ids_ref, _, _ = qfn(state, q, qids)
    z = np.load(out)
    np.testing.assert_array_equal(z["ids"], np.asarray(ids_ref))

    # coarse leg reference
    cconf = conf.replace(coarse_dim=16, coarse_refine=64)
    cstate, _ = fit_sharded(cconf, batch, mesh)
    cqfn = make_query_fn(mesh, layout, steps=0, m_cap=512, k=5,
                         multiprobe=True, exclude_self=True,
                         has_lp=cstate.corpus_lp is not None,
                         has_coarse=True, coarse_refine=64)
    cids_ref, _, _ = cqfn(cstate, q, qids)
    np.testing.assert_array_equal(z["cids"], np.asarray(cids_ref))

    # flat leg reference (single-process 8-device fit over the full corpus)
    from similaritysearchbyrdf_tpu.parallel.sharded_flat import (
        fit_flat_sharded, make_flat_query_fn,
        fit_sparse_flat_sharded, make_sparse_flat_query_fn,
    )

    fstate, _ = fit_flat_sharded(x, np.arange(1024, dtype=np.int32), mesh)
    fqfn = make_flat_query_fn(mesh, k=5, refine=32, block=64)
    fids_ref, _ = fqfn(fstate, q, qids)
    np.testing.assert_array_equal(z["fids"], np.asarray(fids_ref))

    # sparse flat leg reference
    from similaritysearchbyrdf_tpu.vectors import SparseBatch

    srng = np.random.default_rng(9)
    n_sp, dim_sp, nnz = 512, 128, 6
    sidx = np.stack([srng.choice(dim_sp, size=nnz, replace=False)
                     for _ in range(n_sp)]).astype(np.int32)
    sval = (1.0 + 0.1 * srng.normal(size=(n_sp, nnz))).astype(np.float32)
    sbatch = SparseBatch(ids=np.arange(n_sp, dtype=np.int32), size=dim_sp,
                         indices=sidx, values=sval,
                         lengths=np.full(n_sp, nnz, np.int32))
    sfstate, _ = fit_sparse_flat_sharded(sbatch, mesh)
    sffn = make_sparse_flat_query_fn(mesh, k=5, refine=32)
    sfids_ref, _ = sffn(sfstate, jnp.asarray(sidx[:16]),
                        jnp.asarray(sval[:16]),
                        jnp.arange(16, dtype=jnp.int32))
    np.testing.assert_array_equal(z["sfids"], np.asarray(sfids_ref))

    # IVF leg reference: full probe + wide refine covers every row on
    # every shard, so the distributed result must equal brute force
    from similaritysearchbyrdf_tpu import exact_search

    gt_ids, _ = exact_search(x, x[:32], k=5, exclude_self=True)
    np.testing.assert_array_equal(z["iids"], gt_ids)
