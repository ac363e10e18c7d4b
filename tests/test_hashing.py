"""Hash parity vs the scalar oracle (the batched analogue of the
reference's exact-value suites `AngleHashSuite.scala` / `PStableHashSuite.scala`)."""

import numpy as np
import jax.numpy as jnp

import oracle
from similaritysearchbyrdf_tpu.config import RDFConfig, TableConfig, PStableConfig
from similaritysearchbyrdf_tpu.models.families import (
    generate_angle_model,
    generate_pstable_model,
    save_model_file,
    load_model_file,
)
from similaritysearchbyrdf_tpu.ops.hashing import (
    hash_dense,
    hash_sparse,
    hash_sparse_densify,
)


def _conf(**kw):
    base = dict(
        vector_dim=16,
        table_num=3,
        permutation_num=2,
        family_size=20,
        lsh_table=TableConfig(chain_length=8),
        seed=99,
    )
    base.update(kw)
    return RDFConfig(**base)


def test_angle_hash_matches_oracle():
    conf = _conf()
    model = generate_angle_model(conf)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(7, 16)).astype(np.float32)
    got = np.asarray(hash_dense(model, jnp.asarray(x)))  # [7, 6]
    proj = np.asarray(model.proj)
    perm = np.asarray(model.perm)
    for b in range(7):
        for t in range(3):
            for p in range(2):
                chain = proj[t][perm[t, p]]  # permuted function order
                expect = oracle.angle_chain_hash(chain, x[b])
                assert int(got[b, 2 * t + p]) == expect, (b, t, p)


def test_angle_permutations_same_sign_set():
    """A permutation reorders packed bits but not the sign set — popcount of
    every permuted hash of the same base table must match
    (SURVEY.md §7 hard part (e))."""
    conf = _conf(permutation_num=4)
    model = generate_angle_model(conf)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(5, 16)).astype(np.float32)
    h = np.asarray(hash_dense(model, jnp.asarray(x)))
    pc = np.vectorize(lambda v: bin(int(v)).count("1"))(h.astype(np.uint32))
    pc = pc.reshape(5, 3, 4)
    assert (pc == pc[:, :, :1]).all()


def test_pstable_hash_matches_oracle():
    conf = _conf(family_name="pStable", permutation_num=1,
                 pstable=PStableConfig(mu=0.0, sigma=1.0, w=4))
    model = generate_pstable_model(conf)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 16)).astype(np.float32)
    got = np.asarray(hash_dense(model, jnp.asarray(x)))
    proj = np.asarray(model.proj)
    b_arr = np.asarray(model.b)
    for i in range(4):
        for t in range(3):
            expect = oracle.pstable_chain_hash(proj[t], b_arr[t], model.w, x[i])
            assert int(got[i, t]) == expect, (i, t)


def test_sparse_hash_equals_dense_hash_of_densified():
    conf = _conf()
    model = generate_angle_model(conf)
    rng = np.random.default_rng(4)
    b, nnz, d = 6, 5, 16
    idx = np.stack([rng.choice(d, size=nnz, replace=False) for _ in range(b)]).astype(np.int32)
    val = rng.normal(size=(b, nnz)).astype(np.float32)
    dense = np.zeros((b, d), dtype=np.float32)
    for i in range(b):
        dense[i, idx[i]] = val[i]
    h_dense = np.asarray(hash_dense(model, jnp.asarray(dense)))
    h_sparse = np.asarray(hash_sparse(model, jnp.asarray(idx), jnp.asarray(val)))
    h_densify = np.asarray(hash_sparse_densify(model, jnp.asarray(idx), jnp.asarray(val)))
    np.testing.assert_array_equal(h_dense, h_sparse)
    np.testing.assert_array_equal(h_dense, h_densify)


def test_model_file_roundtrip(tmp_path):
    """Hash-function file save/load must preserve hashes — the reference's
    model checkpoint (`LSH.scala:173-195`, `AngleHashFamily.scala:158-177`)."""
    conf = _conf()
    model = generate_angle_model(conf)
    path = str(tmp_path / "family.txt")
    save_model_file(model, path)
    loaded = load_model_file(path, conf)
    assert loaded.total_tables == model.total_tables
    rng = np.random.default_rng(5)
    x = rng.normal(size=(4, 16)).astype(np.float32)
    h0 = np.asarray(hash_dense(model, jnp.asarray(x)))
    h1 = np.asarray(hash_dense(loaded, jnp.asarray(x)))
    np.testing.assert_array_equal(h0, h1)


def test_type_of_index_pipeline():
    """sampling transform must be applied identically at fit and query; check
    it changes hashes but stays deterministic."""
    conf = _conf(type_of_index="sampling")
    model = generate_angle_model(conf)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(3, 16)).astype(np.float32)
    h1 = np.asarray(hash_dense(model, jnp.asarray(x)))
    h2 = np.asarray(hash_dense(model, jnp.asarray(x)))
    np.testing.assert_array_equal(h1, h2)
    conf0 = _conf(type_of_index="original")
    model0 = generate_angle_model(conf0)
    h0 = np.asarray(hash_dense(model0, jnp.asarray(x)))
    assert (h0 != h1).any()
