"""Hash bits at HIGHEST precision against a numpy float64 sign-hash of the
same projections (dense, with margins, and sparse), and the compile-cache
path rule of the entry scripts."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from similaritysearchbyrdf_tpu.config import RDFConfig, TableConfig
from similaritysearchbyrdf_tpu.models.families import generate_angle_model
from similaritysearchbyrdf_tpu.ops import hashing as H
from similaritysearchbyrdf_tpu.utils import device as DV

NEAR_ZERO = 1e-5


def _model(d, chain, tables=4, perms=3, seed=5):
    return generate_angle_model(RDFConfig(
        vector_dim=d, table_num=tables, permutation_num=perms,
        family_size=max(d, 20), lsh_table=TableConfig(chain_length=chain),
        seed=seed))


def _np_bits(model, x):
    """float64 dots [B, T*P, C] in packed order, and the packed hashes."""
    proj = np.asarray(model.proj, np.float64)
    perm = np.asarray(model.perm)
    dots = np.einsum("bd,tcd->btc", x.astype(np.float64), proj)
    pd = np.take_along_axis(dots[:, :, None, :], perm[None].astype(np.int64),
                            axis=-1)                     # [B, T, P, C]
    b, t, p, c = pd.shape
    pd = pd.reshape(b, t * p, c)
    shifts = np.arange(31, 31 - c, -1, dtype=np.uint64)
    packed = ((pd > 0).astype(np.uint64) << shifts).sum(-1)
    return pd, packed.astype(np.uint32)


def _assert_bits_match(got, pd, packed):
    differ = got != packed
    if differ.any():
        # a differing word is allowed only where every differing bit's dot
        # is within NEAR_ZERO of the hyperplane
        c = pd.shape[-1]
        bits = (got[..., None] >> np.arange(31, 31 - c, -1).astype(
            np.uint32)) & 1
        bad = (bits.astype(bool) != (pd > 0)) & (np.abs(pd) >= NEAR_ZERO)
        assert not bad.any()


@pytest.mark.parametrize("d,chain", [(16, 8), (32, 32), (100, 32),
                                     (128, 16), (100, 24)])
def test_hash_dense_highest_matches_float64(d, chain):
    rng = np.random.default_rng(d + chain)
    model = _model(d, chain)
    x = rng.normal(size=(257, d)).astype(np.float32)
    pd, packed = _np_bits(model, x)
    _assert_bits_match(np.asarray(H.hash_dense(model, jnp.asarray(x))),
                       pd, packed)


@pytest.mark.parametrize("d,chain", [(32, 32), (100, 20)])
def test_hash_margins_highest_match_float64(d, chain):
    rng = np.random.default_rng(7 * d)
    model = _model(d, chain)
    x = rng.normal(size=(64, d)).astype(np.float32)
    pd, packed = _np_bits(model, x)
    h, margins = H.hash_dense_with_margins(model, jnp.asarray(x))
    _assert_bits_match(np.asarray(h), pd, packed)
    m = np.asarray(margins)
    np.testing.assert_array_equal(m[..., :32 - chain], np.inf)
    np.testing.assert_allclose(m[..., 32 - chain:], np.abs(pd)[..., ::-1],
                               rtol=1e-5, atol=1e-6)


def test_hash_sparse_highest_matches_float64():
    rng = np.random.default_rng(3)
    d, nnz = 64, 6
    model = _model(d, 16)
    idx = np.stack([rng.choice(d, nnz, replace=False) for _ in range(40)])
    val = rng.normal(size=(40, nnz)).astype(np.float32)
    dense = np.zeros((40, d), np.float32)
    np.put_along_axis(dense, idx, val, axis=1)
    pd, packed = _np_bits(model, dense)
    got = H.hash_sparse(model, jnp.asarray(idx.astype(np.int32)),
                        jnp.asarray(val))
    _assert_bits_match(np.asarray(got), pd, packed)


def test_projection_runs_at_highest():
    """The projection asks XLA for HIGHEST precision (TF32 would round
    operands on the GPU)."""
    model = _model(32, 16)
    txt = jax.jit(H.hash_dense).lower(
        model, jnp.zeros((8, 32), jnp.float32)).as_text()
    assert "HIGHEST" in txt


@pytest.mark.parametrize("env,want", [
    ({}, "root/.jax_cache"),
    ({"JAX_COMPILATION_CACHE_DIR": ""}, "root/.jax_cache"),
    ({"JAX_COMPILATION_CACHE_DIR": "/elsewhere"}, None),
])
def test_compile_cache_dir_rule(env, want):
    got = DV.compile_cache_dir(env, "/some/root")
    if want is None:
        assert got is None
    else:
        assert got == os.path.join("/some", want)


def test_enable_compile_cache_respects_env(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/from/env")
    assert DV.enable_compile_cache("/repo") == "/from/env"
    assert calls == []
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    assert DV.enable_compile_cache("/repo") == "/repo/.jax_cache"
    assert calls == [("jax_compilation_cache_dir", "/repo/.jax_cache")]


def test_require_platform():
    assert DV.require_platform("cpu").platform == "cpu"
    with pytest.raises(RuntimeError, match="expected a gpu device"):
        DV.require_platform("gpu")
