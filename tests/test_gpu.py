"""Tests that need a CUDA device (marker `gpu`): they skip on hosts without
one. On the card: `python -m pytest -m gpu tests/`."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from similaritysearchbyrdf_tpu.ops import flat as F
from similaritysearchbyrdf_tpu.ops.pallas import groupmax as GM


@pytest.fixture
def gpu():
    """Decided per test, never at import: every worker collects the same
    tests."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a CUDA device")
    return jax.devices()[0]


@pytest.mark.gpu
@pytest.mark.parametrize("d,pack", [(128, True), (4096, False)])
def test_kernel_compiled_matches_plain(gpu, d, pack):
    """The compiled Triton kernel equals the plain version bit for bit."""
    rng = np.random.default_rng(d)
    q = jnp.asarray(rng.integers(-127, 128, (1000, d)).astype(np.int8))
    sk = jnp.asarray(rng.integers(-127, 128, (65536, d)).astype(np.int8))
    got = GM.group_max_pallas(q, sk, pack=pack)
    ref = F.group_max_plain(q, sk, pack=pack)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


@pytest.mark.gpu
def test_kernel_over_2gib_matches_plain(gpu):
    """An int8 sketch over 2 GiB (chunked by the wrapper) still equals the
    plain version: without chunks Pallas's 32-bit offsets wrap."""
    k1, k2 = jax.random.split(jax.random.key(0))
    sk = jax.random.randint(k1, (598016, 4096), -127, 128, jnp.int8)
    q = jax.random.randint(k2, (64, 4096), -127, 128, jnp.int8)
    got = GM.group_max_pallas(q, sk)
    ref = F.group_max_plain(q, sk)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


@pytest.mark.gpu
def test_flat_query_same_on_gpu_and_host(gpu):
    """A grouped flat query on the card returns the host CPU's ids."""
    from similaritysearchbyrdf_tpu.vectors import DenseBatch

    rng = np.random.default_rng(1)
    x = rng.normal(size=(20000, 100)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = x[:64] + 0.01 * rng.normal(size=(64, 100)).astype(np.float32)
    fi = F.FlatIndex().fit(DenseBatch(np.arange(20000, dtype=np.int32), x))
    ids, _ = fi.query(q)
    cpu = jax.devices("cpu")[0]
    fi.sketch, fi.corpus, fi.row_ids = jax.device_put(
        (fi.sketch, fi.corpus, fi.row_ids), cpu)
    with jax.default_device(cpu):
        ids_cpu, _ = fi.query(q)
    np.testing.assert_array_equal(ids, ids_cpu)
