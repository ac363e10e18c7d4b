"""Flat group max: the Triton kernel in interpret mode against the plain
reference, the wrapper's tiling and padding, the choice of kernel by
platform, and the argpack / grouped consumers (dead-group masking)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from similaritysearchbyrdf_tpu.ops import flat as F
from similaritysearchbyrdf_tpu.ops.pallas import groupmax as GM


def _np_group_max(q, sk, group, pack):
    s = q.astype(np.int64) @ sk.astype(np.int64).T
    if pack:
        s = (s << (group.bit_length() - 1)) | (np.arange(sk.shape[0])
                                              % group)[None, :]
    return s.reshape(q.shape[0], -1, group).max(-1)


def _i8(rng, shape):
    return rng.integers(-127, 128, shape).astype(np.int8)


@pytest.mark.parametrize("b,d,n,group,pack", [
    (16, 128, 512, 64, True),
    (40, 128, 1024, 64, True),
    (130, 128, 512, 64, False),
    (24, 256, 512, 64, True),
    (16, 384, 256, 64, False),
    (20, 128, 512, 16, True),
    (16, 128, 1024, 512, False),
])
def test_kernel_interpret_matches_plain(b, d, n, group, pack):
    """Integer scores: the kernel equals the plain version bit for bit,
    across batch padding, multi-slice contraction, non-pow2 lane widths
    and group widths below and above the row tile."""
    rng = np.random.default_rng(b + d + n)
    q, sk = _i8(rng, (b, d)), _i8(rng, (n, d))
    got = np.asarray(GM.group_max_pallas(jnp.asarray(q), jnp.asarray(sk),
                                         group=group, pack=pack,
                                         interpret=True))
    ref = np.asarray(F.group_max_plain(jnp.asarray(q), jnp.asarray(sk),
                                       group, pack))
    assert got.dtype == np.int32 and got.shape == (b, n // group)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(ref.astype(np.int64),
                                  _np_group_max(q, sk, group, pack))


def test_kernel_interpret_bf16_matches_plain():
    rng = np.random.default_rng(3)
    q = jnp.asarray(rng.normal(size=(32, 128)), jnp.bfloat16)
    sk = jnp.asarray(rng.normal(size=(512, 128)), jnp.bfloat16)
    got = np.asarray(GM.group_max_pallas(q, sk, interpret=True))
    ref = np.asarray(F.group_max_plain(q, sk))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("b,want", [(1, 16), (16, 16), (17, 32), (40, 64),
                                    (64, 64), (1024, GM.MAX_BLOCK_B)])
def test_block_b_for(b, want):
    assert GM.block_b_for(b) == want


@pytest.mark.parametrize("limit_rows,n", [(256, 1024), (512, 2048),
                                         (768, 1536)])
def test_kernel_chunks_large_sketches(monkeypatch, limit_rows, n):
    """Sketches above MAX_OPERAND_BYTES go to the kernel in row chunks of
    whole row tiles; the concatenated result equals one plain pass."""
    rng = np.random.default_rng(limit_rows + n)
    d = 128
    monkeypatch.setattr(GM, "MAX_OPERAND_BYTES", limit_rows * d + 100)
    jax.clear_caches()
    q, sk = _i8(rng, (24, d)), _i8(rng, (n, d))
    got = np.asarray(GM.group_max_pallas(jnp.asarray(q), jnp.asarray(sk),
                                         pack=True, interpret=True))
    jax.clear_caches()
    np.testing.assert_array_equal(got.astype(np.int64),
                                  _np_group_max(q, sk, 64, True))


def test_kernel_rejects_unpadded_lanes_and_rows():
    q = jnp.zeros((16, 100), jnp.int8)
    sk = jnp.zeros((512, 100), jnp.int8)
    with pytest.raises(AssertionError):
        GM.group_max_pallas(q, sk, interpret=True)
    with pytest.raises(AssertionError):
        GM.group_max_pallas(jnp.zeros((16, 128), jnp.int8),
                            jnp.zeros((300, 128), jnp.int8), interpret=True)


def test_kernel_lowers_for_cuda():
    """The kernel lowers to one Triton custom call for CUDA on this host
    (the GPU compiler itself runs only on the card)."""
    from jax import export

    q = jax.ShapeDtypeStruct((1024, 128), jnp.int8)
    sk = jax.ShapeDtypeStruct((8192, 128), jnp.int8)
    exp = export.export(
        jax.jit(lambda a, b: GM.group_max_pallas(a, b, pack=True)),
        platforms=["cuda"],
        disabled_checks=[export.DisabledSafetyCheck.custom_call(
            "__gpu$xla.gpu.triton")],
    )(q, sk)
    txt = exp.mlir_module()
    assert txt.count("__gpu$xla.gpu.triton") == 1
    assert "grid_x = %d" % (1024 // GM.MAX_BLOCK_B) in txt
    assert "grid_y = %d" % (8192 // GM.BLOCK_N) in txt


def test_group_max_lowers_plain_off_cuda():
    """On the CPU `group_max` compiles the plain version (no Triton call)
    and returns the same values."""
    rng = np.random.default_rng(5)
    q, sk = _i8(rng, (32, 128)), _i8(rng, (8192, 128))
    f = jax.jit(lambda a, b: F.group_max(a, b, 64, pack=True))
    assert "triton" not in f.lower(jnp.asarray(q), jnp.asarray(sk)).as_text()
    np.testing.assert_array_equal(
        np.asarray(f(jnp.asarray(q), jnp.asarray(sk))).astype(np.int64),
        _np_group_max(q, sk, 64, True))


@pytest.mark.parametrize("n_live_off", [0, 100, 8000])
def test_argpack_dead_groups_masked(n_live_off):
    """Rows past n_live (row padding to the 8192 multiple, or a caller's
    dead tail) never become candidates, and the candidates are exactly the
    argmax rows of the top live groups."""
    rng = np.random.default_rng(n_live_off)
    nrows, d, b, refine = 9000, 128, 8, 16
    x = rng.normal(size=(nrows, d)).astype(np.float32)
    sk, _ = F.build_flat_sketch(jnp.asarray(x))
    q = rng.normal(size=(b, d)).astype(np.float32)
    n_live = nrows - n_live_off
    cand, sel_s = F._argpack_candidates(sk, jnp.asarray(q), refine, 64,
                                        n_live=n_live)
    cand, sel_s = np.asarray(cand), np.asarray(sel_s)
    live = np.isfinite(sel_s)
    assert (cand[live] < n_live).all()
    q8 = np.asarray(F._query_lp(jnp.asarray(q), jnp.int8, d))
    npad = -(-nrows // F._BLOCK_N) * F._BLOCK_N
    skp = np.zeros((npad, d), np.int8)
    skp[:nrows] = np.asarray(sk)
    pk = _np_group_max(q8, skp, 64, True)
    pk[:, (np.arange(npad // 64) * 64) >= n_live] = F._I32_DEAD
    for i in range(b):
        gi = np.argsort(-pk[i], kind="stable")[:refine]
        # a partial last live group's argmax may be a dead row: masked
        want = {int(pk[i, g]) >> 6 for g in gi
                if pk[i, g] > F._I32_DEAD
                and g * 64 + (int(pk[i, g]) & 63) < n_live}
        got = {int(s) for s in sel_s[i][live[i]]}
        assert got == want


@pytest.mark.parametrize("dtype,nrows", [("int8", 5000), ("bfloat16", 5000),
                                         ("int8", 8192)])
def test_grouped_candidates_contain_sketch_topk(dtype, nrows):
    """The grouped path (group max → top groups → window rescore) keeps
    every row of the sketch's own top-k, and never returns padded rows."""
    rng = np.random.default_rng(11)
    d, b, k = 64, 16, 10
    x = rng.normal(size=(nrows, d)).astype(np.float32)
    sk, _ = F.build_flat_sketch(jnp.asarray(x), dtype)
    q = rng.normal(size=(b, d)).astype(np.float32)
    cand, sel_s = F._grouped_candidates(sk, jnp.asarray(q), 64, 3 * k, 64,
                                        0.998, select_mode="exact2")
    cand, sel_s = np.asarray(cand), np.asarray(sel_s)
    assert (cand[np.isfinite(sel_s)] < nrows).all()
    skf = np.asarray(sk.astype(jnp.float32))[:, :d]
    qb = np.asarray(jnp.asarray(q).astype(jnp.bfloat16).astype(jnp.float32))
    scores = qb @ skf.T
    for i in range(b):
        top = set(np.argsort(-scores[i], kind="stable")[:k // 2].tolist())
        assert top <= set(cand[i].tolist())


def test_select_packed_rows_skips_dead_sentinel():
    """Dead groups (I32_DEAD) are selected only when fewer live groups
    exist than `refine`, and then come back as -inf."""
    packed = np.full((2, 64), F._I32_DEAD, np.int32)
    packed[0, 3] = (5 << 6) | 7
    packed[1, 10] = (9 << 6) | 1
    cand, sel_s = F.select_packed_rows(jnp.asarray(packed), group=64,
                                       refine=4, n=64 * 64)
    cand, sel_s = np.asarray(cand), np.asarray(sel_s)
    assert cand[0, 0] == 3 * 64 + 7 and sel_s[0, 0] == 5
    assert cand[1, 0] == 10 * 64 + 1 and sel_s[1, 0] == 9
    assert np.isneginf(sel_s[:, 1:]).all()
