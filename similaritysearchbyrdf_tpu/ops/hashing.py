"""Batched LSH compound hashing.

Replaces the reference's per-vector, per-table scalar loops (HOT LOOP #1 in
SURVEY.md §3.2: `AngleHashChain.compute`, `AngleHashFamily.scala:187-219`;
`PStableHashChain.compute`, `PStableHashFamily.scala:122-177`) with one
batched projection `einsum('bd,tcd->btc')` followed by vectorized sign /
floor + bit-pack. All `L = tableNum × permutationNum` table hashes for a
whole batch come out of a single jitted call.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..models.families import HashModel
from ..models.transforms import apply_type_of_index
from .bitops import as_u32, java_bytes_hash_of_ints, pack_bits_msb_first


# Hash bits are signs of dots, so a dot that rounds across zero flips a
# bit. A default-precision f32 matmul may round its operands (TF32 on the
# GPU); HIGHEST keeps every backend's signs equal to an f32 reference's
# outside |dot| ~ 1e-6. The projection is [B, D] x [D, T*C], small next to
# the rest of a query.
_PRECISION = jax.lax.Precision.HIGHEST


def _project(model: HashModel, x: jax.Array) -> jax.Array:
    """dots[b, t, c] = <x_b, proj_{t,c}>."""
    return jnp.einsum(
        "bd,tcd->btc",
        x,
        model.proj,
        precision=_PRECISION,
        preferred_element_type=jnp.float32,
    )


def _pack_chains(model: HashModel, dots: jax.Array) -> jax.Array:
    """Turn raw per-function values into packed per-(table, permutation)
    32-bit hashes `[B, T*P]` (uint32)."""
    if model.family == "angle":
        # sign: 1 if dot > 0 else 0 (`AngleHashFamily.scala:184`)
        bits = (dots > 0).astype(jnp.int32)  # [B, T, C]
        # permutation p of table t reorders the chain's functions; bit j of
        # the packed hash is the sign of function perm[t,p,j]
        # (`AngleHashFamily.scala:143-146`)
        permuted = jnp.take_along_axis(
            bits[:, :, None, :],                      # [B, T, 1, C]
            model.perm[None, :, :, :],                # [1, T, P, C]
            axis=-1,
        )  # [B, T, P, C]
        h = pack_bits_msb_first(permuted)             # [B, T, P] uint32
    elif model.family == "pStable":
        # H(v) = ((a.v + b) / w).toInt — scala Double.toInt TRUNCATES toward
        # zero (not floor); XLA's f32→s32 convert has the same semantics.
        # The chain's ints are then byte-packed and Arrays.hashCode'd into
        # one 32-bit index (`PStableHashFamily.scala:122-177`)
        vals = ((dots + model.b[None]) / jnp.float32(model.w)).astype(jnp.int32)
        permuted = jnp.take_along_axis(
            vals[:, :, None, :], model.perm[None, :, :, :], axis=-1
        )  # [B, T, P, C]
        h = as_u32(java_bytes_hash_of_ints(permuted))  # [B, T, P]
    else:
        raise ValueError(f"unknown family {model.family!r}")
    b = h.shape[0]
    return h.reshape(b, -1)  # [B, T*P]; table order = P*t + p, matching
    #                          `AngleHashFamily.scala:144`


@jax.jit
def hash_dense(model: HashModel, x: jax.Array) -> jax.Array:
    """Hash a dense batch `[B, D]` into `[B, L]` uint32 table indexes,
    including the typeOfIndex post-transform (`LSH.calculateIndex`,
    `LSH.scala:135-166`)."""
    dots = _project(model, x.astype(jnp.float32))
    h = _pack_chains(model, dots)
    return apply_type_of_index(h, model.type_of_index, model.sampling_perm)


@jax.jit
def hash_dense_with_margins(
    model: HashModel, x: jax.Array
) -> Tuple[jax.Array, jax.Array]:
    """Like `hash_dense` but also returns per-packed-bit flip margins
    `f32[B, L, 32]`: margin of bit i = |<x, proj of the function packed at
    bit i>| — the hyperplane distance that makes flipping that bit
    worthwhile (small margin = uncertain bit). Structural bits that carry no
    function (chain_length < 32) get +inf. Only defined for the angle family
    with typeOfIndex=original (margin-guided probing is disabled otherwise).
    """
    if model.family != "angle" or model.type_of_index != "original":
        raise ValueError(
            "bit margins require the angle family with typeOfIndex=original"
        )
    dots = _project(model, x.astype(jnp.float32))              # [B, T, C]
    bits = (dots > 0).astype(jnp.int32)
    permuted_bits = jnp.take_along_axis(
        bits[:, :, None, :], model.perm[None, :, :, :], axis=-1
    )                                                          # [B, T, P, C]
    h = pack_bits_msb_first(permuted_bits)                     # [B, T, P]
    permuted_absdots = jnp.take_along_axis(
        jnp.abs(dots)[:, :, None, :], model.perm[None, :, :, :], axis=-1
    )                                                          # [B, T, P, C]
    b = x.shape[0]
    c = dots.shape[-1]
    # chain position j packs at bit 31-j, so along ascending bit index the
    # low 32-c bits are structural (inf) and the top c are reversed |dots|
    margins = jnp.concatenate(
        [
            jnp.full(permuted_absdots.shape[:-1] + (32 - c,), jnp.inf,
                     dtype=jnp.float32),
            jnp.flip(permuted_absdots, axis=-1),
        ],
        axis=-1,
    )                                                          # [B, T, P, 32]
    l = h.shape[1] * h.shape[2]
    return h.reshape(b, l), margins.reshape(b, l, 32)


@jax.jit
def hash_sparse(
    model: HashModel,
    indices: jax.Array,   # [B, NNZ] int32 (padded with 0)
    values: jax.Array,    # [B, NNZ] f32   (padded with 0.0)
) -> jax.Array:
    """Hash a padded sparse batch into `[B, L]` uint32 table indexes.

    The padded-COO dot with every projection row is a gather of projection
    columns + weighted sum — the batched equivalent of the reference's
    BitSet-intersect sparse dot (`SimilarityCalculator.scala:9-27`). Padding
    values are 0 so they contribute nothing.
    """
    t, c, d = model.proj.shape
    proj_cols = model.proj.reshape(t * c, d).T        # [D, T*C]
    gathered = jnp.take(proj_cols, indices, axis=0)   # [B, NNZ, T*C]
    dots = jnp.einsum(
        "bn,bnk->bk", values, gathered, preferred_element_type=jnp.float32,
        precision=_PRECISION,
    ).reshape(values.shape[0], t, c)
    h = _pack_chains(model, dots)
    return apply_type_of_index(h, model.type_of_index, model.sampling_perm)


def hash_sparse_densify(
    model: HashModel, indices: jax.Array, values: jax.Array
) -> jax.Array:
    """Alternative sparse hash: scatter the batch to dense `[B, D]` and use
    the dense path. Preferable when D is small enough that `B*D` fits
    comfortably (auto-selected by the front-end)."""
    b, nnz = indices.shape
    d = model.proj.shape[2]
    dense = jnp.zeros((b, d), dtype=jnp.float32)
    rows = jnp.broadcast_to(jnp.arange(b)[:, None], (b, nnz))
    dense = dense.at[rows, indices].add(values)
    return hash_dense(model, dense)
