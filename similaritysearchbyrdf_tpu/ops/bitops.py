"""Vectorized 32-bit integer/bit utilities used across the hash pipeline.

The reference does all of this one int at a time on the JVM
(`Sampling.scala`, `significantBits.scala`, `ByteArrayWrapper.scala`); here
every op is elementwise over whole hash batches.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def as_u32(x: jax.Array) -> jax.Array:
    return x.astype(jnp.uint32) if x.dtype != jnp.uint32 else x


def as_i32(x: jax.Array) -> jax.Array:
    return x.astype(jnp.int32) if x.dtype != jnp.int32 else x


def popcount(x: jax.Array) -> jax.Array:
    """Integer.bitCount equivalent."""
    return jax.lax.population_count(as_u32(x)).astype(jnp.int32)


def clz(x: jax.Array) -> jax.Array:
    """Integer.numberOfLeadingZeros equivalent (32 for x==0)."""
    return jax.lax.clz(as_u32(x)).astype(jnp.int32)


def pack_bits_msb_first(bits: jax.Array, total_bits: int = 32) -> jax.Array:
    """Pack 0/1 bits along the last axis into a uint32, first bit highest.

    Reproduces the reference's chain packing: `result = result<<1 | s_j` then
    `result << (32 - chainSize)` (`AngleHashFamily.scala:187-219`), i.e. the
    j-th sign lands at bit (total_bits-1-j).
    """
    c = bits.shape[-1]
    weights = jnp.asarray(
        np.left_shift(np.uint32(1), np.arange(total_bits - 1, total_bits - 1 - c, -1,
                                              dtype=np.uint32)),
        dtype=jnp.uint32,
    )
    return jnp.sum(bits.astype(jnp.uint32) * weights, axis=-1, dtype=jnp.uint32)


def bits_of(x: jax.Array, nbits: int = 32) -> jax.Array:
    """Explode a uint32 into its bits along a new trailing axis, LSB at
    index 0 — the layout `LocalitySensitivePartitioner` builds its 32-dim
    vector with (`utils/Partitioner.scala:45-49`)."""
    shifts = jnp.arange(nbits, dtype=jnp.uint32)
    return ((as_u32(x)[..., None] >> shifts) & jnp.uint32(1)).astype(jnp.int32)


def java_bytes_hash_of_ints(ints: jax.Array) -> jax.Array:
    """`java.util.Arrays.hashCode` over the big-endian byte concatenation of
    int32 values along the last axis.

    This is exactly what the p-stable chain does to collapse its per-function
    ints to a 32-bit table index (`PStableHashFamily.scala:122-177` via
    `ByteArrayWrapper.scala:11-14`): h = 1; for each byte b (signed):
    h = 31*h + b. All arithmetic wraps in int32.
    """
    x = as_i32(ints)
    c = x.shape[-1]

    def per_int(h: jax.Array, v: jax.Array) -> jax.Array:
        # bytes MSB→LSB, sign-extended
        for shift in (24, 16, 8, 0):
            b = ((v >> shift) & 0xFF).astype(jnp.int32)
            b = jnp.where(b >= 128, b - 256, b)  # sign-extend the byte
            h = h * jnp.int32(31) + b
        return h

    h = jnp.ones(x.shape[:-1], dtype=jnp.int32)
    for j in range(c):  # chain length is static & small (<=32): unrolled
        h = per_int(h, x[..., j])
    return h


def searchsorted_u32(sorted_keys: jax.Array, queries: jax.Array) -> jax.Array:
    """Vectorized lower-bound binary search of uint32 `queries` in ascending
    uint32 `sorted_keys` ([N]); returns int32 insertion positions."""
    return jnp.searchsorted(sorted_keys, queries, side="left").astype(jnp.int32)
