"""typeOfIndex hash post-transforms, vectorized.

The reference selects one of four transforms of the raw 32-bit compound hash
via `mclab.lsh.typeOfIndex` (`LSH.scala:110-120`):

  original          — identity
  sampling          — seeded bit-position permutation (`Sampling.scala:32-39`)
  continueBitsCount — run-length statistics of the low 28 bits re-packed into
                      7-bit fields (`significantBits.scala:11-67`)
  angleNewMethod    — angle-to-all-ones bucketing (`significantBits.scala:100-127`)

plus `variableBits` (`significantBits.scala:129-138`), present but unused in
the reference's dispatch; included for completeness.

All transforms here are elementwise uint32 ops over whole hash batches.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np

from ..ops.bitops import as_u32, popcount


def sampling_permutation(seed: int) -> np.ndarray:
    """The seeded permutation of bit positions 0..31.

    The reference shuffles [0..31] with `scala.util.Random(seed)`
    (`Sampling.scala:6-11`, seed hardcoded to 88387 at `LSH.scala:21`). The
    JVM shuffle sequence is not reproducible outside the JVM, so we derive an
    equally deterministic permutation from the same seed with numpy; the
    *operation* (fixed seeded bit shuffle) is identical.
    """
    return np.random.default_rng(seed).permutation(32).astype(np.int32)


def sampling_one_key(keys: jax.Array, perm: jax.Array) -> jax.Array:
    """out bit (31-j) = in bit perm[j] — ref `Sampling.samplingOneKey`
    (`Sampling.scala:32-39`)."""
    k = as_u32(keys)
    out = jnp.zeros_like(k)
    for j in range(32):  # static unroll: 32 elementwise shifts/ors
        bit = (k >> perm[j].astype(jnp.uint32)) & jnp.uint32(1)
        out = out | (bit << jnp.uint32(31 - j))
    return out


def continue_bits_count(
    keys: jax.Array, num_of_bits: tuple = (6, 4, 2, 1)
) -> jax.Array:
    """Count runs of consecutive 1-bits in the low 28 bits, bucketed by run
    length thresholds, repacked into four 7-bit fields under the original top
    4 bits — ref `significantBits.continueBitsCount`
    (`significantBits.scala:11-67`).

    counts[k] = number of runs with length >= num_of_bits[k]; the scan walks
    bits LSB→MSB, closing a run at each 0 bit and at bit 27.
    """
    k = as_u32(keys)
    top4 = k >> jnp.uint32(28)
    thresholds = jnp.asarray(num_of_bits, dtype=jnp.int32)  # [4]

    def body(i, state):
        run, counts = state
        bit = ((k >> jnp.uint32(i)) & jnp.uint32(1)).astype(jnp.int32)
        run = run + bit
        # a run closes when bit==0, or when bit==1 at the last position i==27
        close = jnp.where(bit == 0, 1, jnp.where(i == 27, 1, 0))
        inc = (run[..., None] >= thresholds) & (close[..., None] == 1)
        counts = counts + inc.astype(jnp.int32)
        run = jnp.where(close == 1, 0, run)
        return run, counts

    run0 = jnp.zeros(k.shape, dtype=jnp.int32)
    counts0 = jnp.zeros(k.shape + (4,), dtype=jnp.int32)
    _, counts = jax.lax.fori_loop(0, 28, body, (run0, counts0))

    # repack: tmp = c3<<21 | c2<<14 | c1<<7 | c0, + top4<<28
    c = counts.astype(jnp.uint32)
    out = (
        (c[..., 3] << jnp.uint32(21))
        + (c[..., 2] << jnp.uint32(14))
        + (c[..., 1] << jnp.uint32(7))
        + c[..., 0]
        + (top4 << jnp.uint32(28))
    )
    return out


_ANGLE_THRESHOLDS = np.array(
    [16.0, 25.0, 33.0, 39.0, 46.0, 52.0, 58.0, 66.0, 72.0], dtype=np.float32
)


def angle_distance_deg(keys: jax.Array) -> jax.Array:
    """Angle (degrees) between the low-28-bit 0/1 vector and all-ones — ref
    `significantBits.angleDistance` (`significantBits.scala:100-112`).
    dot = popcount, |v| = sqrt(popcount) ⇒ angle = acos(sqrt(pc/28)).
    pc == 0 yields NaN, matching the JVM's 0/0 double behavior."""
    pc = popcount(as_u32(keys) & jnp.uint32(0x0FFFFFFF)).astype(jnp.float32)
    cos = pc / (jnp.sqrt(jnp.float32(28.0)) * jnp.sqrt(pc))
    return jnp.degrees(jnp.arccos(jnp.clip(cos, -1.0, 1.0) * jnp.where(pc > 0, 1.0, jnp.nan)))


def angle_new_method(keys: jax.Array) -> jax.Array:
    """Replace the third 7-bit field with the angle bucket — ref
    `significantBits.newMethod` (`significantBits.scala:113-127`)."""
    k = as_u32(keys)
    angle = angle_distance_deg(k)
    thr = jnp.asarray(_ANGLE_THRESHOLDS)
    # while(index<9 && angle > thr[index]) index++  ⇒ index = #(thr < angle);
    # NaN compares false everywhere ⇒ index 0, matching the JVM loop.
    label = jnp.sum((angle[..., None] > thr).astype(jnp.uint32), axis=-1)
    mask7 = jnp.uint32(0x7F)
    first4 = (k >> jnp.uint32(28)) & mask7
    first7 = (k >> jnp.uint32(21)) & mask7
    three7 = (k >> jnp.uint32(7)) & mask7
    last7 = k & mask7
    return (
        last7
        + (three7 << jnp.uint32(7))
        + (label << jnp.uint32(14))
        + (first7 << jnp.uint32(21))
        + (first4 << jnp.uint32(28))
    )


def variable_bits(keys: jax.Array) -> jax.Array:
    """Different bit widths per layer — ref `significantBits.variableBits`
    (`significantBits.scala:129-138`)."""
    k = as_u32(keys)
    mask7, mask4 = jnp.uint32(0x7F), jnp.uint32(0xF)
    first4 = (k >> jnp.uint32(28)) & mask7
    first7 = (k >> jnp.uint32(24)) & mask4
    second7 = (k >> jnp.uint32(17)) & mask7
    three7 = (k >> jnp.uint32(10)) & mask7
    last7 = (k >> jnp.uint32(3)) & mask7
    return (
        last7
        + (three7 << jnp.uint32(7))
        + (second7 << jnp.uint32(14))
        + (first7 << jnp.uint32(21))
        + (first4 << jnp.uint32(28))
    )


def apply_type_of_index(
    keys: jax.Array, type_of_index: str, sampling_perm: jax.Array
) -> jax.Array:
    """Dispatch matching `LSH.calculateIndex` (`LSH.scala:110-120`)."""
    if type_of_index == "original":
        return as_u32(keys)
    if type_of_index == "sampling":
        return sampling_one_key(keys, sampling_perm)
    if type_of_index == "continueBitsCount":
        return continue_bits_count(keys)
    if type_of_index == "angleNewMethod":
        return angle_new_method(keys)
    if type_of_index == "variableBits":
        return variable_bits(keys)
    raise ValueError(f"unknown typeOfIndex {type_of_index!r}")
