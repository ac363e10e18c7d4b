"""Fused sketch scan + 64-row group max, Pallas through Triton (GPU).

The flat engine's preselection needs, for every query and every group of
`group` consecutive sketch rows, the best score in the group (optionally
argmax-packed as `(score << log2(group)) | member`). The plain XLA version
writes the whole `[B, Npad]` score matrix to device memory and reads it
back for the group reduce; this kernel keeps each `[bb, bn]` score tile in
registers and writes only `[bb, bn / group]`.

Blocks are independent: the grid is (query tiles, row tiles), both
parallel, and the contraction loops over 128-wide slices of the lane
dimension inside the block. int8 sketches accumulate in int32 (exact, so
the kernel matches the plain version bit for bit); bf16 sketches
accumulate in float32.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# Tile: the fastest of six (query rows, sketch rows, warps, stages)
# configurations timed at 1,187,840 x 128 int8, B = 1024, argmax-packed on
# an H100 (PERF.md).
BLOCK_K = 128        # contraction slice (lane-padded sketches: D % 128 == 0)
BLOCK_N = 256        # sketch rows per block (4 groups of 64; wider groups
#                      take one group per block)
MAX_BLOCK_B = 64     # queries per block
NUM_WARPS = 4
NUM_STAGES = 2
# Pallas's Triton lowering addresses an operand of at most 2**32 bytes with
# 32-bit signed element offsets, which wrap past 2**31 elements (an int8
# sketch over 2 GiB read wrong rows on the card). Larger sketches are fed
# to the kernel in row chunks below this size.
MAX_OPERAND_BYTES = 2**31 - 1


def block_b_for(b: int) -> int:
    """Query-tile rows for a batch of `b`: a power of two in
    [16, MAX_BLOCK_B] (Triton's dot needs >= 16 rows)."""
    bb = 16
    while bb < min(b, MAX_BLOCK_B):
        bb *= 2
    return bb


def _kernel(q_ref, sk_ref, o_ref, *, group, pack, nk):
    bb = q_ref.shape[0]
    bn = sk_ref.shape[0]
    acc_t = jnp.int32 if q_ref.dtype == jnp.int8 else jnp.float32

    def body(i, acc):
        q = q_ref[:, pl.ds(i * BLOCK_K, BLOCK_K)]
        s = sk_ref[:, pl.ds(i * BLOCK_K, BLOCK_K)]
        return acc + jax.lax.dot_general(
            q, s, (((1,), (1,)), ((), ())), preferred_element_type=acc_t)

    acc = jax.lax.fori_loop(0, nk, body, jnp.zeros((bb, bn), acc_t))
    if pack:
        member = jax.lax.broadcasted_iota(jnp.int32, (bb, bn), 1) & (group - 1)
        acc = (acc << (group.bit_length() - 1)) | member
    o_ref[...] = acc.reshape(bb, bn // group, group).max(axis=2)


@functools.partial(jax.jit,
                   static_argnames=("group", "pack", "interpret"))
def group_max_pallas(
    q: jax.Array,        # int8/bf16 [B, D], D % 128 == 0
    sk: jax.Array,       # same dtype [Npad, D], Npad % max(BLOCK_N, group)=0
    group: int = 64,
    pack: bool = False,
    interpret: bool = False,
) -> jax.Array:
    """[B, Npad / group] group maxima of q · skᵀ: int32 for int8 inputs
    (argmax-packed when `pack`), float32 for bf16 inputs."""
    b, d = q.shape
    npad = sk.shape[0]
    bn = max(BLOCK_N, group)
    assert group & (group - 1) == 0, group
    assert d % BLOCK_K == 0 and npad % bn == 0, (d, npad, bn)
    assert not pack or q.dtype == jnp.int8, "packing needs integer scores"
    bb = block_b_for(b)
    bp = -(-b // bb) * bb
    qp = jnp.pad(q, ((0, bp - b), (0, 0)))
    rows = max(bn, MAX_OPERAND_BYTES // (d * sk.dtype.itemsize) // bn * bn)
    outs = [_call(qp, jax.lax.slice_in_dim(sk, r0, min(r0 + rows, npad)),
                  group, pack, bb, bn, interpret)
            for r0 in range(0, npad, rows)]
    out = outs[0] if len(outs) == 1 else jnp.concatenate(outs, axis=1)
    return out[:b]


def _call(qp, sk, group, pack, bb, bn, interpret):
    bp, d = qp.shape
    npad = sk.shape[0]
    out_t = jnp.int32 if qp.dtype == jnp.int8 else jnp.float32
    return pl.pallas_call(
        functools.partial(_kernel, group=group, pack=pack, nk=d // BLOCK_K),
        out_shape=jax.ShapeDtypeStruct((bp, npad // group), out_t),
        grid=(bp // bb, npad // bn),
        in_specs=[
            pl.BlockSpec((bb, d), lambda i, j: (i, 0)),
            pl.BlockSpec((bn, d), lambda i, j: (j, 0)),
        ],
        out_specs=pl.BlockSpec((bb, bn // group), lambda i, j: (i, j)),
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=NUM_STAGES),
        backend="triton",
        interpret=interpret,
        name="flat_group_max",
    )(qp, sk)
