"""Array-encoded bucket tables: the Dynamic Partition Forest without pointers.

The reference's `RandomDrawTreeMap` (`RandomDrawTreeMap.java`, 2.8k LoC of
trie descent, copy-on-write dir nodes and striped locks) exists to map a
32-bit hash to a *data-adaptively sized bucket* of vector ids. Its observable
structure (derived from the put/search paths, `putInner:1662-1790`,
`search:1005-1050`):

  * seg      = top `32-BUCKET_LENGTH` bits of the hash (`:1663`)
  * the trie consumes `log2(dirNodeSize)`-bit slots starting at level
    MAX_TREE_LEVEL and walking DOWN: slot = (h >>> (bits*level)) & mask
    (`:1671`). With the canonical 28/32 config the consumed bits are
    [0, 25) — bits 25-27 of the hash are never consumed.
  * a bucket (linked-node chain) holds every point sharing the consumed
    prefix; a chain splits one level deeper when an insert finds it at
    >= BUCKET_OVERFLOW and level >= 1 (`:1719-1768`).

Flattened array encoding, per table:

  key[i]  = partition ‖ seg ‖ trie-bits   (uint32, right-aligned)
  sorted ascending → every (prefix, depth) bucket is a contiguous range.
  Leaf buckets are computed at build time by the overflow rule (smallest
  depth whose prefix population <= BUCKET_OVERFLOW, capped at the deepest
  level) and stored as three arrays: the bucket's minimal key, its start
  offset, and its prefix shift. A query probe then needs ONE binary search +
  a masked prefix-equality check — no locks, no recids (SURVEY.md §7.2).

Divergence from the reference (documented per SURVEY.md §7 hard part (a)):
the reference's splits are insertion-order dependent (a chain that reaches
exactly BUCKET_OVERFLOW splits only when a later insert walks it); the batch
rule here splits exactly when population > BUCKET_OVERFLOW. Candidate sets
are therefore equal or slightly larger near the threshold — never smaller.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import RDFConfig, TableConfig


# Test hook: force the table-serial depth computation that Deep-scale row
# counts take (l*n >= 64M), so its parity with the vectorized path can be
# asserted on small corpora (tests/test_bucket_table.py). Read at trace
# time — flip it before the first build of a given shape.
_FORCE_SERIAL_DEPTHS = False


# ---------------------------------------------------------------------------
# Key layout
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class KeyLayout:
    """Static description of the composite sort key."""

    partition_bits: int
    seg_bits: int           # 32 - BUCKET_LENGTH
    bits_per_level: int     # log2(dirNodeSize)
    num_levels: int         # MAX_TREE_LEVEL + 1 chain depths
    bucket_bits: int        # BUCKET_LENGTH

    @property
    def consumed_bits(self) -> int:
        return self.bits_per_level * self.num_levels

    @property
    def total_bits(self) -> int:
        return self.partition_bits + self.seg_bits + self.consumed_bits

    def depth_shift(self, depth: int) -> int:
        """Right-shift that turns a key into its depth-`depth` prefix.
        depth 0 = root chain (seg + one slot), depth num_levels-1 = full key."""
        return self.consumed_bits - self.bits_per_level * (depth + 1)

    @staticmethod
    def from_config(conf: RDFConfig, table: TableConfig) -> "KeyLayout":
        layout = KeyLayout(
            partition_bits=conf.partition_bits,
            seg_bits=table.seg_bits,
            bits_per_level=table.bits_per_level,
            num_levels=table.max_tree_level + 1,
            bucket_bits=table.bucket_bits,
        )
        # The composite key must fit 32 bits. Configurations that exceed it
        # (e.g. dirNodeSize=128 with partitionBits=3: 3+4+28=35 bits) drop
        # their DEEPEST trie levels until it fits — max-depth buckets then
        # merge up to 2^(dropped bits) neighboring reference buckets, so
        # candidate sets are equal or larger (supersets; recall is never
        # hurt, re-rank cost grows slightly). Only triggers when >500 points
        # share the remaining prefix.
        while layout.total_bits > 32 and layout.num_levels > 1:
            layout = dataclasses.replace(layout, num_levels=layout.num_levels - 1)
        if layout.total_bits > 32:
            raise NotImplementedError(
                f"composite key needs {layout.total_bits} bits > 32 even at "
                f"one trie level (partitionBits={layout.partition_bits})"
            )
        return layout


def composite_keys(
    hashes: jax.Array, partitions: jax.Array, layout: KeyLayout
) -> jax.Array:
    """key = partition ‖ seg ‖ trie-bits (uint32, right-aligned).

    `hashes` uint32 [...], `partitions` int32 [...] → uint32 [...].
    seg = h >>> BUCKET_LENGTH (`RandomDrawTreeMap.java:1663`); trie bits are
    the low `consumed_bits` of the hash (`:1671`), dropping any skipped bits
    in between (bits 25-27 for the canonical config).
    """
    h = hashes.astype(jnp.uint32)
    seg = h >> jnp.uint32(layout.bucket_bits)
    trie = h & jnp.uint32((1 << layout.consumed_bits) - 1)
    key = (
        (partitions.astype(jnp.uint32) << jnp.uint32(layout.seg_bits + layout.consumed_bits))
        | (seg << jnp.uint32(layout.consumed_bits))
        | trie
    )
    return key


# ---------------------------------------------------------------------------
# Bucket table container
# ---------------------------------------------------------------------------


# trailing columns of -1 appended to sorted_ids so fixed-width slice gathers
# never run off the end (see forest._gather_id_blocks); must be >= the
# largest aligned WINDOW the coarse scoring reads (64-slot windows whose
# 8-aligned start can sit up to 63 rows before the table's end)
ID_PAD = 64


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BucketTables:
    """The whole forest's bucket state (device arrays).

    sorted_keys   u32[L, Npad]  — composite keys, ascending per table
                                  (padding rows = 0xFFFFFFFF)
    sorted_ids    i32[L, Npad+ID_PAD] — vector ids in key order (padding = -1;
                                  the extra ID_PAD trailing -1s keep
                                  block-slice gathers in bounds)
    bucket_keys   u32[L, NB]    — prefix-aligned lower boundary of each leaf
                                  bucket (padding = 0xFFFFFFFF)
    bucket_starts i32[L, NB+1]  — start offset of each leaf bucket into
                                  sorted_ids; entry NB.. = Npad so
                                  end-of-bucket is starts[b+1] (padding = Npad)
    bucket_shifts u32[L, NB]    — right-shift identifying the bucket's prefix
                                  length (padding = 0)

    records       i32[L, NB, 4]  — packed (key, shift, start, end) so one
                                  16-byte gather fetches a whole bucket
                                  descriptor (enables the sort-based lookup
                                  fast path; None on the generic path)
    """

    sorted_keys: jax.Array
    sorted_ids: jax.Array
    bucket_keys: jax.Array
    bucket_starts: jax.Array
    bucket_shifts: jax.Array
    records: Optional[jax.Array] = None

    @property
    def num_tables(self) -> int:
        return self.sorted_keys.shape[0]

    @property
    def capacity(self) -> int:
        return self.sorted_keys.shape[1]

    def index_bytes(self) -> int:
        """HBM bytes held by the index structure (the 'index bytes/vector'
        metric's numerator)."""
        arrays = [
            self.sorted_keys,
            self.sorted_ids,
            self.bucket_keys,
            self.bucket_starts,
            self.bucket_shifts,
        ]
        if self.records is not None:
            arrays.append(self.records)
        return sum(int(np.prod(a.shape)) * a.dtype.itemsize for a in arrays)


# ---------------------------------------------------------------------------
# Build (fit) — SURVEY.md §7.3: hash, sort, prefix-count, split
# ---------------------------------------------------------------------------


def _depths_progressive(
    sorted_keys: jax.Array,  # u32[L, N] ascending per table
    layout: KeyLayout,
    overflow: int,
) -> Tuple[jax.Array, jax.Array]:
    """Each element's leaf-bucket (start, prefix shift) by the overflow rule:
    the SMALLEST depth whose prefix population <= overflow wins, capped at
    the deepest level (level 0 in the reference: splits stop at level >= 1,
    `putInner:1719`). Selection runs progressively per depth — first fit
    wins — so peak memory is a few [L, N] temporaries, never [L, N, D]
    (which at Deep-scale row counts is tens of GB)."""
    l, n = sorted_keys.shape
    idx = jnp.arange(n, dtype=jnp.int32)[None, :]
    done = jnp.zeros((l, n), dtype=bool)
    elem_start = jnp.zeros((l, n), dtype=jnp.int32)
    elem_shift = jnp.zeros((l, n), dtype=jnp.uint32)
    for d in range(layout.num_levels):
        s = layout.depth_shift(d)
        pref = sorted_keys >> jnp.uint32(s)
        # each element's prefix-group bounds come from run boundaries of the
        # (already sorted) keys — pure prefix scans, no binary searches
        # (this is what makes the build O(N) per depth)
        bm = jnp.concatenate(
            [jnp.ones((l, 1), dtype=bool), pref[:, 1:] != pref[:, :-1]],
            axis=1,
        )
        lo = jax.lax.cummax(jnp.where(bm, idx, 0), axis=1)
        nxt = jnp.where(bm, idx, n)
        suffix_min = jnp.flip(
            jax.lax.cummin(jnp.flip(nxt, axis=1), axis=1), axis=1
        )
        hi = jnp.concatenate(
            [suffix_min[:, 1:], jnp.full((l, 1), n, jnp.int32)], axis=1
        )
        fit = ((hi - lo) <= jnp.int32(overflow)) & ~done
        if d == layout.num_levels - 1:
            fit |= ~done                  # deepest level takes the leftovers
        elem_start = jnp.where(fit, lo, elem_start)
        elem_shift = jnp.where(fit, jnp.uint32(s), elem_shift)
        done |= fit
    return elem_start, elem_shift


@functools.partial(jax.jit, static_argnames=("layout", "overflow"))
def _sort_and_depths(
    keys: jax.Array,  # u32[L, Npad] composite keys (pad rows = 0xFFFFFFFF)
    ids: jax.Array,   # i32[L, Npad]
    layout: KeyLayout,
    overflow: int,
) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Sort each table and compute each element's leaf-bucket start and
    prefix shift via the overflow rule. Returns (sorted_keys, sorted_ids,
    elem_bucket_start, elem_shift)."""
    sorted_keys, sorted_ids = jax.lax.sort((keys, ids), dimension=1, num_keys=1)
    l, n = sorted_keys.shape
    if l * n >= 64_000_000 or _FORCE_SERIAL_DEPTHS:
        # Deep-scale tables: bound peak memory to a single table's scans
        # (the vectorized path's [L, N] temporaries would add several GB on
        # top of the corpus at >=8M rows x 30 tables)
        es, sh = jax.lax.map(
            lambda sk: tuple(
                a[0] for a in _depths_progressive(sk[None, :], layout, overflow)
            ),
            sorted_keys,
        )
        return sorted_keys, sorted_ids, es, sh
    elem_start, elem_shift = _depths_progressive(sorted_keys, layout, overflow)
    return sorted_keys, sorted_ids, elem_start, elem_shift


@functools.partial(jax.jit, static_argnames=("nb_pad",))
def _compact_buckets(
    sorted_keys: jax.Array,
    elem_start: jax.Array,
    elem_shift: jax.Array,
    nb_pad: int,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Scatter leaf-bucket descriptors into fixed-size arrays."""
    l, n = sorted_keys.shape
    pos_idx = jnp.arange(n, dtype=jnp.int32)[None, :]
    is_start = elem_start == pos_idx                       # [L, N]
    # exclude padding rows (key == all ones and id == -1 share the max-key
    # region; they may form a bucket but its ids are masked at query time —
    # keep them, validity masking handles it)
    slot = jnp.cumsum(is_start.astype(jnp.int32), axis=1) - 1   # [L, N]
    slot = jnp.where(is_start, slot, nb_pad)               # scatter target

    def scatter_one(keys_row, shift_row, slot_row):
        bkeys = jnp.full((nb_pad + 1,), 0xFFFFFFFF, dtype=jnp.uint32)
        bstarts = jnp.full((nb_pad + 1,), n, dtype=jnp.int32)
        bshifts = jnp.zeros((nb_pad + 1,), dtype=jnp.uint32)
        # store the prefix-aligned *lower boundary* of the bucket's key range
        # (suffix zeroed), not the minimal member key: a probe can be smaller
        # than every member while sharing the prefix, and must still land in
        # this bucket (the reference's trie descent matches prefixes, not
        # member keys, `search:1005-1050`)
        boundary = (keys_row >> shift_row) << shift_row
        bkeys = bkeys.at[slot_row].set(boundary, mode="drop")
        bstarts = bstarts.at[slot_row].set(pos_idx[0], mode="drop")
        bshifts = bshifts.at[slot_row].set(shift_row, mode="drop")
        return bkeys[:nb_pad], bstarts[:nb_pad], bshifts[:nb_pad]

    bkeys, bstarts, bshifts = jax.vmap(scatter_one)(sorted_keys, elem_shift, slot)
    # bucket_starts needs NB+1 entries; buckets are contiguous so end of
    # bucket b = start of bucket b+1 (padding start = n)
    bstarts_full = jnp.concatenate(
        [bstarts, jnp.full((l, 1), n, dtype=jnp.int32)], axis=1
    )
    return bkeys, bstarts_full, bshifts


@jax.jit
def _build_records(
    bucket_keys: jax.Array, bucket_starts: jax.Array, bucket_shifts: jax.Array
) -> jax.Array:
    """Pack (key, shift, start, end) per bucket: one 16-byte gather per
    probe instead of four 4-byte gathers."""
    return jnp.stack(
        [
            bucket_keys.astype(jnp.int32),
            bucket_shifts.astype(jnp.int32),
            bucket_starts[:, :-1],
            bucket_starts[:, 1:],
        ],
        axis=-1,
    )


def build_tables(
    keys: jax.Array,   # u32[L, Npad] composite keys (padding = 0xFFFFFFFF)
    ids: jax.Array,    # i32[L, Npad] (padding = -1)
    layout: KeyLayout,
    overflow: int,
    nb_pad: int | None = None,
    with_records: bool = True,
) -> BucketTables:
    """Build the full forest bucket state. One host sync sizes the compacted
    bucket arrays (`nb_pad`); pass `nb_pad` explicitly to stay sync-free
    (e.g. from a previous build of the same distribution)."""
    sorted_keys, sorted_ids, elem_start, elem_shift = _sort_and_depths(
        keys, ids, layout, overflow
    )
    # trailing -1 pad so block-granular slice gathers (width ID_PAD) never
    # clip-shift near the end of the array (`forest._gather_id_blocks`)
    sorted_ids = jnp.concatenate(
        [sorted_ids, jnp.full((sorted_ids.shape[0], ID_PAD), -1, jnp.int32)],
        axis=1,
    )
    if nb_pad is None:
        n = sorted_keys.shape[1]
        is_start = elem_start == jnp.arange(n, dtype=jnp.int32)[None, :]
        nb = int(jnp.max(jnp.sum(is_start, axis=1)))           # host sync
        nb_pad = max(8, int(np.ceil(nb / 128.0)) * 128)

    bkeys, bstarts, bshifts = _compact_buckets(
        sorted_keys, elem_start, elem_shift, nb_pad
    )
    records = (
        _build_records(bkeys, bstarts, bshifts) if with_records else None
    )
    return BucketTables(
        sorted_keys=sorted_keys,
        sorted_ids=sorted_ids,
        bucket_keys=bkeys,
        bucket_starts=bstarts,
        bucket_shifts=bshifts,
        records=records,
    )


# ---------------------------------------------------------------------------
# Probe lookup (query side)
# ---------------------------------------------------------------------------


def lookup_ranges(
    tables: BucketTables,
    probe_keys: jax.Array,   # u32[B, R] composite probe keys, R = L * per_table
    table_index: jax.Array,  # i32[R]; must be table-major (repeat pattern)
) -> Tuple[jax.Array, jax.Array]:
    """Resolve each probe key to its bucket's (start, length) in that table's
    sorted_ids. A probe whose prefix does not exist gets length 0 — matching
    the reference's empty-slot walk result (`searchWithSimilarity:940-994`).

    Probe columns are table-major (all of table 0's probes, then table 1's,
    ...), so the search vmaps over the L tables directly — no [R, NB] bucket
    array materialization.

    Fast path (when the build packed bucket records): rank every probe with
    a merge-based `searchsorted(method='sort')` (per-step binary-search
    gathers cost per element), then ONE 16-byte
    packed-record gather per probe yields (key, shift, start, end) for the
    prefix-validity check. The generic path does the same with four narrow
    gathers.
    """
    l = tables.num_tables
    b, r = probe_keys.shape
    per_table = r // l
    keys_t = (
        probe_keys.reshape(b, l, per_table).transpose(1, 0, 2).reshape(l, b * per_table)
    )                                                  # [L, B*pt]

    if tables.records is not None:

        def per_table_fast(bk, rec, q):
            # rank probes against bucket boundaries. Merge-based rank (one
            # sort of [NB + Q]) while the bucket array is within ~16x of
            # the probe count. At Deep-scale bucket counts (>=150k/table
            # at 8M rows) the sort's NB term dominates; there a DECIMATED
            # two-level rank: merge-rank against every DEC-th boundary (a
            # small sort), then log2(DEC) vectorized element-gather binary
            # steps inside the DEC-wide span — ~6 gathers/probe instead of
            # log2(NB)~19.
            nb = bk.shape[0]
            if nb <= max(4096, 2 * q.shape[0]):
                b_idx = (
                    jnp.searchsorted(
                        bk, q, side="right", method="sort"
                    ).astype(jnp.int32)
                    - 1
                )
            else:
                dec = 64
                c = (
                    jnp.searchsorted(
                        bk[::dec], q, side="right", method="sort"
                    ).astype(jnp.int32)
                    - 1
                )
                # b_idx ∈ [c*dec, (c+1)*dec): bk[c*dec] <= q < bk[(c+1)*dec].
                # The span is CONTIGUOUS, so fetch it as one full-row gather
                # (per-index cost) and rank within registers — one gather
                # instead of log2(dec) sequential element-gather binary
                # steps (each step paid ~16 ns/probe and they serialize).
                if nb % dec == 0:
                    span = bk.reshape(nb // dec, dec)[jnp.maximum(c, 0)]
                    within = jnp.sum(
                        (span <= q[:, None]).astype(jnp.int32), axis=1
                    )
                    # within >= 1 when c >= 0 (bk[c*dec] <= q by rank)
                    idx = jnp.maximum(c, 0) * dec + within - 1
                else:
                    idx = jnp.maximum(c, 0) * dec
                    s = dec // 2
                    while s:
                        mid = idx + s
                        ok = (mid < nb) & (bk[jnp.minimum(mid, nb - 1)] <= q)
                        idx = jnp.where(ok, mid, idx)
                        s //= 2
                b_idx = jnp.where(c >= 0, idx, -1).astype(jnp.int32)
            r4 = rec[jnp.maximum(b_idx, 0)]             # [Q, 4] packed
            key_b = r4[:, 0].astype(jnp.uint32)
            shift_b = r4[:, 1].astype(jnp.uint32)
            start = r4[:, 2]
            end = r4[:, 3]
            valid = (b_idx >= 0) & ((q >> shift_b) == (key_b >> shift_b))
            return start, jnp.where(valid, end - start, 0)

        start_t, len_t = jax.vmap(per_table_fast)(
            tables.bucket_keys, tables.records, keys_t
        )
    else:

        def per_table_lookup(bk, bst, bsh, q):
            b_idx = jnp.searchsorted(bk, q, side="right").astype(jnp.int32) - 1
            safe = jnp.maximum(b_idx, 0)
            key_b = bk[safe]
            shift_b = bsh[safe]
            start = bst[safe]
            end = bst[safe + 1]
            valid = (b_idx >= 0) & ((q >> shift_b) == (key_b >> shift_b))
            return start, jnp.where(valid, end - start, 0)

        start_t, len_t = jax.vmap(per_table_lookup)(
            tables.bucket_keys, tables.bucket_starts, tables.bucket_shifts, keys_t
        )                                              # [L, B*pt]
    start = start_t.reshape(l, b, per_table).transpose(1, 0, 2).reshape(b, r)
    length = len_t.reshape(l, b, per_table).transpose(1, 0, 2).reshape(b, r)
    return start, length
