"""Hash-family "models": parameter generation, permutation tables, file IO.

The hash functions are the *model* of an LSH engine (the reference
checkpoints them as its model, `LSH.scala:173-195`). This module replaces the
reference's object-per-function design (`AngleHashFamily.scala`,
`PStableHashFamily.scala`) with dense parameter tensors shaped for batched matmuls:

  proj[T, C, D]   — projection rows for tableNum base chains of chainLength
  perm[T, P, C]   — per-(table, permutation) function-order permutation
                    (the reference shuffles the function list per permutation,
                    `AngleHashFamily.scala:143-146`; permuting the packed bit
                    order of the sign matrix is equivalent)
  b[T, C], w      — p-stable offsets/width (H(v)=floor((a.v+b)/w),
                    `PStableHashFamily.scala:122-143`)

A :class:`HashModel` is a JAX pytree so it moves to device once and is closed
over by the jitted hash/fit/query functions.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import RDFConfig
from . import transforms


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class HashModel:
    proj: jax.Array          # f32[T, C, D]
    perm: jax.Array          # i32[T, P, C]
    b: jax.Array             # f32[T, C] (zeros for angle)
    sampling_perm: jax.Array  # i32[32]
    family: str = dataclasses.field(metadata=dict(static=True), default="angle")
    w: int = dataclasses.field(metadata=dict(static=True), default=4)
    type_of_index: str = dataclasses.field(
        metadata=dict(static=True), default="original"
    )

    @property
    def table_num(self) -> int:
        return self.proj.shape[0]

    @property
    def chain_length(self) -> int:
        return self.proj.shape[1]

    @property
    def dim(self) -> int:
        return self.proj.shape[2]

    @property
    def permutation_num(self) -> int:
        return self.perm.shape[1]

    @property
    def total_tables(self) -> int:
        return self.table_num * self.permutation_num


# ---------------------------------------------------------------------------
# Parameter generation
# ---------------------------------------------------------------------------


def _unit_rows(rng: np.random.Generator, n: int, dim: int) -> np.ndarray:
    """Random unit vectors, mirroring `AngleHashFamily.getNewUnitVector`
    (`AngleHashFamily.scala:37-51`): U[0,1) magnitudes with random signs,
    normalized."""
    vals = rng.random((n, dim)) * np.where(rng.integers(0, 2, (n, dim)) > 0, 1.0, -1.0)
    return (vals / np.linalg.norm(vals, axis=1, keepdims=True)).astype(np.float32)


def _orthogonal_rows(rng: np.random.Generator, n: int, dim: int) -> np.ndarray:
    """QR-orthogonalized family rows, mirroring
    `initOrthogonalUnitVectorHashFamily` (`AngleHashFamily.scala:73-85`).
    When n > dim (more functions than dimensions), rows are orthonormal in
    blocks of `dim` — each block an independent QR."""
    blocks = []
    remaining = n
    while remaining > 0:
        k = min(remaining, dim)
        a = rng.random((dim, dim))
        q = np.linalg.qr(a)[0]
        blocks.append(q[:k])
        remaining -= k
    return np.concatenate(blocks, axis=0).astype(np.float32)


def generate_angle_model(conf: RDFConfig, seed: Optional[int] = None) -> HashModel:
    """Angle (sign-random-projection) family — `AngleHashFamily.pick`
    (`AngleHashFamily.scala:121-149`)."""
    rng = np.random.default_rng(conf.seed if seed is None else seed)
    t, c, d, p = conf.table_num, conf.lsh_table.chain_length, conf.vector_dim, conf.permutation_num

    if conf.generate_by_pulling:
        family = (
            _orthogonal_rows(rng, conf.family_size, d)
            if conf.is_orthogonal
            else _unit_rows(rng, conf.family_size, d)
        )
        draw = rng.integers(0, conf.family_size, size=(t, c))
        proj = family[draw]  # [T, C, D]
    else:
        proj = _unit_rows(rng, t * c, d).reshape(t, c, d)

    # every permutation (including the first) is a fresh shuffle of the chain
    # (`AngleHashFamily.scala:143-146`)
    perm = np.stack(
        [np.stack([rng.permutation(c) for _ in range(p)]) for _ in range(t)]
    ).astype(np.int32)

    return HashModel(
        proj=jnp.asarray(proj),
        perm=jnp.asarray(perm),
        b=jnp.zeros((t, c), dtype=jnp.float32),
        sampling_perm=jnp.asarray(transforms.sampling_permutation(conf.sampling_seed)),
        family="angle",
        w=conf.pstable.w,
        type_of_index=conf.type_of_index,
    )


def generate_pstable_model(conf: RDFConfig, seed: Optional[int] = None) -> HashModel:
    """p-stable (E2LSH) family — `PStableHashFamily.pick`
    (`PStableHashFamily.scala:37-77`). The reference's pStable pick ignores
    permutationNum (chains are tableNum only), so permutations are identity
    here."""
    rng = np.random.default_rng(conf.seed if seed is None else seed)
    t, c, d = conf.table_num, conf.lsh_table.chain_length, conf.vector_dim
    ps = conf.pstable

    a = rng.normal(ps.mu, ps.sigma, size=(conf.family_size, d)).astype(np.float32)
    b_family = (rng.random(conf.family_size) * ps.w).astype(np.float32)
    draw = rng.integers(0, conf.family_size, size=(t, c))
    proj = a[draw]
    b = b_family[draw]
    perm = np.broadcast_to(np.arange(c, dtype=np.int32), (t, 1, c)).copy()

    return HashModel(
        proj=jnp.asarray(proj),
        perm=jnp.asarray(perm),
        b=jnp.asarray(b),
        sampling_perm=jnp.asarray(transforms.sampling_permutation(conf.sampling_seed)),
        family="pStable",
        w=ps.w,
        type_of_index=conf.type_of_index,
    )


def generate_model(conf: RDFConfig, seed: Optional[int] = None) -> HashModel:
    """Family dispatch — `LSH.initHashChains` (`LSH.scala:29-53`), including
    the load-from-file path (`generateMethod=fromfile`, `LSH.scala:69-77`)."""
    if conf.generate_method == "fromfile":
        # confType switches which checkpoint a fromfile chain reads
        # (`LSH.scala:71-77`): "lsh" → familyFilePath, "partition" →
        # partitionFamilyFilePath (the best-partition checkpoint flow).
        if conf.conf_type == "partition":
            path = conf.partition_family_file_path
            if path is None:
                raise ValueError(
                    "generate_method=fromfile with confType=partition "
                    "requires partition_family_file_path"
                )
        else:
            path = conf.family_file_path
            if path is None:
                raise ValueError("generate_method=fromfile requires family_file_path")
        return load_model_file(path, conf)
    if conf.family_name == "angle":
        return generate_angle_model(conf, seed)
    if conf.family_name == "pStable":
        return generate_pstable_model(conf, seed)
    raise ValueError(f"{conf.family_name!r} is not a valid family name")


# ---------------------------------------------------------------------------
# Hash-function file round-trip (the reference's model checkpoint format)
# ---------------------------------------------------------------------------


def _sparse_vector_str(vid: int, values: np.ndarray) -> str:
    """The reference's SparseVector.toString: `(id,size,[i...],[v...])`."""
    nz = np.nonzero(values)[0]
    idx = ",".join(str(int(i)) for i in nz)
    val = ",".join(repr(float(values[i])) for i in nz)
    return f"({vid},{len(values)},[{idx}],[{val}])"


def save_model_file(model: HashModel, path: str) -> None:
    """Write hash functions in the reference's text format
    (`LSH.outPutTheHashFunctionsIntoFile`, `LSH.scala:173-195`): one function
    per line, chains flattened in table-major order with permutations
    expanded (each saved chain is already permuted, as in the reference
    where permuted chains are distinct chain objects)."""
    proj = np.asarray(model.proj)
    perm = np.asarray(model.perm)
    b = np.asarray(model.b)
    lines: List[str] = []
    vid = 0
    for t in range(model.table_num):
        for p in range(model.permutation_num):
            for j in range(model.chain_length):
                f = int(perm[t, p, j])
                if model.family == "angle":
                    lines.append(_sparse_vector_str(vid, proj[t, f]))
                else:
                    lines.append(
                        _sparse_vector_str(vid, proj[t, f])
                        + f";{float(b[t, f])!r};{model.w}"
                    )
                vid += 1
    with open(path, "w") as fh:
        fh.write("\r\n".join(lines) + "\r\n")


def load_model_file(path: str, conf: RDFConfig) -> HashModel:
    """Load a hash-function file (angle `(..)` lines or pstable `(..);b;w`
    lines), grouping every `chainLength` lines into one chain —
    `generateTableChainFromFile` (`AngleHashFamily.scala:158-177`,
    `PStableHashFamily.scala:88-108`). Loaded chains become distinct tables
    with identity permutations."""
    from ..vectors import from_string

    c = conf.lsh_table.chain_length
    rows: List[np.ndarray] = []
    bs: List[float] = []
    w = conf.pstable.w
    family = "angle"
    with open(path, "r") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            if ";" in line:
                family = "pStable"
                vec_s, b_s, w_s = line.split(";")
                b_val, w = float(b_s), int(w_s)
            else:
                vec_s, b_val = line, 0.0
            _, size, idx, val = from_string(vec_s)
            dense = np.zeros(size, dtype=np.float32)
            dense[idx] = val
            rows.append(dense)
            bs.append(b_val)
    if len(rows) % c != 0:
        raise ValueError(f"{path}: {len(rows)} functions not divisible by chainLength {c}")
    t = len(rows) // c
    proj = np.stack(rows).reshape(t, c, -1)
    b = np.asarray(bs, dtype=np.float32).reshape(t, c)
    perm = np.broadcast_to(np.arange(c, dtype=np.int32), (t, 1, c)).copy()
    return HashModel(
        proj=jnp.asarray(proj),
        perm=jnp.asarray(perm),
        b=jnp.asarray(b),
        sampling_perm=jnp.asarray(transforms.sampling_permutation(conf.sampling_seed)),
        family=family,
        w=w,
        type_of_index=conf.type_of_index,
    )
