"""Mesh helpers for the sharded forest (single- and multi-process).

Multi-host story (SURVEY.md §7.5, BASELINE configs[4] Deep-100M): call
:func:`init_distributed` in every process (one per host), then
:func:`make_forest_mesh` builds the mesh over ALL processes' devices. The
mesh is 1-D: every card of a host reaches every other over NVLink at the
same rate, so the mesh shape follows the algorithm (one corpus shard per
device) and not the wiring. XLA hands the collectives to NCCL.

Device-memory budget at Deep-100M (100M rows × 96d, canonical 10×3
tables) over four 80 GB cards:
  corpus f32            100M·96·4   = 38.4 GB   →  9.6 GB per card
  sorted keys+ids       100M·30·8   = 24.0 GB   →  6.0 GB per card
  bucket arrays (≈N/overflow·30·28) ≈  1.7 GB   →  0.4 GB per card
  total ≈ 64 GB → 16 GB per card, leaving room for query workspace.
  The optional lane-packed int8 coarse tier costs 128 B per row per group
  of 128/cd tables: at cd=32, 100M × 8 groups × 128 B = 102 GB (26 GB
  per card). Run it with fewer tables or a smaller cd at that scale, or
  disable it (`coarse_dim=None`).
"""

from __future__ import annotations

from typing import Optional

import jax
from jax.sharding import Mesh


SHARD_AXIS = "shard"


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[list] = None,
) -> None:
    """Initialize `jax.distributed` for a multi-process (multi-host) run.
    Pass the arguments explicitly (nothing in the environment describes
    the cluster). Must run before any other jax call in the
    process. Safe to call when already initialized (no-op)."""
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            local_device_ids=local_device_ids,
        )
    except RuntimeError as e:
        if "already initialized" not in str(e):
            raise


def make_forest_mesh(n_devices: Optional[int] = None) -> Mesh:
    """1-D device mesh over the forest-shard axis. Each device holds a
    corpus shard with a full forest over it — the replacement for the
    reference's (vestigial) Akka-cluster distribution (SURVEY.md §2.5 P7):
    queries are replicated, candidate generation is shard-local, and the
    final merge is one all-gather of per-shard top-k.

    After `init_distributed`, `jax.devices()` enumerates every process's
    devices, so the same call builds the global multi-host mesh."""
    devices = jax.devices()
    n = n_devices or len(devices)
    if n > len(devices):
        raise ValueError(f"requested {n} devices, have {len(devices)}")
    return jax.make_mesh((n,), (SHARD_AXIS,), devices=devices[:n])
