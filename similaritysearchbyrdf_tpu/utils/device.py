"""Device facts and process settings shared by the entry scripts
(`chip_smoke.py`, `bench.py`, the CLI)."""

from __future__ import annotations

import os
import subprocess
from typing import Mapping, Optional

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"


def compile_cache_dir(environ: Mapping[str, str], root: str) -> Optional[str]:
    """Where this process should point JAX's persistent compile cache:
    None when `JAX_COMPILATION_CACHE_DIR` is set (JAX reads that variable
    itself, and nothing else is set in code), else the fixed
    `<root>/.jax_cache` (a path that moves never hits the cache)."""
    if environ.get(CACHE_ENV):
        return None
    return os.path.join(os.path.abspath(root), ".jax_cache")


def enable_compile_cache(root: str) -> str:
    """Apply `compile_cache_dir` to this process; returns the directory in
    use."""
    import jax

    path = compile_cache_dir(os.environ, root)
    if path is None:
        return os.environ[CACHE_ENV]
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def card_line() -> str:
    """The first card's `name, power.limit` as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` prints
    them. Raises when nvidia-smi is missing or fails."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0].strip()


def require_platform(platform: str = "gpu"):
    """JAX's first device, after checking that it is on `platform`; a
    measurement that finds no accelerator fails instead of running on the
    host."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != platform:
        raise RuntimeError(
            f"expected a {platform} device, JAX's first device is "
            f"{dev.platform} ({dev.device_kind})")
    return dev
