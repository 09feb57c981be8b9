"""Device and compile-cache helpers for the measurement entry points
(bench.py, chip_smoke.py).

A measurement must run on the GPU it names: ``require_gpu`` fails
instead of letting JAX fall back to the CPU.  ``init_compile_cache``
keeps JAX's persistent compilation cache where
``JAX_COMPILATION_CACHE_DIR`` says when it is set (JAX reads it itself),
else in one fixed directory inside the checkout, so repeated runs of
the same checkout find their compiled programs again.
"""

from __future__ import annotations

import os
import subprocess
from pathlib import Path

CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def init_compile_cache() -> str:
    """Enable the persistent compilation cache; returns its directory."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
    return str(CACHE_DIR)


def require_gpu():
    """The JAX devices, or SystemExit when the default platform is not
    the GPU (a measurement never falls back to the CPU)."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX found {devices[0].platform!r} devices; this "
            "measurement runs only on the GPU")
    return devices


def card_name_and_power() -> str:
    """``nvidia-smi``'s name and power limit of the cards, one line each
    ("not available" when the tool is missing)."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not available"


def device_record() -> dict:
    """What every measurement prints beside its numbers."""
    import jax

    devices = jax.devices()
    return {"platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": len(devices),
            "card": card_name_and_power()}
