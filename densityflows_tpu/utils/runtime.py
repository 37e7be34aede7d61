"""Process set-up for scripts that run on the GPU: the persistent compile
cache and the device checks. Scripts call these at start-up; importing
the package calls neither."""

from __future__ import annotations

import os
import subprocess

__all__ = ["enable_compile_cache", "require_gpu", "gpu_name_power_limit"]


def enable_compile_cache(checkout: str) -> str:
    """Keep JAX's persistent compile cache where ``JAX_COMPILATION_CACHE_DIR``
    says; when it is unset, at the fixed ``<checkout>/.jax_cache`` (a
    directory that moves never hits, so no temporary path). Returns the
    directory in use."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env  # JAX reads the variable itself
    path = os.path.join(os.path.abspath(checkout), ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def require_gpu():
    """The first device, which must be a GPU: a measurement that finds no
    GPU fails instead of timing the CPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"no GPU found (JAX platform {dev.platform!r}); this script "
            "measures the card and does not fall back to the CPU")
    return dev


def gpu_name_power_limit() -> str:
    """``name, power.limit`` of every card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()
