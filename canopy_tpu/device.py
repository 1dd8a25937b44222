"""Every backend decision in one place: platform, device peaks, compile cache.

* :func:`backend` / :func:`require_gpu` — the only place the package asks
  JAX which platform it runs on.
* :data:`PEAKS` / :func:`peaks` — published peak rates keyed by
  ``device.device_kind``; an unknown device is an error, never a default.
* :func:`setup_compile_cache` — the persistent XLA compilation cache:
  ``JAX_COMPILATION_CACHE_DIR`` when set, else ``<checkout>/.jax_cache``.
"""

from __future__ import annotations

import dataclasses
import os

__all__ = ["DevicePeaks", "PEAKS", "backend", "peaks", "require_gpu",
           "default_cache_dir", "setup_compile_cache"]


@dataclasses.dataclass(frozen=True)
class DevicePeaks:
    """Published dense peak rates of one device (no sparsity)."""

    hbm_bytes_per_s: float
    bf16_flops: float
    tf32_flops: float
    f32_flops: float
    source: str


_H100_SXM = DevicePeaks(
    hbm_bytes_per_s=3.35e12, bf16_flops=989e12, tf32_flops=495e12,
    f32_flops=67e12,
    source="NVIDIA H100 SXM data sheet (dense, 700 W power limit)")

#: Peak rates by ``jax.Device.device_kind``.
PEAKS: dict[str, DevicePeaks] = {
    "NVIDIA H100 80GB HBM3": _H100_SXM,
}


def backend() -> str:
    """The JAX platform in use (``"gpu"``, ``"cpu"``, ...)."""
    import jax
    return jax.default_backend()


def require_gpu() -> None:
    """Raise unless JAX runs on a GPU (measurement paths never fall back)."""
    found = backend()
    if found != "gpu":
        raise RuntimeError(f"a GPU is required, JAX found {found!r}")


def peaks(device_kind: str | None = None) -> DevicePeaks:
    """Peak rates of ``device_kind`` (default: the first JAX device)."""
    if device_kind is None:
        import jax
        device_kind = jax.devices()[0].device_kind
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(f"no published peaks for device kind "
                       f"{device_kind!r}; known: {sorted(PEAKS)}") from None


def default_cache_dir() -> str:
    """``<checkout>/.jax_cache``: a fixed path, so cache keys stay valid."""
    checkout = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(checkout, ".jax_cache")


def setup_compile_cache() -> str:
    """Enable JAX's persistent compilation cache and return its directory.

    ``JAX_COMPILATION_CACHE_DIR`` wins when set (JAX reads it itself and
    no other directory is configured); otherwise the cache lives at
    :func:`default_cache_dir`.
    """
    import jax
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = default_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
