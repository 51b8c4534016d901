"""The one place that chooses the hit-finding implementation.

* ``"pallas"`` — the Pallas kernel compiled through Triton
  (ops/pallas_tpg.py), on a GPU;
* ``"scan"`` — the plain ``lax.scan`` path that XLA compiles
  (ops/scan.py), on the CPU.

Any other platform raises: there is no silent fallback.  The Pallas
interpreter runs only where a caller asks for it explicitly (tests do,
with ``interpret=True``); it is never chosen here.
"""

from __future__ import annotations

_BY_PLATFORM = {"gpu": "pallas", "cpu": "scan"}


def hit_backend(platform: str | None = None) -> str:
    """Hit-finding implementation for ``platform`` (default: JAX's
    default backend)."""
    if platform is None:
        import jax
        platform = jax.default_backend()
    try:
        return _BY_PLATFORM[platform]
    except KeyError:
        raise RuntimeError(
            f"no hit-finding implementation for platform {platform!r} "
            f"(supported: {sorted(_BY_PLATFORM)})") from None


def resolve_backend(name: str) -> str:
    """A configured ``tpg_backend`` value -> the implementation to run.
    ``"auto"`` asks :func:`hit_backend`; explicit names pass through
    (``"reference"`` is the numpy oracle)."""
    if name == "auto":
        return hit_backend()
    if name not in ("pallas", "scan", "reference"):
        raise ValueError(f"unknown tpg_backend {name!r}")
    return name
