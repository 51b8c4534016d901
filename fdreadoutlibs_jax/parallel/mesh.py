"""Mesh construction helpers.

Meshes follow the algorithm: links are independent, APAs are
independent, and the only collective is a small monitoring psum over
'link'.  Too few devices is an error — no mesh silently moves to other
devices.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def _devices(need: int | None, backend: str | None):
    devices = jax.devices(backend) if backend else jax.devices()
    if need is not None and len(devices) < need:
        raise RuntimeError(
            f"need {need} {devices[0].platform} devices, have "
            f"{len(devices)}")
    return devices


def make_link_mesh(n_devices: int | None = None,
                   backend: str | None = None) -> Mesh:
    """1-D mesh over the 'link' axis (links = DUNE readout streams) on the
    first ``n_devices`` devices of ``backend`` (default: JAX's default
    backend; all of its devices when n_devices is None)."""
    devices = _devices(n_devices, backend)
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), ("link",))


def make_apa_link_mesh(n_apas: int, n_link_shards: int | None = None,
                       backend: str | None = None) -> Mesh:
    """2-D ('apa', 'link') mesh: one device group per APA (detector
    scale-out; make_detector_step/DetectorPipeline).  The 'apa' axis
    carries no collective at all; the per-APA monitoring psum runs over
    'link' inside each group.

    ``n_link_shards`` defaults to (available devices) // n_apas.
    """
    devices = _devices(None, backend)
    if n_link_shards is None:
        n_link_shards = max(1, len(devices) // n_apas)
    need = n_apas * n_link_shards
    devices = _devices(need, backend)
    grid = np.array(devices[:need]).reshape(n_apas, n_link_shards)
    return Mesh(grid, ("apa", "link"))
