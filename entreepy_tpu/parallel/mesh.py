"""Device mesh helpers.

A Huffman codec has one meaningful parallel axis: independent input blocks
(data parallelism). The mesh is therefore 1-D over the devices in order;
multi-host runs simply extend the same axis across hosts (XLA picks the
transport from device placement: NVLink between the GPUs of a host, the
network across hosts).
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh

BLOCK_AXIS = "blocks"


def make_mesh(n_devices: int | None = None, axis: str = BLOCK_AXIS) -> Mesh:
    """1-D mesh over the first ``n_devices`` devices (default: all)."""
    devices = jax.devices()
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"asked for {n_devices} devices, have {len(devices)}")
        devices = devices[:n_devices]
    return Mesh(devices, (axis,))
