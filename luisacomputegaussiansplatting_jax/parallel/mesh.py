"""Device-mesh helpers.

The reference is strictly single-device (one Device + one Stream,
app/main.cpp:162-163); every multi-device facility here is new
design: jax.sharding.Mesh over the devices, collectives inserted by
shard_map (XLA hands them to NCCL on GPUs).
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh


def make_mesh(
    shape: tuple[int, ...] | None = None,
    axis_names: tuple[str, ...] = ("gs",),
    devices=None,
) -> Mesh:
    """Build a mesh over the available devices.

    Default: a 1D mesh named "gs" (gaussian/tile sharding axis) over all
    devices. For multi-view training use e.g. shape=(V, D//V),
    axis_names=("data", "gs").
    """
    if devices is None:
        devices = jax.devices()
    if shape is None:
        shape = (len(devices),)
    if int(np.prod(shape)) != len(devices):
        raise ValueError(f"mesh shape {shape} != {len(devices)} devices")
    arr = np.asarray(devices).reshape(shape)
    return Mesh(arr, axis_names)


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
):
    """Initialise the multi-host JAX runtime (devices spanning hosts).

    Thin wrapper over jax.distributed.initialize. Nothing tells JAX of a
    GPU cluster: pass coordinator_address ("host:port"), num_processes
    and process_id explicitly. After this, jax.devices() spans every
    device of every process and make_mesh() builds meshes across hosts —
    gaussian shards then exchange splat entries through the same
    all_to_all (XLA routes the collective; see parallel/render_sharded).

    The reference has no distributed anything (single Device/Stream); this
    is the SURVEY.md section 5 'multi-host runtime' item.
    """
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return jax.devices()
