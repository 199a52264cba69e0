"""Device-mesh helpers."""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh


def make_mesh(num_devices: int | None = None, axis_name: str = "data") -> Mesh:
    """One-axis mesh over the first `num_devices` local devices.

    SfM workloads shard naturally along one data axis (images for
    extraction, pairs for matching, landmarks for BA), so a 1-D mesh covers
    every stage; multi-host runs extend the same axis across hosts via
    jax.distributed initialisation before calling this.  The GPUs of one
    host are joined all to all, so the mesh follows the algorithm alone.
    """
    devices = jax.devices()
    if num_devices is not None:
        devices = devices[:num_devices]
    return Mesh(np.array(devices), (axis_name,))


def init_multi_host(coordinator_address: str | None = None,
                    num_processes: int | None = None,
                    process_id: int | None = None):
    """Initialise jax.distributed for multi-host meshes.

    Pass the three arguments explicitly: nothing in a plain GPU or CPU
    cluster announces them.  After this, make_mesh() sees every device of
    every process and the same shard_map programs scale across hosts (the
    reference has no distributed mode at all; SURVEY.md section 5).
    Safe to call more than once.
    """
    import jax

    # CPU meshes (tests / fake backends) need a cross-process collective
    # implementation; gloo ships with jaxlib.  No effect on GPU meshes.
    try:
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    except Exception:
        pass
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:
        if "already initialized" not in str(e):
            raise
    return jax.process_index(), jax.process_count()
