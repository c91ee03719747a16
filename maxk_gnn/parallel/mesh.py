"""Device-mesh helpers.

The reference is single-GPU by design (SURVEY §2.3: zero distributed
machinery). Multi-chip is a new capability of this framework: a 1-axis
mesh named "graph" over which adjacency rows and node features are
partitioned; compressed CBSR features ride the interconnect
(`maxk_gnn.parallel.shard`).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
from jax.sharding import Mesh

GRAPH_AXIS = "graph"


def make_mesh(
    n_devices: Optional[int] = None, devices: Optional[Sequence] = None
) -> Mesh:
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            if len(devices) < n_devices:
                raise ValueError(
                    f"mesh wants {n_devices} devices but the "
                    f"{devices[0].platform} platform has {len(devices)}; "
                    "pass devices=jax.devices('cpu') with XLA_FLAGS="
                    "--xla_force_host_platform_device_count=N for a "
                    "virtual mesh"
                )
            devices = devices[:n_devices]
    return Mesh(list(devices), (GRAPH_AXIS,))
