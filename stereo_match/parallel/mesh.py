"""Device mesh construction and axis conventions.

The reference has zero parallelism (SURVEY.md §2: single process, one
OpenCV thread pool); this framework scales via ``jax.sharding.Mesh``
axes:

* ``"batch"`` — data parallelism over stereo pairs / video frames,
* ``"rows"``  — spatial tiling of image rows within one pair (the SGM
  vertical/diagonal path state crosses shard boundaries; see
  ``parallel/tiling.py`` for the carry chain),

with XLA collectives (NCCL on the GPU). The cards of one host are joined
all to all, so a mesh follows the algorithm, not a topology. Multi-host
initialization wraps ``jax.distributed``.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(batch: int = 1, rows: int | None = None,
              devices=None) -> Mesh:
    """Build a ("batch", "rows") mesh over the available devices.

    ``rows`` defaults to devices/batch. A 1-sized axis is kept in the mesh
    (harmless; specs stay uniform across configurations).
    """
    devices = np.asarray(devices if devices is not None else jax.devices())
    n = devices.size
    if rows is None:
        if n % batch:
            raise ValueError(f"{n} devices not divisible by batch={batch}")
        rows = n // batch
    if batch * rows != n:
        raise ValueError(f"batch*rows = {batch * rows} != {n} devices")
    return Mesh(devices.reshape(batch, rows), ("batch", "rows"))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Leading-axis sharding for a batch of images/pairs."""
    return NamedSharding(mesh, P("batch"))


def volume_sharding(mesh: Mesh) -> NamedSharding:
    """(D, H, W) cost volume: rows (H) sharded, batch replicated."""
    return NamedSharding(mesh, P(None, "rows", None))


def image_sharding(mesh: Mesh) -> NamedSharding:
    """(H, W) image with rows sharded."""
    return NamedSharding(mesh, P("rows", None))


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None) -> None:
    """Join the multi-host process group.

    No-op when single-process (the common case in tests and single-host
    runs). Mirrors ``jax.distributed.initialize`` with env fallbacks.
    """
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id)
