"""Multi-host execution: ("host", "chip") meshes and per-host data loading.

The reference is strictly single-process (SURVEY.md §2); this framework
scales past one host by giving the host boundary its own mesh axis:

* ``"host"``  — one slot per process (network between them),
* ``"chip"``  — the process-local devices.

Data parallelism shards the frame batch over BOTH axes host-major, so the
rows of the global batch that live on host k's chips are exactly the rows
host k's process loads from disk — no cross-host input traffic, the
network carries only compiled collectives (and none at all for pure DP matching).

Real multi-host runs call :func:`initialize_multihost` first (one process
per host); everything here also works single-process, where a *simulated*
host count splits the local devices into virtual host groups — the mode the
test suite and ``benchmarks/scaling.py`` validate the logic in, per
SURVEY.md §4's multi-device simulation strategy.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from stereo_match.parallel.mesh import initialize_multihost  # noqa: F401


def make_host_mesh(n_hosts: int | None = None, devices=None) -> Mesh:
    """A ("host", "chip") mesh.

    Real multi-host: ``n_hosts=None`` uses ``jax.process_count()`` and
    groups devices by owning process — devices are explicitly sorted by
    (process_index, id) first, so each mesh row is owned by exactly one
    process even if ``jax.devices()`` is not process-contiguous on the
    platform (``host_local_slice`` relies on this alignment). Simulation:
    pass ``n_hosts`` to split the local devices into that many virtual
    host groups.
    """
    if devices is None:
        devices = sorted(jax.devices(),
                         key=lambda d: (d.process_index, d.id))
    devices = np.asarray(devices)
    if n_hosts is None:
        n_hosts = jax.process_count()
    if devices.size % n_hosts:
        raise ValueError(f"{devices.size} devices not divisible by "
                         f"{n_hosts} hosts")
    return Mesh(devices.reshape(n_hosts, devices.size // n_hosts),
                ("host", "chip"))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Leading-axis batch sharding over host x chip (host-major)."""
    return NamedSharding(mesh, P(("host", "chip")))


def host_local_slice(n_items: int, host_index: int, n_hosts: int) -> slice:
    """The contiguous rows of the global batch owned by ``host_index``.

    Matches :func:`batch_sharding`'s host-major layout, so a process that
    loads exactly this slice feeds its own chips and nothing else.
    """
    if n_items % n_hosts:
        raise ValueError(f"batch {n_items} not divisible by {n_hosts} hosts")
    per = n_items // n_hosts
    return slice(host_index * per, (host_index + 1) * per)


def load_host_sharded(load_fn, n_items: int, mesh: Mesh,
                      item_shape: tuple[int, ...],
                      dtype=np.float32) -> jax.Array:
    """Assemble a global (n_items, *item_shape) batch, each host loading
    only its own rows.

    ``load_fn(global_index) -> np.ndarray`` is the per-item disk read
    (PNG/npz decode). Real multi-host: each process calls ``load_fn`` for
    its :func:`host_local_slice` only and the global array is stitched via
    ``jax.make_array_from_process_local_data`` (zero DCN input traffic).
    Single-process (incl. simulated hosts): every host group's rows are
    loaded locally and placed shard-by-shard on its devices — same layout,
    same placement, testable without processes.
    """
    n_hosts = mesh.shape["host"]
    sharding = batch_sharding(mesh)
    if jax.process_count() > 1:
        sl = host_local_slice(n_items, jax.process_index(), n_hosts)
        local = np.stack([load_fn(i) for i in range(sl.start, sl.stop)])
        return jax.make_array_from_process_local_data(
            sharding, local.astype(dtype), (n_items, *item_shape))

    # single-process: emulate per-host loading, then per-device placement
    n_dev = math.prod(mesh.devices.shape)
    if n_items % n_dev:
        raise ValueError(f"batch {n_items} not divisible by {n_dev} devices")
    per_dev = n_items // n_dev
    shards = []
    for d, dev in enumerate(mesh.devices.reshape(-1)):
        rows = np.stack([load_fn(i)
                         for i in range(d * per_dev, (d + 1) * per_dev)])
        shards.append(jax.device_put(rows.astype(dtype), dev))
    return jax.make_array_from_single_device_arrays(
        (n_items, *item_shape), sharding, shards)


def batched_matcher_multihost(config, mesh: Mesh):
    """Data-parallel matcher over the flattened ("host", "chip") batch.

    Same per-pair program as ``parallel.batch.batched_matcher``; the only
    difference is the two-axis sharding, which keeps every pair's work on
    one device and requires no collectives at all. Inputs should come from :func:`load_host_sharded`.
    """
    import functools
    from jax import shard_map
    from stereo_match.pipeline.stereo import _match_core

    spec = P(("host", "chip"), None, None)
    core = functools.partial(_match_core, cfg=config)
    local = shard_map(jax.vmap(core), mesh=mesh, in_specs=(spec, spec),
                      out_specs=(spec, spec), check_vma=False)
    return jax.jit(local, out_shardings=(NamedSharding(mesh, spec),) * 2)
