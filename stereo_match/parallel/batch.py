"""Data-parallel stereo matching: a batch of pairs across the mesh.

The throughput-scaling mode (SURVEY.md §2 parallelism table, "DP" row):
each card matches different frames of a capture session / video stream.
Perfect scaling — no cross-card traffic during matching — and the mode the
fps-per-card benchmark multiplies through.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from stereo_match.config import DisparityConfig


def batched_matcher(config: DisparityConfig, mesh: Mesh):
    """Compiled data-parallel matcher over the mesh's "batch" axis.

    Returns ``fn(lefts, rights) -> (raw, filtered)`` for (B, H, W) inputs;
    B must be divisible by the batch-axis size. Each card runs the
    single-card pipeline (``_match_core``, vmapped) on its own slice of the
    batch inside ``shard_map``, so its kernels see only local frames and
    no collective runs; other mesh axes hold replicas.
    """
    from stereo_match.pipeline.stereo import _match_core

    spec = P("batch", None, None)
    core = functools.partial(_match_core, cfg=config)
    local = shard_map(jax.vmap(core), mesh=mesh, in_specs=(spec, spec),
                      out_specs=(spec, spec), check_vma=False)
    fn = jax.jit(local, out_shardings=(NamedSharding(mesh, spec),) * 2)

    def wrapper(lefts, rights):
        l = jnp.asarray(np.asarray(lefts), jnp.float32)
        r = jnp.asarray(np.asarray(rights), jnp.float32)
        return fn(l, r)

    return wrapper
