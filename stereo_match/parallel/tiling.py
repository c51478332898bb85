"""Row-sharded SGM: spatial tiling across cards with carry hand-off.

The stereo analog of sequence parallelism (SURVEY.md §5): SGM's directional
recurrences are sequential along their path, so sharding image rows across
cards cuts every *horizontal* scan into fully-local work, while *vertical
and diagonal* scans must chain a carry -- the (8, D, W) slab of path values
at the shard boundary -- from each shard to the next (``lax.ppermute``).

The local compute is the same per-stage function the single-card pipeline
runs: ``ops/sgm_cuda.sgm_paths``, which is the CUDA kernel on the GPU and
the plain reference (``ops/sgm.py``, ``scan_direction(init_carry=...)``)
on the CPU, with the carry slab threaded through ``init_carry``.

Two modes:

* ``exact`` -- a sequential chain: shard k runs its local scan initialized
  with shard k-1's final carry, delivered by ``lax.ppermute``. Each shard
  computes its local scan ONCE, at its step in the chain (``lax.cond``);
  wall-clock for the chained directions doesn't shrink with shards (the
  dependency is real), but horizontal scans, cost build, and WTA all scale.
  The path values equal the single-card ones; the total adds the same
  paths in another order (E, W, then S, SE, SW, then N, NW, NE), which is
  bit-equal wherever costs are integers (census) and within float32
  rounding otherwise.
* ``halo`` -- shard k additionally scans ``halo`` warm-up rows copied from
  shard k-1 (one ppermute of a (D, halo, W) slab) and discards them. The
  SGM recurrence forgets its initial state geometrically (P2 clamps the
  influence), so a 32-64 row halo makes boundary effects numerically
  invisible while every direction scales linearly.

All functions here run *inside* ``shard_map`` over a mesh "rows" axis; the
public entry is :func:`sgm_aggregate_sharded`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from stereo_match.ops.sgm_cuda import sgm_paths

HORIZONTAL = (0, 1)    # E, W: never cross a row shard


def _chain_dirs(num_paths: int) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """(downward, upward) direction indices of ``ops.sgm.PATH_DIRECTIONS_8``."""
    if num_paths == 8:
        return (2, 4, 6), (3, 5, 7)
    return (2,), (3,)


def _chain(scan_fn, carry_shape, fallback_out, axis_name: str,
           reverse: bool, dtype) -> jnp.ndarray:
    """Exact cross-shard scan: sequential carry chain over the shard axis.

    ``scan_fn(carry_in) -> (out, carry_out)`` runs the local scan.
    Each shard computes exactly once — at its position in the chain, gated
    by ``lax.cond`` (the round-1 version re-ran every shard's scan at every
    step: O(n * H_loc) work per shard instead of O(H_loc)). The other n-1
    steps cost one ppermute of the (8, D, W) carry slab.
    """
    n = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    if reverse:      # carry flows bottom shard -> top shard
        perm = [(i, i - 1) for i in range(1, n)]
        my_step = n - 1 - idx
    else:
        perm = [(i, i + 1) for i in range(n - 1)]
        my_step = idx

    def body(k, state):
        carry_in, out, cout = state
        out, cout = jax.lax.cond(
            k == my_step,
            lambda ci: scan_fn(ci),
            lambda ci: (out, cout),
            carry_in)
        carry_next = jax.lax.ppermute(cout, axis_name, perm)
        return carry_next, out, cout

    zero_carry = jnp.zeros(carry_shape, dtype)
    init = (zero_carry, jnp.zeros_like(fallback_out), zero_carry)
    _, out, _ = jax.lax.fori_loop(0, n, body, init)
    return out


def _halo_scan(vol: jnp.ndarray, accum: jnp.ndarray, p1, p2,
               axis_name: str, reverse: bool, halo: int,
               dirs: tuple[int, ...]) -> jnp.ndarray:
    """Approximate cross-shard scan: warm up through ``halo`` copied rows.

    One ppermute of the predecessor's (D, halo, W) tail (in scan order),
    then a purely local scan over the extended block; warm-up rows are
    dropped.
    """
    D, Hl, W = vol.shape
    h = max(1, min(halo, Hl))
    n = jax.lax.axis_size(axis_name)
    if reverse:      # scan-order predecessor is the shard below
        perm = [(i, i - 1) for i in range(1, n)]
        warm = jax.lax.ppermute(vol[:, :h], axis_name, perm)
        ext = jnp.concatenate([vol, warm], axis=1)
        out = sgm_paths(ext, p1, p2, dirs)[0][:, :Hl]
    else:
        perm = [(i, i + 1) for i in range(n - 1)]
        warm = jax.lax.ppermute(vol[:, -h:], axis_name, perm)
        ext = jnp.concatenate([warm, vol], axis=1)
        out = sgm_paths(ext, p1, p2, dirs)[0][:, h:]
    return accum + out


def _local_sgm(cost_local: jnp.ndarray, p1: float, p2: float,
               num_paths: int, axis_name: str, mode: str,
               halo: int) -> jnp.ndarray:
    """Per-shard 2/4/8-path aggregation with cross-shard chains.

    Runs inside shard_map on the local (D, H_loc, W) block. Horizontal
    paths never cross row shards; the downward and the upward paths chain
    their carry slab exactly or warm up through a halo.
    """
    D, Hl, W = cost_local.shape
    total, _ = sgm_paths(cost_local, p1, p2, HORIZONTAL)
    if num_paths == 2:
        return total
    down, up = _chain_dirs(num_paths)
    for rev, dirs in ((False, down), (True, up)):
        if mode == "exact":
            def scan_fn(ci, dirs=dirs, total=total):
                return sgm_paths(cost_local, p1, p2, dirs, total=total,
                                 init_carry=ci)
            total = _chain(scan_fn, (8, D, W), total, axis_name, rev,
                           total.dtype)
        else:
            total = _halo_scan(cost_local, total, p1, p2, axis_name, rev,
                               halo, dirs)
    return total


def sgm_aggregate_sharded(cost: jnp.ndarray, p1: float, p2: float,
                          mesh: Mesh, num_paths: int = 8,
                          mode: str = "exact", halo: int = 48) -> jnp.ndarray:
    """Row-sharded SGM aggregation over ``mesh``'s "rows" axis.

    ``cost``: (D, H, W); H is zero-padded to whole shards (free: zero rows
    keep a zero carry, see ``ops/sgm.py``). ``mode``: "exact" (the
    single-card paths, chained) or "halo" (linear scaling, numerically
    invisible boundary effects).
    """
    if num_paths not in (2, 4, 8):
        raise ValueError("num_paths must be 2, 4 or 8")
    if mode not in ("exact", "halo"):
        raise ValueError("mode must be 'exact' or 'halo'")
    cost = jnp.asarray(cost)
    if cost.dtype not in (jnp.float32, jnp.int16):
        cost = cost.astype(jnp.float32)
    D, H, W = cost.shape
    rows = mesh.shape["rows"]
    Hp = -(-H // rows) * rows
    if Hp != H:
        cost = jnp.pad(cost, ((0, 0), (0, Hp - H), (0, 0)))

    def fn(block):
        return _local_sgm(block, p1, p2, num_paths, "rows", mode, halo)

    spec = P(None, "rows", None)
    out = shard_map(fn, mesh=mesh, in_specs=(spec,), out_specs=spec,
                    check_vma=False)(cost)
    return out[:, :H] if Hp != H else out
