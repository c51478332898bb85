"""Disparity-plane (D-axis) sharding + the Ulysses-style layout switch.

SURVEY.md §2's third parallelism row (and §5's long-context analog): shard
the cost volume's D axis across cards. Two sound uses:

* **Cost construction + WTA** — each card builds and searches only its
  D-slice. The volume (the largest object in the pipeline, 238 MB at
  KITTI/f32) never exists in full on any card. The winner-take-all
  combine is a handful of (H, W)-sized ``lax.pmin`` rounds —
  global argmin with first-occurrence ties, the idx±1 neighbor costs for
  the subpixel parabola (which may live on the adjacent shard), the
  second-best-outside-±1 for the uniqueness test, and the right-view WTA
  for the LR check. Exact vs the single-card WTA (tested bit-equal).
* **SGM aggregation via layout switch** — SGM's recurrence couples all d
  (pmin, d±1), so per-D-shard SGM is *wrong*. Instead, an
  ``all_to_all`` re-shards (D_loc, H, W) -> (D, H_loc, W) (the stereo
  Ulysses move: shard-by-plane for building, shard-by-rows for
  scanning), the row-sharded SGM of ``parallel/tiling.py`` runs
  with its carry chains, and WTA happens row-local where every d is
  present.

All collectives ride a ``Mesh`` "disp" axis.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from stereo_match.config import DisparityConfig
from stereo_match.ops.census import census_transform, hamming_distance
from stereo_match.ops.cost_volume import INVALID_COST, INVALID_COST_I16


def make_disp_mesh(n: int | None = None, devices=None) -> Mesh:
    """A 1-axis ("disp",) mesh over ``n`` devices."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    if n is not None:
        devices = devices[:n]
    return Mesh(devices, ("disp",))


def _local_census_volume(left: jnp.ndarray, right: jnp.ndarray,
                         d_levels: int, d0, window, min_disparity: int,
                         dtype) -> jnp.ndarray:
    """This shard's (D_loc, H, W) census-cost slice, planes d0..d0+D_loc.

    ``d0`` is the *traced* global plane offset (axis_index * D_loc), so the
    shift is one dynamic ``jnp.roll`` plus static per-plane rolls; the
    wrap-around columns are overwritten by the x < min_disparity+d0+i
    INVALID mask — identical semantics to ``ops.cost_volume`` (bit-equal,
    tested).
    """
    cl = census_transform(left, window)                      # (H, W, words)
    cr = jnp.roll(census_transform(right, window), min_disparity + d0,
                  axis=1)
    W = left.shape[1]
    col = jnp.arange(W)[None, :]
    invalid = INVALID_COST_I16 if jnp.dtype(dtype) == jnp.int16 \
        else INVALID_COST.astype(dtype)
    planes = []
    for i in range(d_levels):
        cr_i = jnp.roll(cr, i, axis=1) if i else cr
        ham = hamming_distance(cl, cr_i).astype(dtype)
        d_total = min_disparity + d0 + i
        planes.append(jnp.where(col < d_total, invalid, ham))
    return jnp.stack(planes, axis=0)


def _pmin(x, axis_name):
    return jax.lax.pmin(x, axis_name)


def _cost_at(v: jnp.ndarray, g: jnp.ndarray, d0, big) -> jnp.ndarray:
    """cost at global plane index ``g`` from this shard's slice (BIG when
    out of range). One-hot masked reduction — no gathers (planes layout)."""
    D_loc = v.shape[0]
    j = g - d0                                               # (H, W)
    iota = jax.lax.broadcasted_iota(jnp.int32, v.shape, 0)
    sel = iota == j[None]
    return jnp.min(jnp.where(sel, v, big), axis=0)


def _right_local(v: jnp.ndarray, d0) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Local right-view WTA: best cost + *global* plane index per (y, xr).

    C_R(y, xr, g) = C_L(g, y, xr + g) for g in this shard's range: pre-roll
    the slice left by d0 so the standard gather-free shear (one reshape,
    see ``ops.wta.right_disparity_from_volume``) aligns plane i at
    xr + d0 + i.
    """
    D_loc, H, W = v.shape
    big = jnp.float32(3e9)
    vr = jnp.roll(v, -d0, axis=2).astype(jnp.float32)
    flat = jnp.swapaxes(vr, 1, 2).reshape(D_loc * W, H)
    flat = jnp.concatenate([flat, jnp.full((D_loc, H), big)], axis=0)
    sheared = flat.reshape(D_loc, W + 1, H)[:, :W, :]        # (D_loc, W, H)
    xr = jnp.arange(W)[None, :, None]
    d = d0 + jnp.arange(D_loc)[:, None, None]
    sheared = jnp.where(xr + d < W, sheared, big)
    best = jnp.min(sheared, axis=0)                          # (W, H)
    idx = jnp.min(jnp.where(sheared == best[None], d, 2 ** 30), axis=0)
    return best.T, idx.T                                     # (H, W) each


def extract_disparity_dsharded(vol_local: jnp.ndarray, d0, axis_name: str,
                               num_disparities: int, min_disparity: int = 0,
                               uniqueness_ratio: int = 15,
                               disp12_max_diff: int = 1,
                               subpixel: bool = True) -> jnp.ndarray:
    """WTA over a D-sharded volume — runs INSIDE shard_map over
    ``axis_name``; returns the (H, W) float disparity (replicated).

    Semantics of ``ops.wta.extract_disparity`` reproduced exactly with
    five (H, W) ``pmin`` rounds: best, winner index, c[idx-1], c[idx+1]
    (either may live on the neighboring shard), second-best outside ±1;
    plus two rounds for the right-view WTA feeding the disp12 check.
    """
    v = vol_local.astype(jnp.float32)
    D_loc = v.shape[0]
    big = jnp.float32(3e9)
    big_i = jnp.int32(2 ** 30)

    best_l = jnp.min(v, axis=0)
    iota_g = d0 + jax.lax.broadcasted_iota(jnp.int32, v.shape, 0)
    idx_lg = jnp.min(jnp.where(v == best_l[None], iota_g, big_i), axis=0)
    best = _pmin(best_l, axis_name)
    ig = _pmin(jnp.where(best_l == best, idx_lg, big_i), axis_name)

    c0 = _pmin(_cost_at(v, ig - 1, d0, big), axis_name)
    c2 = _pmin(_cost_at(v, ig + 1, d0, big), axis_name)
    near = jnp.abs(iota_g - ig[None]) <= 1
    second = _pmin(jnp.min(jnp.where(near, big, v), axis=0), axis_name)

    if subpixel:
        denom = c0 - 2.0 * best + c2
        offset = jnp.where(denom > 1e-9,
                           (c0 - c2) / (2.0 * jnp.maximum(denom, 1e-9)), 0.0)
        offset = jnp.clip(offset, -0.5, 0.5)
        at_edge = (ig == 0) | (ig == num_disparities - 1)
        disp = ig.astype(jnp.float32) + jnp.where(at_edge, 0.0, offset)
    else:
        disp = ig.astype(jnp.float32)
    disp = disp + min_disparity

    if uniqueness_ratio > 0:
        mask = second * 100.0 > best * (100.0 + uniqueness_ratio)
    else:
        mask = jnp.ones(best.shape, bool)

    if disp12_max_diff >= 0:
        rb_l, ri_l = _right_local(vol_local, d0)
        rb = _pmin(rb_l, axis_name)
        ri = _pmin(jnp.where(rb_l == rb, ri_l, big_i), axis_name)
        disp_right = (ri + min_disparity).astype(jnp.float32)
        from stereo_match.ops.wta import lr_consistency_mask
        mask = mask & lr_consistency_mask(disp, disp_right, disp12_max_diff,
                                          min_disparity)
    return jnp.where(mask, disp, jnp.nan)


def wta_dsharded(cost: jnp.ndarray, mesh: Mesh,
                 config: DisparityConfig | None = None) -> jnp.ndarray:
    """Public entry: D-shard a replicated (D, H, W) volume and run the
    pmin-combined WTA. Exact vs ``ops.wta.extract_disparity`` (tested)."""
    cfg = config or DisparityConfig()
    D = cost.shape[0]
    n = mesh.shape["disp"]
    if D % n:
        raise ValueError(f"D={D} not divisible by disp axis size {n}")
    D_loc = D // n

    def body(vol_local):
        d0 = jax.lax.axis_index("disp") * D_loc
        return extract_disparity_dsharded(
            vol_local, d0, "disp", num_disparities=D,
            min_disparity=cfg.min_disparity,
            uniqueness_ratio=cfg.uniqueness_ratio,
            disp12_max_diff=cfg.disp12_max_diff, subpixel=cfg.subpixel)

    return shard_map(body, mesh=mesh, in_specs=(P("disp", None, None),),
                     out_specs=P(None, None), check_vma=False)(cost)


def match_dsharded(left: jnp.ndarray, right: jnp.ndarray,
                   config: DisparityConfig, mesh: Mesh,
                   mode: str = "halo", halo: int = 48) -> jnp.ndarray:
    """Full D-sharded matcher: per-shard cost build -> Ulysses all_to_all
    -> row-sharded SGM (carry chains) -> row-local WTA -> gather.

    The cost volume never materializes unsharded. ``mode`` as in
    ``parallel/tiling.sgm_aggregate_sharded``. Returns (H, W) float32
    disparity with NaN invalids (pre-speckle/WLS).
    """
    from stereo_match.ops.wta import extract_disparity
    from stereo_match.parallel.tiling import _local_sgm

    cfg = config
    n = mesh.shape["disp"]
    D = cfg.num_disparities
    if D % n:
        raise ValueError(f"num_disparities={D} not divisible by {n}")
    D_loc = D // n
    left = jnp.asarray(left, jnp.float32)
    right = jnp.asarray(right, jnp.float32)
    H, W = left.shape
    dtype = jnp.dtype(cfg.dtype) if cfg.dtype else jnp.float32
    Hp = -(-H // n) * n
    if Hp != H:
        pads = ((0, Hp - H), (0, 0))
        left = jnp.pad(left, pads)
        right = jnp.pad(right, pads)

    def body(l, r):
        d0 = jax.lax.axis_index("disp") * D_loc
        vol_l = _local_census_volume(l, r, D_loc, d0, cfg.census_window,
                                     cfg.min_disparity, dtype)
        # Ulysses switch: (D_loc, Hp, W) -> (D, Hp/n, W)
        vol_rows = jax.lax.all_to_all(vol_l, "disp", split_axis=1,
                                      concat_axis=0, tiled=True)
        agg = _local_sgm(vol_rows, cfg.P1, cfg.P2, cfg.num_paths,
                         axis_name="disp", mode=mode, halo=halo)
        disp_local = extract_disparity(
            agg, min_disparity=cfg.min_disparity,
            uniqueness_ratio=cfg.uniqueness_ratio,
            disp12_max_diff=cfg.disp12_max_diff, subpixel=cfg.subpixel)
        return jax.lax.all_gather(disp_local, "disp", axis=0, tiled=True)

    out = shard_map(body, mesh=mesh,
                    in_specs=(P(None, None), P(None, None)),
                    out_specs=P(None, None), check_vma=False)(left, right)
    return out[:H]
