"""Winner-take-all disparity extraction with subpixel, uniqueness, and
left-right consistency (jittable JAX).

Replaces the post-aggregation stages inside OpenCV SGBM/BM (SURVEY.md §2
N4). Volumes are planes layout (D, H, W): the winner search, neighbor-cost
reads, and the right-view readout C_R(x, d) = C_L(x + d, d) are all
major-axis reductions and W-axis slices — no gathers over the volume. The
LR check needs **no second matcher** (the reference derives one via
``createRightMatcher``, ``stereo_vision/stereo_vision.py:171``).

Convention: invalid disparities are NaN in the float API;
:func:`to_fixed_point` converts to the reference's int16 disparity*16
contract (invalid -> (min_disparity - 1) * 16, as OpenCV emits).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def wta_disparity(agg: jnp.ndarray) -> jnp.ndarray:
    """Integer argmin over the D axis of (D, H, W). Returns int32 (H, W)."""
    return jnp.argmin(agg, axis=0).astype(jnp.int32)


def _big_sentinel(dtype) -> jnp.ndarray:
    return jnp.asarray(30000 if dtype == jnp.int16 else 1e9, dtype)


def _neighbor_costs(agg: jnp.ndarray, disp_idx: jnp.ndarray):
    """(c[d-1], c[d], c[d+1]) at the winner, via shifted one-hot sums.

    Planes layout lets the d±1 planes be major-axis shifts; selecting at
    the winner is a masked reduction (no take_along_axis gather). Returns
    float32 (H, W) maps regardless of the volume dtype.
    """
    D = agg.shape[0]
    big = _big_sentinel(agg.dtype)
    onehot = jax.nn.one_hot(disp_idx, D, axis=0, dtype=agg.dtype)  # (D, H, W)
    c1 = jnp.sum(agg * onehot, axis=0).astype(jnp.float32)
    up = jnp.concatenate([jnp.full_like(agg[:1], big), agg[:-1]], axis=0)
    down = jnp.concatenate([agg[1:], jnp.full_like(agg[:1], big)], axis=0)
    c0 = jnp.sum(up * onehot, axis=0).astype(jnp.float32)
    c2 = jnp.sum(down * onehot, axis=0).astype(jnp.float32)
    return c0, c1, c2


def subpixel_refine(agg: jnp.ndarray, disp_idx: jnp.ndarray) -> jnp.ndarray:
    """Parabola interpolation around the winning disparity.

    d* = d + (C[d-1] - C[d+1]) / (2 * (C[d-1] - 2C[d] + C[d+1])), clamped to
    ±0.5; at the D-range edges the integer disparity is kept.
    """
    D = agg.shape[0]
    c0, c1, c2 = _neighbor_costs(agg, disp_idx)
    denom = c0 - 2.0 * c1 + c2
    offset = jnp.where(denom > 1e-9, (c0 - c2) / (2.0 * jnp.maximum(denom, 1e-9)), 0.0)
    offset = jnp.clip(offset, -0.5, 0.5)
    at_edge = (disp_idx == 0) | (disp_idx == D - 1)
    return disp_idx.astype(jnp.float32) + jnp.where(at_edge, 0.0, offset)


def uniqueness_mask(agg: jnp.ndarray, disp_idx: jnp.ndarray,
                    uniqueness_ratio: int) -> jnp.ndarray:
    """True where the winner beats every non-neighbor cost by the ratio.

    OpenCV semantics: invalid if any d with |d - best| > 1 has
    cost[d] * 100 <= cost[best] * (100 + uniquenessRatio).
    """
    if uniqueness_ratio <= 0:
        return jnp.ones(agg.shape[1:], bool)
    D = agg.shape[0]
    best = jnp.min(agg, axis=0)
    ds = jnp.arange(D)[:, None, None]
    neighbor = jnp.abs(ds - disp_idx[None]) <= 1
    # integer-exact form: 100*cost <= (100+r)*best (in int32 to avoid
    # overflow for int16 volumes; fused into one volume pass by XLA)
    lhs = agg.astype(jnp.int32 if agg.dtype == jnp.int16 else jnp.float32) * 100
    rhs = best.astype(jnp.int32 if agg.dtype == jnp.int16 else jnp.float32)[None] \
        * (100 + uniqueness_ratio)
    violates = (lhs <= rhs) & ~neighbor
    return ~jnp.any(violates, axis=0)


def right_disparity_from_volume(agg: jnp.ndarray,
                                min_disparity: int = 0) -> jnp.ndarray:
    """Right-view WTA disparity from the left-anchored cost volume.

    C_right(y, x_r, d) = C_left(y, x_r + d, d): in planes layout each d
    plane just shifts left by d along W (a slice), then argmin over d.
    Out-of-frame samples get a huge cost. Returns float32 (H, W) (integer
    precision — used only for the consistency check, as in OpenCV).
    """
    D, H, W = agg.shape
    big = _big_sentinel(agg.dtype)
    # Gather-free shear: in (D, W, H) order the (d, x) axes are adjacent, so
    # appending one big-cost row per d-plane and re-chunking rows of length
    # W+1 shifts each successive plane left by one more pixel:
    #   sheared[d, xr] = flat[d*(W+1) + xr] = agg[d, :, xr + d].
    # Pure reshape/pad/slice — no take_along_axis.
    flat = jnp.swapaxes(agg, 1, 2).reshape(D * W, H)
    flat = jnp.concatenate([flat, jnp.full((D, H), big, agg.dtype)], axis=0)
    sheared = flat.reshape(D, W + 1, H)[:, :W, :]
    xr = jnp.arange(W)[None, :, None]
    d = jnp.arange(D)[:, None, None]
    sheared = jnp.where(xr + d < W, sheared, big)
    idx = jnp.argmin(sheared, axis=0)                       # (W, H)
    return (idx.T + min_disparity).astype(jnp.float32)


def lr_consistency_mask(disp_left: jnp.ndarray, disp_right: jnp.ndarray,
                        disp12_max_diff: int,
                        min_disparity: int = 0) -> jnp.ndarray:
    """disp12 check: |d_L(x) - d_R(x - d_L(x))| <= disp12_max_diff.

    ``disp12_max_diff < 0`` disables the check (OpenCV convention,
    settings.ini:11).
    """
    if disp12_max_diff < 0:
        return jnp.ones(disp_left.shape, bool)
    H, W = disp_left.shape
    x = jnp.arange(W)[None, :].repeat(H, axis=0)
    xr = jnp.round(x - disp_left).astype(jnp.int32)
    inframe = (xr >= 0) & (xr < W)
    xrc = jnp.clip(xr, 0, W - 1)
    d_r = jnp.take_along_axis(disp_right, xrc, axis=1)
    ok = jnp.abs(disp_left - d_r) <= disp12_max_diff
    return ok & inframe


@functools.partial(jax.jit, static_argnames=("min_disparity", "uniqueness_ratio",
                                             "disp12_max_diff", "subpixel",
                                             "return_right"))
def extract_disparity(agg: jnp.ndarray, min_disparity: int = 0,
                      uniqueness_ratio: int = 15, disp12_max_diff: int = 1,
                      subpixel: bool = True, return_right: bool = False):
    """Aggregated (D, H, W) volume -> float32 disparity map, NaN invalids.

    The full OpenCV-equivalent WTA stage: argmin, uniqueness, subpixel,
    LR consistency. Speckle filtering is separate (``ops/speckle.py``).
    Accepts float32 or int16 volumes (dtype-preserving volume passes).
    ``return_right`` additionally returns the right-view WTA disparity
    (already computed for the disp12 check) so callers can feed an
    LR-confidence map to the WLS stage without a second volume pass.
    """
    agg = jnp.asarray(agg)
    if agg.dtype not in (jnp.float32, jnp.int16):
        agg = agg.astype(jnp.float32)
    idx = wta_disparity(agg)
    disp = subpixel_refine(agg, idx) if subpixel else idx.astype(jnp.float32)
    disp = disp + min_disparity

    mask = uniqueness_mask(agg, idx, uniqueness_ratio)
    disp_right = right_disparity_from_volume(agg, min_disparity)
    mask = mask & lr_consistency_mask(disp, disp_right, disp12_max_diff,
                                      min_disparity)
    disp = jnp.where(mask, disp, jnp.nan)
    return (disp, disp_right) if return_right else disp


def to_fixed_point(disparity: jnp.ndarray, min_disparity: int = 0) -> jnp.ndarray:
    """float NaN-invalid -> int16 disparity*16 (the reference's on-disk
    contract, ``stereo_vision/stereo_vision.py:144-146``)."""
    invalid = (min_disparity - 1) * 16
    fixed = jnp.where(jnp.isfinite(disparity),
                      jnp.round(disparity * 16.0), invalid)
    return fixed.astype(jnp.int16)


def from_fixed_point(disparity16: jnp.ndarray,
                     min_disparity: int = 0) -> jnp.ndarray:
    """int16 disparity*16 -> float with NaN invalids (inverse contract,
    reference divides by 16 at ``disparity_test.py:206``)."""
    d = disparity16.astype(jnp.float32) / 16.0
    return jnp.where(d < min_disparity, jnp.nan, d)
