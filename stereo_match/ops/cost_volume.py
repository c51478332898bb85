"""Matching-cost volume construction (jittable JAX).

Builds cost volumes in the framework's canonical **planes layout**
``(D, H, W)``, with the disparity hypothesis d as the major axis. The plain
stages (SGM scans, WTA, LR readout) consume it with *slices only* --
shifting the right image by d, shifting disparity neighbors d±1, and reading
the right-view cost C_R(x, d) = C_L(x + d, d) are all contiguous slices,
never gathers. The GPU SGM kernel reads (H, W, D) instead and transposes at
its boundary (``ops/sgm_cuda.py``).

Cost families (the native algorithms the reference delegates, SURVEY.md §2
N2):

* census + Hamming (default; robust, integer VPU ops),
* SAD / SSD block costs (the ``StereoBM`` capability,
  ``stereo_vision/stereo_vision.py:165-166``),
* Birchfield–Tomasi on x-Sobel prefiltered images with ``pre_filter_cap``
  (the pixel cost inside OpenCV's ``StereoSGBM``, implicit at
  ``stereo_vision/stereo_vision.py:153``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from stereo_match.ops.census import census_transform, hamming_distance

# Cost assigned where the right-image sample at x-d falls off the frame.
# Finite (not inf) so SGM arithmetic stays NaN-free in any dtype; the int16
# value keeps 8-path sums well inside the int16 range (8 * (1024+P2)).
# numpy (not jnp) scalars: creating a device array at import time would
# initialize the XLA backend, which breaks multi-host programs that must
# call jax.distributed.initialize before any backend touch
INVALID_COST = np.float32(1e4)
INVALID_COST_I16 = np.int16(1024)


def _shift_plane(arr: jnp.ndarray, d) -> jnp.ndarray:
    """(..., W) plane sampled at x-d: out[..., x] = arr[..., x-d].

    Static or traced ``d``; the x-d < 0 region holds the edge replica (it
    is overwritten by INVALID_COST downstream).
    """
    W = arr.shape[-1]
    if isinstance(d, int):          # static shift: a free strided-slice view
        if d == 0:
            return arr
        pad = [(0, 0)] * (arr.ndim - 1) + [(d, 0)]
        return jnp.pad(arr, pad, mode="edge")[..., :W]
    pad = [(0, 0)] * (arr.ndim - 1) + [(W, 0)]
    padded = jnp.pad(arr, pad, mode="edge")
    start = (0,) * (arr.ndim - 1) + (W - d,)
    return jax.lax.dynamic_slice(padded, start, arr.shape)


def _invalid_mask(W: int, num_disparities: int, min_disparity: int) -> jnp.ndarray:
    """(D, 1, W) bool: True where x - d < 0 (no right sample)."""
    d = (min_disparity + jnp.arange(num_disparities))[:, None, None]
    x = jnp.arange(W)[None, None, :]
    return x < d


def _stack_over_disparities(plane_fn, num_disparities: int, min_disparity: int,
                            W: int) -> jnp.ndarray:
    """Unrolled per-disparity (H, W) plane builder -> (D, H, W) volume.

    Static unrolling keeps every shift a strided slice (a vmap over traced
    d would lower the shifts to gathers).
    """
    vol = jnp.stack([plane_fn(min_disparity + i)
                     for i in range(num_disparities)], axis=0)
    mask = _invalid_mask(W, num_disparities, min_disparity)
    invalid = INVALID_COST_I16 if vol.dtype == jnp.int16 else \
        INVALID_COST.astype(vol.dtype)
    return jnp.where(mask, invalid, vol)


def census_cost_volume(left: jnp.ndarray, right: jnp.ndarray,
                       num_disparities: int, min_disparity: int = 0,
                       window: tuple[int, int] = (5, 5),
                       dtype=jnp.float32) -> jnp.ndarray:
    """(D, H, W) Hamming cost between census descriptors.

    ``dtype``: float32 (default) or int16 — census costs are small
    integers, so both are exact; int16 halves the volume's memory.
    """
    cl = census_transform(left, window)    # (H, W, words)
    cr = census_transform(right, window)
    cl = jnp.moveaxis(cl, -1, 0)           # (words, H, W): planes layout too
    cr = jnp.moveaxis(cr, -1, 0)

    def plane(d):
        shifted = _shift_plane(cr, d)
        x = jax.lax.population_count(jnp.bitwise_xor(cl, shifted))
        return jnp.sum(x, axis=0).astype(dtype)

    return _stack_over_disparities(plane, num_disparities, min_disparity,
                                   left.shape[-1])


def _box_filter(x: jnp.ndarray, size: int) -> jnp.ndarray:
    """Mean filter over a size x size window on the trailing (H, W) axes.

    Separable running-sum via cumsum (O(HW) independent of window size);
    edge handling divides by the true in-frame window area.
    """
    if size <= 1:
        return x

    def along(a, axis):
        r = size // 2
        pad = [(0, 0)] * a.ndim
        pad[axis] = (r + 1, r)
        c = jnp.cumsum(jnp.pad(a, pad), axis=axis, dtype=jnp.float32)
        hi = jax.lax.slice_in_dim(c, size, c.shape[axis], axis=axis)
        lo = jax.lax.slice_in_dim(c, 0, c.shape[axis] - size, axis=axis)
        return hi - lo

    ones = jnp.ones(x.shape[-2:], jnp.float32)
    summed = along(along(x.astype(jnp.float32), -2), -1)
    counts = along(along(ones, -2), -1)
    return summed / counts


def sad_cost_volume(left: jnp.ndarray, right: jnp.ndarray,
                    num_disparities: int, min_disparity: int = 0,
                    block_size: int = 5, squared: bool = False) -> jnp.ndarray:
    """(D, H, W) block SAD (or SSD) cost — the StereoBM capability."""
    l = jnp.asarray(left, jnp.float32)
    r = jnp.asarray(right, jnp.float32)

    def plane(d):
        diff = l - _shift_plane(r, d)
        e = diff * diff if squared else jnp.abs(diff)
        return _box_filter(e, block_size)

    return _stack_over_disparities(plane, num_disparities, min_disparity,
                                   l.shape[-1])


def sobel_x_clipped(image: jnp.ndarray, pre_filter_cap: int = 63) -> jnp.ndarray:
    """Horizontal Sobel response clipped to [-cap, cap], shifted to [0, 2cap].

    The SGBM prefilter: matching then happens on this gradient image, which
    is what ``pre_filter_cap`` (settings.ini:19) controls.
    """
    img = jnp.asarray(image, jnp.float32)
    p = jnp.pad(img, 1, mode="edge")
    gx = (p[:-2, 2:] + 2 * p[1:-1, 2:] + p[2:, 2:]
          - p[:-2, :-2] - 2 * p[1:-1, :-2] - p[2:, :-2]) / 4.0
    cap = jnp.float32(pre_filter_cap)
    return jnp.clip(gx, -cap, cap) + cap


def _half_sample_envelope(sig: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Min/max of a signal and its half-sample interpolants along x."""
    prev = jnp.concatenate([sig[:, :1], sig[:, :-1]], axis=1)
    nxt = jnp.concatenate([sig[:, 1:], sig[:, -1:]], axis=1)
    lo = jnp.minimum(jnp.minimum((sig + prev) / 2, (sig + nxt) / 2), sig)
    hi = jnp.maximum(jnp.maximum((sig + prev) / 2, (sig + nxt) / 2), sig)
    return lo, hi


def bt_cost_volume(left: jnp.ndarray, right: jnp.ndarray,
                   num_disparities: int, min_disparity: int = 0,
                   pre_filter_cap: int = 63, block_size: int = 5) -> jnp.ndarray:
    """(D, H, W) Birchfield–Tomasi cost on x-Sobel prefiltered images.

    Sampling-insensitive |difference|: each left pixel is compared against
    the interval spanned by the right pixel's half-sample neighbors (and
    symmetrically), removing aliasing on slanted surfaces; then block_size
    box aggregation. Closest analog of OpenCV SGBM's pixel cost.
    """
    ls = sobel_x_clipped(left, pre_filter_cap)
    rs = sobel_x_clipped(right, pre_filter_cap)
    l_lo, l_hi = _half_sample_envelope(ls)
    r_lo, r_hi = _half_sample_envelope(rs)

    def plane(d):
        rsd = _shift_plane(rs, d)
        rlod = _shift_plane(r_lo, d)
        rhid = _shift_plane(r_hi, d)
        d_lr = jnp.maximum(0.0, jnp.maximum(ls - rhid, rlod - ls))
        d_rl = jnp.maximum(0.0, jnp.maximum(rsd - l_hi, l_lo - rsd))
        return _box_filter(jnp.minimum(d_lr, d_rl), block_size)

    return _stack_over_disparities(plane, num_disparities, min_disparity,
                                   ls.shape[-1])


@functools.partial(jax.jit, static_argnames=("num_disparities", "min_disparity",
                                             "cost", "block_size", "window",
                                             "pre_filter_cap", "dtype"))
def build_cost_volume(left: jnp.ndarray, right: jnp.ndarray,
                      num_disparities: int, min_disparity: int = 0,
                      cost: str = "census", block_size: int = 5,
                      window: tuple[int, int] = (5, 5),
                      pre_filter_cap: int = 63,
                      dtype: str = "float32") -> jnp.ndarray:
    """Dispatch to the named cost family (census | sad | ssd | bt).

    Returns the (D, H, W) planes-layout volume. ``dtype`` ("float32" or
    "int16") selects the volume precision; int16 is exact for census.
    """
    if cost == "census":
        return census_cost_volume(left, right, num_disparities, min_disparity,
                                  window, dtype=jnp.dtype(dtype))
    if cost == "sad":
        return sad_cost_volume(left, right, num_disparities, min_disparity, block_size)
    if cost == "ssd":
        return sad_cost_volume(left, right, num_disparities, min_disparity,
                               block_size, squared=True)
    if cost == "bt":
        return bt_cost_volume(left, right, num_disparities, min_disparity,
                              pre_filter_cap, block_size)
    raise ValueError(f"unknown cost family: {cost}")
