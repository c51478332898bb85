"""True StereoBM semantics: prefilter + SAD WTA, no path aggregation.

The reference's fallback matcher is ``cv2.StereoBM_create(numDisparities,
blockSize)`` (``stereo_vision/stereo_vision.py:165-166``), which inherits
OpenCV's BM defaults: x-Sobel prefilter clamped at ``preFilterCap=31``,
plain block-SAD winner-take-all (no smoothness term), ``textureThreshold=
10`` low-texture rejection, ``uniquenessRatio=15`` and parabola subpixel.
Earlier rounds stood in SAD cost + near-zero-penalty SGM for this mode;
this module reproduces the actual BM algorithm and is oracle-tested
against ``cv2.StereoBM_create`` (tests/test_matching.py).

Shape: everything is (H, W)-plane arithmetic in planes layout — the
prefilter is a 3x3 stencil, SAD is a separable cumsum box sum, WTA /
uniqueness / subpixel reuse the shared ``ops.wta`` reductions. It is a
plain XLA path: one BM frame is ~10x cheaper than SGM and not a
bottleneck.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from stereo_match.config import DisparityConfig
from stereo_match.ops.cost_volume import (INVALID_COST, _invalid_mask,
                                          _shift_plane)
from stereo_match.ops.wta import (lr_consistency_mask, subpixel_refine,
                                  uniqueness_mask, wta_disparity)


def bm_prefilter_xsobel(image: jnp.ndarray, cap: int = 31) -> jnp.ndarray:
    """OpenCV ``prefilterXSobel``: clamp(sobel_x + cap, 0, 2*cap).

    Unlike :func:`ops.cost_volume.sobel_x_clipped` (the BT/SGBM variant)
    the raw 3x3 Sobel response is NOT divided by 4 — OpenCV's BM clamps
    the undivided sum, which saturates far more often and is part of the
    algorithm's character. Rows replicate at top/bottom; the first and
    last column take the neutral value ``cap`` (zero response), matching
    OpenCV's border writes.
    """
    img = jnp.asarray(image, jnp.float32)
    p = jnp.pad(img, ((1, 1), (0, 0)), mode="edge")
    gx = (p[:-2, 2:] + 2.0 * p[1:-1, 2:] + p[2:, 2:]
          - p[:-2, :-2] - 2.0 * p[1:-1, :-2] - p[2:, :-2])
    capf = jnp.float32(cap)
    core = jnp.clip(gx + capf, 0.0, 2.0 * capf)
    edge = jnp.full((img.shape[0], 1), capf)
    return jnp.concatenate([edge, core, edge], axis=1)


def _box_sum(x: jnp.ndarray, size: int) -> jnp.ndarray:
    """Windowed SUM (zero-padded) over the trailing (H, W) axes.

    OpenCV BM aggregates raw sums, not means — the texture threshold and
    uniqueness ratio are calibrated against sums. Border pixels (within
    size//2 of the frame) are invalidated downstream, so the zero padding
    never reaches a comparison.
    """
    if size <= 1:
        return x

    def along(a, axis):
        r = size // 2
        pad = [(0, 0)] * a.ndim
        pad[axis] = (r + 1, size - 1 - r)
        c = jnp.cumsum(jnp.pad(a, pad), axis=axis, dtype=jnp.float32)
        hi = jax.lax.slice_in_dim(c, size, c.shape[axis], axis=axis)
        lo = jax.lax.slice_in_dim(c, 0, c.shape[axis] - size, axis=axis)
        return hi - lo

    return along(along(x.astype(jnp.float32), -2), -1)


@functools.partial(jax.jit, static_argnames=(
    "num_disparities", "min_disparity", "block_size", "pre_filter_cap",
    "texture_threshold", "uniqueness_ratio", "disp12_max_diff"))
def block_match(left: jnp.ndarray, right: jnp.ndarray,
                num_disparities: int, min_disparity: int = 0,
                block_size: int = 21, pre_filter_cap: int = 31,
                texture_threshold: int = 10, uniqueness_ratio: int = 15,
                disp12_max_diff: int = -1) -> jnp.ndarray:
    """StereoBM on one grayscale pair -> float32 (H, W) disparity.

    Invalid pixels (border, low texture, uniqueness/LR failure, no
    in-frame right sample) are NaN; convert with ``to_fixed_point`` for
    the int16*16 OpenCV surface ((minDisparity-1)*16 there).
    """
    lp = bm_prefilter_xsobel(left, pre_filter_cap)
    rp = bm_prefilter_xsobel(right, pre_filter_cap)
    H, W = lp.shape

    def plane(d):
        return _box_sum(jnp.abs(lp - _shift_plane(rp, d)), block_size)

    vol = jnp.stack([plane(min_disparity + i)
                     for i in range(num_disparities)], axis=0)
    # invalidate d-planes with no in-frame right sample: x - d < r would
    # let the replicated edge leak into the window, so require the whole
    # window in frame (OpenCV starts at x = minD + numD + r - 1)
    mask = _invalid_mask(W, num_disparities, min_disparity)
    vol = jnp.where(mask, INVALID_COST * block_size * block_size, vol)

    idx = wta_disparity(vol)
    disp = subpixel_refine(vol, idx) + min_disparity

    ok = uniqueness_mask(vol, idx, uniqueness_ratio)
    # texture: sum|prefiltered - cap| over the SAD window on the left view
    tex = _box_sum(jnp.abs(lp - jnp.float32(pre_filter_cap)), block_size)
    ok &= tex >= texture_threshold
    if disp12_max_diff >= 0:
        from stereo_match.ops.wta import right_disparity_from_volume
        disp_r = right_disparity_from_volume(vol, min_disparity)
        ok &= lr_consistency_mask(disp, disp_r, disp12_max_diff,
                                  min_disparity)
    # border: OpenCV leaves blockSize//2 rows/cols plus the left search
    # band invalid
    r = block_size // 2
    ys = jnp.arange(H)[:, None]
    xs = jnp.arange(W)[None, :]
    inb = (ys >= r) & (ys < H - r) & (xs < W - r) & \
        (xs >= min_disparity + num_disparities + r - 1)
    ok &= inb
    return jnp.where(ok, disp, jnp.nan)


class BlockMatcher:
    """Drop-in matcher with the ``StereoMatcher`` calling convention.

    Returns ``(raw, filtered)``. The reference WLS-filters the BM branch
    too (``stereo_vision/stereo_vision.py:165-183`` builds the
    DisparityWLSFilter from whichever matcher ran and filters ``displ``
    for both SGBM and BM), so ``filtered`` is speckle- then WLS-filtered
    when ``cfg.wls`` is set; with WLS off it is the speckle-filtered
    disparity when ``speckle_window_size > 0``, else the raw map.
    """

    def __init__(self, config: DisparityConfig | None = None):
        self.config = config or DisparityConfig()

    def __call__(self, left_gray, right_gray):
        cfg = self.config
        l = jnp.asarray(np.asarray(left_gray), jnp.float32)
        r = jnp.asarray(np.asarray(right_gray), jnp.float32)
        disp = block_match(
            l, r, num_disparities=cfg.num_disparities,
            min_disparity=cfg.min_disparity, block_size=cfg.block_size,
            pre_filter_cap=cfg.bm_pre_filter_cap,
            texture_threshold=cfg.texture_threshold,
            uniqueness_ratio=cfg.uniqueness_ratio,
            disp12_max_diff=cfg.disp12_max_diff)
        filtered = disp
        if cfg.speckle_window_size > 0:
            from stereo_match.ops.speckle import speckle_filter
            filtered = speckle_filter(disp, cfg.speckle_window_size,
                                      cfg.speckle_range)
        if cfg.wls:
            from stereo_match.ops.wls import wls_filter_disparity
            filtered = wls_filter_disparity(
                filtered, l, lmbda=cfg.lmbda, sigma_color=cfg.sigma,
                num_iter=cfg.wls_iters)
        return disp, filtered
