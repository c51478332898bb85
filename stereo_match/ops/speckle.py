"""Speckle filtering: remove small connected blobs of outlier disparity.

The capability behind OpenCV SGBM's ``speckleWindowSize`` /
``speckleRange`` parameters (``stereo_vision/stereo_vision.py:159-160``,
settings.ini:13-16). Connected components are irregular host-style compute;
the device formulation is min-label flood fill by *segmented min
scans*: one sweep propagates each pixel's label across its entire
connected run along a row (then column) via ``lax.associative_scan`` with
a segment-break flag — log-depth, fully vectorized, and gather-free — so
a whole-image component converges in as many sweeps as its geometry has
"turns" (2-3 for natural disparity maps) instead of geodesic-diameter
many neighbor relaxations. Component sizes then come from one
segment-sum.

Two rejected designs, measured at KITTI size (375x1242): per-neighbor
relaxation needs diameter-many iterations (a 512-iteration loop still
hadn't converged — and pre-fixpoint it splits large components and
over-removes: 1.67% removed vs the correct 0.61%); pointer jumping
(``label <- label[label]``) converges in 11 rounds but needs an (H*W,)
gather per round.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def _neighbor_shift(x: jnp.ndarray, dy: int, dx: int, fill) -> jnp.ndarray:
    """Shift (H, W) by (dy, dx) filling exposed cells."""
    H, W = x.shape
    out = jnp.roll(x, (dy, dx), axis=(0, 1))
    if dy == 1:
        out = out.at[0, :].set(fill)
    elif dy == -1:
        out = out.at[-1, :].set(fill)
    if dx == 1:
        out = out.at[:, 0].set(fill)
    elif dx == -1:
        out = out.at[:, -1].set(fill)
    return out


@functools.partial(jax.jit, static_argnames=("max_speckle_size", "max_iters"))
def speckle_filter(disparity: jnp.ndarray, max_speckle_size: int,
                   max_diff: float, max_iters: int = 64) -> jnp.ndarray:
    """Invalidate (NaN) connected components smaller than max_speckle_size.

    Two pixels are connected when 4-adjacent and |d_a - d_b| <= max_diff —
    the OpenCV ``filterSpeckles`` notion of a speckle. ``max_speckle_size``
    <= 0 disables (the settings.ini default is 0). ``max_iters`` caps the
    sweep loop: each sweep propagates the min label through one more
    geometric "turn" of a component (a spiral with T turns needs ~T
    sweeps), so natural disparity maps converge in 2-4 sweeps and the cap
    is safety only. If the fixpoint is NOT reached at the cap (adversarial
    geometry), the filter conservatively keeps *all* pixels rather than
    split-and-over-remove with half-merged labels.
    """
    if max_speckle_size <= 0:
        return disparity
    d = jnp.asarray(disparity, jnp.float32)
    H, W = d.shape
    valid = jnp.isfinite(d)
    big = jnp.int32(H * W + 1)
    init = jnp.where(
        valid,
        (jnp.arange(H)[:, None] * W + jnp.arange(W)[None, :]).astype(jnp.int32),
        big)

    dval = jnp.where(valid, d, jnp.float32(jnp.inf))
    # connection-to-predecessor masks (loop-invariant): along x for the
    # forward row scan, along y for the forward column scan; the reverse
    # scans use the same connectivity seen from the other side
    conn_x = valid & (jnp.abs(_neighbor_shift(dval, 0, 1, jnp.float32(jnp.inf))
                              - dval) <= max_diff)
    conn_y = valid & (jnp.abs(_neighbor_shift(dval, 1, 0, jnp.float32(jnp.inf))
                              - dval) <= max_diff)

    def seg_min_scan(labels, conn, axis, reverse):
        # segmented min: a break flag restarts the running minimum at
        # every pixel not connected to its scan-order predecessor
        brk = ~(_neighbor_shift(conn, -1, 0, False) if (reverse and axis == 0)
                else _neighbor_shift(conn, 0, -1, False)
                if (reverse and axis == 1) else conn)

        def comb(a, b):
            mv = jnp.where(b[1], b[0], jnp.minimum(a[0], b[0]))
            return mv, a[1] | b[1]

        out, _ = jax.lax.associative_scan(comb, (labels, brk), axis=axis,
                                          reverse=reverse)
        return out

    def sweep(labels):
        labels = seg_min_scan(labels, conn_x, 1, False)
        labels = seg_min_scan(labels, conn_x, 1, True)
        labels = seg_min_scan(labels, conn_y, 0, False)
        labels = seg_min_scan(labels, conn_y, 0, True)
        return labels

    def cond(state):
        labels, changed, it = state
        return changed & (it < max_iters)

    def body(state):
        labels, _, it = state
        new = sweep(labels)
        return new, jnp.any(new != labels), it + 1

    labels, unconverged, _ = jax.lax.while_loop(
        cond, body, (init, jnp.bool_(True), 0))

    flat = labels.reshape(-1)
    sizes = jax.ops.segment_sum(valid.reshape(-1).astype(jnp.int32), flat,
                                num_segments=H * W + 2)
    comp_size = sizes[flat].reshape(H, W)
    keep = (comp_size >= max_speckle_size) | unconverged
    return jnp.where(keep & valid, d, jnp.nan)
