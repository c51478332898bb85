"""Edge-aware weighted-least-squares disparity refinement (jittable JAX).

Replaces OpenCV's ``DisparityWLSFilter`` (reference:
``stereo_vision/stereo_vision.py:172-183``, generic variant
``disparity_test.py:182-186``) with the fast-global-smoother formulation:
the 2-D WLS energy

    E(u) = sum_p (u_p - f_p)^2 + lambda * sum_{q in N(p)} w_pq (u_p - u_q)^2

is minimized by alternating exact 1-D tridiagonal solves (Thomas algorithm)
along rows and columns with guide-image weights
w = exp(-|I_p - I_q| / sigma_color), geometrically increasing per-pass
lambda_t = 1.5 * lambda * 4^(T-t) / (4^T - 1). This is all sequential-scan
math (``lax.scan`` along the solve axis, vectorized across the other axis) —
no sparse linear algebra. On the GPU the 1-D solves run as one Triton kernel
(``ops/fgs_triton.py``) instead of one launch per scan step.

Confidence weighting: invalid (NaN) disparities get weight 0 and are
in-filled by the smoother, u = FGS(c * d) / FGS(c) — the same mechanism
OpenCV's filter uses with its LR-consistency confidence map.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from stereo_match.utils.backend import gpu_kernels


def _edge_weights(guide: jnp.ndarray, axis: int, sigma_color: float) -> jnp.ndarray:
    """w[i] = exp(-|I[i+1] - I[i]| / sigma) along ``axis`` (length N-1)."""
    g = jnp.asarray(guide, jnp.float32)
    diff = jnp.abs(jnp.diff(g, axis=axis))
    return jnp.exp(-diff / jnp.float32(sigma_color))


def _tridiagonal_smooth_rows(f: jnp.ndarray, w: jnp.ndarray,
                             lam: jnp.ndarray) -> jnp.ndarray:
    """Solve (I + lam*A) u = f row-wise; A is the weighted 1-D Laplacian.

    ``f``: (H, W), or (C, H, W) for C right-hand sides that share the
    system; ``w``: (H, W-1) edge weights between columns x and x+1.
    Tridiagonal system per row: a_x u_{x-1} + b_x u_x + c_x u_{x+1} = f_x
    with a_x = -lam*w_{x-1}, c_x = -lam*w_x, b_x = 1 - a_x - c_x.
    Thomas algorithm as a forward scan (carry: modified c', d') plus a
    backward scan, vectorized over rows and right-hand sides.
    """
    squeeze = f.ndim == 2
    f = f[None] if squeeze else f
    C, H, W = f.shape
    zero = jnp.zeros((H, 1), jnp.float32)
    a = jnp.concatenate([zero, -lam * w], axis=1)          # (H, W)
    c = jnp.concatenate([-lam * w, zero], axis=1)
    b = 1.0 - a - c

    # forward sweep over columns; each step handles an (H,) slice
    def fwd(carry, inp):
        cp_prev, dp_prev = carry
        a_x, b_x, c_x, f_x = inp
        denom = b_x - a_x * cp_prev
        cp = c_x / denom
        dp = (f_x - a_x * dp_prev) / denom
        return (cp, dp), (cp, dp)

    inputs = (a.T, b.T, c.T, jnp.transpose(f, (2, 0, 1)))  # (W, [C,] H)
    init = (jnp.zeros(H), jnp.zeros((C, H)))
    (_, _), (cps, dps) = jax.lax.scan(fwd, init, inputs)

    # backward substitution
    def bwd(u_next, inp):
        cp, dp = inp
        u = dp - cp * u_next
        return u, u

    _, us = jax.lax.scan(bwd, jnp.zeros((C, H)), (cps, dps), reverse=True)
    us = jnp.transpose(us, (1, 2, 0))  # (C, H, W)
    return us[0] if squeeze else us


def _solve_rows(f: jnp.ndarray, w: jnp.ndarray, lam) -> jnp.ndarray:
    """Row solve of (C, H, W) slabs: the Triton kernel on the GPU (which
    solves along axis 1 of its slab, hence the transposes), the plain
    Thomas scan elsewhere."""
    if gpu_kernels("fgs"):
        from stereo_match.ops.fgs_triton import fgs_solve_triton
        return jnp.swapaxes(
            fgs_solve_triton(jnp.swapaxes(f, 1, 2), w.T, lam), 1, 2)
    return _tridiagonal_smooth_rows(f, w, lam)


def _solve_cols(f: jnp.ndarray, w: jnp.ndarray, lam) -> jnp.ndarray:
    """Column solve of (C, H, W) slabs; ``w`` (H-1, W)."""
    if gpu_kernels("fgs"):
        from stereo_match.ops.fgs_triton import fgs_solve_triton
        return fgs_solve_triton(f, w, lam)
    return jnp.swapaxes(
        _tridiagonal_smooth_rows(jnp.swapaxes(f, 1, 2), w.T, lam), 1, 2)


def fast_global_smoother(src: jnp.ndarray, guide: jnp.ndarray,
                         lmbda: float, sigma_color: float,
                         num_iter: int = 3) -> jnp.ndarray:
    """Edge-aware smoothing of ``src`` guided by ``guide``.

    ``src``: (H, W), or (C, H, W) maps that share the guide and are solved
    together; ``guide``: (H, W).
    """
    u = jnp.asarray(src, jnp.float32)
    squeeze = u.ndim == 2
    u = u[None] if squeeze else u
    wx = _edge_weights(guide, axis=1, sigma_color=sigma_color)   # (H, W-1)
    wy = _edge_weights(guide, axis=0, sigma_color=sigma_color)   # (H-1, W)
    lam_base = jnp.float32(1.5) * lmbda / (4.0 ** num_iter - 1.0)
    for t in range(num_iter):
        lam_t = lam_base * (4.0 ** (num_iter - t - 1))
        u = _solve_rows(u, wx, lam_t)
        u = _solve_cols(u, wy, lam_t)
    return u[0] if squeeze else u


@functools.partial(jax.jit, static_argnames=("num_iter",))
def wls_filter_disparity(disparity: jnp.ndarray, guide: jnp.ndarray,
                         lmbda: float = 8000.0, sigma_color: float = 1.2,
                         num_iter: int = 3,
                         confidence: jnp.ndarray | None = None) -> jnp.ndarray:
    """Confidence-weighted WLS refinement of a disparity map.

    ``disparity``: (H, W) float with NaN invalids (this framework's
    convention). ``guide``: the left image (H, W) grayscale. ``confidence``:
    optional [0, 1] weights; defaults to validity. Output is dense (invalid
    regions in-filled), matching the reference behavior where the WLS output
    is used densely downstream (``disparity_calculation.py:289-302``).

    Parameter mapping to the reference (settings.ini:21-23, lambda=80000
    sigma=1.2): 1:1. The FGS operator is *linear in the data*, so OpenCV's
    x16 fixed-point disparity scale cancels out of lambda, and the guide
    weights exp(-|dI|/sigma) are computed on the same 0-255 gray scale.
    Validated against an independent dense solve of the same energy at
    exactly these parameters (tests/test_wls_reference.py; this cv2 build
    has no ximgproc to use as a direct oracle).
    """
    d = jnp.asarray(disparity, jnp.float32)
    valid = jnp.isfinite(d)
    conf = valid.astype(jnp.float32)
    if confidence is not None:
        conf = conf * jnp.asarray(confidence, jnp.float32)
    d0 = jnp.where(valid, d, 0.0)
    # both right-hand sides share one solve (the eliminated superdiagonal
    # depends on the guide only)
    nd = fast_global_smoother(jnp.stack([conf * d0, conf]), guide, lmbda,
                              sigma_color, num_iter)
    return nd[0] / jnp.maximum(nd[1], 1e-6)


def lr_confidence(disp_left: jnp.ndarray, disp_right: jnp.ndarray,
                  max_diff: float = 1.0) -> jnp.ndarray:
    """Soft LR-consistency confidence in [0, 1].

    The round-3 stand-in (a smooth agreement ramp). Kept for API
    stability; the production wiring uses :func:`wls_confidence_cv2`,
    which reproduces OpenCV's DisparityWLSFilter confidence semantics.
    """
    H, W = disp_left.shape
    x = jnp.arange(W)[None, :].astype(jnp.float32)
    xr = jnp.clip(jnp.round(x - disp_left), 0, W - 1).astype(jnp.int32)
    d_r = jnp.take_along_axis(disp_right, xr, axis=1)
    err = jnp.abs(disp_left - d_r)
    conf = jnp.clip(1.0 - (err - max_diff) / jnp.maximum(max_diff, 1e-6), 0.0, 1.0)
    return jnp.where(jnp.isfinite(conf), conf, 0.0)


def _window_extrema(d: jnp.ndarray, radius: int):
    """Separable (2r+1)^2 min/max pooling via iterated 1-px shifts."""
    lo = hi = d
    for axis in (0, 1):
        cur_lo, cur_hi = lo, hi
        for _ in range(radius):
            up_lo = jnp.roll(cur_lo, 1, axis=axis)
            dn_lo = jnp.roll(cur_lo, -1, axis=axis)
            up_hi = jnp.roll(cur_hi, 1, axis=axis)
            dn_hi = jnp.roll(cur_hi, -1, axis=axis)
            # edge replicate: overwrite the wrapped row/col with itself
            idx = jnp.arange(d.shape[axis])
            first = (idx == 0)
            last = (idx == d.shape[axis] - 1)
            sel = first[:, None] if axis == 0 else first[None, :]
            sel_l = last[:, None] if axis == 0 else last[None, :]
            up_lo = jnp.where(sel, cur_lo, up_lo)
            dn_lo = jnp.where(sel_l, cur_lo, dn_lo)
            up_hi = jnp.where(sel, cur_hi, up_hi)
            dn_hi = jnp.where(sel_l, cur_hi, dn_hi)
            cur_lo = jnp.minimum(cur_lo, jnp.minimum(up_lo, dn_lo))
            cur_hi = jnp.maximum(cur_hi, jnp.maximum(up_hi, dn_hi))
        lo, hi = cur_lo, cur_hi
    return lo, hi


@functools.partial(jax.jit, static_argnames=("discontinuity_radius",))
def wls_confidence_cv2(disp_left: jnp.ndarray, disp_right: jnp.ndarray,
                       lrc_thresh: float = 1.5,
                       discontinuity_radius: int = 7,
                       discontinuity_jump: float = 6.0,
                       roi_mask: jnp.ndarray | None = None) -> jnp.ndarray:
    """OpenCV ``DisparityWLSFilter`` confidence semantics (in [0, 1]).

    The reference wires the filter's own confidence path
    (``stereo_vision/stereo_vision.py:171-183``: a right matcher feeds
    ``createDisparityWLSFilter``). cv2 builds the map as the PRODUCT of
    two binary terms, ROI-masked:

    * **LRC**: confident iff the left disparity round-trips through the
      right view within ``LRCthresh`` (cv2 default 24 in 16ths = 1.5 px;
      the right matcher's disparities are negated there — this framework
      keeps both maps positive);
    * **depth discontinuity**: zero within ``DepthDiscontinuityRadius``
      of a disparity discontinuity (where the (2r+1)^2 window min/max
      spread exceeds ``discontinuity_jump`` — large enough that sloped
      surfaces stay confident) — exactly the half-occluded /
      foreground-fattened pixels whose data values would otherwise drag
      the solve.

    Invalid (NaN) pixels and, when given, pixels outside ``roi_mask``
    (cv2 computes the ROI from numDisparities/minDisparity) get 0.
    """
    H, W = disp_left.shape
    x = jnp.arange(W)[None, :].astype(jnp.float32)
    valid = jnp.isfinite(disp_left)
    dl = jnp.where(valid, disp_left, 0.0)
    xr = jnp.clip(jnp.round(x - dl), 0, W - 1).astype(jnp.int32)
    d_r = jnp.take_along_axis(jnp.where(jnp.isfinite(disp_right),
                                        disp_right, -1e6), xr, axis=1)
    lrc_ok = jnp.abs(dl - d_r) <= lrc_thresh
    # discontinuity term on a validity-neutral fill (NaN would poison
    # the pooled extrema)
    dfill = jnp.where(valid, dl, jnp.nan)
    med = jnp.nanmedian(dfill)
    lo, hi = _window_extrema(jnp.where(valid, dl, med),
                             discontinuity_radius)
    smooth = (hi - lo) <= discontinuity_jump
    conf = (valid & lrc_ok & smooth).astype(jnp.float32)
    if roi_mask is not None:
        conf = conf * jnp.asarray(roi_mask, jnp.float32)
    return conf
