"""Disparity -> depth -> 3-D point reprojection (jittable JAX).

Replaces ``cv2.reprojectImageTo3D`` (``disparity_calculation.py:302``,
``stereo_vision/stereo_vision.py:187-210``) and the pinhole back-projection
``map2Dto3D`` (``mapTo3D.py:35-56``) with vectorized einsum/broadcast ops.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def make_q_matrix(f: float, cx: float, cy: float, tx: float,
                  cx_prime: float | None = None) -> np.ndarray:
    """Build the 4x4 disparity-to-depth matrix.

    Q maps (u, v, d, 1) -> homogeneous (X, Y, Z, W). ``tx`` is the (signed)
    baseline; the reference hard-codes f=1164, c=(360,640), Tx=-22 variants
    (``disparity_calculation.py:293-299``, ``disparity_test.py:225-229``).
    """
    cx2 = cx if cx_prime is None else cx_prime
    Q = np.zeros((4, 4))
    Q[0, 0] = Q[1, 1] = 1.0
    Q[0, 3] = -cx
    Q[1, 3] = -cy
    Q[2, 3] = f
    Q[3, 2] = -1.0 / tx
    Q[3, 3] = (cx - cx2) / tx
    return Q


def reproject_image_to_3d(disparity: jnp.ndarray, Q: jnp.ndarray,
                          handle_missing: bool = True) -> jnp.ndarray:
    """Disparity map (H, W) -> points (H, W, 3) via the Q matrix.

    Matches ``cv2.reprojectImageTo3D`` semantics: each pixel (u, v) with
    disparity d maps through Q as a homogeneous point. With
    ``handle_missing``, non-positive/non-finite disparities map to a large
    sentinel depth (cv2 uses 10000) so callers can mask them.
    """
    disparity = jnp.asarray(disparity, jnp.float32)
    H, W = disparity.shape
    Q = jnp.asarray(Q, jnp.float32)
    u = jnp.arange(W, dtype=jnp.float32)[None, :]
    v = jnp.arange(H, dtype=jnp.float32)[:, None]
    # Broadcast arithmetic instead of einsum: keeps everything f32 (a
    # matmul may run in bf16 or TF32 on some backends).
    d = disparity

    def row(i):
        return Q[i, 0] * u + Q[i, 1] * v + Q[i, 2] * d + Q[i, 3]

    X, Y, Z, w0 = row(0), row(1), row(2), row(3)
    safe_w = jnp.where(jnp.abs(w0) < 1e-12, 1e-12, w0)
    pts = jnp.stack([X, Y, Z], axis=-1) / safe_w[..., None]
    w = w0[..., None]
    if handle_missing:
        bad = (~jnp.isfinite(disparity)) | (jnp.abs(w[..., 0]) < 1e-12)
        big = jnp.full_like(pts, 10000.0)
        pts = jnp.where(bad[..., None], big, pts)
    return pts


def disparity_to_depth(disparity: jnp.ndarray, f: float, baseline: float,
                       eps: float = 1e-6) -> jnp.ndarray:
    """Z = f * B / d with non-positive disparities -> 0 depth."""
    d = jnp.asarray(disparity, jnp.float32)
    z = f * baseline / jnp.maximum(d, eps)
    return jnp.where(d > eps, z, 0.0)


def pinhole_backproject(depth: jnp.ndarray, fx: float, fy: float,
                        cx: float, cy: float,
                        negate_x: bool = False) -> jnp.ndarray:
    """Depth map (H, W) -> points (H, W, 3) via the pinhole model.

    Capability parity with the custom ``map2Dto3D`` (``mapTo3D.py:35-56``):
    X = (u - cx) * Z / fx, Y = (v - cy) * Z / fy. ``negate_x`` reproduces the
    reference's sign flip (``mapTo3D.py:47-50``).
    """
    depth = jnp.asarray(depth, jnp.float32)
    H, W = depth.shape
    u = jnp.arange(W, dtype=jnp.float32)[None, :]
    v = jnp.arange(H, dtype=jnp.float32)[:, None]
    X = (u - cx) * depth / fx
    Y = (v - cy) * depth / fy
    if negate_x:
        X = -X
    return jnp.stack([X, Y, depth], axis=-1)


def depth_to_points(depth: jnp.ndarray, K: jnp.ndarray,
                    pose: jnp.ndarray | None = None) -> jnp.ndarray:
    """Depth map -> (optionally world-frame) point cloud.

    Capability parity with the external ``hf.depthTo3D`` used at
    ``mapTo3D.py:154``; ``pose`` is a 4x4 camera-to-world transform applied
    to the camera-frame points (``mapTo3D.py:129-130``).
    """
    K = jnp.asarray(K, jnp.float32)
    pts = pinhole_backproject(depth, K[0, 0], K[1, 1], K[0, 2], K[1, 2])
    if pose is not None:
        pts = transform_points(pts, pose)
    return pts


def transform_points(points: jnp.ndarray, transform: jnp.ndarray) -> jnp.ndarray:
    """Apply a rigid 4x4 transform to an (..., 3) point array."""
    T = jnp.asarray(transform, jnp.float32)
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    out = [T[i, 0] * x + T[i, 1] * y + T[i, 2] * z + T[i, 3] for i in range(3)]
    return jnp.stack(out, axis=-1)
