"""WLS/FGS solver validation against an independent dense reference.

This cv2 build has no ximgproc, so OpenCV's DisparityWLSFilter cannot be
run as an oracle. Instead the Thomas-scan solver is validated against a
from-first-principles dense solve of the exact same energy (numpy
``linalg.solve`` of the (I + lam*A) tridiagonal system per line), with the
published FGS lambda schedule (Min et al., TIP 2014 — the algorithm behind
``cv2.ximgproc.createFastGlobalSmootherFilter``):

    lam_t = 1.5 * lam * 4^(T-t) / (4^T - 1)

The settings.ini lambda (80000) and sigma (1.2) therefore carry over 1:1:
the FGS operator is linear in the data, so the x16 fixed-point disparity
scale cancels, and the guide weights exp(-|dI|/sigma) are computed on the
same 0-255 gray scale OpenCV uses (reference call:
``stereo_vision/stereo_vision.py:172-183``).
"""

import numpy as np
import pytest

from stereo_match.ops.wls import (fast_global_smoother,
                                  wls_filter_disparity)


def _dense_line_solve(f, w, lam):
    """Solve (I + lam*A) u = f for one line; A = weighted 1-D Laplacian."""
    n = f.shape[0]
    A = np.zeros((n, n), np.float64)
    for i in range(n - 1):
        A[i, i] += w[i]
        A[i + 1, i + 1] += w[i]
        A[i, i + 1] -= w[i]
        A[i + 1, i] -= w[i]
    return np.linalg.solve(np.eye(n) + lam * A, f)


def _dense_fgs(src, guide, lmbda, sigma, T):
    u = src.astype(np.float64)
    g = guide.astype(np.float64)
    wx = np.exp(-np.abs(np.diff(g, axis=1)) / sigma)
    wy = np.exp(-np.abs(np.diff(g, axis=0)) / sigma)
    lam_base = 1.5 * lmbda / (4.0 ** T - 1.0)
    for t in range(T):
        lam_t = lam_base * 4.0 ** (T - t - 1)
        u = np.stack([_dense_line_solve(u[i], wx[i], lam_t)
                      for i in range(u.shape[0])])
        u = np.stack([_dense_line_solve(u[:, j], wy[:, j], lam_t)
                      for j in range(u.shape[1])], axis=1)
    return u


@pytest.mark.parametrize("lmbda,sigma", [(80000.0, 1.2), (8000.0, 8.0)])
def test_fgs_matches_dense_reference(rng, lmbda, sigma):
    """The Thomas-scan FGS equals the dense solve of the same energy —
    including at the reference production parameters (settings.ini:21-23)."""
    H, W = 24, 31
    src = rng.uniform(0, 64, (H, W)).astype(np.float32)
    guide = rng.uniform(0, 255, (H, W)).astype(np.float32)
    # piecewise guide -> strong edge structure in the weights
    guide[:, W // 2:] += 100.0
    ours = np.asarray(fast_global_smoother(src, guide, lmbda, sigma, 3))
    ref = _dense_fgs(src, guide, lmbda, sigma, 3)
    # f32 scans vs f64 dense solve; lambda=8e4 makes the system stiff, so
    # allow ~1e-3 relative (observed max 6e-4)
    np.testing.assert_allclose(ours, ref, rtol=2e-3, atol=5e-2)


def test_fgs_scale_invariance_x16():
    """FGS is linear in the data: filtering x16 fixed-point disparities
    (OpenCV's internal scale) equals 16x filtering the float disparities —
    the reason settings.ini lambda carries over without rescaling."""
    rng = np.random.default_rng(0)
    H, W = 20, 28
    d = rng.uniform(0, 40, (H, W)).astype(np.float32)
    guide = rng.uniform(0, 255, (H, W)).astype(np.float32)
    a = np.asarray(fast_global_smoother(d * 16.0, guide, 80000.0, 1.2, 3))
    b = np.asarray(fast_global_smoother(d, guide, 80000.0, 1.2, 3)) * 16.0
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-2)


def test_wls_infills_invalid_regions():
    """Confidence weighting in-fills NaN holes from valid surroundings."""
    rng = np.random.default_rng(1)
    H, W = 32, 40
    d = np.full((H, W), 12.0, np.float32)
    d[10:20, 12:24] = np.nan
    guide = rng.uniform(100, 110, (H, W)).astype(np.float32)  # flat guide
    out = np.asarray(wls_filter_disparity(d, guide, lmbda=80000.0,
                                          sigma_color=1.2, num_iter=3))
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, 12.0, atol=0.5)
