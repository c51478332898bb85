"""Zhang calibration vs synthetic ground truth and the cv2 oracle."""

import numpy as np
import pytest

from stereo_match.core.calibration import (
    CalibrationResult, calibrate_camera, chessboard_object_points,
    homography_dlt, undistort_image,
)
from stereo_match.core.camera import rodrigues


def _render_views(K, dist, n_views=6, cols=7, rows=5, seed=0):
    """Project a chessboard into n synthetic camera views."""
    rng = np.random.default_rng(seed)
    obj = chessboard_object_points(cols, rows, square=0.03)
    views, rvecs, tvecs = [], [], []
    k1, k2 = dist
    for _ in range(n_views):
        rvec = rng.normal(scale=0.25, size=3)
        t = np.array([rng.normal(scale=0.05), rng.normal(scale=0.05),
                      0.5 + rng.uniform(0, 0.3)])
        R = rodrigues(rvec)
        P = (R[:, :2] @ obj.T).T + t
        x, y = P[:, 0] / P[:, 2], P[:, 1] / P[:, 2]
        r2 = x * x + y * y
        rad = 1 + k1 * r2 + k2 * r2 ** 2
        u = K[0, 0] * x * rad + K[0, 2]
        v = K[1, 1] * y * rad + K[1, 2]
        views.append(np.stack([u, v], axis=-1))
        rvecs.append(rvec)
        tvecs.append(t)
    return obj, views, rvecs, tvecs


def test_homography_dlt_exact(rng):
    H_true = np.array([[1.2, 0.1, 5.0], [-0.05, 0.9, -3.0], [1e-4, -2e-4, 1.0]])
    src = rng.uniform(0, 100, (20, 2))
    homog = np.concatenate([src, np.ones((20, 1))], axis=1)
    proj = (H_true @ homog.T).T
    dst = proj[:, :2] / proj[:, 2:3]
    H = homography_dlt(src, dst)
    np.testing.assert_allclose(H, H_true / H_true[2, 2], atol=1e-8)


def test_calibrate_recovers_intrinsics():
    K_true = np.array([[800.0, 0, 320], [0, 790.0, 240], [0, 0, 1]])
    obj, views, _, _ = _render_views(K_true, (0.0, 0.0))
    res = calibrate_camera(obj, views)
    assert isinstance(res, CalibrationResult)
    np.testing.assert_allclose(res.K[0, 0], 800.0, rtol=1e-3)
    np.testing.assert_allclose(res.K[1, 1], 790.0, rtol=1e-3)
    np.testing.assert_allclose(res.K[0, 2], 320.0, atol=2.0)
    assert res.rms < 0.1


def test_calibrate_with_distortion():
    K_true = np.array([[600.0, 0, 310], [0, 600.0, 230], [0, 0, 1]])
    obj, views, _, _ = _render_views(K_true, (-0.15, 0.05), n_views=8, seed=3)
    res = calibrate_camera(obj, views)
    assert res.rms < 0.05
    np.testing.assert_allclose(res.dist[0], -0.15, atol=0.02)
    np.testing.assert_allclose(res.K[0, 0], 600.0, rtol=5e-3)


def test_calibrate_matches_opencv():
    import cv2
    K_true = np.array([[700.0, 0, 330], [0, 710.0, 250], [0, 0, 1]])
    obj, views, _, _ = _render_views(K_true, (-0.1, 0.02), n_views=8, seed=5)
    res = calibrate_camera(obj, views)
    obj3 = np.concatenate([obj, np.zeros((len(obj), 1))], axis=1).astype(np.float32)
    rms_cv, K_cv, dist_cv, _, _ = cv2.calibrateCamera(
        [obj3] * len(views), [v.astype(np.float32) for v in views],
        (640, 480), None, None)
    np.testing.assert_allclose(res.K[0, 0], K_cv[0, 0], rtol=1e-2)
    np.testing.assert_allclose(res.K[:2, 2], K_cv[:2, 2], atol=3.0)
    assert res.rms <= rms_cv + 0.05


def test_calibrate_needs_three_views():
    obj = chessboard_object_points(4, 3)
    with pytest.raises(ValueError):
        calibrate_camera(obj, [obj.copy(), obj.copy()])


def test_undistort_identity(rng):
    img = rng.uniform(0, 255, (48, 64)).astype(np.float32)
    K = np.array([[100.0, 0, 32], [0, 100.0, 24], [0, 0, 1]])
    out = undistort_image(img, K, np.zeros(2))
    np.testing.assert_allclose(out, img, atol=1e-2)
