"""Config, reprojection, and metrics."""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest

from stereo_match.config import DisparityConfig, load_settings
from stereo_match.core.reproject import (
    depth_to_points,
    disparity_to_depth,
    make_q_matrix,
    pinhole_backproject,
    reproject_image_to_3d,
    transform_points,
)
from stereo_match.eval.metrics import (
    bad_pixel_rate, compare_disparities, density, end_point_error,
)


def test_config_defaults_match_reference_settings():
    c = DisparityConfig()
    assert c.num_disparities == 160 and c.block_size == 5
    # census penalties scale with descriptor bits (24 for 5x5)
    assert c.P1 == pytest.approx(8.0) and c.P2 == pytest.approx(96.0)
    cbt = c.replace(cost="bt", channels=3)
    assert cbt.P1 == 8 * 3 * 25  # reference P1=8*3*w^2 (stereo_vision.py:148)
    assert cbt.P2 == 32 * 3 * 25
    assert c.replace(p1=7.0).P1 == 7.0


def test_config_rounds_disparities_to_16():
    assert DisparityConfig(num_disparities=100).num_disparities == 112
    with pytest.raises(ValueError):
        DisparityConfig(num_disparities=0)


def test_load_settings_ini(tmp_path):
    ini = tmp_path / "settings.ini"
    ini.write_text("[disparity]\nnum_disparities = 128\nlmbda = 1e7\n"
                   "sigma = 1.5\nunknown_key = 3\n")
    c = load_settings(str(ini), overrides={"block_size": 7})
    assert c.num_disparities == 128
    assert c.lmbda == 1e7 and c.sigma == 1.5
    assert c.block_size == 7
    assert c.window_size == 5  # default preserved


def test_load_settings_missing_file():
    with pytest.raises(FileNotFoundError):
        load_settings("/nonexistent/settings.ini")


def test_reproject_matches_opencv(rng):
    disp = rng.uniform(5, 50, size=(48, 64)).astype(np.float32)
    Q = make_q_matrix(f=1164.0, cx=360, cy=640, tx=-22.0)
    mine = np.asarray(reproject_image_to_3d(disp, Q, handle_missing=False))
    ref = cv2.reprojectImageTo3D(disp, Q.astype(np.float32))
    np.testing.assert_allclose(mine, ref, rtol=1e-4, atol=1e-3)


def test_reproject_handles_missing():
    disp = np.array([[10.0, np.nan], [np.inf, 0.0]], np.float32)
    Q = make_q_matrix(1164.0, 360, 640, -22.0)
    pts = np.asarray(reproject_image_to_3d(disp, Q))
    assert np.isfinite(pts).all()
    assert (np.abs(pts[0, 1]) >= 10000).any()  # sentinel for NaN input


def test_q_matrix_reference_constants():
    # The reference's hard-coded Q (disparity_calculation.py:293-299).
    Q = make_q_matrix(1164.0, 360.0, 640.0, -22.0)
    assert Q[2, 3] == 1164.0
    assert Q[3, 2] == pytest.approx(1 / 22.0)
    assert Q[0, 3] == -360.0 and Q[1, 3] == -640.0


def test_pinhole_backproject_inverts_projection(rng):
    fx = fy = 300.0
    cx, cy = 32.0, 24.0
    depth = rng.uniform(1, 10, size=(48, 64)).astype(np.float32)
    pts = np.asarray(pinhole_backproject(depth, fx, fy, cx, cy))
    # Reproject: u = fx*X/Z + cx must recover the pixel grid.
    u = fx * pts[..., 0] / pts[..., 2] + cx
    v = fy * pts[..., 1] / pts[..., 2] + cy
    uu, vv = np.meshgrid(np.arange(64), np.arange(48))
    np.testing.assert_allclose(u, uu, atol=1e-3)
    np.testing.assert_allclose(v, vv, atol=1e-3)


def test_disparity_depth_consistency():
    d = jnp.array([[10.0, 0.0], [20.0, -1.0]])
    z = disparity_to_depth(d, f=100.0, baseline=0.5)
    assert float(z[0, 0]) == pytest.approx(5.0)
    assert float(z[0, 1]) == 0.0 and float(z[1, 1]) == 0.0


def test_transform_points_rigid(rng):
    T = np.eye(4)
    T[:3, 3] = [1, 2, 3]
    pts = rng.normal(size=(5, 3)).astype(np.float32)
    out = np.asarray(transform_points(pts, T))
    np.testing.assert_allclose(out, pts + [1, 2, 3], atol=1e-6)


def test_depth_to_points_pose(rng):
    K = np.array([[100.0, 0, 8], [0, 100.0, 6], [0, 0, 1]])
    depth = np.ones((12, 16), np.float32)
    pose = np.eye(4)
    pose[:3, 3] = [0, 0, 10]
    pts = np.asarray(depth_to_points(depth, K, pose))
    assert pts[6, 8, 2] == pytest.approx(11.0)


def test_metrics_basic():
    gt = np.full((10, 10), 10.0, np.float32)
    pred = gt.copy()
    pred[0, :5] = 20.0  # 5 bad pixels of 100
    assert float(bad_pixel_rate(pred, gt, 3.0, 0.0)) == pytest.approx(0.05)
    assert float(end_point_error(pred, gt)) == pytest.approx(0.5)
    gt_nan = gt.copy()
    gt_nan[5] = np.nan  # invalid GT excluded
    assert float(bad_pixel_rate(pred, gt_nan, 3.0, 0.0)) == pytest.approx(5 / 90)
    assert float(density(np.where(gt > 0, gt, np.nan))) == 1.0
    scores = compare_disparities(pred, gt)
    assert set(scores) >= {"epe", "bad3", "d1", "density"}


def test_metrics_d1_relative():
    gt = np.full((4, 4), 100.0, np.float32)
    pred = gt + 4.0  # err 4 > 3 but 4 < 5% of 100 -> not D1-bad
    assert float(bad_pixel_rate(pred, gt, 3.0, 0.05)) == 0.0
    assert float(bad_pixel_rate(pred, gt, 3.0, 0.0)) == 1.0
