"""Rectification math vs the OpenCV oracle (SURVEY.md §4 test strategy)."""

import cv2
import numpy as np
import pytest

from stereo_match.core.camera import (
    arkit_to_opencv_extrinsic,
    check_epipoles,
    portrait_swap_principal_point,
    relative_pose,
    rodrigues,
    rotation_to_vector,
)
from stereo_match.core.rectify import (
    rectification_maps,
    rectify_pair,
    remap_bilinear,
    stereo_rectify,
)


def random_stereo_setup(rng, baseline=0.22, jitter=0.02):
    K = np.array([[1164.0, 0, 360], [0, 1164.0, 640], [0, 0, 1]])
    rot_vec = rng.normal(scale=0.03, size=3)
    R = rodrigues(rot_vec)
    T = np.array([-baseline, 0, 0]) + rng.normal(scale=jitter, size=3)
    return K, K.copy(), R, T


@pytest.mark.parametrize("alpha", [-1.0, 0.0, 1.0])
def test_stereo_rectify_matches_opencv(rng, alpha):
    K1, K2, R, T = random_stereo_setup(rng)
    size = (720, 1280)  # (w, h)
    mine = stereo_rectify(K1, K2, size, R, T, alpha=alpha)
    R1, R2, P1, P2, Q, _, _ = cv2.stereoRectify(
        K1, np.zeros(5), K2, np.zeros(5), size, R, T.reshape(3, 1),
        flags=cv2.CALIB_ZERO_DISPARITY, alpha=alpha)
    np.testing.assert_allclose(mine.R1, R1, atol=1e-8)
    np.testing.assert_allclose(mine.R2, R2, atol=1e-8)
    np.testing.assert_allclose(mine.P1, P1, rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(mine.P2, P2, rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(mine.Q, Q, rtol=1e-6, atol=1e-5)


def test_stereo_rectify_vertical_baseline(rng):
    K1, K2, _, _ = random_stereo_setup(rng)
    R = rodrigues(rng.normal(scale=0.02, size=3))
    T = np.array([0.01, -0.3, 0.005])
    size = (640, 480)
    mine = stereo_rectify(K1, K2, size, R, T)
    R1, R2, P1, P2, Q, _, _ = cv2.stereoRectify(
        K1, np.zeros(5), K2, np.zeros(5), size, R, T.reshape(3, 1),
        flags=cv2.CALIB_ZERO_DISPARITY, alpha=-1)
    np.testing.assert_allclose(mine.R1, R1, atol=1e-8)
    np.testing.assert_allclose(mine.P2, P2, rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(mine.Q, Q, rtol=1e-6, atol=1e-5)


def test_rectification_maps_match_opencv(rng):
    K1, K2, R, T = random_stereo_setup(rng)
    size = (320, 240)
    res = stereo_rectify(K1, K2, size, R, T)
    mx, my = rectification_maps(K1, res.R1, res.P1, size)
    cv_mx, cv_my = cv2.initUndistortRectifyMap(
        K1, np.zeros(5), res.R1, res.P1, size, cv2.CV_32FC1)
    np.testing.assert_allclose(np.asarray(mx), cv_mx, atol=2e-2)
    np.testing.assert_allclose(np.asarray(my), cv_my, atol=2e-2)


def test_rectification_maps_with_distortion(rng):
    K = np.array([[500.0, 0, 160], [0, 500.0, 120], [0, 0, 1]])
    dist = np.array([-0.1, 0.05, 0.001, -0.002, 0.0])
    size = (320, 240)
    R_eye = np.eye(3)
    P = np.hstack([K, np.zeros((3, 1))])
    mx, my = rectification_maps(K, R_eye, P, size, dist)
    cv_mx, cv_my = cv2.initUndistortRectifyMap(K, dist, R_eye, P, size, cv2.CV_32FC1)
    np.testing.assert_allclose(np.asarray(mx), cv_mx, atol=2e-2)
    np.testing.assert_allclose(np.asarray(my), cv_my, atol=2e-2)


def test_remap_bilinear_matches_opencv(rng):
    img = rng.integers(0, 255, size=(64, 96), dtype=np.uint8).astype(np.float32)
    mx = rng.uniform(-3, 99, size=(50, 70)).astype(np.float32)
    my = rng.uniform(-3, 67, size=(50, 70)).astype(np.float32)
    mine = np.asarray(remap_bilinear(img, mx, my))
    ref = cv2.remap(img, mx, my, cv2.INTER_LINEAR)
    # Edges differ where cv2 blends with the border constant; compare interior.
    interior = (mx > 0.5) & (mx < 94.5) & (my > 0.5) & (my < 62.5)
    np.testing.assert_allclose(mine[interior], ref[interior], atol=1e-3)


def test_remap_color_and_dtype(rng):
    img = rng.integers(0, 255, size=(32, 32, 3), dtype=np.uint8)
    mx, my = np.meshgrid(np.arange(32, dtype=np.float32),
                         np.arange(32, dtype=np.float32))
    out = np.asarray(remap_bilinear(img, mx, my))
    assert out.dtype == np.uint8
    np.testing.assert_array_equal(out, img)


def test_rectify_pair_aligns_epipolar_lines(rng):
    # Render a textured plane from two poses; after rectification the rows
    # must correspond (zero vertical disparity).
    K = np.array([[300.0, 0, 128], [0, 300.0, 96], [0, 0, 1]])
    h, w = 192, 256
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    texture = (np.sin(xx * 0.3) * np.cos(yy * 0.2) * 100 + 128).astype(np.float32)

    pose_l = np.eye(4)
    pose_r = np.eye(4)
    pose_r[:3, 3] = [0.1, 0.0, 0.0]
    rect_l, rect_r, res = rectify_pair(pose_l, pose_r, K, K, texture, texture, alpha=-1)
    assert rect_l.shape == (h, w)
    assert res.baseline == pytest.approx(0.1, rel=1e-6)
    # For identical images & pure-x baseline with identity rotations the
    # rectifying rotations are (close to) identity.
    np.testing.assert_allclose(res.R1, np.eye(3), atol=1e-8)


def test_relative_pose_roundtrip(rng):
    pose_l = np.eye(4)
    pose_l[:3, :3] = rodrigues(rng.normal(size=3) * 0.1)
    pose_l[:3, 3] = rng.normal(size=3)
    pose_r = np.eye(4)
    pose_r[:3, :3] = rodrigues(rng.normal(size=3) * 0.1)
    pose_r[:3, 3] = rng.normal(size=3)
    R, t = relative_pose(pose_l, pose_r)
    # A point fixed in world, expressed in both camera frames, must satisfy
    # x_r = R x_l + t.
    p_world = rng.normal(size=3)
    x_l = pose_l[:3, :3].T @ (p_world - pose_l[:3, 3])
    x_r = pose_r[:3, :3].T @ (p_world - pose_r[:3, 3])
    np.testing.assert_allclose(R @ x_l + t, x_r, atol=1e-10)


def test_rodrigues_roundtrip(rng):
    for scale in (0.001, 0.5, 2.0, 3.1):
        v = rng.normal(size=3)
        v = v / np.linalg.norm(v) * scale
        R = rodrigues(v)
        cvR, _ = cv2.Rodrigues(v)
        np.testing.assert_allclose(R, cvR, atol=1e-10)
        np.testing.assert_allclose(rotation_to_vector(R), v, atol=1e-6)


def test_arkit_convention_is_rigid(rng):
    T = np.eye(4)
    T[:3, :3] = rodrigues(rng.normal(size=3))
    T[:3, 3] = rng.normal(size=3)
    for mode in ("P", "LR", "LL"):
        E = arkit_to_opencv_extrinsic(T, mode)
        R = E[:3, :3]
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-12)
        assert np.linalg.det(R) == pytest.approx(1.0)
        np.testing.assert_array_equal(E[3], [0, 0, 0, 1])


def test_portrait_swap():
    K = np.array([[100.0, 0, 11], [0, 200.0, 22], [0, 0, 1]])
    K2 = portrait_swap_principal_point(K)
    assert K2[0, 2] == 22 and K2[1, 2] == 11
    assert K[0, 2] == 11  # input untouched


def test_check_epipoles():
    K = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]])
    pose_l = np.eye(4)
    pose_r = np.eye(4)
    pose_r[:3, 3] = [0.2, 0, 0]  # lateral baseline: epipoles at infinity/outside
    assert check_epipoles(K, K, pose_l, pose_r, (240, 320))
    pose_fwd = np.eye(4)
    pose_fwd[:3, 3] = [0, 0, -0.5]  # camera moving along optical axis: epipole in view
    assert not check_epipoles(K, K, pose_l, pose_fwd, (240, 320))


def test_rectify_pair_rejects_forward_motion():
    """The epipole gate (reference stereo_vision.py:12-47) must reject a
    forward-motion pair, where planar rectification is degenerate."""
    import pytest
    from stereo_match.core.rectify import rectify_pair
    K = np.array([[200.0, 0, 64], [0, 200.0, 48], [0, 0, 1]])
    pose_l = np.eye(4)
    pose_r = np.eye(4)
    pose_r[2, 3] = 1.0          # translation along the optical axis
    img = np.zeros((96, 128), np.float32)
    with pytest.raises(ValueError, match="epipole"):
        rectify_pair(pose_l, pose_r, K, K, img, img)
    # check=False forces through (maps computed, shapes intact)
    rl, rr, res = rectify_pair(pose_l, pose_r, K, K, img, img, check=False)
    assert np.asarray(rl).shape == img.shape
