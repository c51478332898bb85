"""I/O layer: PLY round-trips, PFM, npz contract, images."""

import json
import os

import numpy as np
import pytest

from stereo_match.data.arkit import build_npz, load_npz_frames, parse_session
from stereo_match.data.image import image_read, image_save, normalize_to_uint8, to_grayscale
from stereo_match.data.kitti import read_kitti_disparity, write_kitti_disparity
from stereo_match.data.middlebury import read_calib, read_pfm, write_pfm
from stereo_match.data.ply import read_ply, write_mesh_ply, write_ply


@pytest.mark.parametrize("binary", [False, True])
def test_ply_roundtrip(tmp_path, rng, binary):
    pts = rng.normal(size=(100, 3)).astype(np.float32)
    cols = rng.integers(0, 255, size=(100, 3), dtype=np.uint8)
    path = str(tmp_path / "cloud.ply")
    n = write_ply(path, pts, cols, binary=binary)
    assert n == 100
    rpts, rcols = read_ply(path)
    np.testing.assert_allclose(rpts, pts, atol=1e-5)
    np.testing.assert_array_equal(rcols, cols)


def test_ply_scrubs_nonfinite(tmp_path):
    pts = np.array([[1.0, 2, 3], [np.nan, 0, 0], [np.inf, 1, 1]], np.float32)
    cols = np.zeros((3, 3), np.uint8)
    path = str(tmp_path / "scrub.ply")
    write_ply(path, pts, cols)
    rpts, _ = read_ply(path)
    assert np.isfinite(rpts).all()
    np.testing.assert_array_equal(rpts[1], [0, 0, 0])


def test_mesh_ply(tmp_path):
    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    faces = np.array([[0, 1, 2]])
    path = str(tmp_path / "mesh.ply")
    write_mesh_ply(path, verts, faces)
    text = open(path).read()
    assert "element face 1" in text and "3 0 1 2" in text


def test_pfm_roundtrip(tmp_path, rng):
    disp = rng.uniform(0, 64, size=(37, 53)).astype(np.float32)
    path = str(tmp_path / "d.pfm")
    write_pfm(path, disp)
    np.testing.assert_allclose(read_pfm(path), disp, rtol=1e-6)


def test_kitti_disparity_roundtrip(tmp_path, rng):
    disp = rng.uniform(1, 100, size=(40, 60)).astype(np.float32)
    disp[0, 0] = np.nan
    path = str(tmp_path / "d.png")
    write_kitti_disparity(path, disp)
    back = read_kitti_disparity(path)
    assert np.isnan(back[0, 0])
    valid = np.isfinite(disp)
    valid[0, 0] = False
    np.testing.assert_allclose(back[valid], disp[valid], atol=1 / 256.0)


def test_middlebury_calib_parse(tmp_path):
    calib = tmp_path / "calib.txt"
    calib.write_text(
        "cam0=[1000 0 300; 0 1000 200; 0 0 1]\n"
        "cam1=[1000 0 320; 0 1000 200; 0 0 1]\n"
        "baseline=193.001\nndisp=280\nwidth=2964\n")
    c = read_calib(str(calib))
    assert c["cam0"].shape == (3, 3)
    assert c["cam0"][0, 2] == 300
    assert c["baseline"] == pytest.approx(193.001)
    assert c["ndisp"] == 280


def test_image_roundtrip(tmp_path, rng):
    img = rng.integers(0, 255, size=(32, 48, 3), dtype=np.uint8)
    path = str(tmp_path / "img.png")
    image_save(path, img)
    back = image_read(path)
    np.testing.assert_array_equal(back, img)
    gray = to_grayscale(img)
    assert gray.shape == (32, 48)


def test_normalize_to_uint8():
    x = np.array([[0.0, 5.0], [10.0, 2.5]])
    n = normalize_to_uint8(x)
    assert n.dtype == np.uint8
    assert n[0, 0] == 0 and n[1, 0] == 255


def _fake_session(tmp_path, rng, n_frames=3, missing=(), dup=()):
    """Create a session.json + jpegs mimicking an ARKit capture."""
    frames = []
    for i in range(n_frames):
        ts = 100.0 + i
        T = np.eye(4)
        T[:3, 3] = [i * 0.1, 0, 0]
        K = np.array([[1164.0, 0, 360], [0, 1164, 640], [0, 0, 1]])
        frames.append({
            "timestamp": ts,
            "camera": {
                "transform": T.T.flatten().tolist(),   # column-major on disk
                "intrinsics": K.T.flatten().tolist(),
            },
        })
        if i not in missing:
            img = rng.integers(0, 255, size=(16, 24, 3), dtype=np.uint8)
            image_save(str(tmp_path / f"{ts}-1.000.jpeg"), img)
    for i in dup:
        frames.append(dict(frames[i]))
    path = tmp_path / "session.json"
    path.write_text(json.dumps({"frames": frames}))
    return str(path)


def test_parse_session_contract(tmp_path, rng):
    path = _fake_session(tmp_path, rng, n_frames=3, missing={1}, dup={0})
    frames, skipped = parse_session(path, mode="P")
    assert len(frames) == 2           # one missing, one duplicate
    assert skipped == 2
    f = frames[0]
    assert f.extrinsic.shape == (4, 4)
    assert f.intrinsic.shape == (3, 3)
    assert f.intrinsic[0, 0] == 1164.0      # transpose round-trip
    np.testing.assert_array_equal(f.extrinsic[3], [0, 0, 0, 1])
    assert f.frame_id == 0 and frames[1].frame_id == 1


def test_build_npz_contract(tmp_path, rng):
    session = _fake_session(tmp_path, rng)
    out = str(tmp_path / "tmp.npz")
    path, n = build_npz(session, out_path=out)
    assert n == 3
    data = load_npz_frames(path)
    keys = set(data[0].keys())
    assert keys == {"timestamp", "image_mat", "frame_id", "extrinsic",
                    "intrinsic", "image_name"}
    assert data[0]["image_mat"].shape == (16, 24, 3)
