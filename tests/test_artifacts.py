"""Stage artifacts (checkpoint/resume) and the failure-tolerant runner."""

import numpy as np
import pytest

from stereo_match.data.costbin import (
    external_volume_to_disparity, read_cost_bin, write_cost_bin,
)
from stereo_match.pipeline.artifacts import PairResult, StageStore, run_session


def test_cost_bin_roundtrip(tmp_path, rng):
    vol = rng.uniform(0, 10, (8, 12, 16)).astype(np.float32)  # (D, H, W)
    p = str(tmp_path / "left.bin")
    write_cost_bin(p, vol)
    back = read_cost_bin(p, 8, 16, 12)
    np.testing.assert_array_equal(back, vol)
    # on-disk layout is the reference contract (1, D, W, H)
    raw = np.fromfile(p, np.float32)
    assert raw.size == 8 * 12 * 16
    np.testing.assert_allclose(raw[:12], vol[0, :, 0])  # first W-major run


def test_external_volume_to_disparity(rng):
    D, H, W = 8, 16, 24
    vol = np.full((D, H, W), 10.0, np.float32)
    vol[3] = 0.0   # winner everywhere
    disp = external_volume_to_disparity(vol)
    valid = np.isfinite(disp)
    assert (np.abs(disp[valid] - 3.0) < 0.5).all()
    guide = np.zeros((H, W), np.float32)
    disp2 = external_volume_to_disparity(vol, guide=guide)
    assert np.isfinite(disp2).all()   # WLS in-fills


def test_stage_store_roundtrip_and_resume(tmp_path):
    store = StageStore(str(tmp_path / "stages"))
    calls = []

    def compute():
        calls.append(1)
        return {"x": np.arange(5)}

    out1 = store.get_or_compute("s1", compute, frame=3)
    out2 = store.get_or_compute("s1", compute, frame=3)   # cached
    assert len(calls) == 1
    np.testing.assert_array_equal(out2["x"], np.arange(5))
    # different key -> recompute
    store.get_or_compute("s1", compute, frame=4)
    assert len(calls) == 2
    assert store.has("s1", frame=3) and not store.has("s1", frame=99)


def test_run_session_skip_and_continue(tmp_path):
    def process(a, b):
        if a is None:
            raise ValueError("bad frame")
        return {"sum": np.asarray(a + b)}

    pairs = [(1, 2), (None, 5), (3, 4)]
    results = run_session(pairs, process)
    assert [r.ok for r in results] == [True, False, True]
    assert "bad frame" in results[1].error
    assert results[2].outputs["sum"] == 7
    with pytest.raises(ValueError):
        run_session(pairs, process, continue_on_error=False)


def test_run_session_with_store(tmp_path):
    store = StageStore(str(tmp_path))
    count = []

    def process(a, b):
        count.append(1)
        return {"v": np.asarray([a, b])}

    pairs = [(1, 2), (3, 4)]
    run_session(pairs, process, store=store)
    run_session(pairs, process, store=store)   # resumes from artifacts
    assert len(count) == 2
