"""Multi-chip sharding on the 8-device CPU mesh (SURVEY.md §4:
single-chip vs multi-chip equivalence for the sharded kernels)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stereo_match.config import DisparityConfig
from stereo_match.data.synthetic import box_scene, random_dot_pair
from stereo_match.eval.metrics import bad_pixel_rate
from stereo_match.ops.sgm import sgm_aggregate
from stereo_match.parallel.batch import batched_matcher
from stereo_match.parallel.mesh import make_mesh, volume_sharding
from stereo_match.parallel.tiling import sgm_aggregate_sharded


@pytest.fixture(scope="module")
def mesh_rows():
    return make_mesh(batch=1, rows=8)


@pytest.fixture(scope="module")
def mesh_2x4():
    return make_mesh(batch=2, rows=4)


def _volume(rng, D=16, H=64, W=48):
    return jnp.asarray(rng.uniform(0, 24, (D, H, W)).astype(np.float32))


def test_mesh_shapes():
    m = make_mesh(batch=2, rows=4)
    assert m.shape == {"batch": 2, "rows": 4}
    with pytest.raises(ValueError):
        make_mesh(batch=3)


@pytest.mark.parametrize("num_paths", [2, 4])
def test_sharded_exact_matches_single_chip(rng, mesh_rows, num_paths):
    """Horizontal + chained vertical: bit-parity with the unsharded scan."""
    vol = _volume(rng)
    single = np.asarray(sgm_aggregate(vol, 8.0, 96.0, num_paths))
    sharded = np.asarray(sgm_aggregate_sharded(
        vol, 8.0, 96.0, mesh_rows, num_paths, mode="exact"))
    np.testing.assert_allclose(sharded, single, rtol=1e-6, atol=1e-4)


def test_sharded_halo_full_predecessor_is_exact(rng):
    """With halo >= shard height the warm-up replays the whole predecessor
    block, so a 2-shard halo scan is bit-exact vs single chip."""
    mesh2 = make_mesh(batch=1, rows=2, devices=jax.devices()[:2])
    vol = _volume(rng, D=16, H=64, W=48)
    single = np.asarray(sgm_aggregate(vol, 8.0, 96.0, 4))
    sharded = np.asarray(sgm_aggregate_sharded(
        vol, 8.0, 96.0, mesh2, 4, mode="halo", halo=32))
    np.testing.assert_allclose(sharded, single, rtol=1e-6, atol=1e-4)


def test_sharded_halo_quality_on_structured_scene(mesh_rows):
    """On a real scene (structured costs) the SGM recurrence forgets the
    boundary state: 8-shard halo winners match single-chip almost surely."""
    from stereo_match.ops.cost_volume import build_cost_volume
    gt = box_scene(64, 96)
    left, right = random_dot_pair(64, 96, gt, blur=0.8)
    vol = build_cost_volume(jnp.asarray(left), jnp.asarray(right), 16)
    single = np.asarray(sgm_aggregate(vol, 8.0, 96.0, 4))
    mesh4 = make_mesh(batch=1, rows=4, devices=jax.devices()[:4])
    sharded = np.asarray(sgm_aggregate_sharded(
        vol, 8.0, 96.0, mesh4, 4, mode="halo", halo=16))
    agree = (np.argmin(single, 0) == np.argmin(sharded, 0)).mean()
    assert agree > 0.985, agree


def test_sharded_8path_exact_parity():
    """8-path exact mode is bit-exact vs single card — including the
    diagonals, whose carries chain in the (8, D, W) slab."""
    from stereo_match.ops.cost_volume import build_cost_volume
    mesh4 = make_mesh(batch=1, rows=4, devices=jax.devices()[:4])
    gt = box_scene(64, 96)
    left, right = random_dot_pair(64, 96, gt, blur=0.8)
    vol = build_cost_volume(jnp.asarray(left), jnp.asarray(right), 16)
    single = np.asarray(sgm_aggregate(vol, 8.0, 96.0, 8))
    sharded = np.asarray(sgm_aggregate_sharded(
        vol, 8.0, 96.0, mesh4, 8, mode="exact", halo=16))
    np.testing.assert_allclose(sharded, single, rtol=1e-6, atol=1e-4)


def test_sharded_exact_int16_and_ragged_height():
    """int16 volumes + H not divisible by rows: the wrapper pads with zero
    rows (carry-preserving) and slices back."""
    from stereo_match.ops.cost_volume import build_cost_volume
    mesh4 = make_mesh(batch=1, rows=4, devices=jax.devices()[:4])
    gt = box_scene(53, 96)
    left, right = random_dot_pair(53, 96, gt, blur=0.8)
    vol = build_cost_volume(jnp.asarray(left), jnp.asarray(right), 16,
                            dtype="int16")
    assert vol.dtype == jnp.int16
    single = np.asarray(sgm_aggregate(vol, 8.0, 96.0, 8))
    sharded = np.asarray(sgm_aggregate_sharded(
        vol, 8.0, 96.0, mesh4, 8, mode="exact"))
    assert sharded.shape == single.shape
    np.testing.assert_array_equal(sharded, single)


def test_sharded_on_real_scene_quality(mesh_rows):
    """Sharded end-to-end aggregation keeps bad-3px quality (box scene)."""
    from stereo_match.ops.cost_volume import build_cost_volume
    from stereo_match.ops.wta import extract_disparity
    gt = box_scene(64, 96)
    left, right = random_dot_pair(64, 96, gt, blur=0.8)
    vol = build_cost_volume(jnp.asarray(left), jnp.asarray(right), 32)
    agg = sgm_aggregate_sharded(vol, 8.0, 96.0, mesh_rows, 8,
                                mode="halo", halo=8)
    disp = np.asarray(extract_disparity(agg, uniqueness_ratio=0,
                                        disp12_max_diff=1))
    assert float(bad_pixel_rate(disp, gt, 3.0, 0.0)) < 0.04


def test_sharded_input_can_be_device_sharded(rng, mesh_rows):
    """Works when the volume arrives already sharded (no host round-trip)."""
    vol = _volume(rng)
    vol_sharded = jax.device_put(vol, volume_sharding(mesh_rows))
    out = sgm_aggregate_sharded(vol_sharded, 8.0, 96.0, mesh_rows, 4,
                                mode="exact")
    single = np.asarray(sgm_aggregate(vol, 8.0, 96.0, 4))
    np.testing.assert_allclose(np.asarray(out), single, rtol=1e-6, atol=1e-4)


class TestDSharding:
    """Disparity-plane sharding (SURVEY §2 parallelism row 3)."""

    def _scene_volume(self, D=32, H=64, W=96):
        from stereo_match.ops.cost_volume import build_cost_volume
        gt = box_scene(H, W, background=4.0, foreground=14.0)
        left, right = random_dot_pair(H, W, gt, blur=0.8, seed=2)
        vol = build_cost_volume(jnp.asarray(left), jnp.asarray(right), D,
                                cost="census", dtype="float32")
        return left, right, vol, gt

    def test_wta_dsharded_bit_exact(self):
        """pmin-combined WTA over 8 D-shards == single-chip WTA."""
        from stereo_match.ops.wta import extract_disparity
        from stereo_match.parallel.dsharding import (make_disp_mesh,
                                                     wta_dsharded)
        _, _, vol, _ = self._scene_volume()
        cfg = DisparityConfig(num_disparities=32, uniqueness_ratio=15,
                              disp12_max_diff=1)
        single = np.asarray(extract_disparity(
            vol, uniqueness_ratio=15, disp12_max_diff=1))
        sharded = np.asarray(wta_dsharded(vol, make_disp_mesh(8), cfg))
        np.testing.assert_array_equal(sharded, single)

    def test_local_census_slices_assemble_to_reference(self):
        """Per-shard dynamic-offset census slices == the full volume."""
        from stereo_match.parallel.dsharding import _local_census_volume
        left, right, vol, _ = self._scene_volume()
        l = jnp.asarray(left, jnp.float32)
        r = jnp.asarray(right, jnp.float32)
        parts = [np.asarray(_local_census_volume(l, r, 8, d0, (5, 5), 0,
                                                 jnp.float32))
                 for d0 in (0, 8, 16, 24)]
        np.testing.assert_array_equal(np.concatenate(parts, 0),
                                      np.asarray(vol))

    def test_match_dsharded_exact_vs_single_chip(self):
        """Cost build D-sharded -> all_to_all -> row SGM (exact chains) ->
        row-local WTA == the single-card pipeline."""
        from stereo_match.ops.wta import extract_disparity
        from stereo_match.parallel.dsharding import (make_disp_mesh,
                                                     match_dsharded)
        left, right, vol, gt = self._scene_volume()
        cfg = DisparityConfig(num_disparities=32, uniqueness_ratio=15,
                              disp12_max_diff=1, dtype="float32")
        agg = sgm_aggregate(vol, cfg.P1, cfg.P2, 8)
        single = np.asarray(extract_disparity(agg, uniqueness_ratio=15,
                                              disp12_max_diff=1))
        out = np.asarray(match_dsharded(left, right, cfg, make_disp_mesh(8),
                                        mode="exact"))
        np.testing.assert_array_equal(out, single)
        # and it actually solves the scene
        valid = np.isfinite(out)
        assert valid.mean() > 0.5
        err = np.abs(out[valid] - gt[valid])
        assert (err > 3).mean() < 0.05


def test_batched_matcher_dp(mesh_2x4):
    gt = box_scene(32, 64)
    pairs = [random_dot_pair(32, 64, gt, blur=0.8, seed=s) for s in range(4)]
    lefts = np.stack([p[0] for p in pairs])
    rights = np.stack([p[1] for p in pairs])
    cfg = DisparityConfig(num_disparities=16, uniqueness_ratio=0, wls=False,
                          speckle_window_size=0)
    fn = batched_matcher(cfg, mesh_2x4)
    raw, filtered = fn(lefts, rights)
    assert raw.shape == (4, 32, 64)
    # each batch element equals the single-pair result
    from stereo_match.pipeline.stereo import StereoMatcher
    single, _ = StereoMatcher(cfg)(lefts[2], rights[2])
    np.testing.assert_allclose(np.asarray(raw[2]), np.asarray(single),
                               equal_nan=True, atol=1e-5)
