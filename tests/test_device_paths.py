"""The GPU device paths and the plain reference they are tested against.

* The SGM kernel's wrapper on the CPU: layout, widening, odd shapes, carry
  chaining and the choice of path by platform, with the plain reference
  scan standing in for the FFI call (a CUDA kernel has no interpret mode).
* The FGS Triton kernel in interpret mode against the Thomas scan.
* The plain path against brute-force NumPy.
* ``gpu``-marked tests: the kernels themselves on the card, at full width.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stereo_match.ops import sgm, sgm_cuda
from stereo_match.utils import backend

P1, P2 = 8.0, 96.0


def _reference_kernel(cost_hwd, total_hwd, carry_wd, p1, p2, mask, calls=None):
    """The FFI kernel's (H, W, D) contract, computed by ``ops.sgm``."""
    if calls is not None:
        calls.append(mask)
    assert cost_hwd.dtype == jnp.float32 and carry_wd.dtype == jnp.float32
    dirs = [i for i in range(8) if mask >> i & 1]
    total = None if total_hwd is None else jnp.transpose(total_hwd, (2, 0, 1))
    tot, carry = sgm.sgm_paths(jnp.transpose(cost_hwd, (2, 0, 1)), p1, p2,
                               dirs, total, jnp.swapaxes(carry_wd, 1, 2))
    return jnp.transpose(tot, (1, 2, 0)), jnp.swapaxes(carry, 1, 2)


def _census_volume(shape, dtype, seed=0):
    """A census-like integer volume with INVALID-like large cells."""
    D, H, W = shape
    v = np.random.default_rng(seed).integers(0, 25, shape)
    v[:, :, :3] = 1000
    return jnp.asarray(v.astype(dtype))


def _wrapper(cost, dirs, total=None, init_carry=None):
    return sgm_cuda._kernel_paths(cost, P1, P2, dirs, total, init_carry,
                                  _reference_kernel)


# ------------------------------------------------ SGM kernel wrapper (CPU)

@pytest.mark.parametrize("num_paths", [2, 4, 8])
def test_kernel_wrapper_matches_sgm_aggregate(num_paths):
    vol = _census_volume((16, 24, 40), np.float32)
    want = np.asarray(sgm.sgm_aggregate(vol, P1, P2, num_paths))
    got, _ = _wrapper(vol, range(num_paths))
    np.testing.assert_array_equal(np.asarray(got), want)


@pytest.mark.parametrize("dtype", [np.float32, np.int16])
def test_kernel_wrapper_keeps_volume_dtype(dtype):
    """int16 volumes are widened at the boundary and narrowed back,
    bit-equal to the int16 reference."""
    vol = _census_volume((16, 21, 37), dtype, seed=1)
    got, carry = _wrapper(vol, range(8))
    assert got.dtype == vol.dtype and carry.dtype == vol.dtype
    np.testing.assert_array_equal(np.asarray(got),
                                  np.asarray(sgm.sgm_aggregate(vol, P1, P2)))


@pytest.mark.parametrize("shape", [(8, 37, 23), (40, 17, 53), (24, 5, 130),
                                   (16, 1, 9)])
def test_kernel_wrapper_odd_shapes(shape):
    """D not a multiple of the warp width, H or W tiny: the wrapper passes
    the true shape and the kernel masks the tail of its lanes."""
    vol = jnp.asarray(np.random.default_rng(2).uniform(0, 30, shape)
                      .astype(np.float32))
    got, _ = _wrapper(vol, range(8))
    np.testing.assert_array_equal(
        np.asarray(got), np.asarray(sgm.sgm_aggregate(vol, P1, P2)))


@pytest.mark.parametrize("dtype", [np.float32, np.int16])
@pytest.mark.parametrize("cuts", [(13,), (5, 11, 20)])
def test_kernel_wrapper_chains_row_tiles(dtype, cuts):
    """Row tiles chained through the carries equal the whole volume: the
    downward paths top to bottom, the upward ones bottom to top."""
    vol = _census_volume((16, 24, 30), dtype, seed=3)
    tiles = np.split(np.asarray(vol), cuts, axis=1)
    totals = [_wrapper(jnp.asarray(t), (0, 1))[0] for t in tiles]
    carry = None
    for k in range(len(tiles)):
        totals[k], carry = _wrapper(jnp.asarray(tiles[k]), (2, 4, 6),
                                    totals[k], carry)
    carry = None
    for k in reversed(range(len(tiles))):
        totals[k], carry = _wrapper(jnp.asarray(tiles[k]), (3, 5, 7),
                                    totals[k], carry)
    np.testing.assert_array_equal(
        np.concatenate([np.asarray(t) for t in totals], axis=1),
        np.asarray(sgm.sgm_aggregate(vol, P1, P2)))


@pytest.mark.parametrize("direction", range(8))
def test_reference_paths_one_direction(direction):
    """sgm_paths for one direction is that path's L, and its carry is L on
    the row the path leaves the volume by."""
    vol = _census_volume((16, 12, 20), np.float32, seed=4)
    dy, dx = sgm.PATH_DIRECTIONS_8[direction]
    L = np.asarray(sgm.aggregate_direction(vol, dy, dx, P1, P2))
    tot, carry = sgm.sgm_paths(vol, P1, P2, [direction])
    np.testing.assert_array_equal(np.asarray(tot), L)
    want = np.zeros((8, 16, 20), np.float32)
    if dy:
        want[direction] = L[:, -1] if dy > 0 else L[:, 0]
    np.testing.assert_array_equal(np.asarray(carry), want)


@pytest.mark.parametrize("on_card", [True, False])
def test_sgm_path_choice_by_platform(monkeypatch, on_card):
    """On the GPU the FFI call runs (here the stand-in); elsewhere the
    reference runs and no kernel is called."""
    calls = []
    monkeypatch.setattr(sgm_cuda, "gpu_kernels", lambda name: on_card)
    monkeypatch.setattr(sgm_cuda, "_ffi_sgm",
                        functools.partial(_reference_kernel, calls=calls))
    vol = _census_volume((16, 10, 20), np.float32, seed=5)
    got = sgm_cuda.sgm_aggregate_auto.__wrapped__(vol, P1, P2, 8)
    np.testing.assert_array_equal(np.asarray(got),
                                  np.asarray(sgm.sgm_aggregate(vol, P1, P2)))
    assert calls == ([0xFF] if on_card else [])


def test_ffi_call_rejects_too_many_disparities():
    with pytest.raises(ValueError, match="at most"):
        jax.eval_shape(lambda c: sgm_cuda._ffi_sgm(
            c, None, jnp.zeros((8, 4, 600)), P1, P2, 0xFF),
            jax.ShapeDtypeStruct((4, 4, 600), jnp.float32))


def test_match_core_on_gpu_path(monkeypatch):
    """_match_core with the GPU paths chosen (FFI stand-in, Triton solve in
    interpret mode) equals the CPU pipeline."""
    from stereo_match.config import DisparityConfig
    from stereo_match.data.synthetic import box_scene, random_dot_pair
    from stereo_match.ops import fgs_triton
    from stereo_match.ops import wls
    from stereo_match.pipeline.stereo import _match_core

    gt = box_scene(24, 48, 2.0, 9.0)
    left, right = random_dot_pair(24, 48, gt, blur=0.8, seed=6)
    cfg = DisparityConfig(num_disparities=16)
    l, r = jnp.asarray(left), jnp.asarray(right)
    want = [np.asarray(x) for x in _match_core(l, r, cfg)]
    calls = []
    monkeypatch.setattr(sgm_cuda, "gpu_kernels", lambda name: True)
    monkeypatch.setattr(wls, "gpu_kernels", lambda name: True)
    monkeypatch.setattr(sgm_cuda, "_ffi_sgm",
                        functools.partial(_reference_kernel, calls=calls))
    monkeypatch.setattr(fgs_triton, "fgs_solve_triton", functools.partial(
        fgs_triton.fgs_solve_triton, interpret=True))
    jax.clear_caches()
    got = [np.asarray(x) for x in _match_core(l, r, cfg)]
    jax.clear_caches()
    assert calls == [0xFF]
    np.testing.assert_array_equal(got[0], want[0])
    # FGS: FMA contraction and division order differ between the Triton
    # solve and the scan; six chained solves at lambda=80000 amplify the
    # last-bit differences to ~1e-4 px where the confidence is small
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("names,off", [((), ("sgm", "fgs")),
                                       (("sgm",), ("sgm",)),
                                       (("fgs",), ("fgs",))])
def test_xla_only_turns_kernels_off(monkeypatch, names, off):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert all(backend.gpu_kernels(k) for k in backend.KERNELS)
    with backend.xla_only(*names):
        assert all(backend.gpu_kernels(k) == (k not in off)
                   for k in backend.KERNELS)
    assert all(backend.gpu_kernels(k) for k in backend.KERNELS)
    monkeypatch.undo()
    assert not any(backend.gpu_kernels(k) for k in backend.KERNELS)


# ------------------------------------------------- FGS Triton kernel (CPU)

@pytest.mark.parametrize("C,H,W", [(2, 21, 45), (1, 8, 32), (2, 9, 130),
                                   (2, 16, 127), (1, 3, 5)])
def test_fgs_triton_matches_thomas_scan(C, H, W):
    """One Triton solve (interpret mode; padded to whole blocks of steps
    and systems) vs the lax.scan Thomas solve. Same per-step arithmetic;
    the two differ by FMA contraction and division order only."""
    from stereo_match.ops.fgs_triton import fgs_solve_triton
    from stereo_match.ops.wls import _tridiagonal_smooth_rows
    rng = np.random.default_rng(H * W)
    f = rng.normal(10, 5, (C, H, W)).astype(np.float32)
    w = rng.uniform(0, 1, (H, W - 1)).astype(np.float32)
    lam = jnp.float32(190.476)
    want = np.asarray(_tridiagonal_smooth_rows(jnp.asarray(f),
                                               jnp.asarray(w), lam))
    got = np.asarray(fgs_solve_triton(jnp.swapaxes(jnp.asarray(f), 1, 2),
                                      jnp.asarray(w.T), lam, interpret=True))
    np.testing.assert_allclose(np.swapaxes(got, 1, 2), want,
                               rtol=1e-5, atol=1e-5)


def test_fgs_stacked_rhs_equals_separate_solves():
    """The WLS numerator and confidence share one solve: stacking them is
    bit-equal to smoothing each alone."""
    from stereo_match.ops.wls import fast_global_smoother
    rng = np.random.default_rng(3)
    guide = jnp.asarray(rng.uniform(0, 255, (21, 45)).astype(np.float32))
    a = jnp.asarray(rng.normal(size=(21, 45)).astype(np.float32))
    b = jnp.asarray(rng.uniform(0, 1, (21, 45)).astype(np.float32))
    both = np.asarray(fast_global_smoother(jnp.stack([a, b]), guide,
                                           8000.0, 8.0, 3))
    for k, x in enumerate((a, b)):
        np.testing.assert_array_equal(
            both[k], np.asarray(fast_global_smoother(x, guide, 8000.0, 8.0, 3)))


def test_wls_filter_with_triton_solve(monkeypatch):
    """The whole WLS filter through the Triton solve (interpret mode) vs the
    plain one, at the stated 1e-5 relative tolerance."""
    from stereo_match.ops import fgs_triton, wls
    rng = np.random.default_rng(8)
    guide = jnp.asarray(rng.uniform(0, 255, (19, 70)).astype(np.float32))
    d = rng.uniform(2, 30, (19, 70)).astype(np.float32)
    d[rng.uniform(size=d.shape) < 0.2] = np.nan
    want = np.asarray(wls.wls_filter_disparity.__wrapped__(
        jnp.asarray(d), guide, 80000.0, 1.2, 3))
    monkeypatch.setattr(wls, "gpu_kernels", lambda name: True)
    monkeypatch.setattr(fgs_triton, "fgs_solve_triton", functools.partial(
        fgs_triton.fgs_solve_triton, interpret=True))
    got = np.asarray(wls.wls_filter_disparity.__wrapped__(
        jnp.asarray(d), guide, 80000.0, 1.2, 3))
    np.testing.assert_allclose(got, want, rtol=1e-5)


# --------------------------------------- plain path vs brute-force NumPy

def _census_numpy(img, window):
    wh, ww = window
    ry, rx = wh // 2, ww // 2
    H, W = img.shape
    pad = np.pad(img, ((ry, ry), (rx, rx)), mode="edge")
    n_words = (wh * ww - 1 + 31) // 32
    out = np.zeros((H, W, n_words), np.int64)
    bit = 0
    for dy in range(wh):
        for dx in range(ww):
            if dy == ry and dx == rx:
                continue
            b = (pad[dy:dy + H, dx:dx + W] < img).astype(np.int64)
            out[..., bit // 32] |= b << (bit % 32)
            bit += 1
    return out


@pytest.mark.parametrize("window", [(5, 5), (3, 3), (5, 3), (7, 9)])
def test_census_words_vs_numpy(window):
    from stereo_match.ops.census import census_transform
    img = np.random.default_rng(0).integers(0, 8, (17, 29)).astype(np.float32)
    got = np.asarray(census_transform(jnp.asarray(img), window))
    want = _census_numpy(img, window)
    np.testing.assert_array_equal(got.astype(np.int64) & 0xFFFFFFFF,
                                  want & 0xFFFFFFFF)


@pytest.mark.parametrize("dtype", ["float32", "int16"])
@pytest.mark.parametrize("min_d", [0, 3])
def test_census_volume_vs_numpy(dtype, min_d):
    from stereo_match.ops.cost_volume import (INVALID_COST,
                                              INVALID_COST_I16,
                                              census_cost_volume)
    rng = np.random.default_rng(1)
    H, W, D = 11, 40, 12
    left = rng.integers(0, 6, (H, W)).astype(np.float32)
    right = rng.integers(0, 6, (H, W)).astype(np.float32)
    got = np.asarray(census_cost_volume(left, right, D, min_d,
                                        dtype=jnp.dtype(dtype)))
    cl, cr = _census_numpy(left, (5, 5)), _census_numpy(right, (5, 5))
    invalid = INVALID_COST_I16 if dtype == "int16" else INVALID_COST
    want = np.full((D, H, W), invalid, np.float64)
    for i in range(D):
        d = min_d + i
        for x in range(d, W):
            xor = cl[:, x, 0] ^ cr[:, x - d, 0]
            want[i, :, x] = [bin(int(v)).count("1") for v in xor]
    assert got.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(got, want.astype(dtype))


def _wta_numpy(agg, ur, d12, subpixel, min_d=0):
    """OpenCV-semantics WTA, pixel by pixel."""
    D, H, W = agg.shape
    a = agg.astype(np.float64)
    disp = np.full((H, W), np.nan)
    right = np.zeros((H, W))
    for y in range(H):
        for xr in range(W):
            costs = [a[d, y, xr + d] if xr + d < W else np.inf
                     for d in range(D)]
            right[y, xr] = int(np.argmin(costs)) + min_d
    for y in range(H):
        for x in range(W):
            c = a[:, y, x]
            k = int(np.argmin(c))
            ok = all(c[d] * 100 > c[k] * (100 + ur)
                     for d in range(D) if abs(d - k) > 1) if ur > 0 else True
            v = float(k)
            if subpixel and 0 < k < D - 1:
                den = c[k - 1] - 2 * c[k] + c[k + 1]
                if den > 1e-9:
                    v += float(np.clip((c[k - 1] - c[k + 1]) / (2 * den),
                                       -0.5, 0.5))
            v += min_d
            if d12 >= 0:
                xr = int(np.round(x - v))
                ok &= 0 <= xr < W and abs(v - right[y, min(max(xr, 0),
                                                          W - 1)]) <= d12
            if ok:
                disp[y, x] = v
    return disp, right


@pytest.mark.parametrize("ur,d12,subpixel", [(0, 1, True), (15, 1, True),
                                             (0, -1, False)])
def test_extract_disparity_vs_numpy(ur, d12, subpixel):
    from stereo_match.ops.wta import extract_disparity
    agg = np.random.default_rng(ur + 7).integers(0, 300, (12, 9, 23))
    agg = agg.astype(np.float32)
    got = np.asarray(extract_disparity(jnp.asarray(agg), 0, ur, d12,
                                       subpixel))
    want, _ = _wta_numpy(agg, ur, d12, subpixel)
    np.testing.assert_allclose(got, want, equal_nan=True, atol=1e-5)


@pytest.mark.parametrize("dtype,shape", [(np.float32, (16, 7, 37)),
                                         (np.int16, (16, 7, 37)),
                                         (np.float32, (8, 4, 60)),
                                         (np.int16, (32, 5, 50))])
def test_right_view_wta_vs_numpy(dtype, shape):
    from stereo_match.ops.wta import right_disparity_from_volume
    v = np.random.default_rng(9).integers(0, 900, shape).astype(dtype)
    got = np.asarray(right_disparity_from_volume(jnp.asarray(v), 2))
    _, want = _wta_numpy(v, 0, -1, False, min_d=2)
    np.testing.assert_array_equal(got, want.astype(np.float32))


@pytest.mark.parametrize("mind,tol", [(0, 1), (4, 2)])
def test_lr_mask_vs_numpy(mind, tol):
    """disp12 check, including NaN invalids and exact-.5 offsets (round
    half to even, as jnp.round)."""
    from stereo_match.ops.wta import lr_consistency_mask
    rng = np.random.default_rng(mind)
    H, W, D = 13, 70, 24
    dl = rng.uniform(mind, mind + D - 1, (H, W)).astype(np.float32)
    dl[::5, ::7] = np.round(dl[::5, ::7]) + 0.5
    dl[::9, ::11] = np.nan
    dr = rng.uniform(mind, mind + D - 1, (H, W)).astype(np.float32)
    dr[:, : W // 2] = np.round(dl[:, : W // 2])
    got = np.asarray(lr_consistency_mask(jnp.asarray(dl), jnp.asarray(dr),
                                         tol, mind))
    want = np.zeros((H, W), bool)
    for y in range(H):
        for x in range(W):
            if not np.isfinite(dl[y, x]):
                continue
            xr = int(np.round(x - dl[y, x]))
            if 0 <= xr < W:
                want[y, x] = abs(dl[y, x] - dr[y, xr]) <= tol
    np.testing.assert_array_equal(got, want)


def test_int16_volume_pipeline_equals_float32():
    """int16 and float32 census volumes give the same aggregate and the
    same disparities (all values are integers well inside int16)."""
    from stereo_match.data.synthetic import box_scene, random_dot_pair
    from stereo_match.ops.cost_volume import build_cost_volume
    from stereo_match.ops.wta import extract_disparity
    gt = box_scene(24, 56)
    left, right = random_dot_pair(24, 56, gt, blur=0.8)
    outs = []
    for dt in ("float32", "int16"):
        vol = build_cost_volume(jnp.asarray(left), jnp.asarray(right), 16,
                                dtype=dt)
        agg = sgm.sgm_aggregate(vol, P1, P2)
        assert agg.dtype == jnp.dtype(dt)
        outs.append((np.asarray(agg).astype(np.float32),
                     np.asarray(extract_disparity(agg, 0, 15, 1, True))))
    # the invalid band (x < d) holds 1e4 in float32 and 1024 in int16;
    # beyond it, and beyond the reach of the right view into it, all agree
    np.testing.assert_array_equal(outs[0][0][:, :, 16:], outs[1][0][:, :, 16:])
    np.testing.assert_allclose(outs[0][1][:, 32:], outs[1][1][:, 32:],
                               equal_nan=True, atol=1e-5)


@pytest.mark.parametrize("min_d", [0, 3])
def test_mccnn_volume_vs_numpy(min_d):
    """MC-CNN cost planes: scale * (1 - <f_L(x), f_R(x-d)>) / 2, INVALID
    where x < d, from the tower's own features, in float64 NumPy."""
    from stereo_match.models.mccnn import (MCCNNFeatures,
                                           init_params, mccnn_cost_volume,
                                           normalize_image)
    from stereo_match.ops.cost_volume import INVALID_COST
    rng = np.random.default_rng(min_d)
    H, W, D = 6, 30, 8
    left = rng.uniform(0, 255, (H, W)).astype(np.float32)
    right = rng.uniform(0, 255, (H, W)).astype(np.float32)
    model = MCCNNFeatures(features=8, num_layers=2)
    params = init_params(model, jax.random.PRNGKey(0))
    with jax.default_matmul_precision("highest"):
        got = np.asarray(mccnn_cost_volume(model, params, left, right, D,
                                           min_d))
        fl = np.asarray(model.apply(params, normalize_image(left)[None, ...,
                                                                  None])[0])
        fr = np.asarray(model.apply(params, normalize_image(right)[None, ...,
                                                                   None])[0])
    want = np.full((D, H, W), INVALID_COST, np.float64)
    for i in range(D):
        d = min_d + i
        for x in range(d, W):
            sim = np.sum(fl[:, x].astype(np.float64) * fr[:, x - d], axis=-1)
            want[i, :, x] = 24.0 * (1.0 - sim) * 0.5
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ["fast", "accurate"])
def test_mccnn_tower_vs_numpy(arch):
    """The feature tower at its stated precision (float32, highest) vs a
    float64 NumPy convolution: SAME zero padding, ReLU between layers,
    L2-normalized output."""
    from stereo_match.models.mccnn import init_params, make_model
    model = make_model(arch)
    params = init_params(model, jax.random.PRNGKey(1))
    img = np.random.default_rng(3).uniform(-1, 1, (9, 13)).astype(np.float32)
    got = np.asarray(model.apply(params, jnp.asarray(img)[None, ..., None]))[0]
    x = img[..., None].astype(np.float64)
    for i in range(model.num_layers):
        k = np.asarray(params["params"][f"conv{i}"]["kernel"], np.float64)
        b = np.asarray(params["params"][f"conv{i}"]["bias"], np.float64)
        xp = np.pad(x, ((1, 1), (1, 1), (0, 0)))
        y = np.zeros(x.shape[:2] + (k.shape[-1],))
        for dy in range(3):
            for dx in range(3):
                y += xp[dy:dy + x.shape[0], dx:dx + x.shape[1]] @ k[dy, dx]
        x = y + b
        if i < model.num_layers - 1:
            x = np.maximum(x, 0.0)
    want = x / np.sqrt(np.sum(x * x, axis=-1, keepdims=True) + 1e-12)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def _speckle_numpy(d, max_size, max_diff):
    """cv::filterSpeckles semantics by breadth-first search."""
    H, W = d.shape
    out = d.copy()
    seen = np.zeros((H, W), bool)
    for y0 in range(H):
        for x0 in range(W):
            if seen[y0, x0] or not np.isfinite(d[y0, x0]):
                continue
            comp, stack = [], [(y0, x0)]
            seen[y0, x0] = True
            while stack:
                y, x = stack.pop()
                comp.append((y, x))
                for yy, xx in ((y + 1, x), (y - 1, x), (y, x + 1), (y, x - 1)):
                    if (0 <= yy < H and 0 <= xx < W and not seen[yy, xx]
                            and np.isfinite(d[yy, xx])
                            and abs(d[yy, xx] - d[y, x]) <= max_diff):
                        seen[yy, xx] = True
                        stack.append((yy, xx))
            if len(comp) < max_size:
                for y, x in comp:
                    out[y, x] = np.nan
    return out


@pytest.mark.parametrize("H,W", [(20, 33), (17, 40), (9, 61)])
def test_speckle_vs_numpy(H, W):
    from stereo_match.ops.speckle import speckle_filter
    rng = np.random.default_rng(H)
    d = rng.normal(10, 0.2, (H, W)).astype(np.float32)
    d[rng.uniform(size=d.shape) < 0.25] = np.nan
    d[rng.uniform(size=d.shape) < 0.1] += 50
    for T in (5, 30):
        got = np.asarray(speckle_filter(jnp.asarray(d), T, 1.0))
        np.testing.assert_array_equal(got, _speckle_numpy(d, T, 1.0))


def test_speckle_cyclic_blobs_vs_numpy():
    """Blobs with cycles (a 2x2 block, a ring) are counted exactly."""
    from stereo_match.ops.speckle import speckle_filter
    d = np.full((24, 40), np.nan, np.float32)
    d[2:4, 2:4] = 7.0
    d[8:13, 8:13] = 7.0
    d[10, 10] = np.nan
    d[16:22, 20:38] = 7.0
    for T in (5, 25, 100):
        got = np.asarray(speckle_filter(jnp.asarray(d), T, 1.0))
        np.testing.assert_array_equal(got, _speckle_numpy(d, T, 1.0))


# ------------------------------------------------------- on the card only

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [np.float32, np.int16])
@pytest.mark.parametrize("shape", [(128, 375, 1242), (160, 720, 1280),
                                   (228, 64, 300)])
def test_sgm_kernel_bit_equal_on_card(card, dtype, shape):
    vol = _census_volume(shape, dtype, seed=11)
    want = np.asarray(jax.jit(sgm.sgm_aggregate, static_argnums=(1, 2))(
        vol, P1, P2))
    got = np.asarray(sgm_cuda.sgm_aggregate_auto(vol, P1, P2, 8))
    np.testing.assert_array_equal(got, want)


@pytest.mark.gpu
def test_sgm_kernel_chains_on_card(card):
    vol = _census_volume((64, 90, 200), np.float32, seed=12)
    top, bot = vol[:, :41], vol[:, 41:]
    tt, _ = sgm_cuda.sgm_paths(top, P1, P2, (0, 1))
    tb, _ = sgm_cuda.sgm_paths(bot, P1, P2, (0, 1))
    tt, c = sgm_cuda.sgm_paths(top, P1, P2, (2, 4, 6), tt)
    tb, _ = sgm_cuda.sgm_paths(bot, P1, P2, (2, 4, 6), tb, init_carry=c)
    tb, c = sgm_cuda.sgm_paths(bot, P1, P2, (3, 5, 7), tb)
    tt, _ = sgm_cuda.sgm_paths(top, P1, P2, (3, 5, 7), tt, init_carry=c)
    np.testing.assert_array_equal(
        np.concatenate([np.asarray(tt), np.asarray(tb)], axis=1),
        np.asarray(sgm.sgm_aggregate(vol, P1, P2)))


@pytest.mark.gpu
@pytest.mark.parametrize("H,W", [(375, 1242), (720, 1280)])
def test_fgs_kernel_on_card(card, H, W):
    from stereo_match.ops import wls
    rng = np.random.default_rng(13)
    guide = jnp.asarray(rng.uniform(0, 255, (H, W)).astype(np.float32))
    d = rng.uniform(2, 100, (H, W)).astype(np.float32)
    d[rng.uniform(size=d.shape) < 0.2] = np.nan
    got = np.asarray(wls.wls_filter_disparity(jnp.asarray(d), guide,
                                              80000.0, 1.2, 3))
    with backend.xla_only():
        want = np.asarray(wls.wls_filter_disparity(jnp.asarray(d), guide,
                                                   80000.0, 1.2, 3))
    np.testing.assert_allclose(got, want, rtol=1e-5)
