#!/usr/bin/env python3
"""Smoke test of the stereo engine on NVIDIA GPUs.

    python chip_smoke.py               # one card
    python chip_smoke.py --four-cards  # the multi-card paths, on four cards

One card, in one process:

* kernel phase: each GPU kernel (the CUDA SGM aggregation, the Triton WLS
  solve) compiled at the two main-path shapes -- KITTI 1242x375, D=128 and
  the reference's 1280x720, D=160 -- with ``compiled.memory_analysis()``,
  and compared once with the plain reference on the card: SGM bit-equal
  (census costs and path totals are integers below 2**24), chained row
  tiles bit-equal, WLS within ``FGS_RTOL`` of the map's largest magnitude;
* main-path phase, through the entry points a user calls, on scenes
  ray-traced from a seed with their exact ground truth:
  ``StereoMatcher(DisparityConfig())`` at 1280x720 (census 5x5, D=160,
  8 paths, WLS lambda=80000 sigma=1.2), the KITTI config (1242x375,
  D=128, no WLS), and ``run_pipeline`` on a posed, converged pair
  (rectify, match, reproject, PLY). Each prints bad-3px and EPE against
  the ground truth and the median ms/frame of the kernel path and of the
  plain XLA path (each kernel alone turned off too, where WLS runs).

``--four-cards`` runs only the multi-card paths and what they are compared
with: ``batched_matcher`` over a 4-way batch vs the single-card matcher
frame by frame, exact row-sharded SGM at 1280x720, D=160 vs single-card
SGM (bit-equal), and ``match_dsharded`` vs the single-card match.

Every check raises on a mismatch; nothing is caught. The last line of
standard output is one JSON object with the device JAX reports.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

FGS_RTOL = 1e-5      # WLS: max |kernel - plain| / max |plain|
FRAMES = 7           # timed frames per variant, after one warm-up frame


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def median_ms(fn, *args) -> float:
    import jax
    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(FRAMES):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return 1e3 * statistics.median(times)


def rectified_scene(H: int, W: int, D: int, seed: int):
    """Ray-traced rectified pair whose disparities fill ~85% of D."""
    import numpy as np
    from stereo_match.data.raytrace import render_stereo
    left, right, gt = render_stereo(H, W, seed=seed)
    top = float(np.nanmax(gt))
    if top > 0.85 * D:
        left, right, gt = render_stereo(H, W, seed=seed,
                                        baseline=0.54 * 0.85 * D / top)
    return left, right, gt


def scores(disp, gt) -> str:
    import numpy as np
    from stereo_match.eval.metrics import bad_pixel_rate, end_point_error
    d = np.asarray(disp)
    bad3 = float(bad_pixel_rate(d, gt, 3.0, 0.0))
    epe = float(end_point_error(d, gt))
    dens = float(np.isfinite(d).mean())
    return f"bad3={bad3:.4f} epe={epe:.3f}px density={dens:.3f}", bad3, epe


def check_fgs(got, want, what: str) -> float:
    import numpy as np
    got, want = np.asarray(got), np.asarray(want)
    err = float(np.max(np.abs(got - want)) / np.max(np.abs(want)))
    if not err <= FGS_RTOL:
        raise AssertionError(f"{what}: WLS kernel off by {err:.3g} of the "
                             f"map's scale (limit {FGS_RTOL})")
    return err


def check_equal(got, want, what: str) -> None:
    import numpy as np
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape or not np.array_equal(got, want,
                                                     equal_nan=True):
        bad = np.sum(~((got == want) | (np.isnan(got) & np.isnan(want))))
        raise AssertionError(f"{what}: {bad} of {want.size} values differ")


SHAPES = (("kitti", 375, 1242, 128, 1), ("720p", 720, 1280, 160, 0))


def kernel_phase(card: str) -> None:
    import jax
    import jax.numpy as jnp
    from stereo_match.config import DisparityConfig
    from stereo_match.ops import sgm, sgm_cuda
    from stereo_match.ops.cost_volume import build_cost_volume
    from stereo_match.ops.wls import wls_filter_disparity
    from stereo_match.ops.wta import extract_disparity
    from stereo_match.utils.backend import xla_only

    cfg = DisparityConfig()
    p1, p2 = cfg.P1, cfg.P2
    for name, H, W, D, seed in SHAPES:
        left, right, _ = rectified_scene(H, W, D, seed)
        l, r = jnp.asarray(left), jnp.asarray(right)
        ref_fn = jax.jit(lambda v: sgm.sgm_aggregate(v, p1, p2, 8))
        for dtype in ("float32", "int16"):
            vol = build_cost_volume(l, r, D, dtype=dtype)
            fn = jax.jit(lambda v: sgm_cuda.sgm_aggregate_auto(v, p1, p2, 8))
            compiled = fn.lower(vol).compile()
            print(f"[kernel] sgm {name} {dtype} {H}x{W} D={D} memory: "
                  f"{compiled.memory_analysis()}")
            agg = compiled(vol)
            check_equal(agg, ref_fn(vol), f"sgm {name} {dtype}")
            print(f"[kernel] sgm {name} {dtype}: bit-equal to "
                  f"ops.sgm.sgm_aggregate on {card}")
        # row tiles chained through the kernel's carries
        cut = H // 2 + 1
        top, bot = vol[:, :cut], vol[:, cut:]
        tt, _ = sgm_cuda.sgm_paths(top, p1, p2, (0, 1))
        tb, _ = sgm_cuda.sgm_paths(bot, p1, p2, (0, 1))
        tt, c = sgm_cuda.sgm_paths(top, p1, p2, (2, 4, 6), tt)
        tb, _ = sgm_cuda.sgm_paths(bot, p1, p2, (2, 4, 6), tb, init_carry=c)
        tb, c = sgm_cuda.sgm_paths(bot, p1, p2, (3, 5, 7), tb)
        tt, _ = sgm_cuda.sgm_paths(top, p1, p2, (3, 5, 7), tt, init_carry=c)
        check_equal(jnp.concatenate([tt, tb], axis=1), agg,
                    f"sgm {name} chained tiles")
        print(f"[kernel] sgm {name}: two chained row tiles bit-equal")

        disp = extract_disparity(agg)
        wls = jax.jit(lambda d, g: wls_filter_disparity(d, g, cfg.lmbda,
                                                        cfg.sigma, 3))
        compiled = wls.lower(disp, l).compile()
        print(f"[kernel] fgs {name} {H}x{W} memory: "
              f"{compiled.memory_analysis()}")
        got = compiled(disp, l)
        with xla_only("fgs"):
            want = jax.jit(lambda d, g: wls_filter_disparity(
                d, g, cfg.lmbda, cfg.sigma, 3))(disp, l)
            want.block_until_ready()
        err = check_fgs(got, want, f"fgs {name}")
        print(f"[kernel] fgs {name}: max |kernel - plain| = {err:.3g} of the "
              f"map's scale (limit {FGS_RTOL}) on {card}")


VARIANTS = (("kernels", ()), ("xla-sgm", ("sgm",)), ("xla-fgs", ("fgs",)),
            ("xla", ("sgm", "fgs")))


def time_matcher(card: str, label: str, cfg, left, right, gt,
                 variants=VARIANTS):
    """Median ms/frame of each variant; every variant's output checked
    against the kernel path's (raw bit-equal, filtered within FGS_RTOL)."""
    import contextlib

    import numpy as np
    from stereo_match.pipeline.stereo import StereoMatcher
    from stereo_match.utils.backend import xla_only

    base = None
    for name, off in variants:
        with (xla_only(*off) if off else contextlib.nullcontext()):
            matcher = StereoMatcher(cfg)
            ms = median_ms(matcher, left, right)
            raw, filt = (np.asarray(x) for x in matcher(left, right))
        if base is None:
            base = (raw, filt)
            text, bad3, epe = scores(filt, gt)
            print(f"[main] {label}: {text} on {card}")
            if not (bad3 < 0.25 and epe < 3.0):
                raise AssertionError(f"{label}: accuracy out of bounds")
        else:
            check_equal(raw, base[0], f"{label} {name} raw")
            (check_fgs if cfg.wls else check_equal)(
                filt, base[1], f"{label} {name} filtered")
        print(f"[time] {label} {name}: {ms:.3f} ms/frame "
              f"(median of {FRAMES}) on {card}")
    return base


def posed_pipeline(card: str, H: int, W: int, cfg) -> None:
    """run_pipeline on a converged posed pair, scored against the disparity
    the scene gives in the rectified frame."""
    import numpy as np
    from stereo_match.core.camera import intrinsic_from_params, rodrigues
    from stereo_match.data.ply import read_ply
    from stereo_match.data.raytrace import (default_scene, render_view,
                                            scene_surface_distance)
    from stereo_match.pipeline.stereo import run_pipeline

    scene = default_scene(3)
    f = 0.58 * W
    K = intrinsic_from_params(f, f, W / 2.0, H / 2.0)
    pose_l = np.eye(4)
    img_l, pts = render_view(H, W, K, pose_l, scene=scene)
    baseline = 0.8 * cfg.num_disparities * float(np.min(pts[..., 2])) / f
    pose_r = np.eye(4)
    pose_r[:3, :3] = rodrigues([0.008, -0.035, 0.005])
    pose_r[:3, 3] = [baseline, 0.03 * baseline, 0.04 * baseline]
    img_r, _ = render_view(H, W, K, pose_r, scene=scene)

    with tempfile.TemporaryDirectory() as tmp:
        ply = os.path.join(tmp, "cloud.ply")
        t0 = time.perf_counter()
        res = run_pipeline(pose_l, pose_r, K, K, img_l, img_r, config=cfg,
                           alpha=0.0, ply_path=ply)
        first_s = time.perf_counter() - t0
        verts, _ = read_ply(ply)
    rect = res.rectification
    # ground truth: trace the rectified left camera, project into both
    cam = np.eye(4)
    cam[:3, :3] = pose_l[:3, :3] @ rect.R1.T
    cam[:3, 3] = pose_l[:3, 3]
    _, world = render_view(H, W, rect.P1[:, :3], cam, scene=scene)
    x_rect = (world.reshape(-1, 3) - pose_l[:3, 3]) @ (pose_l[:3, :3]
                                                      @ rect.R1.T)
    xh = np.concatenate([x_rect, np.ones((len(x_rect), 1))], axis=1)
    u1, u2 = xh @ rect.P1.T, xh @ rect.P2.T
    gt = (u1[:, 0] / u1[:, 2] - u2[:, 0] / u2[:, 2]).reshape(H, W)
    text, bad3, epe = scores(res.disparity_filtered, gt)
    pts_w = (res.points.reshape(-1, 3) @ rect.R1) @ pose_l[:3, :3].T \
        + pose_l[:3, 3]
    # depth error grows as Z^2 / (f B): score the nearer part of the scene,
    # disparities above D/6, as the pose-driven test does
    raw = res.disparity.reshape(-1)
    sel = np.isfinite(raw) & (raw > cfg.num_disparities / 6)
    dist = float(np.median(scene_surface_distance(scene, pts_w[sel])))
    print(f"[main] run_pipeline posed {W}x{H} D={cfg.num_disparities}: "
          f"{text} "
          f"(ground truth without occlusion masking), median surface "
          f"distance {dist:.4f} (disparity > D/6), {len(verts)} PLY "
          f"vertices, first call "
          f"{first_s:.1f} s with compile, on {card}")
    if not (dist < 0.15 and len(verts) > 1000 and epe < 5.0):
        raise AssertionError("run_pipeline: reconstruction out of bounds")


def main_path_phase(card: str) -> None:
    from stereo_match.config import DisparityConfig

    left, right, gt = rectified_scene(720, 1280, 160, 0)
    time_matcher(card, "StereoMatcher 1280x720 D=160 WLS", DisparityConfig(),
                 left, right, gt)
    left, right, gt = rectified_scene(375, 1242, 128, 1)
    kitti = DisparityConfig(num_disparities=128, wls=False)
    time_matcher(card, "KITTI 1242x375 D=128", kitti, left, right, gt,
                 variants=(VARIANTS[0], VARIANTS[-1]))
    time_matcher(card, "KITTI 1242x375 D=128 WLS", kitti.replace(wls=True),
                 left, right, gt)
    posed_pipeline(card, 720, 1280, DisparityConfig())


def four_card_phase(card: str, H: int, W: int, D: int) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np
    from stereo_match.config import DisparityConfig
    from stereo_match.ops.cost_volume import build_cost_volume
    from stereo_match.ops.sgm_cuda import sgm_aggregate_auto
    from stereo_match.parallel.batch import batched_matcher
    from stereo_match.parallel.dsharding import (make_disp_mesh,
                                                 match_dsharded)
    from stereo_match.parallel.mesh import make_mesh
    from stereo_match.parallel.tiling import sgm_aggregate_sharded
    from stereo_match.pipeline.stereo import StereoMatcher, _match_core

    if len(jax.devices()) < 4:
        raise RuntimeError(f"--four-cards needs 4 GPUs, "
                           f"found {len(jax.devices())}")
    cfg = DisparityConfig(num_disparities=D)
    shape = f"{W}x{H} D={D}"
    scenes = [rectified_scene(H, W, D, s) for s in range(4)]
    lefts = np.stack([s[0] for s in scenes])
    rights = np.stack([s[1] for s in scenes])

    fn = batched_matcher(cfg, make_mesh(batch=4, rows=1))
    raw, filt = fn(lefts, rights)
    ms4 = median_ms(fn, lefts, rights)
    single = StereoMatcher(cfg)
    for i in range(4):
        r1, f1 = single(lefts[i], rights[i])
        check_equal(raw[i], r1, f"batched frame {i} raw")
        check_fgs(filt[i], f1, f"batched frame {i} filtered")
    ms1 = median_ms(single, lefts[0], rights[0])
    print(f"[4 cards] batched_matcher 4 x {shape} WLS: equal to the "
          f"single-card matcher frame by frame; {ms4:.3f} ms per batch of 4 "
          f"vs {ms1:.3f} ms per frame on one card ({card})")

    vol = build_cost_volume(jnp.asarray(lefts[0]), jnp.asarray(rights[0]),
                            cfg.num_disparities)
    one = sgm_aggregate_auto(vol, cfg.P1, cfg.P2, 8)
    mesh = make_mesh(batch=1, rows=4)
    sharded = jax.jit(lambda v: sgm_aggregate_sharded(
        v, cfg.P1, cfg.P2, mesh, 8, mode="exact"))
    check_equal(sharded(vol), one, "row-sharded exact SGM")
    ms_sh = median_ms(sharded, vol)
    ms_one = median_ms(lambda v: sgm_aggregate_auto(v, cfg.P1, cfg.P2, 8),
                       vol)
    print(f"[4 cards] sgm_aggregate_sharded(mode='exact') rows=4 {shape}: "
          f"bit-equal to single-card SGM; {ms_sh:.3f} ms vs "
          f"{ms_one:.3f} ms on one card ({card})")

    dmesh = make_disp_mesh(4)
    got = match_dsharded(lefts[0], rights[0], cfg, dmesh, mode="exact")
    want = jax.jit(lambda l, r: _match_core(l, r, cfg.replace(wls=False))[0])(
        jnp.asarray(lefts[0]), jnp.asarray(rights[0]))
    check_equal(got, want, "match_dsharded")
    print(f"[4 cards] match_dsharded(mode='exact') {shape}: equal to the "
          f"single-card match ({card})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-card paths, on 4 cards")
    args = ap.parse_args(argv)

    import jax
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"error: no GPU (JAX found {devices[0].platform})",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from stereo_match.utils.backend import use_compile_cache
    print(f"compile cache: {use_compile_cache()}")
    card = card_line()
    print(f"card: {card}")
    print(f"jax {jax.__version__}, {len(devices)} x {devices[0].device_kind}")

    t0 = time.perf_counter()
    # every comparison with a reference at full matmul precision (a float32
    # matmul or conv may run as TF32 otherwise)
    with jax.default_matmul_precision("highest"):
        if args.four_cards:
            four_card_phase(card, 720, 1280, 160)
        else:
            kernel_phase(card)
            print(f"kernel phase done in {time.perf_counter() - t0:.1f} s")
            main_path_phase(card)
    print(f"done in {time.perf_counter() - t0:.1f} s; flax imported: "
          f"{'flax' in sys.modules}")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
