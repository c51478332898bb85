"""Multi-card scaling benchmark: frames/s at 1..N devices.

Measures both distribution modes:

* data-parallel batches (``parallel/batch.py``) — the production streaming
  mode, expected ~linear;
* row-tiled single pairs (``parallel/tiling.py``) — the latency mode whose
  vertical carry chain serializes part of the work.

Run on the GPUs of one host under the default platform; on a dev box it
runs on the simulated CPU mesh (set ``--cpu-devices N``), which validates
the harness and the sharding, not device speed.

Output: one JSON line per device count.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def measure(n_devices: int, height: int, width: int, disparities: int,
            reps: int = 3) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np
    from stereo_match.config import DisparityConfig
    from stereo_match.parallel.batch import batched_matcher
    from stereo_match.parallel.mesh import make_mesh
    from stereo_match.parallel.tiling import sgm_aggregate_sharded
    from stereo_match.ops.cost_volume import build_cost_volume

    devices = jax.devices()[:n_devices]
    rng = np.random.default_rng(0)
    cfg = DisparityConfig(num_disparities=disparities, uniqueness_ratio=0,
                          wls=False, speckle_window_size=0)

    # --- data-parallel: one frame per device per step ---
    mesh_dp = make_mesh(batch=n_devices, rows=1, devices=devices)
    fn = batched_matcher(cfg, mesh_dp)
    lefts = rng.uniform(0, 255, (n_devices, height, width)).astype(np.float32)
    rights = rng.uniform(0, 255, (n_devices, height, width)).astype(np.float32)
    raw, _ = fn(lefts, rights)
    jax.block_until_ready(raw)
    t0 = time.perf_counter()
    for _ in range(reps):
        raw, _ = fn(lefts, rights)
        jax.block_until_ready(raw)
    dp_fps = reps * n_devices / (time.perf_counter() - t0)

    # --- row-tiled single pair (8-path, halo mode) ---
    mesh_rows = make_mesh(batch=1, rows=n_devices, devices=devices)
    h_pad = -(-height // n_devices) * n_devices
    left = jnp.asarray(rng.uniform(0, 255, (h_pad, width)).astype(np.float32))
    right = jnp.asarray(rng.uniform(0, 255, (h_pad, width)).astype(np.float32))

    @jax.jit
    def tiled(l, r):
        vol = build_cost_volume(l, r, disparities)
        return sgm_aggregate_sharded(vol, cfg.P1, cfg.P2, mesh_rows, 8,
                                     mode="halo", halo=32)

    out = tiled(left, right)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        jax.block_until_ready(tiled(left, right))
    tiled_fps = reps / (time.perf_counter() - t0)

    return {"devices": n_devices, "dp_fps": round(dp_fps, 2),
            "rowtiled_fps": round(tiled_fps, 2)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--height", type=int, default=368)
    ap.add_argument("--width", type=int, default=1248)
    ap.add_argument("--disparities", type=int, default=128)
    ap.add_argument("--max-devices", type=int, default=None)
    ap.add_argument("--cpu-devices", type=int, default=0,
                    help="simulate N virtual CPU devices (validation mode)")
    args = ap.parse_args(argv)

    if args.cpu_devices:
        import os
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + f" --xla_force_host_platform_device_count={args.cpu_devices}")
        import jax
        jax.config.update("jax_platforms", "cpu")
    import jax
    n_all = len(jax.devices())
    counts = []
    n = 1
    while n <= (args.max_devices or n_all):
        counts.append(n)
        n *= 2
    base = None
    for n in counts:
        r = measure(n, args.height, args.width, args.disparities)
        if base is None:
            base = r["dp_fps"]
        r["dp_scaling"] = round(r["dp_fps"] / (base * n), 3) if base else None
        print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()
