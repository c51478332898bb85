"""Reproducible recipe for the shipped MC-CNN checkpoint.

Trains the `fast` feature tower on a multi-scene synthetic pool (box /
slanted / rough-terrain disparity, noise and blur augmentation) and writes
``stereo_match/models/weights/mccnn_fast.npz`` — the framework's analog
of the reference's pretrained ``net_kitti_fast_-a_train_all.t7``
(``/root/reference/mc_cnn/script.py:9``).

    JAX_PLATFORMS= JAX_PLATFORM_NAME=cpu python tools/train_mccnn.py

Then evaluates the checkpoint against the census cost on held-out noisy
scenes (the ``mccnn_vs_census`` block of tools/accuracy_eval.py).
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="fast", choices=["fast", "accurate"])
    ap.add_argument("--scenes", type=int, default=27)
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--output", default=None,
                    help="default: the packaged weights path")
    args = ap.parse_args()

    import jax
    import numpy as np
    from stereo_match.models import mccnn

    A, P, N = mccnn.make_training_pool(args.scenes, seed=args.seed)
    print(f"pool: {len(A)} triplets", file=sys.stderr)
    model = mccnn.make_model(args.arch)
    params = mccnn.init_params(model, jax.random.PRNGKey(0))
    bs = args.batch
    batches = [(A[i:i + bs], P[i:i + bs], N[i:i + bs])
               for _ in range(args.epochs)
               for i in range(0, len(A) - bs + 1, bs)]
    params, losses = mccnn.train(model, params, batches,
                                 learning_rate=args.lr)
    print(f"hinge loss {losses[0]:.4f} -> {losses[-1]:.4f}", file=sys.stderr)

    out = args.output or mccnn.default_checkpoint_path(args.arch)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    mccnn.save_params_npz(out, params)
    print(f"wrote {out}", file=sys.stderr)

    # held-out eval: learned cost vs census through the same SGM pipeline
    from stereo_match.config import DisparityConfig
    from stereo_match.costs import MCCNNCost
    from stereo_match.data.synthetic import (box_scene, random_dot_pair,
                                             rough_scene)
    from stereo_match.eval.metrics import bad_pixel_rate
    from stereo_match.pipeline.stereo import StereoMatcher
    cfg_c = DisparityConfig(num_disparities=32, cost="census",
                            uniqueness_ratio=15, disp12_max_diff=1,
                            wls=False)
    cfg_m = cfg_c.replace(cost="mccnn")
    m_census = StereoMatcher(cfg_c)
    m_mccnn = StereoMatcher(cfg_m, cost_fn=MCCNNCost(model, params, cfg_m))
    report = {}
    for noise in (0.0, 10.0, 25.0):
        bc, bm = [], []
        for s in range(4):
            gt = rough_scene(96, 160, 999 + s, 2, 24) if s % 2 else \
                box_scene(96, 160, 3 + s, 14 + s)
            l, r = random_dot_pair(96, 160, gt, blur=1.0, seed=555 + s,
                                   noise=noise)
            dc, _ = m_census(l, r)
            dm, _ = m_mccnn(l, r)
            bc.append(float(bad_pixel_rate(np.asarray(dc), gt, 3.0, 0.0)))
            bm.append(float(bad_pixel_rate(np.asarray(dm), gt, 3.0, 0.0)))
        report[f"noise_{noise:g}"] = {"census_bad3": round(float(np.mean(bc)), 4),
                                      "mccnn_bad3": round(float(np.mean(bm)), 4)}
        print(f"noise={noise:5.1f} census={np.mean(bc):.4f} "
              f"mccnn={np.mean(bm):.4f}", file=sys.stderr)

    # out-of-renderer transfer: the RAY-TRACED family is fully held out
    # of the training pool (see make_training_pool — training mixes
    # dots / shaded-shapes / adversarial), so this is honest
    # generalization evidence (the gate tools/accuracy_eval.py / test_mccnn.py
    # enforce: learned <= census, clean AND corrupted)
    from stereo_match.data.raytrace import render_stereo
    oor = {}
    for tag, kw in (("clean", {}),
                    ("noise_gain", {"noise": 6.0, "gain_right": 1.2})):
        bc, bm = [], []
        for s in range(3):
            l, r, gt = render_stereo(96, 160, seed=808 + s, **kw)
            dc, _ = m_census(l, r)
            dm, _ = m_mccnn(l, r)
            bc.append(float(bad_pixel_rate(np.asarray(dc), gt, 3.0, 0.0)))
            bm.append(float(bad_pixel_rate(np.asarray(dm), gt, 3.0, 0.0)))
        oor[tag] = {"census_bad3": round(float(np.mean(bc)), 4),
                    "mccnn_bad3": round(float(np.mean(bm)), 4)}
        print(f"out_of_renderer {tag:16s} census={np.mean(bc):.4f} "
              f"mccnn={np.mean(bm):.4f}", file=sys.stderr)
    print(json.dumps({"checkpoint": out, "held_out_bad3": report,
                      "out_of_renderer": oor}))


if __name__ == "__main__":
    main()
