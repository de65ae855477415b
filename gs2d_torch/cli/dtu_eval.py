"""DTU harness of the port: train → mesh → chamfer per scan.

    python -m gs2d_torch.cli.dtu_eval --dtu <preprocessed DTU> \
        [--DTU <official eval data>] [-o out]

After the JAX package's ``scripts/dtu_eval.py:38-70`` (the reference's
``scripts/dtu_eval.py``): each scan is trained with ``-r 2 --depth_ratio 1
--lambda_dist 1000``, meshed by the render CLI with the fixed TSDF
parameters (``MESH_FLAGS``: voxel 0.004, sdf_trunc 0.016, depth_trunc 3.0,
one cluster kept), and, where ``--DTU`` holds the official ObsMask and
Points, scored by ``eval.dtu.evaluate_scan`` after the mask cull of the
scan's ``cameras.npz`` and ``mask/`` (its dilations on ``--device``). The
scores go to ``<out>/results.json``. The CLIs run in this process;
``--device`` goes to both, and any other flag to the train CLI.
``main(argv)`` returns {scan: scores}.
"""

from __future__ import annotations

import argparse
import json
import os

SCANS = [24, 37, 40, 55, 63, 65, 69, 83, 97, 105, 106, 110, 114, 118, 122]
TRAIN_FLAGS = ["-r", "2", "--depth_ratio", "1.0", "--lambda_dist", "1000"]
MESH_FLAGS = ["--num_cluster", "1", "--voxel_size", "0.004", "--sdf_trunc",
              "0.016", "--depth_trunc", "3.0"]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="gs2d_torch DTU eval")
    ap.add_argument("--dtu", "-dtu", required=True,
                    help="preprocessed DTU dataset root (scan<id> dirs)")
    ap.add_argument("--DTU", default=None,
                    help="official eval data (ObsMask + Points)")
    ap.add_argument("--output_path", "-o", default="./eval/dtu")
    ap.add_argument("--scans", nargs="+", type=int, default=SCANS)
    ap.add_argument("--skip_training", action="store_true")
    ap.add_argument("--skip_rendering", action="store_true")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default) or cpu")
    return ap


def main(argv=None) -> dict:
    from ..eval.dtu import evaluate_scan
    from ..scene.scene import search_max_iteration
    from . import render, train
    args, train_extra = build_parser().parse_known_args(argv)
    dev = ["--device", args.device]
    results = {}
    for scan in args.scans:
        src = os.path.join(args.dtu, f"scan{scan}")
        out = os.path.join(args.output_path, f"scan{scan}")
        if not args.skip_training:
            train.main(["-s", src, "-m", out] + TRAIN_FLAGS + dev
                       + train_extra)
        if not args.skip_rendering:
            render.main(["-m", out, "--skip_train", "--skip_test"]
                        + MESH_FLAGS + dev)
        it = search_max_iteration(os.path.join(out, "point_cloud"))
        mesh = os.path.join(out, "train", f"ours_{it}", "fuse_post.ply")
        if args.DTU:
            gt = os.path.join(args.DTU, "Points", "stl",
                              f"stl{scan:03d}_total.ply")
            obs = os.path.join(args.DTU, "ObsMask", f"ObsMask{scan}_10.mat")
            # the protocol culls by the scan's dilated per-view masks
            # before sampling (reference evaluate_single_scene.py:19-101);
            # scan dirs lacking cameras.npz/mask are scored uncut
            r = evaluate_scan(mesh, gt, obs, scan_dir=src,
                              device=args.device)
            results[scan] = r
            print(f"scan{scan}: chamfer {r['overall']:.4f} "
                  f"(d2s {r['mean_d2s']:.4f} s2d {r['mean_s2d']:.4f})")
    if results:
        mean = sum(r["overall"] for r in results.values()) / len(results)
        print("mean chamfer:", mean)
        os.makedirs(args.output_path, exist_ok=True)
        with open(os.path.join(args.output_path, "results.json"), "w") as f:
            json.dump({"per_scan": {str(k): v for k, v in results.items()},
                       "mean": mean}, f, indent=2)
    return results


if __name__ == "__main__":
    main()
