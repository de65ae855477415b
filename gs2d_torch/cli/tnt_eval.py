"""Tanks and Temples harness of the port: train → mesh → F-score.

    python -m gs2d_torch.cli.tnt_eval --TNT_data <scenes> \
        [--TNT_GT <official GT>] [-o out]

After the JAX package's ``scripts/tnt_eval.py`` (the reference's
``scripts/tnt_eval.py``): each scene is trained with ``-r 2
--depth_ratio 1`` and λ_dist 100 (the 360° scenes) or 10 (the large
ones), meshed by the render CLI with its class's TSDF parameters
(``MESH_360``, ``MESH_LARGE``; both bounded, as the reference runs them),
its COLMAP poses written as the estimated trajectory (``.log``), and,
where ``--TNT_GT`` holds the scene's GT cloud, alignment, SfM log and crop
volume, scored by ``eval.tnt.run_tnt_evaluation`` (precision, recall and
F-score at the scene's τ; curves under ``<out>/<scene>/tnt_eval``). The
scores go to ``<out>/results.json``. The CLIs run in this process;
``--device`` goes to both, and any other flag to the train CLI.
``main(argv)`` returns {scene: scores}.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

SCENES_360 = ["Barn", "Caterpillar", "Ignatius", "Truck"]
SCENES_LARGE = ["Meetingroom", "Courthouse"]
MESH_360 = ["--num_cluster", "1", "--voxel_size", "0.004", "--sdf_trunc",
            "0.016", "--depth_trunc", "3.0"]
MESH_LARGE = ["--num_cluster", "1", "--voxel_size", "0.006", "--sdf_trunc",
              "0.024", "--depth_trunc", "4.5"]


def export_trajectory(src: str, out_log: str) -> None:
    """The scene's COLMAP poses, name-sorted, camera-to-world, as a TnT
    ``.log``: the trajectory the protocol registers against the GT SfM
    log."""
    from ..eval.tnt import write_trajectory_log
    from ..scene.colmap import (detect_model_dir, qvec2rotmat,
                                read_images_binary, read_images_text)
    model = detect_model_dir(src)
    bin_path = os.path.join(model, "images.bin")
    imgs = (read_images_binary(bin_path) if os.path.exists(bin_path)
            else read_images_text(os.path.join(model, "images.txt")))
    poses = []
    for img in sorted(imgs.values(), key=lambda im: im.name):
        R = qvec2rotmat(img.qvec)
        c2w = np.eye(4)
        c2w[:3, :3] = R.T
        c2w[:3, 3] = -R.T @ img.tvec
        poses.append(c2w)
    write_trajectory_log(out_log, np.stack(poses))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="gs2d_torch TnT eval")
    ap.add_argument("--TNT_data", required=True)
    ap.add_argument("--TNT_GT", default=None)
    ap.add_argument("--output_path", "-o", default="./eval/tnt")
    ap.add_argument("--scenes", nargs="+", default=SCENES_360 + SCENES_LARGE)
    ap.add_argument("--skip_training", action="store_true")
    ap.add_argument("--skip_rendering", action="store_true")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default) or cpu")
    return ap


def main(argv=None) -> dict:
    from ..eval.tnt import run_tnt_evaluation
    from ..scene.scene import search_max_iteration
    from . import render, train
    args, train_extra = build_parser().parse_known_args(argv)
    dev = ["--device", args.device]
    results = {}
    for scene in args.scenes:
        src = os.path.join(args.TNT_data, scene)
        out = os.path.join(args.output_path, scene)
        lam = "100" if scene in SCENES_360 else "10"
        if not args.skip_training:
            train.main(["-s", src, "-m", out, "-r", "2", "--depth_ratio",
                        "1.0", "--lambda_dist", lam] + dev + train_extra)
        if not args.skip_rendering:
            render.main(["-m", out, "--skip_test"] + (
                MESH_360 if scene in SCENES_360 else MESH_LARGE) + dev)
        if args.TNT_GT:
            it = search_max_iteration(os.path.join(out, "point_cloud"))
            # the render CLI meshes both classes bounded: fuse_post.ply
            mesh = os.path.join(out, "train", f"ours_{it}", "fuse_post.ply")
            traj = os.path.join(out, f"{scene}_traj.log")
            export_trajectory(src, traj)
            r = run_tnt_evaluation(mesh, os.path.join(args.TNT_GT, scene),
                                   traj, os.path.join(out, "tnt_eval"),
                                   scene=scene)
            r.pop("transform", None)
            r = {k: (v.tolist() if hasattr(v, "tolist") else v)
                 for k, v in r.items()}
            results[scene] = r
            print(f"{scene}: F1 {r['fscore']:.4f} "
                  f"(p {r['precision']:.4f} r {r['recall']:.4f})")
    if results:
        mean = sum(r["fscore"] for r in results.values()) / len(results)
        print("mean F1:", mean)
        os.makedirs(args.output_path, exist_ok=True)
        with open(os.path.join(args.output_path, "results.json"), "w") as f:
            json.dump({"per_scene": results, "mean_f1": mean}, f, indent=2)
    return results


if __name__ == "__main__":
    main()
