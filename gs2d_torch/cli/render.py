"""Render + mesh extraction CLI of the port.

    python -m gs2d_torch.cli.render -m <model dir> [--unbounded]

The surface of the JAX package's ``render.py`` (the reference's
``python render.py -m <model>``): train/test renders and vis maps under
``<model>/{train,test}/ours_<iteration>``, an optional ellipse-path video
(``--render_path``: the frames as PNGs and ``render_traj.avi``, an
uncompressed AVI, under ``<model>/traj/ours_<iteration>``; the JAX CLI
writes an mp4v file through cv2), and a TSDF-fused mesh with the
reference's automatic parameters (depth_trunc = 2·radius, voxel =
depth_trunc / mesh_res, sdf_trunc = 5·voxel), meshed at SH degree 0.
Bounded fusion by default, ``--unbounded`` for the contracted variant.
``--device`` (default ``cuda``) picks the device.

``main(argv)`` returns the iteration, the output directory, the video's
path and the mesh's path and counts.
"""

from __future__ import annotations

import argparse
import dataclasses
import os


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="gs2d_torch render + mesh")
    ap.add_argument("--model_path", "-m", required=True)
    ap.add_argument("--source_path", "-s", default=None)
    ap.add_argument("--iteration", type=int, default=-1)
    ap.add_argument("--skip_train", action="store_true")
    ap.add_argument("--skip_test", action="store_true")
    ap.add_argument("--skip_mesh", action="store_true")
    ap.add_argument("--render_path", action="store_true")
    ap.add_argument("--voxel_size", type=float, default=-1.0)
    ap.add_argument("--depth_trunc", type=float, default=-1.0)
    ap.add_argument("--sdf_trunc", type=float, default=-1.0)
    ap.add_argument("--num_cluster", type=int, default=50)
    ap.add_argument("--mesh_res", type=int, default=1024)
    ap.add_argument("--unbounded", action="store_true")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default) or cpu")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    import torch

    from ..config import load_cfg_args
    from ..render.extract import (GaussianExtractor, post_process_mesh,
                                  save_mesh)
    from ..scene.scene import Scene

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch finds no CUDA device; "
                           "pass --device cpu to render on the CPU")
    model, pipe, _ = load_cfg_args(os.path.join(args.model_path,
                                                "cfg_args.json"))
    if args.source_path:
        model.source_path = args.source_path
    model.model_path = args.model_path

    scene = Scene(model, load_iteration=args.iteration, shuffle=False,
                  device=device)
    iteration = scene.loaded_iter
    print(f"rendering model at iteration {iteration}")

    bg = (1.0, 1.0, 1.0) if model.white_background else (0.0, 0.0, 0.0)
    extractor = GaussianExtractor(
        scene.gaussians, max_sh_degree=model.sh_degree,
        depth_ratio=pipe.depth_ratio, bg_color=bg, device=device)

    train_dir = os.path.join(args.model_path, "train", f"ours_{iteration}")
    test_dir = os.path.join(args.model_path, "test", f"ours_{iteration}")
    result = {"iteration": iteration, "train_dir": train_dir}

    if not args.skip_train:
        extractor.reconstruction(scene.get_train_cameras())
        extractor.export_image(train_dir)
    if not args.skip_test and scene.get_test_cameras():
        extractor.reconstruction(scene.get_test_cameras())
        extractor.export_image(test_dir)
    if args.render_path:
        from ..scene.cameras import CameraData
        from ..utils.render_paths import create_video, generate_path
        cams = generate_path(scene.get_train_cameras(), n_frames=240)
        extractor.reconstruction([CameraData(camera=c) for c in cams])
        frames = [r.permute(1, 2, 0).cpu().numpy()
                  for r in extractor.rgbmaps]
        traj_dir = os.path.join(args.model_path, "traj", f"ours_{iteration}")
        extractor.export_image(traj_dir)
        result["video"] = os.path.join(traj_dir, "render_traj.avi")
        create_video(frames, result["video"])

    if not args.skip_mesh:
        # meshing uses diffuse colour only (reference render.py:93)
        extractor.state = dataclasses.replace(scene.gaussians,
                                              active_sh_degree=0)
        extractor.reconstruction(scene.get_train_cameras())
        os.makedirs(train_dir, exist_ok=True)
        if args.unbounded:
            name = "fuse_unbounded.ply"
            verts, faces, colors = extractor.extract_mesh_unbounded(
                resolution=args.mesh_res)
        else:
            name = "fuse.ply"
            _, radius = extractor.estimate_bounding_sphere()
            depth_trunc = (radius * 2.0) if args.depth_trunc < 0 else \
                args.depth_trunc
            voxel_size = (depth_trunc / args.mesh_res) if \
                args.voxel_size < 0 else args.voxel_size
            sdf_trunc = 5.0 * voxel_size if args.sdf_trunc < 0 else \
                args.sdf_trunc
            verts, faces, colors = extractor.extract_mesh_bounded(
                voxel_size=voxel_size, sdf_trunc=sdf_trunc,
                depth_trunc=depth_trunc)
        mesh_path = os.path.join(train_dir, name)
        save_mesh(mesh_path, verts, faces, colors)
        print(f"mesh saved at {mesh_path}: {len(verts)} verts "
              f"{len(faces)} faces")
        v2, f2, c2 = post_process_mesh(verts, faces, colors,
                                       num_cluster=args.num_cluster)
        save_mesh(mesh_path.replace(".ply", "_post.ply"), v2, f2, c2)
        print(f"post-processed mesh: {len(v2)} verts {len(f2)} faces")
        result.update(mesh=mesh_path, verts=len(verts), faces=len(faces),
                      post_verts=len(v2), post_faces=len(f2))
    return result


if __name__ == "__main__":
    main()
