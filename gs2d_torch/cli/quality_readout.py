"""Quality readout of a model of the rich synthetic scene: NVS metrics and
the mesh's chamfer distance to the true surfaces.

    python -m gs2d_torch.cli.quality_readout --model <model> --data <dataset>
        [--iteration 30000] [--mesh_res 1024] [--out <json>]

The port's ``scripts/quality_readout.py``: the test split rendered by the
port's render CLI (``--skip_train --skip_mesh``, in this process), scored
by its metrics CLI (``results.json`` → ``nvs``); then the bounded TSDF mesh
at ``--mesh_res`` by the render CLI in a child process that is stopped
after 2100 s, retried at half the resolution (900 s) if it fails or runs
out of time (``mesh_res`` records the one that ran, ``mesh_error`` what
failed); then the bidirectional chamfer distance between area samples of
the mesh and samples of the scene's true surfaces
(``bench_scenes.make_trained_like_scene``: the torus, the ground disc and
the background shell), both cropped to the foreground r < 1.6. The record
is written to ``--out`` (default ``<model>/quality_readout.json``) after
each stage; the JAX script writes ``QUALITY_scale.json`` at its repo root,
the port writes nothing outside the model. ``--device`` (default ``cuda``)
goes to both CLIs. ``main(argv)`` returns the record.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MESH_BUDGETS_S = (2100, 900)       # full resolution, then half
FOREGROUND_R = 1.6                 # torus + disc; the shell lies at r ~ 4


def gt_surface_points(n=200_000, seed=7):
    """Samples of the rich scene's true surfaces: the surfel centres of
    ``make_trained_like_scene``, which lie on them."""
    from ..utils.bench_scenes import make_trained_like_scene
    pts, _, _, _, _ = make_trained_like_scene(n, seed=seed, overlap=2.0)
    return np.asarray(pts, np.float32)


def chamfer(a, b, block=8192):
    """Mean nearest-neighbour distance a → b and b → a: a KD-tree where
    scipy imports, else blockwise NumPy (minutes at 10^5 x 10^5)."""
    try:
        from scipy.spatial import cKDTree
    except ImportError:
        def one_way(x, y):
            mins = np.empty(len(x), np.float32)
            for i in range(0, len(x), block):
                d = ((x[i:i + block, None, :] - y[None, :, :]) ** 2).sum(-1)
                mins[i:i + block] = d.min(1)
            return np.sqrt(mins).mean()
    else:
        def one_way(x, y):
            return float(cKDTree(y).query(x, workers=-1)[0].mean())
    return float(one_way(a, b)), float(one_way(b, a))


def find_mesh(model: str, iteration: int):
    """The post-processed mesh of the iteration, else its raw mesh, else
    the first ``fuse*.ply`` under the model (the JAX script's search)."""
    for cand in ("fuse_post.ply", "fuse.ply"):
        for p in (os.path.join(model, "train", f"ours_{iteration}", cand),
                  os.path.join(model, cand)):
            if os.path.exists(p):
                return p
    for dirpath, _, files in os.walk(model):
        for fn in sorted(files):
            if fn.startswith("fuse") and fn.endswith(".ply"):
                return os.path.join(dirpath, fn)
    return None


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="gs2d_torch quality readout")
    ap.add_argument("--model", default="/tmp/rich_run")
    ap.add_argument("--data", default="/tmp/rich_1080p")
    ap.add_argument("--iteration", type=int, default=30000)
    ap.add_argument("--skip_render", action="store_true")
    ap.add_argument("--mesh_gt_samples", type=int, default=100_000)
    ap.add_argument("--mesh_res", type=int, default=1024)
    ap.add_argument("--out", default=None,
                    help="the record (default <model>/quality_readout.json)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default) or cpu")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    from . import metrics, render

    out = args.out or os.path.join(args.model, "quality_readout.json")
    rec = {"ts": time.time(), "model": args.model,
           "iteration": args.iteration}

    def flush_rec():
        with open(out, "w") as f:
            json.dump(rec, f, indent=1)

    render_flags = ["-m", args.model, "-s", args.data, "--iteration",
                    str(args.iteration), "--skip_train", "--device",
                    args.device]

    # stage 1: test-split renders → NVS metrics, kept apart from the mesh
    # stage so that a TSDF failure cannot cost this half of the record
    if not args.skip_render:
        print("=== render test split ===", flush=True)
        render.main(render_flags + ["--skip_mesh"])
    print("=== metrics ===", flush=True)
    metrics.main(["-m", args.model, "--device", args.device])
    with open(os.path.join(args.model, "results.json")) as f:
        rec["nvs"] = json.load(f)
    flush_rec()

    # stage 2: the mesh, in a child process so that it can be stopped at
    # its time limit, retried at half the resolution
    if not args.skip_render:
        for res_try, budget_s in zip((args.mesh_res, args.mesh_res // 2),
                                     MESH_BUDGETS_S):
            print(f"=== mesh extraction @ {res_try} ===", flush=True)
            try:
                subprocess.run(
                    [sys.executable, "-m", "gs2d_torch.cli.render"]
                    + render_flags + ["--skip_test", "--mesh_res",
                                      str(res_try)],
                    check=True, cwd=REPO, timeout=budget_s)
                rec["mesh_res"] = res_try
                flush_rec()
                break
            except (subprocess.CalledProcessError,
                    subprocess.TimeoutExpired) as e:
                print(f"mesh @ {res_try} failed: {e!r}", flush=True)
                rec["mesh_error"] = f"{res_try}: {type(e).__name__}"
                flush_rec()

    mesh_path = find_mesh(args.model, args.iteration)
    rec["mesh_path"] = mesh_path
    if mesh_path:
        from ..eval.geometry import sample_mesh_points
        from ..scene.ply import read_mesh_ply
        verts, faces = read_mesh_ply(mesh_path)[:2]
        rec["mesh_verts"] = int(len(verts))
        rec["mesh_faces"] = int(len(faces))
        ms = sample_mesh_points(verts, faces, args.mesh_gt_samples, seed=0)
        gt = gt_surface_points(args.mesh_gt_samples)
        ms_f = ms[np.linalg.norm(ms, axis=1) < FOREGROUND_R]
        gt_f = gt[np.linalg.norm(gt, axis=1) < FOREGROUND_R]
        d2s, s2d = chamfer(ms_f, gt_f)
        rec["chamfer_mesh_to_gt"] = d2s
        rec["chamfer_gt_to_mesh"] = s2d
        rec["chamfer_mean"] = 0.5 * (d2s + s2d)
        rec["fg_mesh_samples"] = int(len(ms_f))
        rec["fg_gt_samples"] = int(len(gt_f))

    flush_rec()
    print(json.dumps(rec, indent=1), flush=True)
    return rec


if __name__ == "__main__":
    main()
