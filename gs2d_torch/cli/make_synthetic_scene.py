"""Write a synthetic multi-view dataset in the Blender/NeRF-synthetic layout.

    python -m gs2d_torch.cli.make_synthetic_scene --out <dir>
        [--preset torus|rich] [--size 256 | --width W --height H]

The surface of the JAX package's ``scripts/make_synthetic_scene.py``: a
structured surfel cloud (the coloured torus of oriented disks, 50° field
of view; or ``--preset rich``, the trained-like geometry with procedural
multi-scale colours, 70°, and a 30k-point seed cloud as ``points3d.ply``)
rendered from an orbit through the port's ``render()`` (K1) on
``--device`` (default ``cuda``), written as RGBA PNGs and
``transforms_{train,test}.json`` by ``utils/synthetic_scene.py``, so that
``python -m gs2d_torch.cli.train -s <dir>`` runs without an external
dataset. ``main(argv)`` returns the output directory.
"""

from __future__ import annotations

import argparse
import math


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description="gs2d_torch synthetic scene")
    ap.add_argument("--out", default="/tmp/synth_torus")
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--n_train", type=int, default=40)
    ap.add_argument("--n_test", type=int, default=8)
    ap.add_argument("--n_surfels", type=int, default=4000)
    ap.add_argument("--white_background", action="store_true")
    ap.add_argument("--preset", choices=["torus", "rich"], default="torus",
                    help="rich = trained-like geometry + multi-scale "
                         "procedural texture (for the at-scale run); "
                         "supports --width/--height")
    ap.add_argument("--width", type=int, default=0)
    ap.add_argument("--height", type=int, default=0)
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from ..utils import synthetic_scene as ss

    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch finds no CUDA device; "
                           "pass --device cpu to render on the CPU")
    width = args.width or args.size
    height = args.height or args.size
    seed = None
    if args.preset == "rich":
        fovx = math.radians(70.0)
        surfels = ss.rich_surfels(args.n_surfels)
        seed = ss.seed_cloud(surfels[0], surfels[4])
    else:
        fovx = math.radians(50.0)
        surfels = ss.torus_surfels(args.n_surfels)
    ss.write_blender_scene(args.out, ss.SurfelRenderer(surfels, args.device),
                           width, height, args.n_train, args.n_test,
                           fovx=fovx,
                           white_background=args.white_background,
                           seed_points=seed)
    print("wrote", args.out)
    return args.out


if __name__ == "__main__":
    main()
