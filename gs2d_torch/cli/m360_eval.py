"""Mip-NeRF 360 harness of the port: train → render → PSNR/SSIM/LPIPS.

    python -m gs2d_torch.cli.m360_eval -m360 <mipnerf360 root> [-o out]

After the JAX package's ``scripts/m360_eval.py`` (the reference's
``scripts/m360_eval.py``): outdoor scenes at ``images_4``, indoor at
``images_2``; each scene is trained with ``--eval`` (every 8th view held
out), rendered with ``--skip_train --skip_mesh`` and scored by
``gs2d_torch.cli.metrics`` (LPIPS where ``GS2D_LPIPS_WEIGHTS`` names the
weights npz, null otherwise). The scenes ship JPEGs, which the port
decodes itself (``scene/jpeg.py``). The CLIs run in this process;
``--device`` goes to all three, and any other flag to the train CLI
(``--iterations 7000``, say). ``main(argv)`` returns the model
directories.
"""

from __future__ import annotations

import argparse
import os

OUTDOOR = ["bicycle", "flowers", "garden", "stump", "treehill"]
INDOOR = ["room", "counter", "kitchen", "bonsai"]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="gs2d_torch Mip-NeRF 360 eval")
    ap.add_argument("--mipnerf360", "-m360", required=True)
    ap.add_argument("--output_path", "-o", default="./eval/m360")
    ap.add_argument("--scenes", nargs="+", default=OUTDOOR + INDOOR)
    ap.add_argument("--skip_training", action="store_true")
    ap.add_argument("--skip_rendering", action="store_true")
    ap.add_argument("--skip_metrics", action="store_true")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default) or cpu")
    return ap


def main(argv=None) -> list:
    from . import metrics, render, train
    args, train_extra = build_parser().parse_known_args(argv)
    dev = ["--device", args.device]
    out_paths = []
    for scene in args.scenes:
        src = os.path.join(args.mipnerf360, scene)
        out = os.path.join(args.output_path, scene)
        out_paths.append(out)
        images = "images_4" if scene in OUTDOOR else "images_2"
        if not args.skip_training:
            train.main(["-s", src, "-m", out, "-i", images, "--eval"]
                       + dev + train_extra)
        if not args.skip_rendering:
            render.main(["-m", out, "--skip_train", "--skip_mesh"] + dev)
    if not args.skip_metrics:
        metrics.main(["-m"] + out_paths + dev)
    return out_paths


if __name__ == "__main__":
    main()
