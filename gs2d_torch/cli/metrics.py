"""NVS metrics CLI of the port: PSNR / SSIM / LPIPS over exported renders
vs GT.

    python -m gs2d_torch.cli.metrics -m <model dir> [<model dir> ...]

The surface of the JAX package's ``metrics.py`` (the reference's
``metrics.py:36-102``): reads ``<model>/test/<method>/{renders,gt}``
through the port's PNG decoder and writes ``results.json`` and
``per_view.json``. LPIPS (``eval/lpips.py``, on the CLI's device) is
computed per view where the VGG/LPIPS weights npz named by
``GS2D_LPIPS_WEIGHTS`` exists, and written as null otherwise, as the JAX
``metrics.py:37-41``, ``:66-67`` do. A scene that fails is reported and
skipped, so the other scenes still get their results.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def read_images(renders_dir, gt_dir):
    from ..scene.images import decode_png
    renders, gts, names = [], [], []
    for fname in sorted(os.listdir(renders_dir)):
        r = decode_png(os.path.join(renders_dir, fname)).astype(
            np.float32) / 255.0
        g = decode_png(os.path.join(gt_dir, fname)).astype(
            np.float32) / 255.0
        renders.append(r[..., :3].transpose(2, 0, 1))
        gts.append(g[..., :3].transpose(2, 0, 1))
        names.append(fname)
    return renders, gts, names


def _mean(xs):
    return sum(xs) / len(xs) if xs and xs[0] is not None else None


def evaluate(model_paths, split="test", device="cuda"):
    import torch

    from ..eval.lpips import LPIPS
    from ..ops.ssim import psnr as psnr_fn
    from ..ops.ssim import ssim as ssim_fn

    lpips = LPIPS(device=device)
    for model_path in model_paths:
        # per-scene isolation like the reference metrics.py: a broken
        # method dir (empty renders/, stray file) must not abort the
        # remaining scenes or lose already-computed results
        try:
            print("Scene:", model_path)
            full, per_view = {}, {}
            test_dir = os.path.join(model_path, split)
            if not os.path.isdir(test_dir):
                print("  no", split, "dir; skipping")
                continue
            for method in sorted(os.listdir(test_dir)):
                print("Method:", method)
                mdir = os.path.join(test_dir, method)
                renders, gts, names = read_images(
                    os.path.join(mdir, "renders"), os.path.join(mdir, "gt"))
                if not renders:
                    print("  no renders; skipping method")
                    continue
                ssims, psnrs, lpipss = [], [], []
                for r, g in zip(renders, gts):
                    rt = torch.as_tensor(r, device=device)
                    gt = torch.as_tensor(g, device=device)
                    ssims.append(float(ssim_fn(rt, gt)))
                    psnrs.append(float(psnr_fn(rt, gt)))
                    lpipss.append(float(lpips(rt, gt))
                                  if lpips.available() else None)
                print(f"  SSIM : {_mean(ssims):.7f}")
                print(f"  PSNR : {_mean(psnrs):.7f}")
                print(f"  LPIPS: {_mean(lpipss)}")
                full[method] = {"SSIM": _mean(ssims), "PSNR": _mean(psnrs),
                                "LPIPS": _mean(lpipss)}
                per_view[method] = {
                    "SSIM": dict(zip(names, ssims)),
                    "PSNR": dict(zip(names, psnrs)),
                    "LPIPS": dict(zip(names, lpipss)),
                }
            with open(os.path.join(model_path, "results.json"), "w") as f:
                json.dump(full, f, indent=2)
            with open(os.path.join(model_path, "per_view.json"), "w") as f:
                json.dump(per_view, f, indent=2)
        except Exception as e:  # noqa: BLE001 — per-scene isolation
            print("Unable to compute metrics for", model_path, ":", e)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="gs2d_torch metrics")
    ap.add_argument("--model_paths", "-m", nargs="+", required=True)
    ap.add_argument("--split", default="test")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    evaluate(args.model_paths, args.split, args.device)


if __name__ == "__main__":
    main()
