"""COLMAP preprocessing CLI of the port.

    python -m gs2d_torch.cli.convert -s <scene> [--resize] [--skip_matching]

The surface of the JAX package's ``convert.py`` (the reference's
``convert.py:35-122``): ``feature_extractor`` → ``exhaustive_matcher`` →
``mapper`` → ``image_undistorter`` against an external ``colmap`` (or
``--colmap_executable``), each command echoed and a failing one ending the
run with its exit code; then ``sparse/*`` moved into ``sparse/0``. With
``--resize``, every image of ``<scene>/images`` is written to
``images_{2,4,8}`` at 1/2, 1/4 and 1/8 of its size (integer division), as
``convert.py:73-91`` does with PIL: PIL's default bicubic
(``scene/images.py::resize``, RGBA and gray+alpha premultiplied), JPEGs
re-encoded at quality 95, 4:4:4 (``scene/jpeg.py::encode_jpeg``, PIL's
bytes) and PNGs by the port's encoder (the same pixels). Decode, resize and
the encoder's pixel stages run on ``--device`` (default ``cuda``).
``main(argv)`` returns the number of images written.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys

import torch

from ..scene.images import decode_image, encode_png, resize
from ..scene.jpeg import encode_jpeg

FACTORS = ((2, "images_2"), (4, "images_4"), (8, "images_8"))


def run(cmd):
    print("+", " ".join(cmd), flush=True)
    rc = subprocess.run(cmd).returncode
    if rc != 0:
        print(f"command failed with code {rc}. Exiting.")
        sys.exit(rc)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="gs2d_torch COLMAP convert")
    ap.add_argument("--source_path", "-s", required=True)
    ap.add_argument("--no_gpu", action="store_true")
    ap.add_argument("--skip_matching", action="store_true")
    ap.add_argument("--camera", default="OPENCV")
    ap.add_argument("--colmap_executable", default="")
    ap.add_argument("--resize", action="store_true")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default) or cpu: where --resize runs")
    return ap


def downscale(src: str, device) -> int:
    """``<src>/images/*`` → ``images_{2,4,8}``; returns the files written.
    A file the port cannot read or write raises, naming it."""
    n = 0
    for _, name in FACTORS:
        os.makedirs(os.path.join(src, name), exist_ok=True)
    for fn in os.listdir(os.path.join(src, "images")):
        img = decode_image(os.path.join(src, "images", fn), device)
        h, w = img.shape[:2]
        for factor, name in FACTORS:
            path = os.path.join(src, name, fn)
            if w // factor == 0 or h // factor == 0:
                raise ValueError(f"{path}: {w}x{h} / {factor} is empty")
            out = resize(img, w // factor, h // factor, device=device)
            if fn.lower().endswith((".jpg", ".jpeg")):
                encode_jpeg(path, torch.as_tensor(out, device=device),
                            quality=95, subsampling=0)
            elif fn.lower().endswith(".png"):
                encode_png(path, out)
            else:
                raise ValueError(f"{path}: the port writes .png and .jpg/"
                                 ".jpeg images only")
            n += 1
    return n


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if args.resize and device.type == "cuda" \
            and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch finds no CUDA device; "
                           "pass --device cpu to resize on the CPU")
    colmap = args.colmap_executable or "colmap"
    if shutil.which(colmap) is None:
        print("error: COLMAP binary not found on PATH — install COLMAP or "
              "pass --colmap_executable")
        sys.exit(1)
    use_gpu = "0" if args.no_gpu else "1"
    src = args.source_path

    if not args.skip_matching:
        os.makedirs(os.path.join(src, "distorted", "sparse"), exist_ok=True)
        run([colmap, "feature_extractor",
             "--database_path", f"{src}/distorted/database.db",
             "--image_path", f"{src}/input",
             "--ImageReader.single_camera", "1",
             "--ImageReader.camera_model", args.camera,
             "--SiftExtraction.use_gpu", use_gpu])
        run([colmap, "exhaustive_matcher",
             "--database_path", f"{src}/distorted/database.db",
             "--SiftMatching.use_gpu", use_gpu])
        run([colmap, "mapper",
             "--database_path", f"{src}/distorted/database.db",
             "--image_path", f"{src}/input",
             "--output_path", f"{src}/distorted/sparse",
             "--Mapper.ba_global_function_tolerance=0.000001"])

    run([colmap, "image_undistorter",
         "--image_path", f"{src}/input",
         "--input_path", f"{src}/distorted/sparse/0",
         "--output_path", src, "--output_type", "COLMAP"])

    # move sparse/* into sparse/0 (reference convert.py:80-88)
    sparse = os.path.join(src, "sparse")
    os.makedirs(os.path.join(sparse, "0"), exist_ok=True)
    for f in os.listdir(sparse):
        if f == "0":
            continue
        shutil.move(os.path.join(sparse, f), os.path.join(sparse, "0", f))

    n = downscale(src, device) if args.resize else 0
    print("Done.")
    return n


if __name__ == "__main__":
    main()
