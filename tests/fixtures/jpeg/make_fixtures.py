"""Writes the JPEG fixtures of tests/test_torch_jpeg.py and chip_smoke.py.

    python tests/fixtures/jpeg/make_fixtures.py

Each fixture is a view of the synthetic scene (``rich_surfels``, rendered
by the port on the CPU), saved as JPEG by PIL (the 4:4:0 one by OpenCV:
PIL writes no 4:4:0), and beside it ``<name>.png``, the array
``np.asarray(PIL.Image.open(<name>.jpg))``, stored through the port's PNG
encoder. The progressive one has no PNG: the port must refuse it.
``index.json`` lists each fixture with how it was written and the camera
it was rendered from (a view of ``synthetic_scene.orbit``), so a COLMAP
model of the fixtures can be built without PIL (``chip_smoke.py`` does).
"""

import json
import math
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))

SURFELS = 60_000
FOVX_DEG = 70.0
# name, (width, height), view of ss.orbit(len(FIXTURES)), writer options
FIXTURES = [
    ("view_1080p_420_q95", (1920, 1080), 0,
     {"quality": 95, "subsampling": 2}),
    ("m360_images4_444_q95", (1237, 822), 1,
     {"quality": 95, "subsampling": 0}),
    ("view_422_q90", (1557, 1038), 2, {"quality": 90, "subsampling": 1}),
    ("small_420_restart", (333, 251), 3,
     {"quality": 85, "subsampling": 2, "restart_marker_blocks": 5}),
    ("small_optimized", (301, 207), 4,
     {"quality": 80, "subsampling": 2, "optimize": True}),
    ("small_gray", (257, 171), 5, {"quality": 90, "gray": True}),
    ("small_440", (219, 163), 6, {"quality": 92, "cv2_440": True}),
    ("small_progressive", (160, 120), 7,
     {"quality": 90, "progressive": True}),
]


def main():
    import cv2
    from PIL import Image

    from gs2d_torch.scene.images import encode_png
    from gs2d_torch.utils import synthetic_scene as ss

    renderer = ss.SurfelRenderer(ss.rich_surfels(SURFELS), device="cpu")
    views = ss.orbit(len(FIXTURES))
    index = {}
    for name, (w, h), view, opts in FIXTURES:
        img = renderer.rgba(views[view], w, h,
                            math.radians(FOVX_DEG))[..., :3]
        path = os.path.join(HERE, f"{name}.jpg")
        opts = dict(opts)
        if opts.pop("cv2_440", False):
            cv2.imwrite(path, np.ascontiguousarray(img[..., ::-1]), [
                cv2.IMWRITE_JPEG_QUALITY, opts.pop("quality"),
                cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440])
            writer = "cv2 4:4:0"
        else:
            pil = Image.fromarray(img)
            if opts.pop("gray", False):
                pil = pil.convert("L")
            pil.save(path, **opts)
            writer = "PIL " + json.dumps(opts, sort_keys=True)
        entry = {"size": [w, h], "writer": writer, "view": view,
                 "views": len(FIXTURES), "fovx_deg": FOVX_DEG,
                 "surfels": SURFELS}
        if not opts.get("progressive"):
            ref = np.asarray(Image.open(path))
            encode_png(os.path.join(HERE, f"{name}.png"), ref, 4, level=9)
            entry["decoded"] = f"{name}.png"
        index[f"{name}.jpg"] = entry
        print(name, os.path.getsize(path), flush=True)
    with open(os.path.join(HERE, "index.json"), "w") as f:
        json.dump(index, f, indent=1)


if __name__ == "__main__":
    main()
