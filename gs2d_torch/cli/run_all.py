"""Scene sweep: one training run per scene.

    python -m gs2d_torch.cli.run_all --data_root <dir> [--output_root <dir>]
        [--scenes a b ...] [--shard i/n] [-- <train flags>]

The surface of the JAX package's ``scripts/run_all.py`` (the reference's
``scripts/run_all.sh``): every sub-directory of ``--data_root`` (or
``--scenes``) whose index k in sorted order has k % n == i for ``--shard
i/n`` is trained by the port's train CLI (``gs2d_torch.cli.train``, in
this process) into ``<output_root>/<scene>`` with the flags after ``--``
(``--device cpu`` among them). A scene that fails is reported and the
others go on; the CLI exits with 1 if any failed. ``main(argv)`` returns
the scenes it ran.
"""

from __future__ import annotations

import argparse
import os
import sys

from . import train
from .batch import run_cli


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description="gs2d_torch run_all")
    ap.add_argument("--data_root", required=True)
    ap.add_argument("--output_root", default="./output/all")
    ap.add_argument("--scenes", nargs="*", default=None)
    ap.add_argument("--shard", default="0/1",
                    help="i/n — run every n-th scene starting at i")
    ap.add_argument("extra", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)

    scenes = args.scenes or sorted(
        d for d in os.listdir(args.data_root)
        if os.path.isdir(os.path.join(args.data_root, d)))
    i, n = (int(x) for x in args.shard.split("/"))
    ran, failures = [], []
    for k, scene in enumerate(scenes):
        if k % n != i:
            continue
        print(f"=== {scene} ===", flush=True)
        ran.append(scene)
        rc = run_cli(train, [
            "-s", os.path.join(args.data_root, scene),
            "-m", os.path.join(args.output_root, scene)]
            + [a for a in args.extra if a != "--"])
        if rc != 0:
            print(f"{scene} failed rc={rc}")
            failures.append(scene)
    if failures:
        print("failed scenes:", ", ".join(failures))
        sys.exit(1)
    return ran


if __name__ == "__main__":
    main()
