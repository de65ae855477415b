"""Batch render/mesh over a list of model directories.

    python -m gs2d_torch.cli.render_all -md <model> [<model> ...]
        [--out_root <dir>] [-- <render flags>]

The surface of the JAX package's ``render_all.py`` (the reference's
``render_all.py``): the port's render CLI (``gs2d_torch.cli.render``, in
this process) on each model with the flags after ``--`` (``--device cpu``
among them); with ``--out_root``, each model's ``train``, ``test`` and
``traj`` directories are copied to ``<out_root>/<yymmdd_HHMM>/<model
name>``. A model whose render fails is reported and not copied (its
directories hold the renders of an earlier run), the others go on, and the
CLI exits with 1 if any failed. ``main(argv)`` returns the failed models.
"""

from __future__ import annotations

import argparse
import datetime
import os
import shutil
import sys

from . import render
from .batch import run_cli


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description="gs2d_torch render_all")
    ap.add_argument("--model_dirs", "-md", nargs="+", required=True)
    ap.add_argument("--out_root", default=None)
    ap.add_argument("passthrough", nargs=argparse.REMAINDER,
                    help="flags forwarded to the render CLI")
    args = ap.parse_args(argv)

    stamp = datetime.datetime.now().strftime("%y%m%d_%H%M")
    failures = []
    for md in args.model_dirs:
        print(f"=== rendering {md} ===", flush=True)
        rc = run_cli(render, ["-m", md] + [a for a in args.passthrough
                                           if a != "--"])
        if rc != 0:
            print(f"render failed for {md} (rc={rc}); skipping copy")
            failures.append(md)
            continue
        if args.out_root:
            dst = os.path.join(args.out_root, stamp,
                               os.path.basename(md.rstrip("/")))
            os.makedirs(dst, exist_ok=True)
            for sub in ("train", "test", "traj"):
                s = os.path.join(md, sub)
                if os.path.isdir(s):
                    shutil.copytree(s, os.path.join(dst, sub),
                                    dirs_exist_ok=True)
    if failures:
        print("failed models:", ", ".join(failures))
        sys.exit(1)
    return failures


if __name__ == "__main__":
    main()
