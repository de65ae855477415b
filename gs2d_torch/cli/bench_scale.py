"""Scale benchmark of the port: per-stage rasterizer times at 0.5M, 1M and
2M splats.

    python -m gs2d_torch.cli.bench_scale                 # on the card
    python -m gs2d_torch.cli.bench_scale --device cpu --n 300 600 \\
        --width 64 --height 32 --iters 1                 # plain versions

The counterpart of the JAX package's ``scripts/bench_scale.py`` (which
stays as it is): per N, ``make_trained_like_scene(N)`` at ``width`` ×
``height`` from ``cli/bench.py::bench_camera`` (70° fovx, 3 units out on
+z), the interval cull on, and one JSON line with that script's keys, its
stages mapped onto the port's layers:

- ``t_preprocess_ms``: ``preprocess_packed(..., colors=rgb)``, the
  render's preprocess, on the scales' logs and the opacities' logits;
- ``t_binning_ms``: ``api.bin_preprocessed`` with the cull on. Binning
  reads sizes back to the host, so its CUDA-event time includes the
  device's idle time while the host waits, as a user pays it;
- ``t_gather_ms``: ``ops/gather.py::gather_rows(packed, gid)``, the row
  gather (G1–G5's kernel) at this N's ``packed[gid]`` shape, flag read
  included. K1 reads ``packed`` through ``gid`` itself, so this is the
  gather kernel at the scene's shape, not a stage of the render;
- ``t_fwd_kernel_ms``: K1, ``kernel_fwd.rasterize_fwd``;
- ``t_bwd_kernel_ms``: K2, ``kernel_bwd.rasterize_bwd`` on K1's outputs
  and a ones cotangent;
- ``t_bwd_glue_ms``: ``api.reduce_slot_grads`` of ones slot rows;
- ``t_e2e_fwd_ms``: ``preprocess_packed`` then ``rasterize``, no
  gradient;
- ``t_e2e_fwd_bwd_ms`` and ``rays_per_s_fwd_bwd``: ``cli/bench.py::
  measure``'s step, the loss ``sum(out · ones)`` and gradients to means,
  log-scales, quats, opacity logits and colours, chained as
  ``a − 1e-12·g``.

Every stage is timed by ``cli/bench.py::timed_loop``: ``WARMUP`` untimed
calls, then ``--iters`` between two CUDA events. ``num_pairs`` counts the
slots after the cull, ``num_pairs_uncull`` those of the same view binned
once without it (untimed; the JAX record's ``num_expanded``). The JAX
record's capacity and chunk fields have no counterpart: the port has no
capacities. Added: the card's ``device`` name, ``power_limit_w``,
``peak_hbm_gb`` (the allocator's peak over this N, reset per N, GiB) and
``kernel_launches`` (each kernel's launches during this N).

Each line is printed as it is made, so a run that is cut keeps the
finished Ns; ``--out PATH`` also appends it there (there is no default
file). Without a card and without ``--device cpu`` it prints one line
with ``"error": "cuda_unavailable"`` and no number, and exits 0: it never
reports a CPU number in the card's place. ``--device cpu`` runs the
kernels' plain versions, timed with the host's clock, for the tests.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from ..ops.gather import gather_rows
from ..ops.rasterize.api import (bin_preprocessed, pack_entries, rasterize,
                                 reduce_slot_grads)
from ..ops.rasterize.common import DENTRY_F
from ..ops.rasterize.kernel_bwd import rasterize_bwd
from ..ops.rasterize.kernel_fwd import rasterize_fwd
from ..ops.rasterize.preprocess import preprocess_packed
from ..utils.bench_scenes import make_trained_like_scene
from .bench import (bench_camera, kernel_launches, measure, power_limit_w,
                    timed_loop)


def bench_one(n: int, width: int, height: int, iters: int,
              device: torch.device) -> dict:
    """The record of one N (see the module docstring)."""
    t_wall = time.time()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    before = kernel_launches()
    scene = make_trained_like_scene(n)
    means, scales, quats, opac, rgb = (torch.as_tensor(x, device=device)
                                       for x in scene)
    scaling, logit = torch.log(scales), torch.logit(opac)[:, None]
    cam = bench_camera(width, height, device)

    def stage_ms(fn):
        return timed_loop(lambda _: fn(), None, iters, device) * 1e3

    def pre_of(m):
        return preprocess_packed(m, scaling, quats, logit, cam.world_view,
                                 cam.full_proj, cam.campos, width, height,
                                 colors=rgb)

    rec = {"n_gaussians": n, "width": width, "height": height}
    with torch.no_grad():
        pre = pre_of(means)
        bins = bin_preprocessed(pre, width, height)
        rec["num_pairs"] = bins.num_pairs
        rec["num_pairs_uncull"] = bin_preprocessed(
            pre, width, height, cull=False).num_pairs
        packed = pack_entries(pre)
        k_args = (packed, bins.gid, bins.tile_start, bins.tile_count)
        rec["t_fwd_kernel_ms"] = stage_ms(
            lambda: rasterize_fwd(*k_args, width, height))
        out, med_idx, n_contrib = rasterize_fwd(*k_args, width, height)
        cot = torch.ones_like(out)
        rec["t_bwd_kernel_ms"] = stage_ms(lambda: rasterize_bwd(
            *k_args, out, cot, med_idx, n_contrib, width, height))
        del out, cot, med_idx, n_contrib
        rec["t_preprocess_ms"] = stage_ms(lambda: pre_of(means))
        rec["t_binning_ms"] = stage_ms(
            lambda: bin_preprocessed(pre, width, height))
        rec["t_gather_ms"] = stage_ms(lambda: gather_rows(packed, bins.gid))
        d_slots = torch.ones((bins.num_pairs, DENTRY_F), device=device)
        rec["t_bwd_glue_ms"] = stage_ms(
            lambda: reduce_slot_grads(d_slots, bins, n))
        del d_slots, k_args, packed, bins
        rec["t_e2e_fwd_ms"] = stage_ms(
            lambda: rasterize(pre_of(means), width, height))
        del pre
    rays = measure(scene, width, height, iters, device)
    rec["t_e2e_fwd_bwd_ms"] = width * height / rays * 1e3
    rec["rays_per_s_fwd_bwd"] = rays
    rec["wall_s"] = time.time() - t_wall
    after = kernel_launches()
    rec["kernel_launches"] = {k: after[k] - before[k] for k in after}
    rec["peak_hbm_gb"] = (torch.cuda.max_memory_allocated(device) / 2**30
                          if device.type == "cuda" else None)
    return rec


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--n", type=int, nargs="+",
                   default=[500_000, 1_000_000, 2_000_000],
                   help="splats of the trained-like scene, one record each")
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--iters", type=int, default=8,
                   help="timed calls of each stage")
    p.add_argument("--out", default=None,
                   help="also append each record to this JSON-lines file")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print(json.dumps({"error": "cuda_unavailable", "detail":
                          "torch.cuda.is_available() is false; --device "
                          "cpu runs the plain versions at a tiny size"}),
              flush=True)
        return 0
    device = torch.device(args.device)
    if device.type == "cuda":
        card = {"device": torch.cuda.get_device_name(device),
                "power_limit_w": power_limit_w()}
    else:
        card = {"device": "cpu", "power_limit_w": None}
    for n in args.n:
        rec = {**bench_one(n, args.width, args.height, args.iters, device),
               **card}
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
