"""Benchmark entry point of the port: rasterizer forward+backward rays/s.

    python -m gs2d_torch.cli.bench                  # on the card
    python -m gs2d_torch.cli.bench --device cpu --n 300 --width 64 \\
        --height 32 --iters 1 --uniform_n 300       # plain versions, tiny

The counterpart of the JAX package's ``bench.py`` (which stays as it is):
it prints ONE JSON line with its keys, ``metric``
(``rays_per_s_per_chip_fwd_bwd_1080p``), ``value``, ``unit`` and
``vs_baseline`` (against the ``BENCH_BASELINE`` environment variable, else
null), ``platform``, ``n_devices``, ``scene``, ``width``, ``height``,
``headline_wall_s``, ``train_step_it_per_s`` and
``uniform_100k_rays_per_s``, plus the card's ``device`` name and
``power_limit_w`` and the ``kernel_launches`` of the run (each kernel
wrapper's count; a fresh process starts them at zero).

- Headline (``bench.py:84-122``): ``make_trained_like_scene(n)`` at
  ``width`` × ``height`` from the 70° camera 3 units out on +z,
  ``preprocess(..., colors=rgb)`` then ``rasterize`` with the interval
  cull on, the loss ``sum(out · ones)``, gradients to means, scales,
  quats, opacities and colours, each step chained as ``a − 1e-12·g``;
  2 warm-up steps, then ``iters`` timed. value = width·height / seconds
  per step.
- ``train_step_it_per_s`` (``bench.py:125-197``): ``make_train_step``
  (lambda_dist 10, SH degree 3, depth_ratio 1) on the same scene with
  zero SH rest, ground truth ``default_rng(1)``, black background,
  iteration 8000; 2 warm-up steps, then 6 timed.
- ``uniform_100k_rays_per_s``: ``build_uniform_scene(uniform_n)``
  (100,000 by default) through the headline's measurement.

On the card every loop is timed with CUDA events: one record before it,
one after, one synchronize. Without a card and without ``--device cpu``
the line carries ``"value": null`` and ``"error": "cuda_unavailable"``:
the benchmark never reports a CPU number in place of the card's. ``--device
cpu`` runs the kernels' plain versions, for the tests, with the host's
clock, and says ``"platform": "cpu"``.

As ``bench.py``: one JSON line and exit 0 whatever happens. A failure
gives ``"value": null`` and an ``error`` field (the traceback goes to
stderr); the measurement runs under a ``BENCH_DEADLINE`` second alarm
(default 3000), past which the line carries what was measured and
``"error": "deadline_exceeded"``; the secondary points run only while
the budget allows, as there.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import signal
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

METRIC = "rays_per_s_per_chip_fwd_bwd_1080p"
WARMUP = 2
TRAIN_ITERS = 6
TRAIN_ITERATION = 8000


def emit(value, extra=None, error=None):
    base = os.environ.get("BENCH_BASELINE")
    vs = (value / float(base)) if (value is not None and base) else None
    rec = {"metric": METRIC, "value": value, "unit": "rays/s",
           "vs_baseline": vs}
    if error:
        rec["error"] = error
    if extra:
        rec.update(extra)
    print(json.dumps(rec), flush=True)


class _Deadline(Exception):
    pass


def _alarm(signum, frame):
    raise _Deadline()


def power_limit_w():
    """The card's power limit in watts from ``nvidia-smi``, or None."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60, check=True)
        return float(res.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def bench_camera(width, height, device, theta_deg=0.0, dist=3.0,
                 fov_deg=70.0):
    """``bench.py``'s camera: 70° horizontal field of view, 3 units out on
    +z, looking at the origin; ``theta_deg`` orbits it about the world y
    axis, ``dist`` and ``fov_deg`` move and widen it."""
    from ..scene.cameras import make_camera
    th = math.radians(theta_deg)
    R = np.array([[math.cos(th), 0.0, math.sin(th)], [0.0, 1.0, 0.0],
                  [-math.sin(th), 0.0, math.cos(th)]])      # cam → world
    fovx = math.radians(fov_deg)
    fovy = 2 * math.atan(math.tan(fovx / 2) * height / width)
    return make_camera(R, np.array([0.0, 0.0, dist]), fovx, fovy, width,
                       height, device=device)


def timed_loop(step, state, n, device):
    """Seconds per iteration of ``state = step(state)`` chained ``n``
    times after ``WARMUP`` untimed ones: CUDA events on the card, the
    host's clock around a CPU run."""
    for _ in range(WARMUP):
        state = step(state)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            state = step(state)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / n
    t0 = time.perf_counter()
    for _ in range(n):
        state = step(state)
    return (time.perf_counter() - t0) / n


def measure(scene, width, height, n_iters, device):
    """rays/s of chained forward+backward steps on (means, scales, quats,
    opacity, rgb)."""
    from ..ops.rasterize.api import rasterize
    from ..ops.rasterize.preprocess import preprocess

    cam = bench_camera(width, height, device)
    cot = torch.ones((15, height, width), device=device)

    def step(arrays):
        leaves = [a.detach().requires_grad_() for a in arrays]
        means, scales, quats, opac, rgb = leaves
        pre = preprocess(means, scales, quats, opac, cam.world_view,
                         cam.full_proj, cam.campos, width, height,
                         colors=rgb)
        out, _ = rasterize(pre, width, height)
        grads = torch.autograd.grad(torch.sum(out * cot), leaves)
        return [a.detach() - 1e-12 * g for a, g in zip(leaves, grads)]

    arrays = [torch.as_tensor(x, device=device) for x in scene]
    return width * height / timed_loop(step, arrays, n_iters, device)


def measure_train_step(n, width, height, n_iters, device):
    """Iterations/s of the whole ``train_step`` at the headline scene."""
    from ..config import OptimizationParams
    from ..train.optim import init_adam
    from ..train.step import TrainState, make_train_step
    from ..utils.bench_scenes import bench_state

    state = bench_state(n, device=device)
    cam = bench_camera(width, height, device)
    step = make_train_step(OptimizationParams(lambda_dist=10.0),
                           max_sh_degree=3, spatial_lr_scale=1.0,
                           depth_ratio=1.0, device=device)
    gt = torch.as_tensor(np.random.default_rng(1).random(
        (3, height, width), np.float32), device=device)
    bg = torch.zeros(3, device=device)

    def fn(ts):
        return step(ts, cam, gt, TRAIN_ITERATION, bg)[0]

    ts = TrainState(gaussians=state, opt=init_adam(state.params))
    return 1.0 / timed_loop(fn, ts, n_iters, device)


def kernel_launches():
    from ..ops.gather import gather_rows
    from ..ops.rasterize import kernel_bwd, kernel_fwd
    return {"rasterize_fwd": kernel_fwd.rasterize_fwd.launches,
            "rasterize_bwd": kernel_bwd.rasterize_bwd.launches,
            "gather_rows": gather_rows.launches}


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--n", type=int, default=1_000_000,
                   help="splats of the trained-like scene")
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--iters", type=int, default=8,
                   help="timed headline steps")
    p.add_argument("--uniform_n", type=int, default=100_000,
                   help="splats of the uniform scene")
    return p.parse_args(argv)


def main(argv=None) -> int:
    from ..utils.bench_scenes import build_uniform_scene, \
        make_trained_like_scene

    args = parse_args(argv)
    deadline_s = int(os.environ.get("BENCH_DEADLINE", "3000"))
    if args.device == "cuda" and not torch.cuda.is_available():
        emit(None, error="cuda_unavailable",
             extra={"detail": "torch.cuda.is_available() is false; "
                    "--device cpu runs the plain versions at a tiny size"})
        return 0
    device = torch.device(args.device)
    W, H = args.width, args.height
    extra = {"platform": "gpu" if device.type == "cuda" else "cpu"}
    if device.type == "cuda":
        extra.update(n_devices=torch.cuda.device_count(),
                     device=torch.cuda.get_device_name(0),
                     power_limit_w=power_limit_w())
    else:
        extra.update(n_devices=1, device="cpu", power_limit_w=None)
    extra.update(scene=f"trained_like_{args.n}", width=W, height=H)

    t0 = time.time()
    old = signal.signal(signal.SIGALRM, _alarm)
    signal.alarm(deadline_s)
    value = None
    try:
        value = measure(make_trained_like_scene(args.n), W, H, args.iters,
                        device)
        extra["headline_wall_s"] = round(time.time() - t0, 1)
        if (time.time() - t0) * 2 < deadline_s * 0.8:
            try:
                extra["train_step_it_per_s"] = measure_train_step(
                    args.n, W, H, TRAIN_ITERS, device)
            except _Deadline:
                signal.alarm(10)
                extra["train_step_it_per_s"] = None
        if (time.time() - t0) * 1.5 < deadline_s * 0.8:
            try:
                extra["uniform_100k_rays_per_s"] = measure(
                    build_uniform_scene(args.uniform_n), W, H, args.iters,
                    device)
            except _Deadline:
                signal.alarm(10)     # still emit the headline below
                extra["uniform_100k_rays_per_s"] = None
    except _Deadline:
        signal.alarm(0)
        emit(value, error="deadline_exceeded",
             extra={**extra, "deadline_s": deadline_s,
                    "kernel_launches": kernel_launches()})
        return 0
    except Exception as e:  # noqa: BLE001 — one JSON line whatever happens
        signal.alarm(0)
        traceback.print_exc()
        emit(None, error=f"{type(e).__name__}: {e}"[:500],
             extra={**extra, "kernel_launches": kernel_launches()})
        return 0
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
    emit(value, extra={**extra, "kernel_launches": kernel_launches()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
