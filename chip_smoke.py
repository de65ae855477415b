#!/usr/bin/env python3
"""Smoke test of the gs2d_torch port on one NVIDIA GPU (written for the H100).

Run from the root of a checkout: ``python3 chip_smoke.py``. It builds the
port's CUDA kernels from ``gs2d_torch/csrc`` and drives the render path
(``gs2d_torch.render.renderer.render``), the training step
(``gs2d_torch.train.step.make_train_step``) and the training loop
(``gs2d_torch.train.loop.train``) on the card:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: every kernel, compiled together, with the build seconds and
   each kernel's registers, shared memory and spills;
3. small scenes (seeded), render path: K1 (rasterize_fwd) against its
   plain PyTorch version on the card — all 15 channels within rtol/atol
   2e-4, the median slot equal on >= 99.9% of pixels — the render against
   the plain oracle rasterizer at the same bar, and the JAX package's
   golden render (tests/golden) at 5e-4;
4. small scenes, training: K2 (rasterize_bwd) against its plain version on
   every slot under a seeded cotangent, and per-Gaussian gradients through
   render on the card against the same on CPU tensors, at the gradient
   bar (rtol 1e-3 / atol 5e-4 on values normalised by each field's largest
   magnitude); a 30-step overfit of a tiny scene on the card;
5. full width, render path: the 1M-splat trained-like scene at SH degree
   3, 1920x1080, rendered from several views of an orbit around the
   benchmark camera. Outputs must be finite with real alpha coverage, K1
   must run once per view, and sampled tiles and all of view 0 must agree
   with the plain version. Per view: pairs, stage times (CUDA events) and
   peak memory;
6. full width, training: one warm-up and TRAIN_STEPS timed steps of
   ``train_step`` at the bench.py train-step point (view 0, lambda_dist
   10, depth_ratio 1, iteration 8000, ground truth from default_rng(1)).
   K1 and K2 must run once per step, every gradient, parameter and
   statistic must be finite and ``denom`` must grow on exactly the visible
   Gaussians. Per step: step and stage times (CUDA events), loss terms and
   peak memory; one profiled step; two backward passes bit-identical; K2
   against its plain version on sampled tiles and all of view 0;
7. small loop: the card twin of tests/test_loop_e2e.py,
   300 iterations of ``train()`` on three 64x32 views from 12 points;
   densification must grow N past 12, every logged loss be finite and
   view 0's PSNR rise by more than 2 dB;
8. row gather (G1–G5's function): ``gather_rows`` bit-identical to
   ``table[idx]`` for F in GATHER_F, M in {0, 1, 1000, GATHER_M}, int32
   and int64 indices, out-of-range indices raising; the kernel alone and
   its wrapper timed (mean of 20, CUDA events) beside
   ``torch.index_select`` and the plain version at the probes' shape and
   at view 0's expansion gather ``packed[gid]``;
9. full-width loop: ``train()`` resumed from a checkpoint of the
   perturbed 1M-splat scene at iteration 2900 and run to 3100 against
   renders of the true scene (densify at 3000 and 3100, the opacity
   reset at 3000). Gates: K1 and K2 once per step; after each densify
   the N equation, the gather launches its code implies and bit-identity
   with the same call through the plain gather; after the reset the
   opacity cap and zero opacity moments; finite losses, parameters and
   moments; the checkpoint written at 3100 resumes 5 steps bit for bit.
   Prints per-window step times and pairs, densify and reset times, the
   gather's share, checkpoint write and read times and peak memory;
10. one ``{"kernels": [...]}`` line: per kernel its launches on the main
   paths, error, time, plain-version time, library-call time where there
   is one and the bound computed from this run's inputs (H100 SXM peaks:
   3.35 TB/s, 67 TFLOP/s FP32);
11. the card line, then ``{"ok": true, "device": {...}}`` as the last
   line.

Any failure exits non-zero before the last line is printed; so does a
machine without CUDA or a directory without the gs2d_torch package.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N_SPLATS = 1_000_000
WIDTH, HEIGHT = 1920, 1080
SH_DEGREE = 3
VIEW_DEGREES = (0.0, 20.0, 40.0)   # orbit about the world y axis
SAMPLED_TILES = 32
TOL = 2e-4                         # tests/test_rasterize_fwd.py:79-80
MED_AGREE = 0.999                  # median flips at T = 0.5 (verify skill)
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
FP32_OPS_PER_S = 67e12             # H100 SXM, FP32 off the tensor cores
# FP32 operations per evaluated (record, pixel) in rasterize_fwd.cu: the
# intersection and footprint test before any early skip (a composited
# record costs ~70 with its accumulations).
OPS_PER_EVAL = 40
# The same count for rasterize_bwd.cu, which evaluates the same pairs (up
# to each pixel's n_contrib) with the same test; a composited pair costs
# ~150 more for its gradient chain and 22 warp-reduced sums, which the
# bound leaves out (the outputs do not say how many pairs composited).
OPS_PER_EVAL_BWD = 40
GRAD_RTOL, GRAD_ATOL = 1e-3, 5e-4  # tests/test_rasterize_bwd.py:50-57
DFLD = {"A": slice(0, 3), "B": slice(3, 6), "C": slice(6, 9),
        "c2": slice(9, 12), "opacity": slice(12, 13), "rgb": slice(13, 16),
        "normal": slice(16, 19), "noise": slice(19, 22)}  # common.py
TRAIN_ITER = 8000                  # bench.py: every loss term live
TRAIN_STEPS = 5
KERNEL_REPS = 20
GATHER_N = 1 << 20                 # scripts/probe_gather_kernel.py:59-61
GATHER_M = 5_600_256
GATHER_F = (1, 2, 3, 4, 24, 45)
# tests/test_loop_e2e.py:77-82, the compressed schedule of the small loop
SMALL_LOOP = dict(iterations=300, densify_from_iter=20,
                  densify_until_iter=220, densification_interval=20,
                  opacity_reset_interval=120, densify_grad_threshold=5e-5,
                  percent_dense=0.01, position_lr_init=2e-3,
                  position_lr_final=2e-4)
# the full-width loop resumes at 2900 and runs to 3100: densify at 3000
# (size threshold 0) and 3100 (threshold 20), the opacity reset at 3000
LOOP_FROM, LOOP_TO = 2900, 3100
RESUME_STEPS = 5


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 1) -> float:
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def random_cloud(n, seed, spread=1.0, scale_lo=0.02, scale_hi=0.25,
                 opaque=None):
    import numpy as np
    rng = np.random.default_rng(seed)
    means = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    scales = rng.uniform(scale_lo, scale_hi, (n, 2)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opac = rng.uniform(0.2, 0.95, (n,)).astype(np.float32)
    if opaque is not None:
        opac[:] = opaque
    rgb = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    noise = rng.normal(size=(n, 3)).astype(np.float32)
    return means, scales, quats, opac, rgb, noise


def lookat(width, height, theta_deg=0.0, dist=4.0, fov_deg=60.0,
           device="cuda"):
    """Camera at distance ``dist`` from the origin, looking at it, orbited
    by ``theta_deg`` about the world y axis."""
    import numpy as np

    from gs2d_torch.scene.cameras import make_camera
    th = math.radians(theta_deg)
    R = np.array([[math.cos(th), 0.0, math.sin(th)], [0.0, 1.0, 0.0],
                  [-math.sin(th), 0.0, math.cos(th)]])      # cam → world
    fovx = math.radians(fov_deg)
    fovy = 2 * math.atan(math.tan(fovx / 2) * height / width)
    return make_camera(R, np.array([0.0, 0.0, dist]), fovx, fovy, width,
                       height, device=device)


def small_scene_list():
    """The seeded small scenes: (name, width, height, cloud)."""
    import numpy as np
    n = 16                                 # every splat behind the camera
    culled = (np.tile(np.float32([0, 0, -50]), (n, 1)),
              np.full((n, 2), 0.1, np.float32),
              np.tile(np.float32([1, 0, 0, 0]), (n, 1)),
              np.full(n, 0.9, np.float32), np.full((n, 3), 0.5, np.float32),
              np.zeros((n, 3), np.float32))
    return [("2k_256x128", 256, 128, random_cloud(2000, 0)),
            ("occlusion_128x64", 128, 64, random_cloud(
                300, 7, spread=0.3, scale_lo=0.2, scale_hi=0.5,
                opaque=0.99)),
            ("all_culled_64x32", 64, 32, culled)]


def cloud_state(cloud, device):
    """A random cloud → (GaussianState at SH degree 3, noise (N, 3))."""
    import numpy as np
    import torch

    from gs2d_torch.models.gaussians import GaussianParams, GaussianState
    from gs2d_torch.ops.sh import rgb_to_sh
    means, scales, quats, opac, rgb, noise = cloud
    n = means.shape[0]
    dev = lambda x: torch.as_tensor(np.ascontiguousarray(x),  # noqa: E731
                                    dtype=torch.float32, device=device)
    params = GaussianParams(
        xyz=dev(means), features_dc=dev(rgb_to_sh(rgb)[:, None, :]),
        features_rest=torch.zeros((n, 15, 3), device=device),
        scaling=dev(np.log(scales)), rotation=dev(quats),
        opacity=dev(np.log(opac / (1 - opac))[:, None]))
    return GaussianState(params=params, active_sh_degree=SH_DEGREE), \
        dev(noise)


def compare_tiles(got, ref, what):
    """got/ref = (out, med_idx, n_contrib) over the same tiles → max abs
    error; raises unless the channels agree at TOL and the median slot on
    MED_AGREE of the pixels."""
    import torch
    out, med, _ = got
    rout, rmed, _ = ref
    if not torch.isfinite(out).all():
        raise AssertionError(f"{what}: kernel output is not finite")
    if not torch.allclose(out, rout, rtol=TOL, atol=TOL):
        bad = (out - rout).abs() > TOL + TOL * rout.abs()
        raise AssertionError(
            f"{what}: {int(bad.sum())} of {bad.numel()} values off by more "
            f"than {TOL} (max abs err {(out - rout).abs().max().item():.3g})")
    agree = (med == rmed).float().mean().item()
    if agree < MED_AGREE:
        raise AssertionError(f"{what}: median slot agrees on {agree:.5f} "
                             f"of pixels (< {MED_AGREE})")
    return (out - rout).abs().max().item()


def small_scenes(report):
    """Phase 3: kernel vs plain version, and render vs the oracle."""
    import numpy as np
    import torch

    from gs2d_torch.ops.rasterize.api import pack_entries, rasterize, untile
    from gs2d_torch.ops.rasterize.binning import bin_gaussians
    from gs2d_torch.ops.rasterize.kernel_fwd import (rasterize_fwd,
                                                     rasterize_fwd_reference)
    from gs2d_torch.ops.rasterize.oracle import rasterize_oracle
    from gs2d_torch.ops.rasterize.preprocess import preprocess
    from gs2d_torch.render.renderer import prepare, render

    err = 0.0
    for name, w, h, cloud in small_scene_list():
        state, noise = cloud_state(cloud, "cuda")
        cam = lookat(w, h)
        bg = torch.zeros(3, device="cuda")
        pre = prepare(cam, state, noise=noise)
        bins = bin_gaussians(pre.center2d, pre.extent, pre.depth,
                             pre.visible, w, h)
        args = (pack_entries(pre), bins.gid, bins.tile_start,
                bins.tile_count, w, h)
        got = rasterize_fwd(*args)
        torch.cuda.synchronize()
        ref = rasterize_fwd_reference(*args)
        scene_err = compare_tiles(got, ref, f"{name} kernel")
        err = max(err, scene_err)
        if name == "all_culled_64x32" and (bins.num_pairs != 0
                                           or got[0].abs().max() != 0):
            raise AssertionError("all-culled scene rendered something")
        # end to end: the render against the binning-free oracle
        out = render(cam, state, bg, noise=noise)
        orc = rasterize_oracle(pre, w, h)
        alpha_err = (out["rend_alpha"][0] - orc[4]).abs().max().item()
        rgb_err = (out["render"] - orc[0:3]).abs().max().item()
        if max(alpha_err, rgb_err) > TOL:
            raise AssertionError(f"{name}: render vs oracle off by "
                                 f"{max(alpha_err, rgb_err):.3g}")
        if name == "2k_256x128":
            report["plain_ms_small"] = cuda_ms(
                lambda: rasterize_fwd_reference(*args))
            report["kernel_ms_small"] = cuda_ms(
                lambda: rasterize_fwd(*args), reps=20)
            full = untile(got[0], w, h)
            if not torch.allclose(full, orc, rtol=TOL, atol=TOL):
                raise AssertionError(
                    f"{name}: kernel image vs oracle off by "
                    f"{(full - orc).abs().max().item():.3g}")
        print(f"small scene {name}: pairs {bins.num_pairs}, kernel vs "
              f"plain max abs err {scene_err:.3g}, render vs oracle "
              f"{max(alpha_err, rgb_err):.3g}", flush=True)
    # the JAX package's golden render (tests/golden, made by its oracle;
    # tests/test_golden.py holds its tiled path at 5e-4)
    means, scales, quats, opac, rgb, noise = (
        torch.as_tensor(x, device="cuda") for x in random_cloud(100, 42))
    cam = lookat(128, 64)
    pre = preprocess(means, scales, quats, opac, cam.world_view,
                     cam.full_proj, cam.campos, 128, 64, colors=rgb,
                     noise=noise)
    out, _ = rasterize(pre, 128, 64)
    gold = torch.as_tensor(np.load(ROOT / "tests" / "golden" /
                                   "render_128x64_seed42.npz")["out"])
    gold_err = (out.cpu() - gold).abs().max().item()
    if not torch.allclose(out.cpu(), gold, rtol=5e-4, atol=5e-4):
        raise AssertionError(f"golden render off by {gold_err:.3g}")
    print(f"golden render 128x64: max abs err {gold_err:.3g} (bar 5e-4)",
          flush=True)
    return err


def profile_call(fn, top=6):
    """One call of ``fn`` under torch.profiler: host wall time, the device
    time of everything the card ran (kernels, copies, fills; one stream,
    so they do not overlap) and the top entries by device time. Device
    fields are None if the trace holds no device events (no CUPTI)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us() / 1e3
    busy_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"wall_ms": wall_ms,
            "device_busy_ms": busy_ms if by_name else None,
            "device_idle_share": 1 - busy_ms / wall_ms if by_name else None,
            "top_device_ms": {k[:70]: v for k, v in top}}


def bench_state():
    """The 1M-splat trained-like scene at SH degree 3 (bench.py), with
    seeded SH rest coefficients, on the card."""
    import numpy as np
    import torch

    from gs2d_torch.models.gaussians import GaussianParams, GaussianState
    from gs2d_torch.ops.sh import rgb_to_sh
    from gs2d_torch.utils.bench_scenes import make_trained_like_scene

    t0 = time.time()
    means, scales, quats, opac, rgb = make_trained_like_scene(N_SPLATS)
    rng = np.random.default_rng(0)
    rest = (rng.normal(size=(N_SPLATS, 15, 3)) * 0.1).astype(np.float32)
    opac = np.clip(opac, 1e-4, 1 - 1e-4)
    dev = lambda x: torch.as_tensor(np.ascontiguousarray(x),  # noqa: E731
                                    dtype=torch.float32, device="cuda")
    state = GaussianState(params=GaussianParams(
        xyz=dev(means), features_dc=dev(rgb_to_sh(rgb)[:, None, :]),
        features_rest=dev(rest), scaling=dev(np.log(scales)),
        rotation=dev(quats), opacity=dev(np.log(opac / (1 - opac))[:, None])),
        active_sh_degree=SH_DEGREE)
    print(f"full width: scene of {N_SPLATS} splats built in "
          f"{time.time() - t0:.1f} s", flush=True)
    return state


def bench_camera(theta_deg=0.0):
    """The benchmark camera (bench.py: 70 degree fovx, 3 units from the
    origin), orbited by ``theta_deg`` about the world y axis."""
    return lookat(WIDTH, HEIGHT, theta_deg, dist=3.0, fov_deg=70.0)


def full_width(report, state):
    """Phase 5: the 1M-splat scene at 1080p through render()."""
    import numpy as np
    import torch

    from gs2d_torch.ops.rasterize import kernel_bwd, kernel_fwd
    from gs2d_torch.ops.rasterize.api import pack_entries, untile
    from gs2d_torch.ops.rasterize.binning import bin_gaussians
    from gs2d_torch.render.renderer import bridge, prepare, render

    bg = torch.zeros(3, device="cuda")
    cams = [bench_camera(th) for th in VIEW_DEGREES]

    with torch.no_grad():
        render(cams[0], state, bg)                       # warm-up
        torch.cuda.synchronize()
        # --- the main path: counts from zero, views through render() ----
        kernel_fwd.rasterize_fwd.launches = 0
        kernel_bwd.rasterize_bwd.launches = 0
        outs = []
        for cam in cams:
            torch.cuda.reset_peak_memory_stats()
            total = cuda_ms(lambda: outs.append(render(cam, state, bg)))
            outs[-1]["total_ms"] = total
            outs[-1]["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        launches = kernel_fwd.rasterize_fwd.launches
        if launches != len(cams) or kernel_bwd.rasterize_bwd.launches:
            raise AssertionError(f"rasterize_fwd launched {launches} times "
                                 f"for {len(cams)} views, rasterize_bwd "
                                 f"{kernel_bwd.rasterize_bwd.launches}")
        report["launches_by_path"] = {"render": launches}

        # --- checks and per-stage times, view by view ---------------------
        err, n_eval, inputs0 = 0.0, 0, None
        for v, (cam, res) in enumerate(zip(cams, outs)):
            for key, val in res.items():
                if torch.is_tensor(val) and val.is_floating_point() \
                        and not torch.isfinite(val).all():
                    raise AssertionError(f"view {v}: {key} is not finite")
            cover = (res["rend_alpha"] > 0.5).float().mean().item()
            if cover < 0.5:
                raise AssertionError(f"view {v}: alpha > 0.5 on only "
                                     f"{cover:.3f} of pixels")
            ms = {}
            st = {}

            def stage(name, fn):
                ms[name] = cuda_ms(lambda: st.__setitem__(name, fn()))

            stage("preprocess", lambda: prepare(cam, state))
            pre = st["preprocess"]
            stage("binning", lambda: bin_gaussians(
                pre.center2d, pre.extent, pre.depth, pre.visible, WIDTH,
                HEIGHT))
            bins = st["binning"]
            stage("pack", lambda: pack_entries(pre))
            args = (st["pack"], bins.gid, bins.tile_start, bins.tile_count,
                    WIDTH, HEIGHT)
            stage("rasterize_fwd", lambda: kernel_fwd.rasterize_fwd(*args))
            out_t, med, nc = st["rasterize_fwd"]
            stage("bridge", lambda: bridge(
                cam, pre, untile(out_t, WIDTH, HEIGHT),
                {"num_pairs": bins.num_pairs}, bg))
            if bins.num_pairs != res["num_pairs"]:
                raise AssertionError(f"view {v}: staged pairs "
                                     f"{bins.num_pairs} != render's "
                                     f"{res['num_pairs']}")
            # sampled tiles against the plain version: the busiest tile,
            # then a seeded sample
            T = out_t.shape[0]
            tiles = [int(bins.tile_count.argmax())] + np.random.default_rng(
                v).choice(T, SAMPLED_TILES, replace=False).tolist()
            ref = kernel_fwd.rasterize_fwd_reference(*args, tiles=tiles)
            idx = torch.as_tensor(tiles, device="cuda")
            err = max(err, compare_tiles((out_t[idx], med[idx], nc[idx]),
                                         ref, f"view {v} sampled tiles"))
            n_eval += int(nc.sum())
            if v == 0:
                inputs0 = args
            line = {"view": v, "theta_deg": VIEW_DEGREES[v],
                    "num_pairs": bins.num_pairs,
                    "evaluated_pairs": int(nc.sum()),
                    "alpha_cover": cover, "total_ms": res["total_ms"],
                    "stage_ms": ms, "peak_gib": res["peak_gib"]}
            print("view " + json.dumps(line), flush=True)
        report["max_abs_err"] = max(report["max_abs_err"], err)

        # --- kernel and plain-version times at view 0's inputs -------------
        kernel_fwd.rasterize_fwd(*inputs0)
        report["ms"] = cuda_ms(lambda: kernel_fwd.rasterize_fwd(*inputs0),
                               reps=20)
        out_t, med, nc = kernel_fwd.rasterize_fwd(*inputs0)
        plain = {}
        report["plain_ms"] = cuda_ms(lambda: plain.__setitem__(
            "r", kernel_fwd.rasterize_fwd_reference(*inputs0)))
        pout, pmed, _ = plain["r"]
        ok_px = torch.isclose(out_t, pout, rtol=TOL, atol=TOL).all(dim=1)
        report["full_image_px_agree"] = ok_px.float().mean().item()
        report["full_image_med_agree"] = (med == pmed).float().mean().item()
        report["full_image_contrib_agree"] = (
            nc == plain["r"][2]).float().mean().item()
        if report["full_image_px_agree"] < MED_AGREE:
            raise AssertionError(
                f"view 0 full image: only {report['full_image_px_agree']:.5f}"
                f" of pixels agree with the plain version at {TOL}")

        # view 0's entry table and slot list: the per-pair expansion
        # gather packed[gid] that K1 does inside, timed by the gather phase
        report["_gather_inputs"] = (inputs0[0], inputs0[1])

        # --- one traced render of view 0: device busy share, top kernels ---
        print("profile " + json.dumps(profile_call(
            lambda: render(cams[0], state, bg))), flush=True)

        # --- bound from this run's inputs (view 0) -------------------------
        packed, gid, ts, tc = inputs0[:4]
        nbytes = sum(x.numel() * x.element_size()
                     for x in (packed, gid, ts, tc, out_t, med, nc))
        ops = OPS_PER_EVAL * int(nc.sum())
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / FP32_OPS_PER_S * 1e3
        report["bound_ms"] = max(t_bytes, t_ops)
        report["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        report["bound_detail"] = {
            "bytes": nbytes, "bytes_ms": t_bytes, "ops": ops,
            "ops_ms": t_ops,
            "gathered_bytes": gid.numel() * (packed.shape[1] * 4 + 4),
            "gathered_ms": gid.numel() * (packed.shape[1] * 4 + 4)
            / HBM_BYTES_PER_S * 1e3}


def grad_err(got, ref, what):
    """The gradient bar (tests/test_rasterize_bwd.py:50-57): rtol 1e-3 /
    atol 5e-4 on values normalised by the reference's largest magnitude.
    Raises if it fails; returns (max abs err, max normalised err)."""
    import torch
    got, ref = got.float(), ref.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: not finite")
    if got.numel() == 0:
        return 0.0, 0.0
    scale = ref.abs().max().clamp(min=1e-6)
    a, b = got / scale, ref / scale
    if not torch.allclose(a, b, rtol=GRAD_RTOL, atol=GRAD_ATOL):
        bad = (a - b).abs() > GRAD_ATOL + GRAD_RTOL * b.abs()
        raise AssertionError(
            f"{what}: {int(bad.sum())} of {bad.numel()} values off the "
            f"gradient bar (max normalised err "
            f"{(a - b).abs().max().item():.3g})")
    return (got - ref).abs().max().item(), (a - b).abs().max().item()


def slot_rows_err(got, ref, what):
    """K2's (P, 22) rows against the plain version's, field by field."""
    errs = [grad_err(got[:, sl], ref[:, sl], f"{what} {name}")
            for name, sl in DFLD.items()]
    return max(e[0] for e in errs), max(e[1] for e in errs)


def k2_inputs(cam, state, noise, cot_seed):
    """K1's inputs and outputs for a view plus a seeded 15-channel
    cotangent: the arguments of rasterize_bwd."""
    import numpy as np
    import torch

    from gs2d_torch.ops.rasterize.api import pack_entries
    from gs2d_torch.ops.rasterize.binning import bin_gaussians
    from gs2d_torch.ops.rasterize.kernel_fwd import rasterize_fwd
    from gs2d_torch.render.renderer import prepare

    with torch.no_grad():
        pre = prepare(cam, state, noise=noise)
        bins = bin_gaussians(pre.center2d, pre.extent, pre.depth,
                             pre.visible, cam.width, cam.height)
        fargs = (pack_entries(pre), bins.gid, bins.tile_start,
                 bins.tile_count)
        out, med, nc = rasterize_fwd(*fargs, cam.width, cam.height)
    cot = torch.as_tensor(np.random.default_rng(cot_seed).normal(
        size=tuple(out.shape)).astype(np.float32), device=out.device)
    return fargs + (out, cot, med, nc, cam.width, cam.height)


def render_grads(cam, state, noise, seed):
    """Per-Gaussian gradients through render (prepare → rasterize →
    bridge, as render() composes them) of a seeded linear loss of the 15
    raster channels, the image and the surface depth: (names, grads)."""
    import dataclasses

    import numpy as np
    import torch

    from gs2d_torch.models.gaussians import GaussianParams
    from gs2d_torch.ops.rasterize.api import rasterize
    from gs2d_torch.render.renderer import bridge, prepare
    from gs2d_torch.train.optim import FIELDS

    dev = state.params.xyz.device
    leaves = {f: getattr(state.params, f).detach().clone().requires_grad_()
              for f in FIELDS}
    leaves["noise"] = noise.detach().clone().requires_grad_()
    leaves["screen_offsets"] = torch.zeros(
        (noise.shape[0], 2), device=dev, requires_grad=True)
    st = dataclasses.replace(state, params=GaussianParams(
        **{f: leaves[f] for f in FIELDS}))
    pre = prepare(cam, st, noise=leaves["noise"],
                  screen_offsets=leaves["screen_offsets"])
    out, aux = rasterize(pre, cam.width, cam.height)
    pkg = bridge(cam, pre, out, aux, torch.zeros(3, device=dev), 1.0)
    rng = np.random.default_rng(seed)

    def cot(x):
        return torch.as_tensor(rng.normal(size=tuple(x.shape)).astype(
            np.float32), device=dev)

    loss = (cot(out) * out).sum() + (cot(pkg["render"]) * pkg["render"]) \
        .sum() + (cot(pkg["surf_depth"]) * pkg["surf_depth"]).sum()
    return list(leaves), torch.autograd.grad(loss, list(leaves.values()))


def overfit():
    """30 steps of train_step on a tiny scene, in the shape of
    tests/test_train_smoke.py: the render of a "true" Gaussian set is the
    target, the learner starts from jittered points, on the card.
    → losses."""
    import numpy as np
    import torch

    from gs2d_torch.config import OptimizationParams
    from gs2d_torch.models.gaussians import GaussianParams, GaussianState
    from gs2d_torch.ops.sh import rgb_to_sh
    from gs2d_torch.render.renderer import render
    from gs2d_torch.train.optim import init_adam
    from gs2d_torch.train.step import TrainState, make_train_step

    means, scales, quats, opac, rgb, _ = random_cloud(
        30, 5, spread=0.8, scale_lo=0.1, scale_hi=0.3)
    n = means.shape[0]
    dev = lambda x: torch.as_tensor(np.ascontiguousarray(x),  # noqa: E731
                                    dtype=torch.float32, device="cuda")

    def state(xyz, colors, rot, logit):
        return GaussianState(params=GaussianParams(
            xyz=dev(xyz), features_dc=dev(rgb_to_sh(colors)[:, None, :]),
            features_rest=torch.zeros((n, 15, 3), device="cuda"),
            scaling=dev(np.log(scales)), rotation=dev(rot),
            opacity=dev(logit)), active_sh_degree=0)

    cam = lookat(64, 32)
    bg = torch.zeros(3, device="cuda")
    logit = np.log(opac / (1 - opac))[:, None]
    with torch.no_grad():
        gt = render(cam, state(means, rgb, quats, logit), bg)["render"]
    jitter = np.random.default_rng(7).normal(scale=0.05, size=means.shape)
    learner = state(means + jitter, rgb * 0.5 + 0.25,
                    np.random.default_rng(1).random((n, 4)),
                    np.full((n, 1), np.log(0.1 / 0.9)))
    step = make_train_step(OptimizationParams(position_lr_init=0.002,
                                              position_lr_final=0.0002),
                           max_sh_degree=3)
    ts = TrainState(gaussians=learner, opt=init_adam(learner.params))
    losses = []
    for it in range(1, 31):
        ts, metrics = step(ts, cam, gt, it, bg)
        losses.append(float(metrics["total_loss"]))
    return losses


def small_train(report):
    """Phase 4: K2 against its plain version and gradients on the card
    against the CPU on the small scenes; a 30-step overfit on the card."""
    import torch

    from gs2d_torch.ops.rasterize.kernel_bwd import (rasterize_bwd,
                                                     rasterize_bwd_reference)

    abs_err = norm_err = 0.0
    for i, (name, w, h, cloud) in enumerate(small_scene_list()):
        state, noise = cloud_state(cloud, "cuda")
        args = k2_inputs(lookat(w, h), state, noise, cot_seed=i)
        got = rasterize_bwd(*args)
        torch.cuda.synchronize()
        a, b = slot_rows_err(got, rasterize_bwd_reference(*args),
                             f"{name} K2")
        abs_err, norm_err = max(abs_err, a), max(norm_err, b)
        # through render: the card against CPU tensors (plain versions)
        names, g_card = render_grads(lookat(w, h), state, noise, seed=i)
        c_state, c_noise = cloud_state(cloud, "cpu")
        cam_cpu = lookat(w, h, device="cpu")
        _, g_cpu = render_grads(cam_cpu, c_state, c_noise, seed=i)
        worst = 0.0
        for f, x, y in zip(names, g_card, g_cpu):
            worst = max(worst, grad_err(x.cpu(), y, f"{name} d {f}")[1])
        print(f"small scene {name}: K2 vs plain max abs err {a:.3g} "
              f"(normalised {b:.3g}); card vs CPU gradients of "
              f"{', '.join(names)}: max normalised err {worst:.3g}",
              flush=True)
    report["max_abs_err"] = abs_err
    report["max_norm_err"] = norm_err
    losses = overfit()
    if not all(math.isfinite(x) for x in losses) \
            or not losses[-1] < 0.7 * losses[0]:
        raise AssertionError(f"overfit on the card: losses {losses}")
    print(f"overfit 64x32, 30 steps on the card: loss {losses[0]:.5f} -> "
          f"{losses[-1]:.5f}", flush=True)


class StageMarks:
    """CUDA events around the train step's stages, by wrapping the
    functions it looks up at call time (train/step.py: render,
    compute_losses, apply_update; ops/rasterize/api.py: rasterize_bwd,
    reduce_slot_grads). Keeps each stage's last arguments and result."""

    def __init__(self):
        import gs2d_torch.ops.rasterize.api as api
        import gs2d_torch.train.step as step_mod
        self.targets = [(step_mod, "render"), (step_mod, "compute_losses"),
                        (api, "rasterize_bwd"), (api, "reduce_slot_grads"),
                        (step_mod, "apply_update")]
        self.events, self.seen = {}, {}

    def __enter__(self):
        self.saved = [getattr(m, n) for m, n in self.targets]
        for (mod, name), fn in zip(self.targets, self.saved):
            setattr(mod, name, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for (mod, name), fn in zip(self.targets, self.saved):
            setattr(mod, name, fn)

    def _wrap(self, name, fn):
        import torch

        def wrapped(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            res = fn(*args, **kw)
            end.record()
            self.events[name] = (start, end)
            self.seen[name] = (args, res)
            return res
        return wrapped

    def stage_ms(self):
        """Per-stage device ms of the last step (after a synchronize)."""
        ev = self.events

        def ms(a, b):
            return a.elapsed_time(b)
        return {
            "forward_render": ms(*ev["render"]),
            "losses": ms(*ev["compute_losses"]),
            "loss_and_bridge_bwd": ms(ev["compute_losses"][1],
                                      ev["rasterize_bwd"][0]),
            "rasterize_bwd": ms(*ev["rasterize_bwd"]),
            "reduction": ms(*ev["reduce_slot_grads"]),
            "preprocess_sh_bwd": ms(ev["reduce_slot_grads"][1],
                                    ev["apply_update"][0]),
            "adam_stats": ms(*ev["apply_update"])}


def full_train(report, state):
    """Phase 6: train_step at the bench.py train-step point (1M splats,
    SH degree 3, 1920x1080, lambda_dist 10, depth_ratio 1, iteration
    8000), with K2 checked against its plain version on view 0."""
    import numpy as np
    import torch

    from gs2d_torch.config import OptimizationParams
    from gs2d_torch.ops.rasterize import kernel_bwd, kernel_fwd
    from gs2d_torch.train.optim import FIELDS, init_adam
    from gs2d_torch.train.step import (TrainState, loss_and_grads,
                                       make_train_step)

    cam = bench_camera(0.0)
    gt = torch.as_tensor(np.random.default_rng(1).random(
        (3, HEIGHT, WIDTH), np.float32), device="cuda")
    bg = torch.zeros(3, device="cuda")
    cfg = OptimizationParams(lambda_dist=10.0)
    step = make_train_step(cfg, max_sh_degree=SH_DEGREE, depth_ratio=1.0)
    ts = TrainState(gaussians=state, opt=init_adam(state.params))
    ts, _ = step(ts, cam, gt, TRAIN_ITER, bg)                  # warm-up
    torch.cuda.synchronize()

    # --- the main path: counts from zero, TRAIN_STEPS steps ---------------
    kernel_fwd.rasterize_fwd.launches = 0
    kernel_bwd.rasterize_bwd.launches = 0
    step_ms = []
    with StageMarks() as marks:
        for i in range(TRAIN_STEPS):
            torch.cuda.reset_peak_memory_stats()
            before = (kernel_fwd.rasterize_fwd.launches,
                      kernel_bwd.rasterize_bwd.launches)
            denom0 = ts.gaussians.denom
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            ts, metrics = step(ts, cam, gt, TRAIN_ITER, bg)
            end.record()
            end.synchronize()
            step_ms.append(start.elapsed_time(end))
            counts = (kernel_fwd.rasterize_fwd.launches - before[0],
                      kernel_bwd.rasterize_bwd.launches - before[1])
            if counts != (1, 1):
                raise AssertionError(f"step {i}: rasterize_fwd, "
                                     f"rasterize_bwd launched {counts}")
            # finite gradients, parameters and statistics; denom grows by
            # one exactly on the Gaussians visible in this step
            args, _ = marks.seen["apply_update"]
            grads, screen_grads = args[2], args[3]
            g = ts.gaussians
            for what, x in ([(f"d {f}", getattr(grads, f)) for f in FIELDS]
                            + [(f, getattr(g.params, f)) for f in FIELDS]
                            + [("d screen offsets", screen_grads),
                               ("max_radii2d", g.max_radii2d),
                               ("grad_accum", g.grad_accum),
                               ("denom", g.denom)]):
                if not torch.isfinite(x).all():
                    raise AssertionError(f"step {i}: {what} not finite")
            vis = marks.seen["render"][1]["radii"] > 0
            if not torch.equal(g.denom - denom0, vis.float()) \
                    or int(vis.sum()) == 0:
                raise AssertionError(f"step {i}: denom did not grow by one "
                                     f"on exactly the visible Gaussians")
            line = {"step": i, "step_ms": step_ms[-1],
                    "stage_ms": marks.stage_ms(),
                    "loss": {k: float(metrics[k]) for k in (
                        "total_loss", "l1", "ssim", "loss", "dist_loss",
                        "normal_loss")},
                    "num_pairs": metrics["num_pairs"],
                    "visible": int(vis.sum()),
                    "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
            print("train " + json.dumps(line), flush=True)
        bwd_args = marks.seen["rasterize_bwd"][0]
    launches = kernel_bwd.rasterize_bwd.launches
    report["launches"] = launches
    report["launches_by_path"] = {"train_step": launches}
    report["fwd_launches_train"] = kernel_fwd.rasterize_fwd.launches
    report["step_ms"] = sum(step_ms) / len(step_ms)
    report["card_steps_per_s"] = 1e3 / report["step_ms"]

    # --- one traced step: device busy share, top kernels ------------------
    print("profile_train " + json.dumps(profile_call(
        lambda: step(ts, cam, gt, TRAIN_ITER, bg), top=12)), flush=True)

    # --- per-Gaussian gradients of two backward passes, bit for bit -------
    st = ts.gaussians
    runs = [loss_and_grads(st, cam, gt, TRAIN_ITER, bg, cfg,
                           max_sh_degree=SH_DEGREE, depth_ratio=1.0)
            for _ in range(2)]
    for f in FIELDS:
        if not torch.equal(getattr(runs[0][2], f), getattr(runs[1][2], f)):
            raise AssertionError(f"two backward passes differ in d {f}")
    if not torch.equal(runs[0][3], runs[1][3]):
        raise AssertionError("two backward passes differ in d offsets")
    del runs
    print("two backward passes: per-Gaussian gradients bit-identical",
          flush=True)

    # --- K2 against its plain version at the step's inputs ----------------
    packed, gid, tstart, tcount, out, cot, med, nc, _, _ = bwd_args
    with torch.no_grad():
        d = kernel_bwd.rasterize_bwd(*bwd_args)
        T = out.shape[0]
        tiles = [int(tcount.argmax())] + np.random.default_rng(0).choice(
            T, SAMPLED_TILES, replace=False).tolist()
        idx = torch.cat([torch.arange(int(tstart[t]),
                                      int(tstart[t] + tcount[t]),
                                      device="cuda") for t in tiles])
        a, b = slot_rows_err(d[idx], kernel_bwd.rasterize_bwd_reference(
            *bwd_args, tiles=tiles), "view 0 sampled tiles K2")
        print(f"view 0 K2 vs plain, busiest tile ({int(tcount.max())} "
              f"slots) and {SAMPLED_TILES} seeded tiles: max abs err "
              f"{a:.3g} (normalised {b:.3g})", flush=True)
        report["ms"] = cuda_ms(lambda: kernel_bwd.rasterize_bwd(*bwd_args),
                               reps=KERNEL_REPS)
        plain = {}
        report["plain_ms"] = cuda_ms(lambda: plain.__setitem__(
            "r", kernel_bwd.rasterize_bwd_reference(*bwd_args)))
        a, b = slot_rows_err(d, plain.pop("r"), "view 0 all tiles K2")
        report["max_abs_err"] = max(report["max_abs_err"], a)
        report["max_norm_err"] = max(report["max_norm_err"], b)
        print(f"view 0 K2 vs plain, all {T} tiles: max abs err {a:.3g} "
              f"(normalised {b:.3g}); K2 {report['ms']:.3f} ms, plain "
              f"{report['plain_ms']:.1f} ms", flush=True)

    # --- bound from this run's inputs --------------------------------------
    nbytes = sum(x.numel() * x.element_size()
                 for x in (packed, gid, tstart, tcount, out, cot, med, nc, d))
    ops = OPS_PER_EVAL_BWD * int(nc.sum())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    report["bound_ms"] = max(t_bytes, t_ops)
    report["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    report["bound_detail"] = {"bytes": nbytes, "bytes_ms": t_bytes,
                              "ops": ops, "ops_ms": t_ops,
                              "evaluated_pairs": int(nc.sum()),
                              "max_n_contrib": int(nc.max())}


def gather_bytes(table, idx) -> int:
    """What the row gather must move: the table and the indices read
    once, the (M, F) output written once."""
    return (table.numel() * 4 + idx.numel() * idx.element_size()
            + idx.numel() * table.shape[1] * 4)


def time_gather(table, idx) -> dict:
    """The row-gather kernel alone (``ms``: launches into one output, no
    allocation, no flag read), its wrapper ``gather_rows`` (``wrapper_ms``:
    allocation, launch and the out-of-range flag read, one host sync per
    call), ``torch.index_select`` and the plain version on the same
    inputs, each the mean of KERNEL_REPS calls, with the bound from their
    bytes."""
    import torch

    from gs2d_torch.ops import gather
    out = torch.empty((idx.numel(), table.shape[1]), device="cuda")
    bad = torch.zeros(1, dtype=torch.int32, device="cuda")
    gather.gather_rows(table, idx)
    torch.index_select(table, 0, idx)
    res = {"N": table.shape[0], "F": table.shape[1], "M": idx.numel(),
           "index_dtype": str(idx.dtype).replace("torch.", ""),
           "ms": cuda_ms(lambda: gather.launch(table, idx, out, bad),
                         reps=KERNEL_REPS),
           "wrapper_ms": cuda_ms(lambda: gather.gather_rows(table, idx),
                                 reps=KERNEL_REPS),
           "library_ms": cuda_ms(lambda: torch.index_select(table, 0, idx),
                                 reps=KERNEL_REPS),
           "plain_ms": cuda_ms(lambda: gather.gather_rows_reference(
               table, idx), reps=KERNEL_REPS),
           "bytes": gather_bytes(table, idx)}
    if bad.item() or not torch.equal(out, table[idx.long()]):
        raise AssertionError("gather kernel timing: output differs")
    res["bound_ms"] = res["bytes"] / HBM_BYTES_PER_S * 1e3
    return res


def gather_phase(report, table0, gid0):
    """Phase 8: the row-gather kernel (G1–G5) bit for bit against
    table[idx] for every F of GATHER_F, M in {0, 1, 1000, GATHER_M}, both
    index types (negative indices included) and out-of-range indices,
    which must raise; then timed at the probes' shape and at view 0's
    expansion gather packed[gid]."""
    import torch

    from gs2d_torch.ops.gather import gather_rows
    g = torch.Generator(device="cuda").manual_seed(0)
    before, calls, cases = gather_rows.launches, 0, 0
    for f in GATHER_F:
        table = torch.rand((GATHER_N, f), generator=g, device="cuda")
        for dtype in (torch.int32, torch.int64):
            for m in (0, 1, 1000, GATHER_M):
                idx = torch.randint(-GATHER_N, GATHER_N, (m,), generator=g,
                                    dtype=dtype, device="cuda")
                out = gather_rows(table, idx)
                calls += m > 0
                cases += 1
                if tuple(out.shape) != (m, f) \
                        or not torch.equal(out, table[idx.long()]):
                    raise AssertionError(f"gather_rows F={f} M={m} {dtype}: "
                                         f"not equal to table[idx]")
            for bad in (GATHER_N, -GATHER_N - 1):
                try:
                    gather_rows(table, torch.tensor([0, bad], dtype=dtype,
                                                    device="cuda"))
                except IndexError:
                    calls += 1
                else:
                    raise AssertionError(f"gather_rows F={f} {dtype}: index "
                                         f"{bad} of {GATHER_N} rows did not "
                                         f"raise")
        del table, out
    if gather_rows.launches - before != calls:
        raise AssertionError(f"gather_rows launched "
                             f"{gather_rows.launches - before} times for "
                             f"{calls} non-empty calls")
    print(f"gather: {cases} cases (F {list(GATHER_F)}, M 0/1/1000/"
          f"{GATHER_M}, int32 and int64) bit-identical to table[idx]; "
          f"out-of-range indices raise", flush=True)

    probe = time_gather(
        torch.rand((GATHER_N, 24), generator=g, device="cuda"),
        torch.randint(0, GATHER_N, (GATHER_M,), generator=g,
                      dtype=torch.int32, device="cuda"))
    print("gather probe shape " + json.dumps(probe), flush=True)
    view0 = time_gather(table0, gid0)
    if not torch.equal(gather_rows(table0, gid0), table0[gid0.long()]):
        raise AssertionError("gather_rows packed[gid] of view 0 differs")
    print("gather view 0 packed[gid] " + json.dumps(view0), flush=True)
    report["max_abs_err"] = 0.0
    for k in ("ms", "wrapper_ms", "plain_ms", "bound_ms", "library_ms"):
        report[k] = view0[k]
    report["bound_by"] = "bytes"
    report["bound_detail"] = {"bytes": view0["bytes"], "N": view0["N"],
                              "F": view0["F"], "M": view0["M"]}
    report["probe_shape"] = probe


class LoopScene:
    """The in-memory scene ``gs2d_torch.train.loop.train`` takes (the
    dataset loaders are not ported yet)."""

    def __init__(self, gaussians, cameras_extent, model_path, cams):
        self.gaussians = gaussians
        self.cameras_extent = cameras_extent
        self.model_path = model_path
        self.cams = cams
        self.saved = []

    def get_train_cameras(self):
        return self.cams

    def save(self, iteration, state):
        self.saved.append(iteration)


def psnr(img, ref) -> float:
    mse = float(((img - ref) ** 2).mean())
    return -10.0 * math.log10(max(mse, 1e-10))


def small_loop():
    """Phase 7: the card twin of tests/test_loop_e2e.py — three 64x32
    views of a 40-splat scene, a learner from 12 displaced flat-gray
    points, 300 iterations of train() with densify every 20 and a reset
    every 120. → (N, losses, PSNR before, PSNR after)."""
    import numpy as np
    import torch

    from gs2d_torch.config import (ModelParams, OptimizationParams,
                                   PipelineParams, RuntimeParams)
    from gs2d_torch.models.gaussians import init_from_pcd
    from gs2d_torch.render.renderer import render
    from gs2d_torch.scene.cameras import CameraData
    from gs2d_torch.train.loop import train

    means, scales, _, _, rgb, _ = random_cloud(40, 3, spread=0.9,
                                               scale_lo=0.08, scale_hi=0.35)
    true = init_from_pcd(means, rgb, init_scales=np.log(scales), seed=0)
    bg = torch.zeros(3, device="cuda")
    cams = [lookat(64, 32, dist=d) for d in (4.0, 3.4, 4.7)]
    with torch.no_grad():
        imgs = [render(c, true, bg)["render"] for c in cams]
    init_pts = means[:12] + np.random.default_rng(11).normal(
        scale=0.15, size=(12, 3)).astype(np.float32)
    learner = init_from_pcd(init_pts, np.full((12, 3), 0.5, np.float32),
                            max_sh_degree=2, seed=0)
    scene = LoopScene(learner, 1.5, "", [
        CameraData(camera=c, image=img, image_name=f"v{i}", uid=i)
        for i, (c, img) in enumerate(zip(cams, imgs))])
    logs = []
    ts, _ = train(ModelParams(sh_degree=2), OptimizationParams(**SMALL_LOOP),
                  PipelineParams(), RuntimeParams(seed=0), scene=scene,
                  test_iterations=(), save_iterations=(),
                  log_fn=lambda it, r: logs.append(r["loss"]))

    def view0(state):
        with torch.no_grad():
            return psnr(render(cams[0], state, bg, max_sh_degree=2)
                        ["render"], imgs[0])

    return (ts.gaussians.params.xyz.shape[0], logs, view0(learner),
            view0(ts.gaussians))


class LoopProbe:
    """Wraps what ``gs2d_torch.train.loop`` looks up at call time — the
    step, densify, the opacity reset and the checkpoint writer — to time
    them with CUDA events and check each call: K1 and K2 once per step;
    after each densify the N equation, the gather launches its code
    implies, bit-identity with a replay through the plain gather on the
    same inputs and noise, and finite parameters and moments; after each
    reset the opacity cap and zero opacity moments."""

    def __init__(self):
        import gs2d_torch.models.densify as densify_mod
        import gs2d_torch.train.loop as loop_mod
        self.loop_mod, self.densify_mod = loop_mod, densify_mod
        self.names = ("make_train_step", "densify_and_prune",
                      "reset_opacity", "save_checkpoint", "load_checkpoint")
        self.steps, self.densify, self.resets, self.ckpt = [], [], [], []
        self.loaded = None

    def __enter__(self):
        self.saved = {k: getattr(self.loop_mod, k) for k in self.names}
        for k in self.names:
            setattr(self.loop_mod, k, getattr(self, "_" + k))
        return self

    def __exit__(self, *exc):
        for k, fn in self.saved.items():
            setattr(self.loop_mod, k, fn)

    def _make_train_step(self, *args, **kw):
        import torch

        from gs2d_torch.ops.rasterize import kernel_bwd, kernel_fwd
        step = self.saved["make_train_step"](*args, **kw)

        def probed(ts, camera, gt, iteration, bg):
            k1 = kernel_fwd.rasterize_fwd.launches
            k2 = kernel_bwd.rasterize_bwd.launches
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            ts, metrics = step(ts, camera, gt, iteration, bg)
            end.record()
            counts = (kernel_fwd.rasterize_fwd.launches - k1,
                      kernel_bwd.rasterize_bwd.launches - k2)
            if counts != (1, 1):
                raise AssertionError(f"iteration {iteration}: rasterize_fwd, "
                                     f"rasterize_bwd launched {counts}")
            self.steps.append((int(iteration), start, end,
                               metrics["num_pairs"], metrics["num_points"]))
            return ts, metrics
        return probed

    def _densify_and_prune(self, state, opt, *args, generator, **kw):
        import torch

        from gs2d_torch.ops.gather import gather_rows, gather_rows_reference
        from gs2d_torch.train.optim import FIELDS
        real = self.saved["densify_and_prune"]
        gen_state = generator.get_state()
        n0 = state.params.xyz.shape[0]
        marks = []

        def timed_gather(table, idx):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = gather_rows(table, idx)
            e.record()
            marks.append((s, e))
            return out

        before = gather_rows.launches
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        self.densify_mod.gather_rows = timed_gather
        try:
            t0.record()
            new_s, new_o, c = real(state, opt, *args, generator=generator,
                                   **kw)
            t1.record()
        finally:
            self.densify_mod.gather_rows = gather_rows
        t1.synchronize()
        launches = gather_rows.launches - before
        n1 = new_s.params.xyz.shape[0]
        it = self.steps[-1][0]
        if n1 != n0 - c.pruned + c.clone + 2 * c.split - c.culled:
            raise AssertionError(f"densify at {it}: N {n0} -> {n1} with {c}")
        # one launch per parameter leaf and per moment leaf that has rows,
        # one for the kept split children's noise
        expect = 6 * (n1 > 0) + 12 * (n0 > c.pruned) + (c.children > 0)
        if launches != expect:
            raise AssertionError(f"densify at {it}: gather_rows launched "
                                 f"{launches} times, its code implies "
                                 f"{expect}")
        # the same call through the plain gather, with the same noise
        replay = torch.Generator(device=generator.device)
        replay.set_state(gen_state)
        self.densify_mod.gather_rows = gather_rows_reference
        try:
            ref_s, ref_o, ref_c = real(state, opt, *args, generator=replay,
                                       **kw)
        finally:
            self.densify_mod.gather_rows = gather_rows
        if gather_rows.launches != before + launches or ref_c != c:
            raise AssertionError(f"densify at {it}: the replay launched the "
                                 f"kernel or counted {ref_c} against {c}")
        pairs = [(f"params.{f}", getattr(new_s.params, f),
                  getattr(ref_s.params, f)) for f in FIELDS]
        pairs += [(f"{m}.{f}", getattr(getattr(new_o, m), f),
                   getattr(getattr(ref_o, m), f))
                  for m in ("mu", "nu") for f in FIELDS]
        pairs += [(f, getattr(new_s, f), getattr(ref_s, f))
                  for f in ("max_radii2d", "grad_accum", "denom")]
        for what, a, b in pairs:
            if not torch.equal(a, b):
                raise AssertionError(f"densify at {it}: {what} differs from "
                                     f"the plain gather's")
            if not torch.isfinite(a).all():
                raise AssertionError(f"densify at {it}: {what} not finite")
        del ref_s, ref_o, pairs
        self.densify.append({
            "iteration": it, "n_before": n0, "n_after": n1,
            "clone": c.clone, "split": c.split, "pruned": c.pruned,
            "culled": c.culled, "children": c.children,
            "ms": t0.elapsed_time(t1),
            "gather_ms": sum(s.elapsed_time(e) for s, e in marks),
            "gather_launches": launches})
        return new_s, new_o, c

    def _reset_opacity(self, state, opt):
        import torch
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        new_s, new_o = self.saved["reset_opacity"](state, opt)
        t1.record()
        t1.synchronize()
        it = self.steps[-1][0]
        o = torch.sigmoid(new_s.params.opacity)
        if not torch.isfinite(new_s.params.opacity).all() \
                or float(o.max()) > 0.01 + 1e-6:
            raise AssertionError(f"reset at {it}: sigmoid(opacity) up to "
                                 f"{float(o.max())}")
        if new_o.mu.opacity.any() or new_o.nu.opacity.any():
            raise AssertionError(f"reset at {it}: opacity moments not zero")
        self.resets.append({"iteration": it, "ms": t0.elapsed_time(t1),
                            "n": new_s.params.xyz.shape[0]})
        return new_s, new_o

    def _save_checkpoint(self, path, *args, **kw):
        t0 = time.perf_counter()
        self.saved["save_checkpoint"](path, *args, **kw)
        self.ckpt.append({"path": path, "write_s": time.perf_counter() - t0,
                          "bytes": Path(path).stat().st_size})

    def _load_checkpoint(self, path, *args, **kw):
        import torch
        t0 = time.perf_counter()
        res = self.saved["load_checkpoint"](path, *args, **kw)
        torch.cuda.synchronize()
        self.loaded = {"read_s": time.perf_counter() - t0,
                       "bytes": Path(path).stat().st_size}
        return res


def nerfpp_radius(cams) -> float:
    """The scene extent of gs2d_tpu/scene/dataset.py:50-62: 1.1 × the
    largest distance of a camera centre from their mean."""
    import numpy as np
    centers = np.stack([c.campos.cpu().numpy() for c in cams])
    return float(np.linalg.norm(centers - centers.mean(0), axis=1).max()
                 * 1.1)


def same_state(a, b) -> bool:
    """Two TrainStates bit for bit: parameters, moments, statistics."""
    import torch

    from gs2d_torch.train.optim import FIELDS
    ga, gb = a.gaussians, b.gaussians
    return (all(torch.equal(getattr(x, f), getattr(y, f)) for f in FIELDS
                for x, y in ((ga.params, gb.params), (a.opt.mu, b.opt.mu),
                             (a.opt.nu, b.opt.nu)))
            and all(torch.equal(getattr(ga, f), getattr(gb, f))
                    for f in ("max_radii2d", "grad_accum", "denom"))
            and a.opt.step == b.opt.step
            and ga.active_sh_degree == gb.active_sh_degree)


def full_loop(report, state):
    """Phase 9: train() at full width. The 1M-splat SH-3 scene is the
    true scene: its renders of the VIEW_DEGREES views (zero background)
    are the ground truth. The learner is that scene perturbed with
    default_rng(2) (xyz + N(0, 0.01²), scaling + N(0, 0.1²), features_dc +
    N(0, 0.1²)), written as a checkpoint at LOOP_FROM with fresh Adam
    moments; train() resumes from it and runs to LOOP_TO with the
    reference schedule (lambda_dist 10, depth_ratio 1), writing a
    checkpoint at LOOP_TO, which must resume bit for bit."""
    import shutil

    import numpy as np
    import torch

    from gs2d_torch.config import (ModelParams, OptimizationParams,
                                   PipelineParams, RuntimeParams)
    from gs2d_torch.models.gaussians import GaussianParams, GaussianState
    from gs2d_torch.models.io import load_checkpoint, save_checkpoint
    from gs2d_torch.ops.gather import gather_rows
    from gs2d_torch.ops.rasterize import kernel_bwd, kernel_fwd
    from gs2d_torch.render.renderer import render
    from gs2d_torch.scene.cameras import CameraData
    from gs2d_torch.train.loop import train
    from gs2d_torch.train.optim import FIELDS, init_adam
    from gs2d_torch.train.step import TrainState, make_train_step

    cams = [bench_camera(th) for th in VIEW_DEGREES]
    bg = torch.zeros(3, device="cuda")
    with torch.no_grad():
        gts = [render(c, state, bg)["render"] for c in cams]
    extent = nerfpp_radius(cams)
    rng = np.random.default_rng(2)
    p = state.params

    def noisy(x, sigma):
        return x + torch.as_tensor(rng.normal(0.0, sigma, tuple(x.shape))
                                   .astype(np.float32), device="cuda")

    xyz, scaling = noisy(p.xyz, 0.01), noisy(p.scaling, 0.1)
    learner = GaussianState(params=GaussianParams(
        xyz=xyz, features_dc=noisy(p.features_dc, 0.1),
        features_rest=p.features_rest, scaling=scaling, rotation=p.rotation,
        opacity=p.opacity), active_sh_degree=SH_DEGREE)
    out_dir = ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    start = str(out_dir / f"chkpnt{LOOP_FROM}.npz")
    t0 = time.perf_counter()
    save_checkpoint(start, learner, init_adam(learner.params), LOOP_FROM,
                    extent)
    start_write_s = time.perf_counter() - t0
    scene = LoopScene(learner, extent, str(out_dir), [
        CameraData(camera=c, image=g, image_name=f"view{i}", uid=i)
        for i, (c, g) in enumerate(zip(cams, gts))])
    cfg = OptimizationParams(iterations=LOOP_TO, lambda_dist=10.0)
    n_start = learner.params.xyz.shape[0]
    del learner, xyz, scaling

    # --- the main path: counts from zero, train() from the checkpoint ------
    logs = []
    kernel_fwd.rasterize_fwd.launches = 0
    kernel_bwd.rasterize_bwd.launches = 0
    gather_rows.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with LoopProbe() as probe:
        ts, _ = train(ModelParams(sh_degree=SH_DEGREE), cfg,
                      PipelineParams(depth_ratio=1.0), RuntimeParams(seed=0),
                      scene=scene, test_iterations=(), save_iterations=(),
                      checkpoint_iterations=(LOOP_TO,),
                      start_checkpoint=start,
                      log_fn=lambda it, r: logs.append((it, r)))
        torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = {"rasterize_fwd": kernel_fwd.rasterize_fwd.launches,
                "rasterize_bwd": kernel_bwd.rasterize_bwd.launches,
                "gather_rows": gather_rows.launches}
    n_steps = LOOP_TO - LOOP_FROM
    if [s[0] for s in probe.steps] != list(range(LOOP_FROM + 1,
                                                 LOOP_TO + 1)):
        raise AssertionError("train() did not resume at "
                             f"{LOOP_FROM + 1} and run to {LOOP_TO}")
    if launches["rasterize_fwd"] != n_steps \
            or launches["rasterize_bwd"] != n_steps:
        raise AssertionError(f"loop launches {launches} for {n_steps} steps")
    if [d["iteration"] for d in probe.densify] != [3000, 3100] \
            or [r["iteration"] for r in probe.resets] != [3000]:
        raise AssertionError("densify / reset off the reference schedule: "
                             f"{probe.densify} {probe.resets}")
    if launches["gather_rows"] != sum(d["gather_launches"]
                                      for d in probe.densify):
        raise AssertionError("gather_rows launched outside densify")
    if probe.densify[0]["n_before"] != n_start:
        raise AssertionError("the resumed state lost rows")
    for it, rec in logs:
        if not all(math.isfinite(rec[k]) for k in ("loss", "dist",
                                                   "normal")):
            raise AssertionError(f"iteration {it}: logged loss {rec}")
    g = ts.gaussians
    for f in FIELDS:
        for what, tree in (("params", g.params), ("mu", ts.opt.mu),
                           ("nu", ts.opt.nu)):
            if not torch.isfinite(getattr(tree, f)).all():
                raise AssertionError(f"after the loop: {what}.{f} not "
                                     f"finite")

    # --- per-window step times, pairs, densify and reset -------------------
    windows = []
    for lo in range(LOOP_FROM, LOOP_TO, 100):
        win = [s for s in probe.steps if lo < s[0] <= lo + 100]
        ms = [s[1].elapsed_time(s[2]) for s in win]
        windows.append({"iterations": f"{lo + 1}-{lo + 100}",
                        "mean_step_ms": sum(ms) / len(ms),
                        "min_step_ms": min(ms), "max_step_ms": max(ms),
                        "pairs_min": min(s[3] for s in win),
                        "pairs_max": max(s[3] for s in win),
                        "points": sorted({s[4] for s in win})})
    for w in windows:
        print("loop window " + json.dumps(w), flush=True)
    for d in probe.densify:
        print("loop densify " + json.dumps(d), flush=True)
    for r in probe.resets:
        print("loop reset " + json.dumps(r), flush=True)
    probe.loaded["write_s"] = start_write_s
    print(f"loop start checkpoint ({n_start} splats) " +
          json.dumps(probe.loaded), flush=True)
    print(f"loop N: {n_start} at {LOOP_FROM}, "
          f"{probe.densify[0]['n_after']} at 3000, "
          f"{probe.densify[1]['n_after']} at 3100; {n_steps} steps in "
          f"{loop_s:.1f} s (densify replays and checks included); peak "
          f"{peak:.2f} GiB", flush=True)

    # --- resume: the checkpoint at LOOP_TO against the in-memory state -----
    ck = probe.ckpt[-1]
    t0 = time.perf_counter()
    gs2, opt2, it2, _ = load_checkpoint(ck["path"])
    torch.cuda.synchronize()
    ck["read_s"] = time.perf_counter() - t0
    loaded = TrainState(gaussians=gs2, opt=opt2)
    if it2 != LOOP_TO or not same_state(loaded, ts):
        raise AssertionError("the checkpoint does not hold the loop's state")
    step = make_train_step(cfg, max_sh_degree=SH_DEGREE,
                           spatial_lr_scale=extent, depth_ratio=1.0)
    a, b = ts, loaded
    for i in range(RESUME_STEPS):
        v = i % len(cams)
        a, _ = step(a, cams[v], gts[v], LOOP_TO + 1 + i, bg)
        b, _ = step(b, cams[v], gts[v], LOOP_TO + 1 + i, bg)
    if not same_state(a, b):
        raise AssertionError(f"{RESUME_STEPS} steps from the loaded "
                             f"checkpoint differ from the in-memory state")
    ck.pop("path")
    print("loop checkpoint " + json.dumps(ck) + f"; {RESUME_STEPS} steps "
          "from it bit-identical to the in-memory state", flush=True)
    shutil.rmtree(out_dir, ignore_errors=True)
    report.update(launches=launches, windows=windows,
                  densify=probe.densify, resets=probe.resets,
                  checkpoint=ck, start_checkpoint=probe.loaded,
                  peak_gib=peak)


def main() -> int:
    if not (ROOT / "gs2d_torch" / "csrc").is_dir():
        print("chip_smoke.py: run it from a checkout of the repo (no "
              "gs2d_torch package beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2

    card = card_line()
    print(f"card: {card}", flush=True)

    from gs2d_torch import cuda_build
    t0 = time.time()
    reports = cuda_build.build_all()
    print(f"build: {time.time() - t0:.1f} s", flush=True)
    for name, text in reports.items():
        for ln in text.splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"  {name}: {ln.strip()}")

    fwd = {"name": "rasterize_fwd", "route": "cuda",
           "source": "gs2d_torch/csrc/rasterize_fwd.cu",
           "replaces": "gs2d_tpu/ops/rasterize/kernel_fwd.py:201",
           "library_ms": None}
    bwd = {"name": "rasterize_bwd", "route": "cuda",
           "source": "gs2d_torch/csrc/rasterize_bwd.cu",
           "replaces": "gs2d_tpu/ops/rasterize/kernel_bwd.py:281",
           "library_ms": None}
    gat = {"name": "gather_rows", "route": "cuda",
           "source": "gs2d_torch/csrc/gather_rows.cu",
           "replaces": "scripts/probe_gather_kernel.py:80",
           "replaces_also": ["scripts/probe_gather_kernel.py:106",
                             "scripts/probe_gather_kernel.py:144",
                             "scripts/probe_gather_kernel2.py:57",
                             "scripts/probe_gather_kernel2.py:83"]}
    fwd["max_abs_err"] = small_scenes(fwd)
    small_train(bwd)
    state = bench_state()
    full_width(fwd, state)
    full_train(bwd, state)
    n, losses, p0, p1 = small_loop()
    if n <= 12 or not all(math.isfinite(x) for x in losses) \
            or not p1 > p0 + 2.0:
        raise AssertionError(f"small loop on the card: N {n}, PSNR {p0:.2f} "
                             f"-> {p1:.2f} dB, losses {losses}")
    print(f"small loop 64x32, 300 iterations on the card: N 12 -> {n}, "
          f"view 0 PSNR {p0:.2f} -> {p1:.2f} dB", flush=True)
    gather_phase(gat, *fwd.pop("_gather_inputs"))
    loop = {}
    full_loop(loop, state)
    # K1 runs on every path: once per view and once per step
    fwd["launches_by_path"]["train_step"] = bwd.pop("fwd_launches_train")
    fwd["launches_by_path"]["loop"] = loop["launches"]["rasterize_fwd"]
    fwd["launches"] = sum(fwd["launches_by_path"].values())
    bwd["launches_by_path"]["loop"] = loop["launches"]["rasterize_bwd"]
    bwd["launches"] = sum(bwd["launches_by_path"].values())
    gat["launches_by_path"] = {"loop": loop["launches"]["gather_rows"]}
    gat["launches"] = loop["launches"]["gather_rows"]
    gat["densify"] = [{k: d[k] for k in ("iteration", "n_before", "n_after",
                                         "ms", "gather_ms",
                                         "gather_launches")}
                      for d in loop["densify"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "launches_by_path", "bound_detail")
    fwd_keys = keys + ("plain_ms_small", "kernel_ms_small",
                       "full_image_px_agree", "full_image_med_agree",
                       "full_image_contrib_agree")
    bwd_keys = keys + ("max_norm_err", "step_ms", "card_steps_per_s")
    gat_keys = keys + ("wrapper_ms", "replaces_also", "probe_shape",
                       "densify")
    print(json.dumps({"kernels": [{k: fwd[k] for k in fwd_keys},
                                  {k: bwd[k] for k in bwd_keys},
                                  {k: gat[k] for k in gat_keys}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
