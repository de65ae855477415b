"""Training CLI of the port.

    python -m gs2d_torch.cli.train -s <dataset> -m <model dir> [--eval]

The surface of the JAX package's ``train.py`` (the reference's
``python train.py -s <data> -m <out>``): the reference flag names and
defaults, ``cfg_args.json``, the held-out PSNR report at
``--test_iterations``, PLY saves at ``--save_iterations`` (and at the last
iteration), checkpoints at ``--checkpoint_iterations`` and
``--start_checkpoint``. ``--device`` (default ``cuda``) picks the device;
the tests pass ``--device cpu``. Progress is printed every 100 iterations
(no tqdm), and TensorBoard logs where it imports. The TPU runtime knobs
(capacities, interpret mode, data devices, multi-host) and the viewer
flags have no counterpart here.

``main(argv)`` returns what it reported: the PSNR per test iteration and
per 100-iteration window the host's mean ms per iteration, loss and N.
"""

from __future__ import annotations

import argparse
import json
import os
import uuid

from ..config import (ModelParams, OptimizationParams, PipelineParams,
                      RuntimeParams, save_cfg_args)

OPT_FLAGS = ("iterations", "position_lr_init", "position_lr_final",
             "position_lr_delay_mult", "position_lr_max_steps", "feature_lr",
             "opacity_lr", "scaling_lr", "rotation_lr", "percent_dense",
             "lambda_dssim", "lambda_dist", "lambda_normal", "opacity_cull",
             "densification_interval", "opacity_reset_interval",
             "densify_from_iter", "densify_until_iter",
             "densify_grad_threshold")
WINDOW = 100


def build_parser() -> argparse.ArgumentParser:
    m, o, p, r = (ModelParams(), OptimizationParams(), PipelineParams(),
                  RuntimeParams())
    ap = argparse.ArgumentParser(description="gs2d_torch training")
    ap.add_argument("--source_path", "-s", type=str, required=True)
    ap.add_argument("--model_path", "-m", type=str, default="")
    ap.add_argument("--images", "-i", type=str, default=m.images)
    ap.add_argument("--resolution", "-r", type=int, default=m.resolution)
    ap.add_argument("--white_background", "-w", action="store_true")
    ap.add_argument("--sh_degree", type=int, default=m.sh_degree)
    ap.add_argument("--eval", action="store_true")
    for f in OPT_FLAGS:
        v = getattr(o, f)
        ap.add_argument(f"--{f}", type=type(v), default=v)
    ap.add_argument("--depth_ratio", type=float, default=p.depth_ratio)
    ap.add_argument("--seed", type=int, default=r.seed)
    ap.add_argument("--test_iterations", nargs="+", type=int,
                    default=[7000, 30000])
    ap.add_argument("--save_iterations", nargs="+", type=int,
                    default=[7000, 30000])
    ap.add_argument("--checkpoint_iterations", nargs="+", type=int,
                    default=[])
    ap.add_argument("--start_checkpoint", type=str, default=None)
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--run_log", type=str, default=None,
                    help="append one JSON line per logging tick")
    ap.add_argument("--detect_anomaly", action="store_true",
                    help="torch.autograd anomaly detection")
    ap.add_argument("--profile", type=str, default=None,
                    help="write a torch.profiler trace of iterations 50-60 "
                         "to this directory")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default) or cpu")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    import torch
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch finds no CUDA device; "
                           "pass --device cpu to train on the CPU")
    if not args.model_path:
        args.model_path = os.path.join("./output", str(uuid.uuid4())[:10])
    os.makedirs(args.model_path, exist_ok=True)
    if args.detect_anomaly:
        torch.autograd.set_detect_anomaly(True)

    model = ModelParams(sh_degree=args.sh_degree,
                        source_path=args.source_path,
                        model_path=args.model_path, images=args.images,
                        resolution=args.resolution,
                        white_background=args.white_background,
                        eval=args.eval)
    opt = OptimizationParams(**{f: getattr(args, f) for f in OPT_FLAGS})
    pipe = PipelineParams(depth_ratio=args.depth_ratio)
    rt = RuntimeParams(seed=args.seed)
    save_cfg_args(os.path.join(args.model_path, "cfg_args.json"), model,
                  pipe, opt)
    args.save_iterations.append(opt.iterations)

    from ..ops.ssim import psnr as psnr_fn
    from ..render.renderer import render
    from ..train.loop import train

    tb_writer = None
    try:
        from torch.utils.tensorboard import SummaryWriter
        tb_writer = SummaryWriter(args.model_path)
    except ImportError:
        print("Tensorboard not available: not logging progress")

    result = {"model_path": args.model_path, "psnr": {}, "windows": []}
    # the loop logs every 10 iterations, timed from its first iteration
    last = {"iteration": None, "elapsed_s": 0.0}
    run_log = open(args.run_log, "a", buffering=1) if args.run_log else None

    def log_fn(iteration, info):
        if run_log is not None:
            run_log.write(json.dumps({"iter": iteration, **info}) + "\n")
        if tb_writer is not None:
            for tag, key in (("train_loss_patches/total_loss", "loss"),
                             ("train_loss_patches/dist_loss", "dist"),
                             ("train_loss_patches/normal_loss", "normal"),
                             ("total_points", "points")):
                tb_writer.add_scalar(tag, info[key], iteration)
        if last["iteration"] is None:
            last["iteration"] = max(iteration - 10, 0)
        if iteration % WINDOW and iteration != opt.iterations:
            return
        n_it = iteration - last["iteration"]
        ms = (info["elapsed_s"] - last["elapsed_s"]) / max(n_it, 1) * 1e3
        last.update(iteration=iteration, elapsed_s=info["elapsed_s"])
        result["windows"].append({
            "iterations": f"{iteration - n_it + 1}-{iteration}",
            "ms_per_it": ms, "loss": info["loss"],
            "points": info["points"]})
        if tb_writer is not None:
            tb_writer.add_scalar("iter_time", ms / 1e3, iteration)
        if not args.quiet:
            print(f"[ITER {iteration}] loss {info['loss']:.5f} distort "
                  f"{info['dist']:.5f} normal {info['normal']:.5f} points "
                  f"{info['points']} {ms:.1f} ms/it", flush=True)

    bg = torch.tensor([1.0] * 3 if model.white_background else [0.0] * 3,
                      device=device)

    @torch.no_grad()
    def report_fn(iteration, ts, scene):
        test_cams = scene.get_test_cameras() or scene.get_train_cameras()[:4]
        vals = []
        for i, c in enumerate(test_cams[:8]):
            pkg = render(c.camera, ts.gaussians, bg,
                         max_sh_degree=model.sh_degree,
                         depth_ratio=pipe.depth_ratio, device=device)
            img = torch.clamp(pkg["render"], 0, 1)
            gt = torch.as_tensor(c.image, device=device)
            vals.append(float(psnr_fn(img, gt)))
            if tb_writer is not None and i < 5:
                name = f"test_view_{c.image_name}"
                tb_writer.add_images(f"{name}/render", img[None].cpu(),
                                     global_step=iteration)
                d = pkg["surf_depth"]
                tb_writer.add_images(
                    f"{name}/depth", (d / max(float(d.max()), 1e-6))[None]
                    .cpu(), global_step=iteration)
                tb_writer.add_images(
                    f"{name}/rend_normal",
                    (pkg["rend_normal"] * 0.5 + 0.5)[None].cpu(),
                    global_step=iteration)
        mean = sum(vals) / len(vals)
        result["psnr"][iteration] = mean
        print(f"[ITER {iteration}] eval PSNR {mean:.2f} over {len(vals)} "
              "views", flush=True)
        if tb_writer is not None:
            tb_writer.add_scalar("test/psnr", mean, iteration)

    try:
        train(model, opt, pipe, rt,
              test_iterations=args.test_iterations,
              save_iterations=args.save_iterations,
              checkpoint_iterations=args.checkpoint_iterations,
              start_checkpoint=args.start_checkpoint,
              log_fn=log_fn, report_fn=report_fn,
              profile_dir=args.profile, device=device)
    finally:
        if run_log is not None:
            run_log.close()
        if tb_writer is not None:
            tb_writer.close()
    print("\nTraining complete.")
    return result


if __name__ == "__main__":
    main()
