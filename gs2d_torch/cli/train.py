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
(capacities, interpret mode) have no counterpart here.

Several GPUs (``gs2d_torch/parallel/``): ``--data_devices N`` starts N
local ranks, one per GPU (gloo ranks on the CPU with ``--device cpu``),
each rendering one row band of every view; ``--multihost`` joins the
process group that torchrun's environment names
(``python -m torch.distributed.run --nproc_per_node G [--nnodes ...] -m
gs2d_torch.cli.train --multihost ...``), each rank on ``cuda:LOCAL_RANK``
uploading only its band of each view. Only the first rank writes files,
prints and serves the viewer. Without ``-m`` the model directory is
named from the source path and seed, so every rank agrees on it.

The SIBR live viewer (``render/network_gui.py``) listens on ``--ip``:
``--port`` (127.0.0.1:6009) unless ``--no_viewer``; a port that cannot be
bound prints one line and training goes on without the viewer.

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
                         "(trace.json) and the stages' spans and counters "
                         "over them (spans.json) to this directory")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default) or cpu")
    return ap


def add_launch_flags(ap: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The JAX ``train.py``'s data-device, multi-host and viewer flags."""
    ap.add_argument("--data_devices", type=int, default=1,
                    help="pixel-shard every view over N local ranks, one "
                         "per GPU")
    ap.add_argument("--multihost", action="store_true",
                    help="join the process group of torchrun's environment")
    ap.add_argument("--ip", type=str, default="127.0.0.1")
    ap.add_argument("--port", type=int, default=6009)
    ap.add_argument("--no_viewer", action="store_true")
    return ap


def main(argv=None) -> dict:
    args = add_launch_flags(build_parser()).parse_args(argv)
    import torch
    import torch.distributed as dist

    from ..parallel import multihost as mh
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch finds no CUDA device; "
                           "pass --device cpu to train on the CPU")
    if args.data_devices < 1:
        raise ValueError(f"--data_devices {args.data_devices}")
    if args.multihost:
        mh.initialize_distributed(backend=mh.default_backend(device.type))
        if not dist.is_initialized():
            raise RuntimeError("--multihost, but no launcher environment "
                               "(RANK, WORLD_SIZE, MASTER_ADDR, "
                               "MASTER_PORT): start it with torchrun")
        return _run(args, mh.rank_device(device.type), dist.group.WORLD)
    if args.data_devices > 1:
        if device.type == "cuda" \
                and args.data_devices > torch.cuda.device_count():
            raise ValueError(
                f"--data_devices {args.data_devices}, but torch finds "
                f"{torch.cuda.device_count()} CUDA devices")
        return _spawn_local_ranks(args)
    return _run(args, device, None)


def _model_dir(args) -> str:
    """The model directory: ``-m``, else one that every rank of a run
    names alike (from the source path and seed, as the JAX ``train.py``'s
    multi-host path does), else a random one."""
    if args.model_path:
        return args.model_path
    if args.multihost or args.data_devices > 1:
        tag = uuid.uuid5(uuid.NAMESPACE_URL,
                         f"{args.source_path}|{args.seed}")
    else:
        tag = uuid.uuid4()
    return os.path.join("./output", str(tag)[:10])


def _spawn_local_ranks(args) -> dict:
    """Train on ``args.data_devices`` spawned ranks of one process group
    (NCCL on the card, gloo on the CPU) → the first rank's result."""
    import tempfile

    import torch.multiprocessing as mp
    args.model_path = _model_dir(args)
    n = args.data_devices
    ctx = mp.get_context("spawn")
    results = ctx.SimpleQueue()
    result = None
    with tempfile.TemporaryDirectory(prefix="gs2d_train_") as tmp:
        procs = mp.start_processes(
            _rank_main, args=(n, args, os.path.join(tmp, "store"), results),
            nprocs=n, join=False, start_method="spawn")
        # read the result as it comes: a rank blocks on a full pipe
        while not procs.join(timeout=1):
            if result is None and not results.empty():
                result = results.get()
    return result if result is not None else results.get()


def _rank_main(rank, n, args, store, results):
    """One local rank of ``--data_devices``."""
    import torch
    import torch.distributed as dist

    from ..parallel import multihost as mh
    os.environ["LOCAL_RANK"] = str(rank)
    device = mh.rank_device(torch.device(args.device).type)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        # the ranks share the host's cores; more threads than that each
        # ran a 2-rank CPU run several times slower
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    dist.init_process_group(mh.default_backend(device.type),
                            init_method=f"file://{store}", rank=rank,
                            world_size=n, timeout=mh.TIMEOUT)
    try:
        result = _run(args, device, dist.group.WORLD)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        results.put(result)


def _run(args, device, group) -> dict:
    """The training run of this process (one rank of ``group``, if any)."""
    import torch

    from ..parallel.multihost import is_main_process
    args.model_path = _model_dir(args)
    main_proc = group is None or is_main_process()
    if main_proc:
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
    if main_proc:
        save_cfg_args(os.path.join(args.model_path, "cfg_args.json"), model,
                      pipe, opt)
    args.save_iterations.append(opt.iterations)

    from ..ops.ssim import psnr as psnr_fn
    from ..render.renderer import render
    from ..train.loop import train

    tb_writer = None
    if main_proc:
        try:
            from torch.utils.tensorboard import SummaryWriter
            tb_writer = SummaryWriter(args.model_path)
        except ImportError:
            print("Tensorboard not available: not logging progress")

    result = {"model_path": args.model_path, "psnr": {}, "windows": []}
    # the loop logs every 10 iterations, timed from its first iteration
    last = {"iteration": None, "elapsed_s": 0.0}
    run_log = (open(args.run_log, "a", buffering=1)
               if args.run_log and main_proc else None)

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

    gui = _viewer(args, device) if main_proc and not args.no_viewer else None

    @torch.no_grad()
    def viewer_fn(iteration, ts, ema):
        """The reference's train.py:146-168: serve the connected client's
        frames until it asks to train on (or the run is over and it does
        not keep the viewer alive); no client, no wait."""
        from .view import serve_frame
        if gui.conn is None:
            gui.try_connect(model.render_items)
        while gui.conn is not None:
            try:
                _, do_training, keep_alive = serve_frame(
                    gui, ts.gaussians, model, pipe, bg, device,
                    {"#": int(ts.gaussians.params.xyz.shape[0]),
                     "loss": ema["loss"]})
                if do_training and (iteration < opt.iterations
                                    or not keep_alive):
                    break
            except Exception as e:             # noqa: BLE001 - reported
                print(f"viewer connection dropped: {type(e).__name__}: "
                      f"{e}", flush=True)
                gui.disconnect()

    try:
        train(model, opt, pipe, rt,
              test_iterations=args.test_iterations,
              save_iterations=args.save_iterations,
              checkpoint_iterations=args.checkpoint_iterations,
              start_checkpoint=args.start_checkpoint,
              log_fn=log_fn, report_fn=report_fn,
              profile_dir=args.profile,
              viewer_fn=viewer_fn if gui is not None else None,
              device=device, group=group, multihost=args.multihost)
    finally:
        if run_log is not None:
            run_log.close()
        if tb_writer is not None:
            tb_writer.close()
        if gui is not None:
            gui.close()
    if main_proc:
        print("\nTraining complete.")
    return result


def _viewer(args, device):
    """The viewer's listener on ``--ip``:``--port``, or None (one line
    printed) when the port cannot be bound."""
    from ..render.network_gui import NetworkGUI
    gui = NetworkGUI(device=device)
    try:
        gui.init(args.ip, args.port)
    except OSError as e:
        gui.close()
        print(f"viewer: cannot listen on {args.ip}:{args.port} ({e}); "
              "training without it", flush=True)
        return None
    return gui


if __name__ == "__main__":
    main()
