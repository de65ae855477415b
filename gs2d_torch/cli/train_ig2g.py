"""IG2G training CLI of the port: 2DGS optimisation with periodic
InstructPix2Pix edits of the training images.

    python -m gs2d_torch.cli.train_ig2g -s <dataset> -m <out> \\
        --text_prompt "..." [--editor stub|torch] [--device cuda|cpu]

The surface of the JAX package's ``train_ig2g.py``: the train CLI's flags
(``cli/train.py::build_parser``) plus the editing ones. After
``--ip2p_start_iter``, every ``ip2p_cycle_iter / num_cameras`` iterations,
the current camera is rendered with per-Gaussian Gaussian noise
composited into the ``rend_noise`` channel, edited by InstructPix2Pix
conditioned on its original image, and the edit replaces that camera's
ground truth (the Iterative Dataset Update of InstructNeRF2NeRF), until
``ip2p_iter`` edits per camera are done. The xyz learning rate restarts at
``--ip2p_start_iter``; the model is saved at the last iteration.

``--editor torch`` is the SD-1.5 InstructPix2Pix of ``gs2d_torch.ig2g``,
with the UNet, VAE, text tower and tokenizer read from the diffusers
snapshot at ``$GS2D_SD_WEIGHTS`` (without one it raises); ``--editor
stub`` runs the whole loop without weights. ``--save_edited`` writes each
edit as a PNG under ``<model>/edited``. ``main(argv)`` returns the camera
order, the edits and the losses.
"""

from __future__ import annotations

import os
import random
import time
import uuid

from ..config import (ModelParams, OptimizationParams, PipelineParams,
                      RuntimeParams, save_cfg_args)
from ..render.renderer import render
from .train import OPT_FLAGS, build_parser


def add_ig2g_flags(ap):
    ap.add_argument("--text_prompt", type=str, default="")
    ap.add_argument("--ip2p_start_iter", type=int, default=20000)
    ap.add_argument("--ip2p_cycle_iter", type=int, default=2500)
    ap.add_argument("--ip2p_iter", type=int, default=3)
    ap.add_argument("--guidance_scale", type=float, default=12.5)
    ap.add_argument("--image_guidance_scale", type=float, default=1.5)
    ap.add_argument("--diffusion_steps", type=int, default=20)
    ap.add_argument("--lower_bound", type=float, default=0.7)
    ap.add_argument("--upper_bound", type=float, default=0.98)
    ap.add_argument("--noise_type", type=str, default="None")
    ap.add_argument("--noise_reg", type=str, default="outlier")
    ap.add_argument("--freeu_mode", type=str, default="None")
    ap.add_argument("--lambda_intermediate", type=float, default=1.0)
    ap.add_argument("--is_freeu", action="store_true")
    ap.add_argument("--freeu_s1", type=float, default=0.9)
    ap.add_argument("--freeu_s2", type=float, default=0.2)
    ap.add_argument("--freeu_b1", type=float, default=1.2)
    ap.add_argument("--freeu_b2", type=float, default=1.4)
    ap.add_argument("--editor", choices=["stub", "torch"], default="stub",
                    help="torch = the SD-1.5 UNet+VAE (needs "
                         "$GS2D_SD_WEIGHTS)")
    ap.add_argument("--save_edited", action="store_true")
    ap.add_argument("--wandb", action="store_true",
                    help="log to Weights & Biases; continues without it "
                         "where it does not import")
    return ap


def main(argv=None) -> dict:
    ap = build_parser()
    ap.description = "gs2d_torch IG2G training"
    args = add_ig2g_flags(ap).parse_args(argv)
    import numpy as np
    import torch

    from ..ig2g.ip2p import InstructPix2Pix, IP2PParams
    from ..ig2g.ops import resize_bilinear
    from ..models.densify import densify_and_prune, reset_opacity
    from ..scene.images import encode_png
    from ..scene.scene import Scene
    from ..train.optim import init_adam
    from ..train.step import TrainState, make_train_step

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch finds no CUDA device; "
                           "pass --device cpu to train on the CPU")
    if not args.model_path:
        args.model_path = os.path.join("./output",
                                       "ig2g_" + str(uuid.uuid4())[:8])
    os.makedirs(args.model_path, exist_ok=True)

    wandb_run = None
    if args.wandb:
        try:
            import wandb
            wandb_run = wandb.init(project="gs2d_tpu_ig2g",
                                   dir=args.model_path, config=vars(args))
        except Exception as e:  # not installed or offline: keep training
            print(f"wandb unavailable ({e}); continuing without it")

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

    ip2p = InstructPix2Pix(IP2PParams(
        guidance_scale=args.guidance_scale,
        image_guidance_scale=args.image_guidance_scale,
        diffusion_steps=args.diffusion_steps,
        lower_bound=args.lower_bound, upper_bound=args.upper_bound,
        noise_type=args.noise_type, noise_reg=args.noise_reg,
        freeu_mode=args.freeu_mode,
        lambda_intermediate=args.lambda_intermediate,
        is_freeu=args.is_freeu, freeu_s1=args.freeu_s1,
        freeu_s2=args.freeu_s2, freeu_b1=args.freeu_b1,
        freeu_b2=args.freeu_b2,
    ), backend=args.editor, seed=rt.seed, device=device)

    # the SD editor is conditioned on the prompt's CLIP embeddings (the
    # reference's pipe._encode_prompt); the stub ignores them
    text_embeddings = None
    if args.editor == "torch":
        from ..ig2g.clip_text import PromptEncoder
        text_embeddings = PromptEncoder(ip2p.backend.root,
                                        device=device).encode(args.text_prompt)

    scene = Scene(model, seed=rt.seed, device=device)
    cams = scene.get_train_cameras()
    if not cams:
        raise ValueError("no training cameras")
    # each camera's ground truth on the device; an edit replaces it
    edited = [None] * len(cams)
    bg = torch.tensor([1.0] * 3 if model.white_background else [0.0] * 3,
                      dtype=torch.float32, device=device)
    step_fn = make_train_step(opt, max_sh_degree=model.sh_degree,
                              spatial_lr_scale=scene.cameras_extent,
                              depth_ratio=pipe.depth_ratio, device=device)
    ts = TrainState(gaussians=scene.gaussians,
                    opt=init_adam(scene.gaussians.params))
    densify_gen = torch.Generator(device=device).manual_seed(rt.seed)
    noise_gen = torch.Generator(device=device).manual_seed(rt.seed + 1)

    rng = random.Random(rt.seed)
    stack = []
    ip2p_iteration = 0
    edit_every = max(int(args.ip2p_cycle_iter / max(len(cams), 1)), 1)
    result = {"model_path": args.model_path, "order": [], "edits": [],
              "losses": []}
    losses = []
    t_start = time.time()

    for iteration in range(1, opt.iterations + 1):
        if not stack:
            stack = list(range(len(cams)))
        ci = stack.pop(rng.randrange(len(stack)))
        cam_data = cams[ci]
        result["order"].append(ci)
        if edited[ci] is None:
            edited[ci] = torch.as_tensor(cam_data.image, dtype=torch.float32,
                                         device=device)

        # the periodic dataset edit (reference :232-304)
        if (iteration > args.ip2p_start_iter
                and (edit_every == 1 or iteration % edit_every == 1)
                and ip2p_iteration < args.ip2p_iter * len(cams)):
            t0 = time.perf_counter()
            with torch.no_grad():
                gnoise = torch.randn(
                    (ts.gaussians.params.xyz.shape[0], 3),
                    generator=noise_gen, device=device)
                pkg = render(cam_data.camera, ts.gaussians, bg,
                             max_sh_degree=model.sh_degree, noise=gnoise,
                             depth_ratio=pipe.depth_ratio, device=device)
                rendered = torch.clamp(pkg["render"], 0, 1)[None]
                original = torch.as_tensor(
                    cam_data.image, dtype=torch.float32, device=device)[None]
                out = ip2p.edit_image(text_embeddings, rendered, original,
                                      pkg["rend_noise"][None])
                # the VAE's x8 round trip returns sides rounded up to a
                # multiple of 8: back to the render's size (reference
                # train_ig2g.py:293-297)
                if out.shape[2:] != rendered.shape[2:]:
                    out = resize_bilinear(out, rendered.shape[2:])
            edited[ci] = out[0]
            ip2p_iteration += 1
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            result["edits"].append({"iteration": iteration, "camera": ci,
                                    "image_name": cam_data.image_name,
                                    "s": time.perf_counter() - t0})
            if args.save_edited:
                d = os.path.join(args.model_path, "edited")
                os.makedirs(d, exist_ok=True)
                encode_png(
                    os.path.join(d, f"{iteration}_{cam_data.image_name}.png"),
                    (out[0].permute(1, 2, 0).cpu().numpy() * 255)
                    .astype(np.uint8))
            if not args.quiet:
                print(f"[ITER {iteration}] edit {ip2p_iteration} of "
                      f"{cam_data.image_name} in "
                      f"{result['edits'][-1]['s']:.2f} s", flush=True)

        # the xyz LR schedule restarts at the edit phase's start
        # (reference train_ig2g.py:205-206)
        lr_it = (iteration - args.ip2p_start_iter
                 if iteration > args.ip2p_start_iter else iteration)
        ts, metrics = step_fn(ts, cam_data.camera, edited[ci], iteration,
                              bg, lr_iteration=lr_it)
        losses.append(metrics["total_loss"])

        if iteration < opt.densify_until_iter:
            if (iteration > opt.densify_from_iter
                    and iteration % opt.densification_interval == 0):
                size_thr = 20.0 if iteration > opt.opacity_reset_interval \
                    else 0.0
                gs_new, opt_new, _ = densify_and_prune(
                    ts.gaussians, ts.opt, opt.densify_grad_threshold,
                    opt.opacity_cull, scene.cameras_extent, size_thr,
                    opt.percent_dense, generator=densify_gen)
                ts = TrainState(gaussians=gs_new, opt=opt_new)
            if (iteration % opt.opacity_reset_interval == 0
                    or (model.white_background
                        and iteration == opt.densify_from_iter)):
                gs_new, opt_new = reset_opacity(ts.gaussians, ts.opt)
                ts = TrainState(gaussians=gs_new, opt=opt_new)

        if iteration % 10 == 0:
            loss, total = torch.stack([metrics["loss"],
                                       metrics["total_loss"]]).tolist()
            points = int(metrics["num_points"])
            if wandb_run is not None:
                wandb_run.log({"train/loss": loss, "train/total_loss": total,
                               "train/points": points,
                               "train/edits": ip2p_iteration},
                              step=iteration)
            if not args.quiet and iteration % 100 == 0:
                print(f"[ITER {iteration}] loss {loss:.5f} points {points} "
                      f"edits {ip2p_iteration} "
                      f"{time.time() - t_start:.1f} s", flush=True)
        if iteration == opt.iterations:
            scene.save(iteration, ts.gaussians)

    result["losses"] = torch.stack(losses).tolist() if losses else []
    result["points"] = int(ts.gaussians.params.xyz.shape[0])
    print("\nIG2G training complete.")
    return result


if __name__ == "__main__":
    main()
