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

The loop is ``train/loop.py::train`` with its ``Editor`` hook; this CLI
builds the editor and the prompt's embeddings and calls it.

``--editor torch`` is the SD-1.5 InstructPix2Pix of ``gs2d_torch.ig2g``,
with the UNet, VAE, text tower and tokenizer read from the diffusers
snapshot at ``$GS2D_SD_WEIGHTS`` (without one it raises), each network
in the dtype its snapshot stores; ``--editor
stub`` runs the whole loop without weights. ``--save_edited`` writes each
edit as a PNG under ``<model>/edited``. ``main(argv)`` returns the camera
order, the edits and the losses.
"""

from __future__ import annotations

import os
import time
import uuid

from ..config import (ModelParams, OptimizationParams, PipelineParams,
                      RuntimeParams, save_cfg_args)
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
    from ..scene.images import encode_png
    from ..scene.scene import Scene
    from ..train import loop
    from ..train.loop import Editor

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

    result = {"model_path": args.model_path, "order": [], "edits": [],
              "losses": []}
    losses = []
    t_start = time.time()

    def on_step(iteration, cam_idx, metrics):
        result["order"].append(cam_idx)
        losses.append(metrics["total_loss"])
        if iteration % 10:
            return
        loss, total = torch.stack([metrics["loss"],
                                   metrics["total_loss"]]).tolist()
        points = int(metrics["num_points"])
        n_edits = len(result["edits"])
        if wandb_run is not None:
            wandb_run.log({"train/loss": loss, "train/total_loss": total,
                           "train/points": points, "train/edits": n_edits},
                          step=iteration)
        if not args.quiet and iteration % 100 == 0:
            print(f"[ITER {iteration}] loss {loss:.5f} points {points} "
                  f"edits {n_edits} {time.time() - t_start:.1f} s",
                  flush=True)

    def on_edit(iteration, cam_idx, out, seconds):
        name = cams[cam_idx].image_name
        result["edits"].append({"iteration": iteration, "camera": cam_idx,
                                "image_name": name, "s": seconds})
        if args.save_edited:
            d = os.path.join(args.model_path, "edited")
            os.makedirs(d, exist_ok=True)
            encode_png(os.path.join(d, f"{iteration}_{name}.png"),
                       (out[0].permute(1, 2, 0).cpu().numpy() * 255)
                       .astype(np.uint8))
        if not args.quiet:
            print(f"[ITER {iteration}] edit {len(result['edits'])} of "
                  f"{name} in {seconds:.2f} s", flush=True)

    scene = Scene(model, seed=rt.seed, device=device)
    cams = scene.get_train_cameras()
    editor = Editor(
        edit=lambda rendered, original, noise: ip2p.edit_image(
            text_embeddings, rendered, original, noise),
        start_iter=args.ip2p_start_iter, cycle_iter=args.ip2p_cycle_iter,
        iters=args.ip2p_iter, on_edit=on_edit)
    ts, _ = loop.train(model, opt, pipe, rt, scene=scene,
                       test_iterations=(),
                       save_iterations=(opt.iterations,),
                       step_fn=on_step, editor=editor, device=device)

    result["losses"] = torch.stack(losses).tolist() if losses else []
    result["points"] = int(ts.gaussians.params.xyz.shape[0])
    print("\nIG2G training complete.")
    return result


if __name__ == "__main__":
    main()
