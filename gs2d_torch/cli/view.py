"""Live viewer server of the port: serve a trained model to the SIBR remote
viewer.

    python -m gs2d_torch.cli.view -m <model dir> [--iteration N] \\
        [--ip 127.0.0.1] [--port 6009] [--device cuda|cpu]

The surface of the JAX package's ``view.py`` (the reference's
``view.py:9-51``): load a model iteration (the last by default) and loop
accept → receive a camera → render (K1, at the client's resolution) →
send, until interrupted. It reads the model's PLY and ``cfg_args.json``,
not its dataset. ``--port 0`` binds a free port; the line ``viewer server
on <ip>:<port>`` names it. ``main(argv, stop=event)`` returns once the
``threading.Event`` is set and no client is connected.
"""

from __future__ import annotations

import argparse
import os
import time
import traceback


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="gs2d_torch viewer server")
    ap.add_argument("--model_path", "-m", required=True)
    ap.add_argument("--iteration", type=int, default=-1)
    ap.add_argument("--ip", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=6009)
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default) or cpu")
    return ap


def serve_frame(gui, state, model, pipe, bg, device, metrics) -> tuple:
    """Answer one camera message of the connected client: render at its
    resolution in its mode and send the frame (none for an empty
    resolution). Returns (camera, do_training, keep_alive) of the
    message."""
    from ..render.network_gui import frame_bytes, render_net_image
    from ..render.renderer import render
    cam, do_training, keep_alive, scaling, mode = gui.receive()
    img = None
    if cam is not None:
        pkg = render(cam, state, bg, max_sh_degree=model.sh_degree,
                     scaling_modifier=scaling,
                     depth_ratio=pipe.depth_ratio, device=device)
        img = frame_bytes(render_net_image(pkg, model.render_items, mode,
                                           cam))
    gui.send(img, model.source_path, metrics)
    return cam, do_training, keep_alive


def main(argv=None, stop=None) -> None:
    args = build_parser().parse_args(argv)
    import torch

    from ..config import load_cfg_args
    from ..models.io import load_ply
    from ..render.network_gui import NetworkGUI
    from ..scene.scene import search_max_iteration

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch finds no CUDA device; "
                           "pass --device cpu to serve from the CPU")
    model, pipe, _ = load_cfg_args(os.path.join(args.model_path,
                                                "cfg_args.json"))
    clouds = os.path.join(args.model_path, "point_cloud")
    it = (search_max_iteration(clouds) if args.iteration == -1
          else args.iteration)
    state = load_ply(os.path.join(clouds, f"iteration_{it}",
                                  "point_cloud.ply"),
                     max_sh_degree=model.sh_degree, device=device)
    bg = torch.tensor([1.0] * 3 if model.white_background else [0.0] * 3,
                      device=device)
    metrics = {"#": int(state.params.xyz.shape[0]), "loss": 0.0}

    gui = NetworkGUI(device=device)
    gui.init(args.ip, args.port)
    print(f"viewer server on {args.ip}:{gui.port} (iteration {it})",
          flush=True)
    try:
        while True:
            if gui.conn is None:
                if stop is not None and stop.is_set():
                    return
                gui.try_connect(model.render_items)
                if gui.conn is None:
                    time.sleep(0.05)   # non-blocking accept: no busy spin
                continue
            try:
                with torch.no_grad():
                    serve_frame(gui, state, model, pipe, bg, device, metrics)
            except ConnectionError as e:
                print(f"viewer client left: {e}", flush=True)
                gui.disconnect()
            except Exception:                  # noqa: BLE001 - reported
                # a client whose message fails drops its connection, not
                # the server
                print("viewer connection dropped:\n"
                      + traceback.format_exc(), flush=True)
                gui.disconnect()
    finally:
        gui.close()


if __name__ == "__main__":
    main()
