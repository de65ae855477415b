"""The port's SIBR viewer (gs2d_torch/render/network_gui.py,
gs2d_torch/cli/view.py and the train CLI's viewer) against the JAX
package's (gs2d_tpu/render/network_gui.py, tests/test_viewer.py).

- The protocol over a real socket, as tests/test_viewer.py: greeting,
  camera decode with the y/z column flips, reply framing. The JAX server
  and the port's, given the same client bytes, send the same bytes back
  and decode the same camera.
- ``render_net_image`` in all six modes against the JAX one on the same
  render package (a port render of a small scene): 2e-4, which also holds
  the colormap's indices exact (neighbouring turbo entries differ by
  more). The port's turbo table equals matplotlib's exactly.
- ``cli.view`` on a tiny model answers a client's frame with the frame of
  ``render`` (same bytes), and the train CLI's viewer serves a frame in
  the middle of training, or trains on when its port is taken.
"""

import json
import math
import socket
import struct
import sys
import threading
import time

import matplotlib
import numpy as np
import pytest
import torch

from gs2d_torch.cli import train as t_train_cli
from gs2d_torch.cli import view as t_view_cli
from gs2d_torch.config import (ModelParams, OptimizationParams,
                               PipelineParams, save_cfg_args)
from gs2d_torch.models.gaussians import init_from_pcd
from gs2d_torch.models.io import save_ply
from gs2d_torch.render import network_gui as tng
from gs2d_torch.render.renderer import render
from gs2d_torch.utils import synthetic_scene as ss
from gs2d_tpu.render import network_gui as jng

from .test_torch_common import one_torch_thread, port_camera  # noqa: F401
from .utils import random_cloud

ITEMS = ["RGB", "Alpha", "Normal", "Depth", "Edge", "Curvature"]


def _message(width=64, height=32, mode=1, train=True):
    view = np.eye(4)
    view[3, :3] = [0.1, -0.2, 4.0]
    proj = np.eye(4) * 1.5
    proj[2, 3] = 1.0
    msg = {"resolution_x": width, "resolution_y": height, "train": train,
           "fov_y": 0.8, "fov_x": 1.0, "z_near": 0.01, "z_far": 100.0,
           "keep_alive": True, "scaling_modifier": 1.0,
           "view_matrix": view.flatten().tolist(),
           "view_projection_matrix": proj.flatten().tolist(),
           "render_mode": mode}
    payload = json.dumps(msg).encode()
    return struct.pack("I", len(payload)) + payload


def _recv_exact(sock, n):
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        assert chunk, "server closed"
        buf += chunk
    return buf


def _read_reply(sock, image_bytes):
    """(image, verify string, metrics bytes) of one reply."""
    img = _recv_exact(sock, image_bytes)
    verify = _recv_exact(sock, int.from_bytes(_recv_exact(sock, 4), "little"))
    metrics = _recv_exact(sock, int.from_bytes(_recv_exact(sock, 4),
                                               "little"))
    return img, verify, metrics


def _exchange(gui):
    """One client session against ``gui``: the bytes it sends back (the
    greeting, then the reply) and what it decoded."""
    gui.init("127.0.0.1", 0)
    port = gui.listener.getsockname()[1]
    result = {}

    def server():
        deadline = time.monotonic() + 10
        while gui.conn is None and time.monotonic() < deadline:
            gui.try_connect(ITEMS[:2])
            time.sleep(0.01)
        result["decoded"] = gui.receive()
        gui.send(b"\x01\x02\x03", "srcpath", {"#": 7, "loss": 0.5})

    t = threading.Thread(target=server)
    t.start()
    cli = socket.create_connection(("127.0.0.1", port), timeout=10)
    try:
        n = int.from_bytes(_recv_exact(cli, 4), "little")
        greeting = _recv_exact(cli, n)
        cli.sendall(_message())
        reply = _read_reply(cli, 3)
    finally:
        cli.close()
        t.join(timeout=10)
    assert not t.is_alive()
    gui.disconnect()
    gui.listener.close()
    return greeting, reply, result["decoded"]


def test_protocol_matches_the_jax_server_byte_for_byte():
    j_greet, j_reply, j_dec = _exchange(jng.NetworkGUI())
    t_greet, t_reply, t_dec = _exchange(tng.NetworkGUI(device="cpu"))
    assert json.loads(t_greet) == ITEMS[:2]
    assert (t_greet, t_reply) == (j_greet, j_reply)
    assert t_reply[:2] == (b"\x01\x02\x03", b"srcpath")
    jc, tc = j_dec[0], t_dec[0]
    for f in ("world_view", "full_proj", "campos"):
        np.testing.assert_array_equal(getattr(tc, f).numpy(),
                                      np.asarray(getattr(jc, f)), err_msg=f)
    assert (tc.width, tc.height, tc.fovx, tc.fovy, tc.znear, tc.zfar) == (
        jc.width, jc.height, jc.fovx, jc.fovy, jc.znear, jc.zfar)
    assert t_dec[1:] == j_dec[1:] == (True, True, 1.0, 1)
    # the y/z column flips of the reference
    assert tc.world_view[1, 1] == -1 and tc.world_view[2, 2] == -1


def test_empty_resolution_and_no_client():
    gui = tng.NetworkGUI(device="cpu")
    gui.init("127.0.0.1", 0)
    try:
        t0 = time.monotonic()
        gui.try_connect(ITEMS)               # no client: returns at once
        assert gui.conn is None and time.monotonic() - t0 < 1.0
        cli = socket.create_connection(("127.0.0.1", gui.port), timeout=10)
        deadline = time.monotonic() + 10
        while gui.conn is None and time.monotonic() < deadline:
            gui.try_connect(ITEMS)
        _recv_exact(cli, int.from_bytes(_recv_exact(cli, 4), "little"))
        cli.sendall(_message(0, 0))
        assert gui.receive() == (None,) * 5
        cli.close()
        with pytest.raises(ConnectionError):
            gui.receive()
    finally:
        gui.close()


def test_turbo_table_equals_matplotlib():
    ref = np.asarray(matplotlib.colormaps["turbo"](np.linspace(0, 1, 256)))
    np.testing.assert_array_equal(np.asarray(tng.TURBO), ref[:, :3])


def _render_pkg():
    means, scales, quats, opac, rgb, _ = random_cloud(200, 4)
    st = init_from_pcd(means, rgb, max_sh_degree=0,
                       init_scales=np.log(scales), device="cpu")
    return render(port_camera(64, 32), st, torch.zeros(3), max_sh_degree=0,
                  device="cpu")


def test_render_net_image_modes_match_jax():
    pkg = _render_pkg()
    jpkg = {k: pkg[k].detach().numpy() for k in
            ("render", "rend_alpha", "rend_normal", "surf_depth")}
    for mode, name in enumerate(ITEMS):
        got = tng.render_net_image(pkg, ITEMS, mode).detach()
        ref = jng.render_net_image(jpkg, ITEMS, mode, None)
        assert got.shape == (3, 32, 64) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), ref, rtol=2e-4, atol=2e-4,
                                   err_msg=name)
    # a constant map takes the colormap's first entry, as in matplotlib
    flat = tng.apply_colormap(torch.ones(1, 2, 3))
    np.testing.assert_array_equal(flat[:, 0, 0].numpy(),
                                  np.float32(tng.TURBO[0]))


@pytest.fixture(scope="module")
def tiny_model(tmp_path_factory):
    root = tmp_path_factory.mktemp("view_model")
    means, scales, quats, opac, rgb, _ = random_cloud(200, 4)
    st = init_from_pcd(means, rgb, max_sh_degree=1,
                       init_scales=np.log(scales), device="cpu")
    model = ModelParams(sh_degree=1, source_path="/data/scene",
                        model_path=str(root))
    save_cfg_args(str(root / "cfg_args.json"), model, PipelineParams(),
                  OptimizationParams())
    save_ply(st, str(root / "point_cloud" / "iteration_7" /
                     "point_cloud.ply"))
    return root


def test_view_cli_answers_a_frame(tiny_model, capsys):
    stop = threading.Event()
    t = threading.Thread(target=t_view_cli.main, args=(
        ["-m", str(tiny_model), "--port", "0", "--device", "cpu"], stop))
    t.start()
    try:
        said = []
        deadline = time.monotonic() + 30
        while not said and time.monotonic() < deadline:
            said = [line for line in capsys.readouterr().out.splitlines()
                    if line.startswith("viewer server on ")]
            time.sleep(0.05)
        assert said and said[0].endswith("(iteration 7)")
        port = int(said[0].split()[3].split(":")[1])
        cli = socket.create_connection(("127.0.0.1", port), timeout=30)
        try:
            n = int.from_bytes(_recv_exact(cli, 4), "little")
            assert json.loads(_recv_exact(cli, n)) == ITEMS
            cli.sendall(_message(48, 24, mode=0))
            img, verify, metrics = _read_reply(cli, 48 * 24 * 3)
        finally:
            cli.close()
    finally:
        stop.set()
        t.join(timeout=30)
    assert not t.is_alive()
    assert verify == b"/data/scene" and json.loads(metrics)["#"] == 200
    # the same frame through the port's render and the JAX conversion
    from gs2d_torch.models.io import load_ply
    st = load_ply(str(tiny_model / "point_cloud" / "iteration_7" /
                      "point_cloud.ply"), max_sh_degree=1, device="cpu")
    cam = _decode(_message(48, 24, mode=0))
    pkg = render(cam, st, torch.zeros(3), max_sh_degree=1, device="cpu")
    ref = np.clip(pkg["render"].numpy(), 0, 1)
    ref = (ref * 255).astype(np.uint8).transpose(1, 2, 0).tobytes()
    assert img == ref


def _decode(raw):
    """The camera a port server decodes from one client message."""
    a, b = socket.socketpair()
    gui = tng.NetworkGUI(device="cpu")
    gui.listener.close()
    gui.conn = b
    try:
        a.sendall(raw)
        return gui.receive()[0]
    finally:
        a.close()
        b.close()


@pytest.fixture(scope="module")
def tiny_scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("view_scene")
    surf = ss.torus_surfels(2000)
    ss.write_blender_scene(str(root), ss.SurfelRenderer(surf, device="cpu"),
                           40, 30, 4, 1,
                           seed_points=ss.seed_cloud(surf[0], surf[4], 200))
    return root


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_train_cli_viewer_serves_during_training(tiny_scene, tmp_path,
                                                 monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    port = _free_port()
    got = {}

    def client():
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            try:
                cli = socket.create_connection(("127.0.0.1", port),
                                               timeout=60)
                break
            except OSError:
                time.sleep(0.05)
        try:
            n = int.from_bytes(_recv_exact(cli, 4), "little")
            got["items"] = json.loads(_recv_exact(cli, n))
            cli.sendall(_message(40, 30, mode=3))
            got["reply"] = _read_reply(cli, 40 * 30 * 3)
        finally:
            cli.close()

    t = threading.Thread(target=client)
    t.start()
    res = t_train_cli.main(["-s", str(tiny_scene), "-m", str(tmp_path / "m"),
                            "--iterations", "40", "--device", "cpu",
                            "--quiet", "--port", str(port),
                            "--test_iterations", "40"])
    t.join(timeout=60)
    assert not t.is_alive()
    assert got["items"] == ITEMS
    img, verify, metrics = got["reply"]
    assert verify == str(tiny_scene).encode()
    assert len(img) == 40 * 30 * 3 and json.loads(metrics)["#"] > 0
    assert math.isfinite(res["psnr"][40])
    # the listener is closed after the run: the port binds again
    with socket.socket() as s:
        s.bind(("127.0.0.1", port))


def test_train_cli_trains_without_the_viewer_when_its_port_is_taken(
        tiny_scene, tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    with socket.socket() as taken:
        taken.bind(("127.0.0.1", 0))
        taken.listen()
        port = taken.getsockname()[1]
        res = t_train_cli.main(["-s", str(tiny_scene), "-m",
                                str(tmp_path / "m"), "--iterations", "10",
                                "--device", "cpu", "--quiet", "--port",
                                str(port), "--test_iterations", "10"])
    lines = [l for l in capsys.readouterr().out.splitlines()
             if l.startswith("viewer:")]
    assert len(lines) == 1 and f":{port} " in lines[0]
    assert math.isfinite(res["psnr"][10])
