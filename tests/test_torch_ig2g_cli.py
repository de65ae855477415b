"""The port's IG2G CLI (``gs2d_torch.cli.train_ig2g.main``, ``--device
cpu --editor stub``) against the JAX package's ``train_ig2g.py`` with the
same flags, on a tiny COLMAP scene of the torus (48x40, 8 views, a
300-point seed cloud), 10 iterations, edits at iterations 5, 7 and 9.

The editor's draws are replayed from the JAX keys (``JaxDraws``). Equal:
the camera of every step (world-view matrices within 1e-6) and the edit
iterations. The first edited image within 1e-5 of the JAX one; the total
loss of every step up to and including the first step on an edited image
within 1e-5 relative (the bar of tests/test_torch_train_step.py). The PLY
saved at the last iteration loads through both packages' readers. The
edits are written as PNGs by the port's encoder (``--save_edited``).
``--editor torch`` without weights raises (without a card, the default
device raises: tests/test_torch_isolation.py).
"""

import sys

import numpy as np
import pytest
import torch

import gs2d_torch.ig2g.ip2p as t_ip2p
import gs2d_torch.train.step as t_step
from gs2d_torch.cli import train_ig2g as t_cli
from gs2d_torch.models.io import load_ply as t_load_ply
from gs2d_torch.scene.images import decode_png
from gs2d_torch.utils import synthetic_scene as ss

from .test_torch_common import one_torch_thread  # noqa: F401
from .test_torch_ig2g_edit import JaxDraws

ITERS = 10
FLAGS = ["--iterations", str(ITERS), "--ip2p_start_iter", "3",
         "--ip2p_cycle_iter", "16", "--ip2p_iter", "1", "--sh_degree", "1",
         "--text_prompt", "make it snowy", "--seed", "0"]


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("ig2g") / "scene"
    surf = ss.torus_surfels(4000)
    ss.write_colmap_scene(str(root), ss.SurfelRenderer(surf, device="cpu"),
                          48, 40, 8,
                          seed_points=ss.seed_cloud(surf[0], surf[4], 300))
    return root


def _recording_step(make, log):
    def make_recorded(*args, **kw):
        step = make(*args, **kw)

        def recorded(ts, camera, gt, iteration, bg, lr_iteration=None):
            ts, metrics = step(ts, camera, gt, iteration, bg,
                               lr_iteration=lr_iteration)
            log.append((int(iteration), np.array(camera.world_view),
                        float(metrics["total_loss"])))
            return ts, metrics
        return recorded
    return make_recorded


def _recording_edit(cls, edits, log):
    real = cls.edit_image

    def edit_image(self, *args, **kw):
        out = real(self, *args, **kw)
        edits.append((len(log) + 1, np.array(out)))
        return out
    return edit_image


@pytest.fixture(scope="module")
def runs(scene_dir, tmp_path_factory):
    base = tmp_path_factory.mktemp("ig2g_runs")
    with pytest.MonkeyPatch.context() as mp:
        import gs2d_tpu.ig2g.ip2p as j_ip2p
        import gs2d_tpu.train.step as j_step
        import train_ig2g as j_cli           # the JAX package's CLI
        j_log, j_edits = [], []
        mp.setattr(j_step, "make_train_step",
                   _recording_step(j_step.make_train_step, j_log))
        mp.setattr(j_ip2p.InstructPix2Pix, "edit_image",
                   _recording_edit(j_ip2p.InstructPix2Pix, j_edits, j_log))
        mp.setattr(sys, "argv", [
            "train_ig2g.py", "-s", str(scene_dir), "-m", str(base / "jax"),
            "--initial_capacity", "512", "--pairs_capacity", str(1 << 13),
            "--interpret"] + FLAGS)
        j_cli.main()

        t_log, t_edits = [], []
        mp.setattr(t_step, "make_train_step",
                   _recording_step(t_step.make_train_step, t_log))
        mp.setattr(t_ip2p.InstructPix2Pix, "edit_image",
                   _recording_edit(t_ip2p.InstructPix2Pix, t_edits, t_log))
        mp.setattr(t_ip2p, "Draws", JaxDraws)
        res = t_cli.main(["-s", str(scene_dir), "-m", str(base / "port"),
                          "--device", "cpu", "--save_edited", "--quiet"]
                         + FLAGS)
    return dict(base=base, res=res, j_log=j_log, j_edits=j_edits,
                t_log=t_log, t_edits=t_edits)


def test_cameras_and_edit_iterations_match_jax(runs):
    j_log, t_log = runs["j_log"], runs["t_log"]
    assert [it for it, _, _ in t_log] == [it for it, _, _ in j_log] \
        == list(range(1, ITERS + 1))
    for (_, a, _), (_, b, _) in zip(t_log, j_log):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    t_its = [it for it, _ in runs["t_edits"]]
    assert t_its == [it for it, _ in runs["j_edits"]] == [5, 7, 9]
    assert [e["iteration"] for e in runs["res"]["edits"]] == t_its


def test_first_edit_and_losses_match_jax(runs):
    (_, t_img), (_, j_img) = runs["t_edits"][0], runs["j_edits"][0]
    assert t_img.shape == j_img.shape == (1, 3, 40, 48)
    np.testing.assert_allclose(t_img, j_img, rtol=0, atol=1e-5)
    first_edited_step = runs["t_edits"][0][0]
    for (it, _, a), (_, _, b) in zip(runs["t_log"], runs["j_log"]):
        if it <= first_edited_step:
            assert abs(a - b) <= 1e-5 * abs(b), (it, a, b)
    assert runs["res"]["losses"] == pytest.approx(
        [loss for _, _, loss in runs["t_log"]], rel=0, abs=0)


def test_saved_ply_and_edited_pngs(runs):
    from gs2d_tpu.models.io import load_ply as j_load_ply
    base = runs["base"]
    ply = base / "port" / "point_cloud" / f"iteration_{ITERS}" \
        / "point_cloud.ply"
    state = t_load_ply(str(ply), max_sh_degree=1, device="cpu")
    n = state.params.xyz.shape[0]
    assert n == runs["res"]["points"] == 300
    assert bool(torch.isfinite(state.params.xyz).all())
    j_state = j_load_ply(str(ply), 512, max_sh_degree=1)
    assert int(np.asarray(j_state.active).sum()) == n
    for it, img in runs["t_edits"]:
        e = next(e for e in runs["res"]["edits"] if e["iteration"] == it)
        png = decode_png(str(base / "port" / "edited"
                             / f"{it}_{e['image_name']}.png"))
        np.testing.assert_array_equal(
            png, (img[0].transpose(1, 2, 0) * 255).astype(np.uint8))


def test_torch_editor_without_weights_raises(scene_dir, tmp_path,
                                             monkeypatch):
    monkeypatch.delenv("GS2D_SD_WEIGHTS", raising=False)
    with pytest.raises(FileNotFoundError, match="GS2D_SD_WEIGHTS"):
        t_cli.main(["-s", str(scene_dir), "-m", str(tmp_path / "m"),
                    "--device", "cpu", "--editor", "torch"] + FLAGS)
