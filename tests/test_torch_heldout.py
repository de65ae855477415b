"""Held-out PSNR: the port's ``train(scene=None)`` against the JAX
``train()``, from the same dataset on disk.

The dataset is built like scripts/make_synthetic_scene.py's torus
(4000 coloured surfels, 48x48 RGBA views on its orbit, 8 train and 4
test, a 300-point seed cloud), written by the port. Both loops run 300
iterations with densification every 100 from 100 (at 200 and 300), SH
degree 1, on the CPU (the JAX package in interpret mode). The split
noise differs between the packages, so the states are not compared:
their held-out PSNRs over the 4 test views (clipped render against the
loaded ground truth, as the train CLIs report it) must agree within 1 dB,
and each must beat the initial state's by more than 3 dB (a CPU run of
this test measured 13.92 dB for the initial state, 19.11 dB for the JAX
loop and 18.77 dB for the port's).
"""

import jax
import numpy as np
import torch

from gs2d_torch import config as t_cfg
from gs2d_torch.render.renderer import render as t_render
from gs2d_torch.scene.scene import Scene as TScene
from gs2d_torch.train.loop import train as t_train
from gs2d_torch.utils import synthetic_scene as ss
from gs2d_tpu import config as j_cfg
from gs2d_tpu.ops.rasterize.api import RasterizeConfig
from gs2d_tpu.render.renderer import render as j_render
from gs2d_tpu.train.loop import train as j_train

from .test_torch_common import one_torch_thread  # noqa: F401

OPT = dict(iterations=300, densify_from_iter=100, densification_interval=100,
           densify_until_iter=301, opacity_reset_interval=10_000,
           position_lr_max_steps=300)
GAIN_DB = 3.0


def _psnr(img, gt):
    mse = float(np.mean((np.clip(img, 0, 1) - gt) ** 2))
    return -10.0 * np.log10(max(mse, 1e-10))


def test_heldout_psnr_matches_jax(tmp_path):
    surf = ss.torus_surfels(4000)
    data = tmp_path / "data"
    ss.write_blender_scene(str(data), ss.SurfelRenderer(surf, device="cpu"),
                           48, 48, 8, 4,
                           seed_points=ss.seed_cloud(surf[0], surf[4], 300))
    kw = dict(sh_degree=1, source_path=str(data), eval=True)

    # the JAX loop, and its held-out PSNR
    jts, jscene = j_train(
        j_cfg.ModelParams(**kw), j_cfg.OptimizationParams(**OPT),
        j_cfg.PipelineParams(),
        j_cfg.RuntimeParams(initial_capacity=1024, pairs_capacity=1 << 14,
                            chunk=128, interpret=True, seed=0),
        test_iterations=[], save_iterations=[])
    rcfg = RasterizeConfig(width=48, height=48, pairs_capacity=1 << 14,
                           chunk=128, interpret=True)
    bg = np.zeros(3, np.float32)
    j_image = jax.jit(lambda cam, state: j_render(
        cam, state, rcfg, bg, max_sh_degree=1)["render"])

    def j_psnr(state):
        return np.mean([_psnr(np.asarray(j_image(c.camera, state)), c.image)
                        for c in jscene.get_test_cameras()])

    # the port's loop with scene=None: it loads the dataset itself
    tts, tscene = t_train(
        t_cfg.ModelParams(**kw), t_cfg.OptimizationParams(**OPT),
        t_cfg.PipelineParams(), t_cfg.RuntimeParams(seed=0),
        test_iterations=[], save_iterations=[], device="cpu")
    assert isinstance(tscene, TScene)
    assert len(tscene.get_train_cameras()) == 8

    def t_psnr(state):
        with torch.no_grad():
            return np.mean([_psnr(t_render(
                c.camera, state, torch.zeros(3), max_sh_degree=1,
                device="cpu")["render"].numpy(), c.image.numpy())
                for c in tscene.get_test_cameras()])

    fresh = TScene(t_cfg.ModelParams(**kw), seed=0, device="cpu")
    p_init = t_psnr(fresh.gaussians)
    p_jax, p_port = j_psnr(jts.gaussians), t_psnr(tts.gaussians)
    assert abs(p_init - j_psnr(jscene.gaussians)) < 1e-3
    assert abs(p_port - p_jax) < 1.0, (p_init, p_jax, p_port)
    assert p_port > p_init + GAIN_DB and p_jax > p_init + GAIN_DB, \
        (p_init, p_jax, p_port)
    assert tts.gaussians.params.xyz.shape[0] > 300
