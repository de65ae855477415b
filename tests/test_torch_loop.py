"""The port's training loop (``gs2d_torch.train.loop.train``) on the CPU.

The stub scene of tests/test_loop_e2e.py — three 64×32 views of a
40-splat scene rendered by the JAX package, a learner started from 12
displaced flat-gray points — with that test's compressed schedule
(300 iterations, densify every 20 in (20, 220), opacity reset every 120,
threshold 5e-5).

- Schedule: both loops run with their densify and reset calls recorded
  (the JAX loop with a stub step, since its schedule does not depend on
  the step's result); they must fire at the same iterations with the same
  scalar arguments, and visit the cameras in the same order.
- Outcome, at the JAX test's bars: densification grows the model past 12
  points, every logged loss is finite, the loss floor sits under 0.8 of
  its peak, and view 0 renders more than 2 dB better than the init.
  Trajectories are not compared: the split noise comes from each
  package's own generator.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gs2d_torch.train.loop as t_loop
import gs2d_tpu.train.loop as j_loop
from gs2d_torch import config as t_cfg
from gs2d_torch.models.gaussians import init_from_pcd as t_init
from gs2d_torch.render.renderer import render as t_render
from gs2d_torch.scene.cameras import CameraData as TCameraData
from gs2d_tpu import config as j_cfg
from gs2d_tpu.models.gaussians import init_from_pcd as j_init
from gs2d_tpu.ops.rasterize.api import RasterizeConfig
from gs2d_tpu.render.renderer import render as j_render
from gs2d_tpu.scene.cameras import CameraData as JCameraData

from .test_torch_common import port_camera
from .utils import lookat_camera, random_cloud

W, H = 64, 32
DISTS = (4.0, 3.4, 4.7)
SH = 2
OPT_KW = dict(iterations=300, densify_from_iter=20, densify_until_iter=220,
              densification_interval=20, opacity_reset_interval=120,
              densify_grad_threshold=5e-5, percent_dense=0.01,
              position_lr_init=2e-3, position_lr_final=2e-4)


def _stub_data():
    """tests/test_loop_e2e.py's ground truth (the JAX render) and init."""
    means, scales, _, _, rgb, _ = random_cloud(40, 3, spread=0.9,
                                               scale_lo=0.08, scale_hi=0.35)
    gt_state = j_init(means, rgb, 64, init_scales=np.log(scales), seed=0)
    rcfg = RasterizeConfig(width=W, height=H, pairs_capacity=1 << 12,
                           chunk=16, interpret=True)
    images = [np.asarray(j_render(lookat_camera(W, H, dist=d), gt_state,
                                  rcfg, jnp.zeros((3,), jnp.float32))
                         ["render"]) for d in DISTS]
    rng = np.random.default_rng(11)
    init_pts = means[:12] + rng.normal(scale=0.15, size=(12, 3)) \
        .astype(np.float32)
    return images, init_pts


class _Recorder:
    """Records the step's iteration and camera, and the densify and reset
    calls with their scalar arguments, at the iteration they follow."""

    def __init__(self, cameras):
        self.cameras, self.iteration = cameras, None
        self.visits, self.calls = [], []

    def saw_step(self, iteration, camera):
        self.iteration = int(iteration)
        self.visits.append(next(i for i, c in enumerate(self.cameras)
                                if c is camera))

    def saw_call(self, kind, args):
        self.calls.append((self.iteration, kind,
                           tuple(float(np.float32(a)) for a in args)))


class _PortScene:
    def __init__(self, images, init_pts):
        self.cams = [TCameraData(camera=port_camera(W, H, dist=d),
                                 image=torch.tensor(img),
                                 image_name=f"v{i}", uid=i)
                     for i, (d, img) in enumerate(zip(DISTS, images))]
        self.model_path = ""
        self.cameras_extent = 1.5
        self.gaussians = t_init(init_pts, np.full((12, 3), 0.5, np.float32),
                                max_sh_degree=SH, seed=0, device="cpu")
        self.saved = []

    def get_train_cameras(self):
        return self.cams

    def save(self, iteration, state):
        self.saved.append(iteration)


def _jax_schedule(init_pts):
    """The JAX loop's schedule, with a stub step and recorded densify and
    reset calls (both return the state unchanged)."""
    cams = [JCameraData(camera=lookat_camera(W, H, dist=d), uid=i,
                        image=np.zeros((3, H, W), np.float32))
            for i, d in enumerate(DISTS)]
    rec = _Recorder([c.camera for c in cams])

    class Scene:
        def __init__(self, args, *, capacity, seed=0, **_):
            self.model_path, self.cameras_extent = "", 1.5
            self.gaussians = j_init(
                init_pts, np.full((12, 3), 0.5, np.float32), capacity,
                max_sh_degree=args.sh_degree,
                init_scales=np.zeros((12, 2), np.float32), seed=seed)

        def get_train_cameras(self, scale=1.0):
            return cams

    metrics = {"overflow": False, "loss": 0.0, "dist_loss": 0.0,
               "normal_loss": 0.0, "num_points": 12, "padded_total": 0,
               "num_expanded": 0, "num_rows": 0}

    def make_step(*args, **kw):
        def step(ts, camera, gt, iteration, bg):
            rec.saw_step(iteration, camera)
            return ts, metrics
        return step

    def densify(state, opt, key, *args):
        rec.saw_call("densify", args)
        return state, opt

    def reset(state, opt):
        rec.saw_call("reset", ())
        return state, opt

    mp = {"Scene": Scene, "make_train_step": make_step,
          "densify_and_prune": densify, "reset_opacity": reset}
    saved = {k: getattr(j_loop, k) for k in mp}
    try:
        for k, v in mp.items():
            setattr(j_loop, k, v)
        j_loop.train(j_cfg.ModelParams(sh_degree=SH, source_path="unused"),
                     j_cfg.OptimizationParams(**OPT_KW),
                     j_cfg.PipelineParams(),
                     j_cfg.RuntimeParams(initial_capacity=64,
                                         pairs_capacity_auto=False, seed=0,
                                         interpret=True),
                     test_iterations=[], save_iterations=[])
    finally:
        for k, v in saved.items():
            setattr(j_loop, k, v)
    return rec


def test_loop_matches_jax_schedule_and_trains(monkeypatch):
    images, init_pts = _stub_data()
    scene = _PortScene(images, init_pts)
    rec = _Recorder([c.camera for c in scene.cams])
    real_step, real_densify, real_reset = (
        t_loop.make_train_step, t_loop.densify_and_prune,
        t_loop.reset_opacity)

    def make_step(*args, **kw):
        step = real_step(*args, **kw)

        def recorded(ts, camera, gt, iteration, bg):
            rec.saw_step(iteration, camera)
            return step(ts, camera, gt, iteration, bg)
        return recorded

    def densify(state, opt, *args, **kw):
        rec.saw_call("densify", args)
        return real_densify(state, opt, *args, **kw)

    def reset(state, opt):
        rec.saw_call("reset", ())
        return real_reset(state, opt)

    monkeypatch.setattr(t_loop, "make_train_step", make_step)
    monkeypatch.setattr(t_loop, "densify_and_prune", densify)
    monkeypatch.setattr(t_loop, "reset_opacity", reset)
    losses = []
    ts, _ = t_loop.train(
        t_cfg.ModelParams(sh_degree=SH), t_cfg.OptimizationParams(**OPT_KW),
        t_cfg.PipelineParams(), t_cfg.RuntimeParams(seed=0), scene=scene,
        test_iterations=[], save_iterations=[],
        log_fn=lambda it, r: losses.append((it, r["loss"], r["points"])),
        device="cpu")

    ref = _jax_schedule(init_pts)
    assert rec.calls == ref.calls
    assert [it for it, kind, _ in rec.calls if kind == "densify"] == \
        list(range(40, 220, 20))
    assert [it for it, kind, _ in rec.calls if kind == "reset"] == [120]
    assert rec.visits == ref.visits and len(rec.visits) == 300

    n_final = ts.gaussians.params.xyz.shape[0]
    assert n_final > 12, f"densification never grew the model ({n_final})"
    lvals = np.array([loss for _, loss, _ in losses])
    assert len(lvals) == 30 and np.isfinite(lvals).all()
    assert lvals.min() < 0.8 * lvals.max()

    cam0, img0 = scene.cams[0].camera, images[0]

    def psnr_of(state):
        with torch.no_grad():
            img = t_render(cam0, state, torch.zeros(3), max_sh_degree=SH,
                           device="cpu")["render"].numpy()
        return -10.0 * np.log10(max(float(np.mean((img - img0) ** 2)),
                                    1e-10))

    p_init, p_final = psnr_of(scene.gaussians), psnr_of(ts.gaussians)
    assert p_final > p_init + 2.0, f"{p_init:.2f} -> {p_final:.2f} dB"


def test_loop_without_a_scene_raises(tmp_path):
    """With no scene passed, train() loads the dataset at
    model.source_path; where there is none it raises before any step."""
    with pytest.raises(ValueError, match="could not recognize scene type"):
        t_loop.train(t_cfg.ModelParams(source_path=str(tmp_path)),
                     t_cfg.OptimizationParams(), t_cfg.PipelineParams(),
                     t_cfg.RuntimeParams(), device="cpu")


def test_loop_saves_profiles_checkpoints_and_resumes(tmp_path):
    """save_iterations go through scene.save, checkpoint_iterations write
    chkpnt<it>.npz under model_path, profile_dir gets a trace of
    iterations 50–60, and start_checkpoint resumes after the checkpoint's
    iteration with its state."""
    from gs2d_torch.models.io import load_checkpoint
    images, init_pts = _stub_data()
    scene = _PortScene(images, init_pts)
    scene.model_path = str(tmp_path)
    kw = dict(OPT_KW, iterations=60, densify_until_iter=41)
    logged = []
    ts, _ = t_loop.train(
        t_cfg.ModelParams(sh_degree=SH), t_cfg.OptimizationParams(**kw),
        t_cfg.PipelineParams(), t_cfg.RuntimeParams(seed=0), scene=scene,
        test_iterations=[], save_iterations=[30],
        checkpoint_iterations=[40], profile_dir=str(tmp_path / "prof"),
        device="cpu")
    assert scene.saved == [30]
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    ck = str(tmp_path / "chkpnt40.npz")
    state40, opt40, it, extent = load_checkpoint(ck, device="cpu")
    assert it == 40 and extent == scene.cameras_extent and opt40.step == 40
    assert state40.params.xyz.shape == ts.gaussians.params.xyz.shape

    ts2, _ = t_loop.train(
        t_cfg.ModelParams(sh_degree=SH), t_cfg.OptimizationParams(**kw),
        t_cfg.PipelineParams(), t_cfg.RuntimeParams(seed=0), scene=scene,
        test_iterations=[], save_iterations=[], start_checkpoint=ck,
        log_fn=lambda i, r: logged.append(i), device="cpu")
    assert logged == [50, 60] and ts2.opt.step == 60
    assert ts2.gaussians.params.xyz.shape == state40.params.xyz.shape
    assert all(torch.isfinite(getattr(ts2.gaussians.params, f)).all()
               for f in ("xyz", "scaling", "opacity"))


def _jax_run_log_keys():
    """The keys of the JAX loop's run-log record (``rec`` in
    ``gs2d_tpu/train/loop.py``'s ``train``: the dict it builds and every
    key it assigns)."""
    import ast
    from pathlib import Path
    src = Path(j_loop.__file__).read_text()
    fn = next(f for f in ast.parse(src).body
              if isinstance(f, ast.FunctionDef) and f.name == "train")
    keys = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and any(isinstance(t, ast.Name) and t.id == "rec"
                        for t in node.targets):
            keys |= {k.value for k in node.value.keys}
        elif isinstance(node, ast.Subscript) \
                and isinstance(node.ctx, ast.Store) \
                and isinstance(node.value, ast.Name) \
                and node.value.id == "rec":
            keys.add(node.slice.value)
    return keys


def test_loop_run_log_writes_peak_hbm_gb(tmp_path, monkeypatch):
    """Every 500 iterations the run-log record carries the allocator's
    peak as ``peak_hbm_gb``, as the JAX loop writes it, and no other peak
    key; its keys include every key of the JAX loop's record. Resumed at
    490 with the peak stubbed (on the CPU there is none)."""
    from gs2d_torch.models.io import save_checkpoint
    from gs2d_torch.train.optim import init_adam
    assert t_loop.peak_hbm_gb(torch.device("cpu")) is None
    images, init_pts = _stub_data()
    scene = _PortScene(images, init_pts)
    ck = str(tmp_path / "chkpnt490.npz")
    save_checkpoint(ck, scene.gaussians, init_adam(scene.gaussians.params),
                    490, scene.cameras_extent)
    monkeypatch.setattr(t_loop, "peak_hbm_gb", lambda device: 1.25)
    logged = {}
    t_loop.train(
        t_cfg.ModelParams(sh_degree=SH),
        t_cfg.OptimizationParams(**dict(OPT_KW, iterations=510)),
        t_cfg.PipelineParams(), t_cfg.RuntimeParams(seed=0), scene=scene,
        test_iterations=[], save_iterations=[], start_checkpoint=ck,
        log_fn=lambda i, r: logged.setdefault(i, r), device="cpu")
    assert sorted(logged) == [500, 510]
    assert logged[500]["peak_hbm_gb"] == 1.25
    assert "peak_hbm_gb" not in logged[510]
    assert not any("peak_gib" in r for r in logged.values())
    jax_keys = _jax_run_log_keys()
    assert {"loss", "points", "elapsed_s", "peak_hbm_gb"} <= jax_keys
    assert jax_keys <= set(logged[500]), jax_keys - set(logged[500])
