"""The ``train`` mix: the port's training loop resumed from a checkpoint.

Set-up makes the surfels, the Adam moments, the camera rig and the ground
truth from the seed, writes them as a checkpoint in the loop's npz schema
into host memory (``np.load`` reads it from there as from a file), and
calls ``gs2d_torch.train.loop.train`` with ``start_checkpoint`` on it.
The loop's per-iteration callback watches it: after the first
``checked_steps`` it keeps what the check needs (the first moments after
step 1, the parameters after the last checked step), after
``warmup_iterations`` it opens the window, and it ends the loop by
raising once the window has run ``--seconds`` (or, traced,
``trace_iterations`` iterations). Two thin wrappers observe the loop
without changing it: one around ``make_train_step`` keeps the checked
steps' losses, and the training views record which view the loop took.

After the window the program's state is freed and the reference follows
the checked steps from the same checkpoint, on the views of the
reference's own camera order.

The configuration's ``optimization`` block holds ``resume_iteration``,
``gt_cache_budget`` and ``depth_ratio``, and may name the distortion
loss's weight ``lambda_dist``, the one loss weight that 2DGS's published
protocols set (DTU 1000, Tanks and Temples 100 or 10): it goes to the
program's ``OptimizationParams`` and to the reference's options alike,
and where it is not named both keep the default 0. Any other key stops
the run at set-up.
"""

from __future__ import annotations

import gc
import io
import statistics
import time

import numpy as np
import torch

from .. import scene as scenes
from ..readers import Traced
from ..reference import raster
from ..reference import train as ref
from . import Outcome, Run, WindowClosed, patched, reference_mode
from .. import trace as tracing

FIELDS = ref.FIELDS
OPT = {"position_lr_init": 0.00016, "position_lr_final": 0.0000016,
       "position_lr_max_steps": 30_000, "feature_lr": 0.0025,
       "opacity_lr": 0.05, "scaling_lr": 0.005, "rotation_lr": 0.001,
       "lambda_dssim": 0.2, "lambda_normal": 0.05, "lambda_dist": 0.0}
LOSS_WEIGHTS = ("lambda_dist",)
SETTINGS = ("resume_iteration", "gt_cache_budget", "depth_ratio")


def loss_weights(cfg: dict) -> dict:
    """The loss weights that the configuration's ``optimization`` block
    names; a key that is neither a weight nor a setting raises."""
    block = cfg["optimization"]
    unknown = sorted(set(block) - set(LOSS_WEIGHTS) - set(SETTINGS))
    if unknown:
        raise ValueError(f"unknown optimization keys {unknown} in "
                         f"{cfg.get('name', 'the configuration')}")
    return {k: float(block[k]) for k in LOSS_WEIGHTS if k in block}


class _View:
    """A training view that notes each time the loop takes its camera."""
    __slots__ = ("_camera", "image", "alpha_mask", "_i", "_taken")

    def __init__(self, i, camera, image, taken):
        self._camera, self.image, self.alpha_mask = camera, image, None
        self._i, self._taken = i, taken

    @property
    def camera(self):
        self._taken.append(self._i)
        return self._camera


class _Watch:
    """The loop's per-iteration callback."""

    def __init__(self, r: Run, first: int, taken: list):
        t = r.traffic
        self.r, self.first, self.taken = r, first, taken
        self.checked = int(t["checked_steps"])
        self.warm = int(t["warmup_iterations"])
        self.trace_its = int(t["trace_iterations"])
        if self.warm <= self.checked:
            raise ValueError("warmup_iterations must exceed checked_steps")
        self.mu1 = self.p_checked = self.ts = None
        self.n = 0
        self.t_open = self.t_close = self.wall_open = 0.0
        self.taken_open = self.taken_close = 0
        self.prof = self.win = None
        self.stamps = []

    def __call__(self, iteration, ts, ema):
        k = iteration - self.first
        if k == 1:
            self.r.sync()
            self.r.log("train: first step done")
            self.mu1 = {f: getattr(ts.opt.mu, f).detach().cpu()
                        for f in FIELDS}
        if k == self.checked:
            self.p_checked = {f: getattr(ts.gaussians.params, f).detach()
                              .cpu() for f in FIELDS}
        if k == self.warm:
            if self.r.trace:
                self.prof = tracing.profiler()
                self.prof.start()
            self.r.sync()
            if self.r.trace:
                self.win = tracing.span("window")
                self.win.__enter__()
            self.wall_open = time.time()
            self.t_open = time.perf_counter()
            self.taken_open = len(self.taken)
            self.r.log(f"train: window opens after iteration {iteration}")
        elif k > self.warm:
            self.n += 1
            self.stamps.append(time.perf_counter())
            done = (self.n >= self.trace_its if self.r.trace else
                    time.perf_counter() - self.t_open >= self.r.seconds)
            if done:
                self.r.sync()
                self.t_close = time.perf_counter()
                self.taken_close = len(self.taken)
                if self.r.trace:
                    self.win.__exit__(None, None, None)
                    self.prof.stop()
                self.ts = ts
                raise WindowClosed


def _moments(params: dict, seed: int, device):
    g = torch.Generator(device=device).manual_seed(int(seed) ^ 0xADA)
    mu = {f: 1e-7 * torch.randn(params[f].shape, generator=g, device=device)
          for f in FIELDS}
    nu = {f: 1e-12 * (1 + torch.rand(params[f].shape, generator=g,
                                     device=device)) for f in FIELDS}
    return mu, nu


def _checkpoint(p: dict, mu: dict, nu: dict, iteration: int,
                extent: float) -> io.BytesIO:
    """The loop's npz checkpoint schema, in host memory."""
    n = p["xyz"].shape[0]
    z = np.zeros(n, np.float32)
    arrays = {f"{k}.{f}": t[f].numpy() for k, t in (("p", p), ("mu", mu),
                                                     ("nu", nu))
              for f in FIELDS}
    buf = io.BytesIO()
    np.savez(buf, **arrays, active=np.ones(n, bool),
             active_sh_degree=np.int32(3), max_radii2d=z, grad_accum=z,
             denom=z, opt_step=np.int32(iteration),
             iteration=np.int64(iteration),
             spatial_lr_scale=np.float64(extent))
    buf.seek(0)
    return buf


def _leaf_norms(d: dict) -> dict:
    return {f: float(torch.linalg.vector_norm(d[f].double())) for f in d}


def _gap(prog: dict, refd: dict, leaves) -> tuple:
    """Per leaf, the gap of norms against the larger of the reference's
    norm of that leaf and of the median leaf → (worst gap, gaps, program
    norms, reference norms)."""
    np_, nr = _leaf_norms(prog), _leaf_norms(refd)
    med = statistics.median(nr[f] for f in leaves)
    gaps = {f: abs(np_[f] - nr[f]) / max(nr[f], med, 1e-300)
            for f in leaves}
    return max(gaps.values()), gaps, np_, nr


def _rows(d: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(d.double().reshape(d.shape[0], -1),
                                    dim=1)


def _reference_steps(r: Run, p0, mu0, nu0, views, order, gt, extent,
                     first, steps, dtype, opt: dict, depth_ratio: float):
    """The reference's ``steps`` steps from the checkpoint with the
    options ``opt`` → (losses, first gradient, parameters after the last
    step), on the host."""
    dev = r.device
    p = {f: p0[f].to(dev, dtype) for f in FIELDS}
    mu = {f: mu0[f].to(dev, dtype) for f in FIELDS}
    nu = {f: nu0[f].to(dev, dtype) for f in FIELDS}
    bg = torch.zeros(3, dtype=dtype, device=dev)
    losses, g1 = [], None
    for k in range(steps):
        it = first + k + 1
        v = order[k]
        loss, g = ref.gradient(p, views[v], gt[v].to(dev, dtype), it, opt,
                               bg, depth_ratio=depth_ratio)
        losses.append(float(loss))
        if k == 0:
            g1 = {f: g[f].float().cpu() for f in FIELDS}
        p, mu, nu = ref.adam(p, g, mu, nu, first + k + 1,
                             ref.learning_rates(it, extent, opt))
    return losses, g1, {f: p[f].float().cpu() for f in FIELDS}


def run(r: Run) -> Outcome:
    from gs2d_torch.config import (ModelParams, OptimizationParams,
                                   PipelineParams, RuntimeParams)
    from gs2d_torch.scene.cameras import make_camera
    from gs2d_torch.train import loop, step as step_mod
    from gs2d_torch.ops.rasterize import api

    cfg, dev = r.cfg, r.device
    weights = loss_weights(cfg)
    opt_ref = {**OPT, **weights}
    ratio = float(cfg["optimization"]["depth_ratio"])
    first = int(cfg["optimization"]["resume_iteration"])
    if first < 3000 or first < 1000 * int(cfg["sh_degree"]):
        raise ValueError("the reference resumes past the SH ramp only")
    r.log("train: set-up")
    p_dev = scenes.make_params(cfg, r.seed, dev, r.n)
    mu_dev, nu_dev = _moments(p_dev, r.seed, dev)
    p0 = {f: p_dev[f].cpu() for f in FIELDS}
    mu0 = {f: mu_dev[f].cpu() for f in FIELDS}
    nu0 = {f: nu_dev[f].cpu() for f in FIELDS}
    del p_dev, mu_dev, nu_dev
    rig = scenes.make_rig(cfg, r.scale)
    views = [rig.views[i] for i in rig.train]
    extent = scenes.camera_extent(views)
    W, H = views[0].width, views[0].height
    gt = scenes.make_gt(len(views), W, H, r.seed, dev)
    checked = int(r.traffic["checked_steps"])
    order = ref.camera_order(r.seed, len(views), checked)
    if r.mode == "control":
        return _control(r, p0, mu0, nu0, views, order, gt, extent, first,
                        opt_ref, ratio)

    buf = _checkpoint(p0, mu0, nu0, first, extent)
    taken = []
    train_views = [_View(i, make_camera(v.R, v.t, v.fovx, v.fovy, v.width,
                                       v.height, device=dev), gt[i], taken)
                   for i, v in enumerate(views)]
    scene = _Scene(extent, train_views)
    watch = _Watch(r, first, taken)
    losses = []
    make = loop.make_train_step

    def make_step(*a, **k):
        st = make(*a, **k)

        def step(ts, *args, **kw):
            new_ts, m = st(ts, *args, **kw)
            if len(losses) < checked:
                losses.append(m["total_loss"])
            return (ts if r.mode == "unchanged" else new_ts), m
        return step

    orig_losses = step_mod.compute_losses

    def half_losses(pkg, gt_image, iteration, opt_cfg):
        h = gt_image.shape[1] // 2
        part = {k: (v[:, :h] if torch.is_tensor(v) and v.dim() == 3 else v)
                for k, v in pkg.items()}
        return orig_losses(part, gt_image[:, :h], iteration, opt_cfg)

    orig_bin = api.bin_preprocessed
    orig_load = loop.load_checkpoint

    def timed_load(*a, **k):
        t0 = time.perf_counter()
        out = orig_load(*a, **k)
        r.log(f"train: checkpoint loaded in {time.perf_counter() - t0:.3f} s")
        return out

    def traced_bin(*a, **k):
        with tracing.span("bin_preprocessed"):
            return orig_bin(*a, **k)

    opt = OptimizationParams(**weights)
    rt = RuntimeParams(seed=r.seed,
                       gt_cache_budget=int(cfg["optimization"]
                                           ["gt_cache_budget"]))
    pipe = PipelineParams(depth_ratio=ratio)
    r.log("train: the loop starts")
    with patched(loop, "make_train_step", make_step), \
            patched(step_mod, "compute_losses",
                    half_losses if r.mode == "half_batch" else orig_losses), \
            patched(api, "bin_preprocessed",
                    traced_bin if r.trace else orig_bin), \
            patched(loop, "load_checkpoint", timed_load):
        try:
            loop.train(ModelParams(sh_degree=int(cfg["sh_degree"])), opt,
                       pipe, rt, scene=scene, test_iterations=(),
                       save_iterations=(), checkpoint_iterations=(),
                       start_checkpoint=buf, viewer_fn=watch, device=dev)
        except WindowClosed:
            pass
    if watch.ts is None:
        raise RuntimeError("the loop ended before the window closed")
    span = watch.t_close - watch.t_open
    r.log(f"train: window closed after {watch.n} iterations in {span:.3f} s;"
          f" it/s by quarter {_quarters(watch.t_open, watch.stamps)}")
    setup_s = watch.wall_open - r.t_start
    peak = r.peak_bytes()
    prog_losses = [float(x) for x in losses]
    window_views = taken[watch.taken_open:watch.taken_close]
    traced = None
    if r.trace:
        tr = tracing.read(watch.prof)
        watch.prof = None
    watch.ts = None
    del buf, scene, train_views
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    reference_mode()
    if r.trace:
        traced = _traced(r, tr, watch.n, window_views, p0, views)
    r.log("train: reference")
    order = ref.camera_order(r.seed, len(views), len(taken))
    ref_losses, g1, p_ref = _reference_steps(
        r, p0, mu0, nu0, views, order, gt, extent, first, checked,
        torch.float32, opt_ref, ratio)
    r.log("train: reference done")
    g1_prog = {f: (watch.mu1[f].double() - ref.BETA1 * mu0[f].double())
               / (1 - ref.BETA1) for f in FIELDS}
    numbers = _compare(r, prog_losses, ref_losses, g1_prog, g1,
                       {f: watch.p_checked[f] - p0[f] for f in FIELDS},
                       {f: p_ref[f] - p0[f] for f in FIELDS})
    numbers["views_off"] = float(sum(a != b for a, b in zip(taken, order))
                                 + abs(len(taken) - len(order)))
    return Outcome({"train_it_s": watch.n / span}, watch.n, 0, peak,
                   numbers, setup_s, traced)


def _quarters(t0: float, stamps: list) -> list:
    """Iterations per second of each quarter of the window."""
    if len(stamps) < 8:
        return []
    q = len(stamps) // 4
    edges = [t0] + [stamps[q * i - 1] for i in range(1, 5)]
    return [round(q / (b - a), 3) for a, b in zip(edges, edges[1:])]


class _Scene:
    """What the loop asks of a scene when it resumes from a checkpoint."""

    def __init__(self, extent, views):
        self.gaussians, self.cameras_extent = None, extent
        self.model_path, self._views = "", views

    def get_train_cameras(self):
        return self._views

    def save(self, iteration, state):
        pass


def _compare(r: Run, lp, lr, gp, gr, dp, dr) -> dict:
    """The compared numbers of the checked steps: each step's loss; the
    first gradient's gap of norms of the median leaf; the change's gap of
    norms of the worst leaf, without the leaves whose reference gradient
    is under a thousandth of the median leaf's. The first gradient takes
    the median leaf because a few surfels seen nearly edge-on (a ray
    meets the plane at p / p2 with p2 near rounding) carry a gradient
    that is rounding noise on both sides, and it can set the norm of one
    or two leaves (rotation, xyz)."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(lp, lr))
    worst, gg, gnp, gnr = _gap(gp, gr, FIELDS)
    grad_gap = statistics.median(gg.values())
    med = statistics.median(gnr.values())
    moved = [f for f in FIELDS if gnr[f] >= 1e-3 * med]
    change_gap, cg, cnp, cnr = _gap(dp, dr, moved)
    r.log(f"losses program {lp} reference {lr}")
    r.log(f"first gradient: median leaf's gap {grad_gap!r}, worst leaf's "
          f"{worst!r}")
    for f in FIELDS:
        d = (gp[f].double() - gr[f].double())
        rows = _rows(d)
        top = torch.topk(rows, min(5, rows.numel())).values.tolist()
        worst_rows = torch.topk(rows, min(3, rows.numel())).indices
        rp = _rows(gp[f])[worst_rows].tolist()
        rr = _rows(gr[f])[worst_rows].tolist()
        nz = _rows(gr[f])
        nz = nz[nz > 0]
        r.log(f"{f}: gradient norm {gnp[f]!r} / {gnr[f]!r} gap {gg[f]!r}, "
              f"all rows' difference norm "
              f"{float(torch.linalg.vector_norm(d))!r}, largest rows' "
              f"differences {top}, those rows' norms {rp} / {rr}, median "
              f"nonzero row {float(nz.median()) if nz.numel() else 0.0!r}; "
              f"change norm {cnp.get(f)!r} / {cnr.get(f)!r} gap "
              f"{cg.get(f)!r}")
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap}


def _control(r, p0, mu0, nu0, views, order, gt, extent, first, opt,
             ratio) -> Outcome:
    """The reference in bfloat16 in the program's place."""
    reference_mode()
    steps = int(r.traffic["checked_steps"])
    r.log("train: reference, float32")
    lr, gr, pr = _reference_steps(r, p0, mu0, nu0, views, order, gt,
                                  extent, first, steps, torch.float32, opt,
                                  ratio)
    r.log("train: reference, bfloat16")
    lb, gb, pb = _reference_steps(r, p0, mu0, nu0, views, order, gt,
                                  extent, first, steps, torch.bfloat16, opt,
                                  ratio)
    numbers = _compare(r, lb, lr, gb, gr,
                       {f: pb[f] - p0[f] for f in FIELDS},
                       {f: pr[f] - p0[f] for f in FIELDS})
    numbers["views_off"] = 0.0
    return Outcome({}, 0, 0, r.peak_bytes(), numbers, 0.0)


def _traced(r: Run, tr, n: int, window_views: list, p0: dict, views):
    """The traced window with the geometry counts of its views."""
    stride = int(r.traffic["count_stride"])
    p = {f: p0[f].to(r.device) for f in FIELDS}
    per_view = {}
    for v in sorted(set(window_views)):
        pairs, visible, pixels = raster.composited_pairs(p, views[v],
                                                         stride=stride)
        per_view[v] = {"pairs": pairs, "visible": visible,
                       "surfels": p["xyz"].shape[0], "pixels": pixels}
    del p
    return Traced("train", tr, n, [per_view[v] for v in window_views])
