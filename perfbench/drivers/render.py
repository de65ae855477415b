"""The ``render`` mix: one closed-loop client renders the held-out views.

Each request renders one view through ``gs2d_torch.render.renderer.render``
as the render CLI's extractor does (no gradient, the model's depth
ratio, rgb clamped to [0, 1]) and waits for it: its latency is the host
clock from the call to the ``torch.cuda.synchronize()`` after it. The
views go in whole passes of a fixed order that starts at a view drawn
from the seed. Set-up renders one whole pass. The outputs of
``checked_views`` requests of the window's first pass, drawn from the
seed, are kept and compared with the reference's once the window has
closed.
"""

from __future__ import annotations

import gc
import math
import random
import time

import torch

from .. import scene as scenes
from .. import trace as tracing
from ..readers import Traced
from ..reference import raster
from . import Outcome, Run, patched, reference_mode, rel_l1

OUTPUTS = ("render", "rend_alpha", "rend_normal", "surf_depth", "rend_dist")
NUMBER = {"render": "rgb_gap", "rend_alpha": "alpha_gap",
          "rend_normal": "normal_gap", "surf_depth": "depth_off",
          "rend_dist": "dist_gap"}
DEPTH_OFF = 1e-4   # a pixel's surface depth is off past this share of it


def p95(values) -> float:
    """The 95th percentile by nearest rank."""
    s = sorted(values)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


def run(r: Run) -> Outcome:
    from gs2d_torch.models.gaussians import GaussianParams, GaussianState
    from gs2d_torch.ops.rasterize import api
    from gs2d_torch.render import renderer
    from gs2d_torch.scene.cameras import make_camera

    cfg, dev, t = r.cfg, r.device, r.traffic
    r.log("render: set-up")
    params = scenes.make_params(cfg, r.seed, dev, r.n)
    rig = scenes.make_rig(cfg, r.scale)
    views = [rig.views[i] for i in rig.test]
    V = len(views)
    rng = random.Random(r.seed)
    start = rng.randrange(V)
    checked = sorted(rng.sample(range(V), int(t["checked_views"])))
    bg = torch.zeros(3, dtype=torch.float32, device=dev)
    ratio = float(cfg["optimization"]["depth_ratio"])
    if r.mode == "control":
        return _control(r, params, views, [(start + k) % V for k in checked],
                        bg, ratio)

    state = GaussianState(params=GaussianParams(**params),
                          active_sh_degree=int(cfg["sh_degree"]))
    cams = [make_camera(v.R, v.t, v.fovx, v.fovy, v.width, v.height,
                        device=dev) for v in views]

    def one(i: int) -> dict:
        with torch.no_grad():
            pkg = renderer.render(cams[i], state, bg,
                                  max_sh_degree=int(cfg["sh_degree"]),
                                  depth_ratio=ratio, device=dev)
            pkg["render"] = torch.clamp(pkg["render"], 0, 1)
        return pkg

    orig_bin = api.bin_preprocessed
    orig_rast = renderer.rasterize

    def traced_bin(*a, **k):
        with tracing.span("bin_preprocessed"):
            return orig_bin(*a, **k)

    def altered(*a, **k):
        out, aux = orig_rast(*a, **k)
        return torch.cat([out[:3] * 1.01, out[3:]]), aux

    kept, lat, prof = {}, [], None
    with patched(api, "bin_preprocessed",
                 traced_bin if r.trace else orig_bin), \
            patched(renderer, "rasterize",
                    altered if r.mode == "altered" else orig_rast):
        for k in range(int(t["warmup_passes"]) * V):
            one((start + k) % V)
        if r.trace:
            prof = tracing.profiler()
            prof.start()
        r.sync()
        win = tracing.span("window") if r.trace else None
        if win is not None:
            win.__enter__()
        wall_open = time.time()
        t_open = time.perf_counter()
        r.log("render: window opens")
        k = 0
        limit = int(t["trace_passes"]) * V if r.trace else None
        while True:
            i = (start + k) % V
            t0 = time.perf_counter()
            pkg = one(i)
            r.sync()
            t1 = time.perf_counter()
            lat.append(t1 - t0)
            if k in checked:
                kept[i] = {o: pkg[o] for o in OUTPUTS}
            del pkg
            k += 1
            if (k >= limit) if r.trace else (t1 - t_open >= r.seconds):
                break
        t_close = time.perf_counter()
        if win is not None:
            win.__exit__(None, None, None)
            prof.stop()
    span = t_close - t_open
    q = len(lat) // 4
    by_quarter = [round(1e3 * sum(lat[i:i + q]) / q, 3)
                  for i in range(0, 4 * q, q)] if q else []
    r.log(f"render: window closed after {k} views in {span:.3f} s; mean ms "
          f"by quarter {by_quarter}")
    if len(kept) != len(checked):
        raise RuntimeError("the window ended before its checked views")
    peak = r.peak_bytes()
    traced = None
    if r.trace:
        tr = tracing.read(prof)
        prof = None
    del state, cams
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    reference_mode()
    if r.trace:
        traced = _traced(r, tr, k, [(start + j) % V for j in range(k)],
                         params, views)
    r.log("render: reference")
    numbers = {n: 0.0 for n in NUMBER.values()}
    for i, prog in kept.items():
        _gaps(numbers, prog, raster.render(params, views[i], bg,
                                           depth_ratio=ratio))
    r.log("render: reference done")
    return Outcome({"render_views_s": k / span,
                    "render_ms_p95": 1e3 * p95(lat)}, k, 0, peak, numbers,
                   wall_open - r.t_start, traced)


def _control(r: Run, params, views, checked, bg, ratio) -> Outcome:
    """The reference in bfloat16 in the program's place."""
    reference_mode()
    numbers = {n: 0.0 for n in NUMBER.values()}
    low = {f: x.to(torch.bfloat16) for f, x in params.items()}
    for i in checked:
        got = raster.render(low, views[i], bg.to(torch.bfloat16),
                            depth_ratio=ratio)
        got["render"] = torch.clamp(got["render"], 0, 1)
        _gaps(numbers, got, raster.render(params, views[i], bg,
                                          depth_ratio=ratio))
    return Outcome({}, 0, 0, r.peak_bytes(), numbers, 0.0)


def _gaps(numbers: dict, got: dict, want: dict) -> None:
    """Raise each compared number to this view's reading: Σ|got − want|
    over Σ|want| for each output, but the distortion's over the size of
    the two terms it is the difference of (alpha·Σw·m² and (Σw·m)²),
    which sets its rounding, and for the surface depth the share of
    pixels off by more than DEPTH_OFF of the reference's depth: a surfel
    that a ray meets nearly in its plane composites through the
    low-pass filter at a depth u·c2_0 + v·c2_1 + c2_2 whose (u, v) =
    p / p2 is rounding noise, so a few pixels' depths are noise on both
    sides, large enough to set a sum of differences."""
    want["render"] = torch.clamp(want["render"], 0, 1)
    for o in OUTPUTS:
        if o == "surf_depth":
            g, w = got[o].double(), want[o].double()
            v = float(torch.mean((torch.abs(g - w)
                                  > DEPTH_OFF * torch.abs(w) + 1e-7)
                                 .double()))
        elif o == "rend_dist":
            d = torch.sum(torch.abs(got[o].double() - want[o].double()))
            v = float(d / torch.clamp(torch.sum(want["dist_scale"].double()),
                                      min=1e-300))
        else:
            v = rel_l1(got[o], want[o])
        numbers[NUMBER[o]] = max(numbers[NUMBER[o]], v)


def _traced(r: Run, tr, n: int, window_views: list, params, views):
    stride = int(r.traffic["count_stride"])
    per_view = {}
    for v in sorted(set(window_views)):
        pairs, visible, pixels = raster.composited_pairs(params, views[v],
                                                         stride=stride)
        per_view[v] = {"pairs": pairs, "visible": visible,
                       "surfels": params["xyz"].shape[0], "pixels": pixels}
    return Traced("render", tr, n, [per_view[v] for v in window_views])
