"""The ``ig2g`` mix: the port's training loop with the IG2G editor on,
resumed from a checkpoint.

Set-up makes the surfels, the Adam moments, the camera rig and the ground
truth from the seed as the ``train`` mix does, builds the editor's three
networks at the configuration's widths with weights drawn from the seed
in its ``torch_dtype`` (``gs2d_torch.ig2g.sd_weights.seeded``), encodes
the prompt once through the program's text tower and a synthetic
tokenizer, and calls ``gs2d_torch.train.loop.train`` with
``start_checkpoint`` and the program's ``Editor`` hook, whose edit is the
program's ``InstructPix2Pix.edit_image``.

The loop's per-iteration callback watches it. A cycle is an edit
iteration and the steps up to the next edit. The first ``checked_edits``
edits are checked: the state before and after their step is kept, with
the edited image the step trained on. Around the first one, forward
hooks on the UNet and the VAE keep the inputs and outputs of the first
and the last UNet call, of each encode and of the decode, and wrappers
on the editor's instances keep its steps as it took them: the strength
T and the posterior's normal draw, every UNet call's float32 latents,
timestep and predictions, the latents and the image of the decode, and
the edit render's ``rend_noise``. After ``warmup_cycles`` more cycles
the window opens, right before an edit and after a synchronise; at each
later cycle's start the device is synchronised and the time noted, and
the window closes at the end of the last whole cycle inside
``--seconds`` (traced: after ``trace_cycles`` cycles). ``train_it_s`` is
the window's iterations over its seconds.

After the window the program's state is freed and the reference
(``reference/ip2p.py``, ``reference/raster.py`` and
``reference/train.py``, in float32 without TF32) recomputes, each from
the program's own values so that float16's error does not compound:
the first and the last UNet call, each encode and the decode on their
inputs (Σ|Δ|/Σ|ref| of the outputs); the first UNet call's input from
the kept T, draw and moments (the noise set-up and the image latents);
each DDIM step from the program's latents and predictions through the
reference's guidance and step, against the program's next latents and
the decode's (its timesteps held exactly); the edit render's noise
channels, the per-surfel draw of a generator seeded ``seed + 1``
composited by the reference raster and min-max normalised; the resize
of the decoded image back to the render's size; and one training step
from each checked edit's state on its edited image (the ``train`` mix's
loss, gradient and change gaps, the xyz rate on the editor's restarted
clock). The edits' iterations and cameras and every step's view are
held against the cadence and the loop's camera order from the seed.

``--control`` runs the reference's own float32 edit and puts the
reference in bfloat16 in the program's place on its inputs;
``altered`` scales every UNet output by 1.01 as it is produced.
``perfbench/tools/mutants.py`` breaks the editor's other stages.

The configuration's ``editor`` block holds the networks' widths
(``unet``, ``vae``, ``text_encoder``), ``torch_dtype``, the editor's
knobs, the edit cadence and the ``prompt``; any other key, and any mode
the reference does not hold (FreeU, the fused-skip and rendered-noise
guidance modes, another noise type), stops the run at set-up.
"""

from __future__ import annotations

import gc
import tempfile
import time

import torch
import torch.nn.functional as F

from .. import scene as scenes
from .. import trace as tracing
from ..readers import Traced
from ..reference import ip2p as ref_ip2p
from ..reference import raster
from ..reference import train as ref
from . import Outcome, Run, WindowClosed, patched, reference_mode, rel_l1
from .train import (FIELDS, OPT, _checkpoint, _compare, _moments, _Scene,
                    _View, loss_weights)

DTYPES = {"float16": torch.float16, "bfloat16": torch.bfloat16,
          "float32": torch.float32}
KNOBS = ("guidance_scale", "image_guidance_scale", "diffusion_steps",
         "lower_bound", "upper_bound", "noise_type", "noise_reg",
         "freeu_mode", "is_freeu")
CADENCE = ("ip2p_start_iter", "ip2p_cycle_iter", "ip2p_iter")
EDITOR_KEYS = ("torch_dtype", "unet", "vae", "text_encoder", "prompt",
               *KNOBS, *CADENCE)


def editor_block(cfg: dict) -> dict:
    """The configuration's ``editor`` block, checked."""
    ed = cfg["editor"]
    unknown = sorted(set(ed) - set(EDITOR_KEYS))
    missing = sorted(set(EDITOR_KEYS) - set(ed))
    if unknown or missing:
        raise ValueError(f"editor block: unknown keys {unknown}, missing "
                         f"{missing}")
    if (ed["noise_type"] != "encoded-normalized"
            or ed["noise_reg"] not in ("outlier", "none")
            or ed["freeu_mode"] != "None" or ed["is_freeu"]):
        raise ValueError("the reference holds the encoded-normalized noise "
                         "without FreeU or the fused-skip modes only")
    return ed


class _Probe:
    """Forward hooks on the program's UNet and VAE and wrappers on its
    editor. While armed: the first and the last UNet call's (input, t,
    text states, output), each encode's (image, moments), the decode's
    (latents, image) at the VAE; the editor's T and posterior draw, each
    UNet call's (latents, t, predictions), the decode's (latents, image)
    and the edit render's ``rend_noise``; all on the host. With
    ``scale``, every UNet output is scaled as it is produced."""

    def __init__(self, unet, vae, scale=None):
        self.armed, self.unet_first, self.unet_last = False, None, None
        self.enc, self.dec, self._img, self._lat = [], [], None, None
        self.T = self.draw = self.decoded = self.rend_noise = None
        self.steps = []
        self.handles, self.wrapped = [], []
        if scale is not None:
            self.handles.append(unet.register_forward_hook(
                lambda m, a, out: out * scale))
        self.handles += [
            unet.register_forward_hook(self._unet),
            vae.encoder.register_forward_hook(self._enc_in),
            vae.quant_conv.register_forward_hook(self._enc_out),
            vae.post_quant_conv.register_forward_hook(self._dec_in),
            vae.decoder.register_forward_hook(self._dec_out)]

    @staticmethod
    def _host(x):
        return x.detach().cpu()

    def _unet(self, m, args, out):
        if self.armed:
            call = (self._host(args[0]), int(args[1]), self._host(args[2]),
                    self._host(out))
            if self.unet_first is None:
                self.unet_first = call
            self.unet_last = call

    def _enc_in(self, m, args, out):
        if self.armed:
            self._img = self._host(args[0])

    def _enc_out(self, m, args, out):
        if self.armed:
            self.enc.append((self._img, self._host(out)))

    def _dec_in(self, m, args, out):
        if self.armed:
            self._lat = self._host(args[0])

    def _dec_out(self, m, args, out):
        if self.armed:
            self.dec.append((self._lat, self._host(out)))

    def _wrap(self, obj, name, make):
        setattr(obj, name, make(getattr(obj, name)))
        self.wrapped.append((obj, name))

    def editor(self, ip2p) -> None:
        """Wrap the editor's draws, its backend's predictor and decode."""

        def timestep(real):
            def f(lo, hi):
                T = real(lo, hi)
                if self.armed:
                    self.T = T
                return T
            return f

        def posterior(real):
            def f(shape):
                d = real(shape)
                if self.armed:
                    self.draw = self._host(d)
                return d
            return f

        def predictor(real):
            def make(*a, **kw):
                predict = real(*a, **kw)

                def f(latents, t):
                    eps = predict(latents, t)
                    if self.armed:
                        self.steps.append((self._host(latents), int(t),
                                           self._host(torch.cat(eps, 0))))
                    return eps
                return f
            return make

        def decode(real):
            def f(lat):
                img = real(lat)
                if self.armed:
                    self.decoded = (self._host(lat), self._host(img))
                return img
            return f

        self._wrap(ip2p.draws, "timestep", timestep)
        self._wrap(ip2p.draws, "posterior", posterior)
        self._wrap(ip2p.backend, "make_eps_predictor", predictor)
        self._wrap(ip2p.backend, "decode", decode)

    def render(self, real):
        """``real`` (the loop's ``render``), keeping ``rend_noise``."""
        def f(*a, **kw):
            pkg = real(*a, **kw)
            if self.armed:
                self.rend_noise = self._host(pkg["rend_noise"])
            return pkg
        return f

    def remove(self):
        for h in self.handles:
            h.remove()
        for obj, name in self.wrapped:
            delattr(obj, name)


class _Watch:
    """The loop's per-iteration callback, the editor's ``on_edit`` and the
    views' log."""

    def __init__(self, r: Run, due, checked: list, open_after,
                 probe: _Probe):
        t = r.traffic
        self.r, self.due = r, due
        self.checked, self.open_after = checked, open_after
        self.trace_cycles = int(t["trace_cycles"])
        self.probe = probe
        self.taken, self.views = [], []          # per access, per iteration
        self.edits, self.before, self.after, self.edited = [], {}, {}, {}
        self.bounds = []                          # (perf_counter, iteration)
        self.closed = None
        self.wall_open = 0.0
        self.prof = self.win = None

    def _state(self, ts, opt_too=True):
        g = ts.gaussians.params
        out = {"p": {f: getattr(g, f).detach().cpu() for f in FIELDS},
               "mu": {f: getattr(ts.opt.mu, f).detach().cpu()
                      for f in FIELDS}}
        if opt_too:
            out["nu"] = {f: getattr(ts.opt.nu, f).detach().cpu()
                         for f in FIELDS}
        return out

    def on_edit(self, iteration, cam_idx, out, seconds):
        self.edits.append((iteration, cam_idx))
        if iteration in self.checked:
            self.edited[iteration] = out[0].detach().cpu()
            self.probe.armed = False
        if iteration <= self.checked[-1]:
            self.r.log(f"ig2g: edit at {iteration} of view {cam_idx} in "
                       f"{seconds:.3f} s")

    def __call__(self, iteration, ts, ema):
        seen = set(self.taken)
        self.views.append(self.taken[0] if len(seen) == 1 else -1)
        self.taken.clear()
        if iteration + 1 in self.checked:
            self.before[iteration + 1] = self._state(ts)
            if iteration + 1 == self.checked[0]:
                self.probe.armed = True
        if iteration in self.checked:
            self.after[iteration] = self._state(ts, opt_too=False)
        if iteration < self.open_after or not self.due(iteration + 1):
            return
        if iteration == self.open_after:
            if self.r.trace:
                self.prof = tracing.profiler()
                self.prof.start()
            self.r.sync()
            if self.r.trace:
                self.win = tracing.span("window")
                self.win.__enter__()
            self.wall_open = time.time()
            self.bounds.append((time.perf_counter(), iteration))
            self.r.log(f"ig2g: window opens after iteration {iteration}")
            return
        self.r.sync()
        now = (time.perf_counter(), iteration)
        t_open = self.bounds[0][0]
        if self.r.trace:
            if len(self.bounds) < self.trace_cycles:
                self.bounds.append(now)
                return
            self.win.__exit__(None, None, None)
            self.prof.stop()
            self.closed = now
        elif now[0] - t_open <= self.r.seconds:
            self.bounds.append(now)
            return
        else:
            self.closed = self.bounds[-1] if len(self.bounds) > 1 else now
        raise WindowClosed


def run(r: Run) -> Outcome:
    from gs2d_torch.config import (ModelParams, OptimizationParams,
                                   PipelineParams, RuntimeParams)
    from gs2d_torch.ig2g import sd_weights
    from gs2d_torch.ig2g.clip_text import CLIPTextConfig, PromptEncoder
    from gs2d_torch.ig2g.ip2p import (InstructPix2Pix, IP2PParams,
                                      TorchSDBackend)
    from gs2d_torch.ig2g.sdnet import UNetConfig
    from gs2d_torch.ig2g.tokenizer import (CLIPTokenizer,
                                           write_synthetic_tokenizer)
    from gs2d_torch.ig2g.vae import VAEConfig
    from gs2d_torch.scene.cameras import make_camera
    from gs2d_torch.train import loop
    from gs2d_torch.train import step as step_mod

    cfg, dev = r.cfg, r.device
    ed = editor_block(cfg)
    weights = loss_weights(cfg)
    opt_ref = {**OPT, **weights}
    ratio = float(cfg["optimization"]["depth_ratio"])
    first = int(cfg["optimization"]["resume_iteration"])
    if first < 3000 or first < 1000 * int(cfg["sh_degree"]):
        raise ValueError("the reference resumes past the SH ramp only")
    dtype = DTYPES[ed["torch_dtype"]]
    r.log("ig2g: set-up")
    unet_cfg = UNetConfig(**{k: tuple(v) if isinstance(v, list) else v
                             for k, v in ed["unet"].items()})
    vae_cfg = VAEConfig(**{k: tuple(v) if isinstance(v, list) else v
                           for k, v in ed["vae"].items()})
    clip_cfg = CLIPTextConfig(**ed["text_encoder"])
    unet, vae, clip = sd_weights.seeded(r.seed, dtype, dev, unet_cfg,
                                        vae_cfg, clip_cfg)
    with tempfile.TemporaryDirectory() as d:
        write_synthetic_tokenizer(d, ed["prompt"].split())
        tok = CLIPTokenizer.from_snapshot(d, clip_cfg.max_positions)
    text = PromptEncoder(None, clip_cfg, model=clip, tokenizer=tok,
                         device=dev).encode(ed["prompt"])
    del clip
    r.log(f"ig2g: networks built in {dtype}, prompt encoded")
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

    hook = loop.Editor(edit=None, start_iter=int(ed["ip2p_start_iter"]),
                       cycle_iter=int(ed["ip2p_cycle_iter"]),
                       iters=int(ed["ip2p_iter"]))

    def due(it):
        return hook.due(it, 0, len(views))

    n_edits = hook.iters * len(views)
    plan = [it for it in range(first + 1, first + 2 + hook.every(len(views))
                               * n_edits) if due(it)][:n_edits]
    n_checked = int(r.traffic["checked_edits"])
    warm = int(r.traffic["warmup_cycles"])
    if warm < 1 or n_checked < 1:
        raise ValueError("checked_edits and warmup_cycles must be positive")
    checked = plan[:n_checked]
    open_after = plan[n_checked + warm] - 1
    if r.mode == "control":
        return _control(r, ed, unet, vae, text, p0, mu0, nu0, views, gt,
                        extent, checked[0], hook, opt_ref, ratio,
                        unet_cfg, vae_cfg)

    backend = TorchSDBackend(unet=unet, vae=vae, device=dev)
    ip2p = InstructPix2Pix(IP2PParams(**{k: ed[k] for k in KNOBS}),
                           backend=backend, seed=r.seed, device=dev)
    probe = _Probe(unet, vae, 1.01 if r.mode == "altered" else None)
    probe.editor(ip2p)
    watch = _Watch(r, due, checked, open_after, probe)
    if checked[0] == first + 1:
        watch.before[checked[0]] = {"p": p0, "mu": mu0, "nu": nu0}
        probe.armed = True
    hook.edit = lambda rendered, original, noise: ip2p.edit_image(
        text, rendered, original, noise)
    hook.on_edit = watch.on_edit
    buf = _checkpoint(p0, mu0, nu0, first, extent)
    train_views = [_View(i, make_camera(v.R, v.t, v.fovx, v.fovy, v.width,
                                       v.height, device=dev), gt[i],
                         watch.taken) for i, v in enumerate(views)]
    scene = _Scene(extent, train_views)
    losses = {}
    make = loop.make_train_step

    def make_step(*a, **k):
        st = make(*a, **k)

        def step(ts, *args, **kw):
            new_ts, m = st(ts, *args, **kw)
            if int(args[2]) in checked:
                losses[int(args[2])] = m["total_loss"]
            return (ts if r.mode == "unchanged" else new_ts), m
        return step

    orig_losses = step_mod.compute_losses

    def half_losses(pkg, gt_image, iteration, opt_cfg):
        h = gt_image.shape[1] // 2
        part = {k: (v[:, :h] if torch.is_tensor(v) and v.dim() == 3 else v)
                for k, v in pkg.items()}
        return orig_losses(part, gt_image[:, :h], iteration, opt_cfg)

    rt = RuntimeParams(seed=r.seed,
                       gt_cache_budget=int(cfg["optimization"]
                                           ["gt_cache_budget"]))
    r.log(f"ig2g: the loop starts; edits at {plan[:6]}..., checked "
          f"{checked}, the window opens after {open_after}")
    with patched(loop, "make_train_step", make_step), \
            patched(loop, "render", probe.render(loop.render)), \
            patched(step_mod, "compute_losses",
                    half_losses if r.mode == "half_batch" else orig_losses):
        try:
            loop.train(ModelParams(sh_degree=int(cfg["sh_degree"])),
                       OptimizationParams(**weights),
                       PipelineParams(depth_ratio=ratio), rt, scene=scene,
                       test_iterations=(), save_iterations=(),
                       checkpoint_iterations=(), start_checkpoint=buf,
                       viewer_fn=watch, editor=hook, device=dev)
        except WindowClosed:
            pass
    if watch.closed is None:
        raise RuntimeError("the loop ended before the window closed")
    (t0, it0), (t1, it1) = watch.bounds[0], watch.closed
    n_it = it1 - it0
    marks = [b for b in watch.bounds if b[1] < it1] + [watch.closed]
    r.log(f"ig2g: window closed: {n_it} iterations in {t1 - t0:.3f} s; "
          f"cycle seconds {[round(b[0] - a[0], 3) for a, b in zip(marks, marks[1:])]}")
    setup_s = watch.wall_open - r.t_start
    peak = r.peak_bytes()
    traced = None
    if r.trace:
        tr = tracing.read(watch.prof)
        watch.prof = None
        traced = Traced("ig2g", tr, n_it, [{
            "unet": ed["unet"], "batch": 3, "image": [H, W],
            "ctx_len": clip_cfg.max_positions,
            "dtype_bytes": torch.tensor([], dtype=dtype).element_size()}])
        _log_shares(r)
    probe.remove()
    w_unet = {k: v.float() for k, v in unet.state_dict().items()}
    w_vae = {k: v.float() for k, v in vae.state_dict().items()}
    hook.edit = hook.on_edit = None
    del ip2p, backend, unet, vae, buf, scene, train_views, gt
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    reference_mode()
    r.log("ig2g: reference")
    numbers = _networks(r, probe, w_unet, w_vae, ed)
    del w_unet, w_vae
    first_cam = watch.edits[0][1]
    numbers.update(_edit_steps(r, probe, ed, watch.before[checked[0]]["p"],
                               views[first_cam], watch.edited[checked[0]]))
    steps = []
    for it in checked:
        lp = float(losses[it]) if it in losses else float("nan")
        cam = watch.edits[checked.index(it)][1]
        b, a = watch.before[it], watch.after[it]
        lr, gr, pr = _reference_step(r, b, views[cam], watch.edited[it], it,
                                     hook.lr_iteration(it), extent, opt_ref,
                                     ratio, torch.float32)
        gp = {f: (a["mu"][f].double() - ref.BETA1 * b["mu"][f].double())
              / (1 - ref.BETA1) for f in FIELDS}
        steps.append(_compare(r, [lp], [lr], gp, gr,
                              {f: a["p"][f] - b["p"][f] for f in FIELDS},
                              {f: pr[f] - b["p"][f] for f in FIELDS}))
    for k in ("loss_gap", "grad_gap", "change_gap"):
        numbers[k] = max(s[k] for s in steps)
    order = ref.camera_order(r.seed, len(views), len(watch.views))
    want = [(it, order[it - first - 1]) for it in plan if it <= it1
            and it - first - 1 < len(order)]
    got = [e for e in watch.edits if e[0] <= it1]
    numbers["edits_off"] = float(sum(a != b for a, b in zip(got, want))
                                 + abs(len(got) - len(want)))
    numbers["views_off"] = float(sum(a != b for a, b in
                                     zip(watch.views, order)))
    r.log("ig2g: reference done")
    return Outcome({"train_it_s": n_it / (t1 - t0)}, n_it, 0, peak, numbers,
                   setup_s, traced)


def _log_shares(r: Run) -> None:
    """The editor's stages' device seconds in the traced window."""
    from gs2d_torch.utils import trace as program_trace
    spans = program_trace.summary()["spans"]
    line = {k: round(v["device_s"], 4) for k, v in spans.items()
            if k.startswith("ig2g.") or k == "loop.step"}
    r.log(f"ig2g: device seconds by span in the window {line}")


def _networks(r: Run, probe: _Probe, w_unet, w_vae, ed) -> dict:
    """The UNet's first and last call, the encodes and the decode of the
    first checked edit, recomputed by the reference on their inputs."""
    dev = r.device
    out = {}
    with torch.no_grad():
        for key, call in (("unet_first_gap", probe.unet_first),
                          ("unet_last_gap", probe.unet_last)):
            x, t, ctx, got = call
            want = ref_ip2p.unet(w_unet, x.to(dev).float(), t,
                                 ctx.to(dev).float(), ed["unet"])
            out[key] = rel_l1(got.float(), want.cpu())
        gaps = []
        for img, got in probe.enc:
            mean, logvar = ref_ip2p.vae_moments(w_vae, img.to(dev).float(),
                                                ed["vae"])
            gaps.append(rel_l1(got.float(), torch.cat([mean, logvar], 1)
                               .cpu()))
        out["vae_enc_gap"] = max(gaps)
        lat, got = probe.dec[0]
        out["vae_dec_gap"] = rel_l1(got.float(), ref_ip2p.vae_decode(
            w_vae, lat.to(dev).float(), ed["vae"]).cpu())
    r.log(f"ig2g: the networks' gaps {out}, encode gaps {gaps}")
    return out


def _noise_render(params: dict, view, noise, dtype) -> torch.Tensor:
    """The reference raster's compositing of the per-surfel ``noise`` in
    place of the colour, min-max normalised over the image: the render's
    ``rend_noise`` (3, H, W)."""
    p = {f: params[f].to(noise.device, dtype) for f in FIELDS}
    W, H = view.width, view.height
    with torch.no_grad():
        s = raster.setup(p, raster.matrices(view, noise.device, dtype), W, H)
        fields = s.fields.clone()
        fields[:, raster.F_RGB] = noise.to(dtype)
        ch = raster.composite(fields, raster.cell_lists(s, W, H), W,
                              H)[raster.CH_RGB].float()
    return (ch - ch.min()) / torch.clamp(ch.max() - ch.min(), min=1e-12)


def _resize(img: torch.Tensor, size) -> torch.Tensor:
    """Bilinear with half-pixel centres, antialiased where a side
    shrinks: a triangle filter renormalised at the borders."""
    if tuple(img.shape[2:]) == tuple(size):
        return img
    return F.interpolate(img, size=tuple(size), mode="bilinear",
                         align_corners=False,
                         antialias=any(o < i for o, i in
                                       zip(size, img.shape[2:])))


def _edit_steps(r: Run, probe: _Probe, ed, params: dict, view,
                edited: torch.Tensor) -> dict:
    """The first checked edit's stages between the networks, recomputed
    by the reference from the program's own values: the first UNet
    input (``init_gap``), each DDIM step from the program's latents and
    predictions (``ddim_gap``, the worst step; ``steps_off``, timesteps
    other than the reference's), the render's noise channels
    (``noise_gap``) and the resize back (``resize_gap``)."""
    dev = r.device
    steps = int(ed["diffusion_steps"])
    ac = ref_ip2p.alphas_cumprod(dev)
    ts, ratio = ref_ip2p.timesteps(probe.T, steps)
    got_ts = [t for _, t, _ in probe.steps]
    out = {"steps_off": float(sum(a != b for a, b in zip(got_ts, ts))
                              + abs(len(got_ts) - len(ts)))}
    n_lat = probe.draw.shape[1]
    mean, logvar = probe.enc[0][1].float().chunk(2, dim=1)
    want = ref_ip2p.first_input(
        ac, ts[0], mean.to(dev), logvar.to(dev), probe.draw.to(dev),
        probe.enc[1][1][:, :n_lat].float().to(dev),
        probe.enc[2][1][:, :n_lat].float().to(dev),
        "outlier" in ed["noise_reg"])
    out["init_gap"] = rel_l1(probe.unet_first[0].float(), want.cpu())
    after = [x for x, _, _ in probe.steps[1:]] + [probe.decoded[0]]
    gaps = []
    for (x, _, eps), t, nxt in zip(probe.steps, ts, after):
        eps = ref_ip2p.guide(eps.to(dev), float(ed["guidance_scale"]),
                             float(ed["image_guidance_scale"]))
        want = ref_ip2p.ddim_step(ac, eps, t, ratio, x.to(dev))
        gaps.append(rel_l1(nxt, want.cpu()))
    out["ddim_gap"] = max(gaps)
    g = torch.Generator(device=dev).manual_seed(int(r.seed) + 1)
    noise = torch.randn((params["xyz"].shape[0], 3), generator=g,
                        device=dev)
    out["noise_gap"] = rel_l1(probe.rend_noise, _noise_render(
        params, view, noise, torch.float32).cpu())
    out["resize_gap"] = rel_l1(edited, _resize(
        probe.decoded[1].to(dev), edited.shape[1:])[0].cpu())
    r.log(f"ig2g: the edit's steps {out}, DDIM steps' gaps "
          f"{[float(f'{x:.3g}') for x in gaps]}")
    return out


def _reference_step(r: Run, state: dict, view, gt_img, it: int, lr_it: int,
                    extent: float, opt: dict, ratio: float, dtype):
    """The reference's step ``it`` from ``state`` on ``gt_img`` → (loss,
    gradient, parameters after), on the host."""
    dev = r.device
    p = {f: state["p"][f].to(dev, dtype) for f in FIELDS}
    mu = {f: state["mu"][f].to(dev, dtype) for f in FIELDS}
    nu = {f: state["nu"][f].to(dev, dtype) for f in FIELDS}
    bg = torch.zeros(3, dtype=dtype, device=dev)
    loss, g = ref.gradient(p, view, gt_img.to(dev, dtype), it, opt, bg,
                           depth_ratio=ratio)
    p2, _, _ = ref.adam(p, g, mu, nu, it, ref.learning_rates(lr_it, extent,
                                                             opt))
    return (float(loss), {f: g[f].float().cpu() for f in FIELDS},
            {f: p2[f].float().cpu() for f in FIELDS})


def _control(r: Run, ed, unet, vae, text, p0, mu0, nu0, views, gt, extent,
             it: int, hook, opt, ratio, unet_cfg, vae_cfg) -> Outcome:
    """The reference in bfloat16 in the program's place: the reference's
    own float32 edit of the first checked edit's view (its image standing
    in for the render, a seeded uniform image for the noise render) gives
    the inputs; the bfloat16 reference is compared with the float32 one
    on them, and one bfloat16 step on the edited image with the float32
    step."""
    dev = r.device
    w32 = {"unet": {k: v.float() for k, v in unet.state_dict().items()},
           "vae": {k: v.float() for k, v in vae.state_dict().items()}}
    del unet, vae
    reference_mode()
    order = ref.camera_order(r.seed, len(views), it - int(
        r.cfg["optimization"]["resume_iteration"]))
    v = order[-1]
    g = torch.Generator(device=dev).manual_seed(int(r.seed) ^ 0xC0)
    img = gt[v].to(dev)[None]
    noise_img = torch.rand(img.shape, generator=g, device=dev)
    lat_shape = (1, int(ed["vae"]["latent_channels"]), img.shape[2] // 8,
                 img.shape[3] // 8)
    lo, hi = int(1000 * ed["lower_bound"]), int(1000 * ed["upper_bound"])
    T = int(torch.randint(lo, hi + 1, (1,), generator=g, device=dev))
    draw = torch.randn(lat_shape, generator=g, device=dev)
    steps = int(ed["diffusion_steps"])
    guidance = (float(ed["guidance_scale"]),
                float(ed["image_guidance_scale"]))
    outlier = "outlier" in ed["noise_reg"]
    calls = {}

    def keep(k, x, t, ctx, eps):
        calls[k] = (x, t, ctx, eps)

    r.log("ig2g: control, the reference's float32 edit")
    with torch.no_grad():
        decoded = ref_ip2p.edit(
            w32["unet"], w32["vae"], img, img, noise_img, text.float(), T,
            draw, guidance=guidance[0], image_guidance=guidance[1],
            steps=steps, outlier=outlier, unet_cfg=ed["unet"],
            vae_cfg=ed["vae"], on_unet=keep)
        edited = _resize(decoded, img.shape[2:])[0]
        w16 = {n: {k: x.bfloat16() for k, x in w.items()}
               for n, w in w32.items()}
        numbers = _control_steps(r, ed, w32["vae"], calls, img, noise_img,
                                 draw, T, p0, views[v], decoded)
        for key, k in (("unet_first_gap", 0),
                       ("unet_last_gap", int(ed["diffusion_steps"]) - 1)):
            x, t, ctx, want = calls[k]
            got = ref_ip2p.unet(w16["unet"], x.bfloat16(), t, ctx.bfloat16(),
                                ed["unet"])
            numbers[key] = rel_l1(got.float(), want)
        x = img * 2 - 1
        want = torch.cat(ref_ip2p.vae_moments(w32["vae"], x, ed["vae"]), 1)
        got = torch.cat(ref_ip2p.vae_moments(w16["vae"], x.bfloat16(),
                                             ed["vae"]), 1)
        numbers["vae_enc_gap"] = rel_l1(got.float(), want)
        lat = want[:, :lat_shape[1]]
        numbers["vae_dec_gap"] = rel_l1(
            ref_ip2p.vae_decode(w16["vae"], lat.bfloat16(),
                                ed["vae"]).float(),
            ref_ip2p.vae_decode(w32["vae"], lat, ed["vae"]))
    del w32, w16
    state = {"p": p0, "mu": mu0, "nu": nu0}
    lr32, g32, p32 = _reference_step(r, state, views[v], edited, it,
                                     hook.lr_iteration(it), extent, opt,
                                     ratio, torch.float32)
    lr16, g16, p16 = _reference_step(r, state, views[v], edited, it,
                                     hook.lr_iteration(it), extent, opt,
                                     ratio, torch.bfloat16)
    numbers.update(_compare(r, [lr16], [lr32], g16, g32,
                            {f: p16[f] - p0[f] for f in FIELDS},
                            {f: p32[f] - p0[f] for f in FIELDS}))
    numbers["edits_off"] = numbers["views_off"] = 0.0
    numbers["steps_off"] = 0.0
    r.log(f"ig2g: control numbers {numbers}")
    return Outcome({}, 0, 0, r.peak_bytes(), numbers, 0.0)


def _control_steps(r: Run, ed, w_vae, calls, img, noise_img, draw, T,
                   params, view, decoded) -> dict:
    """The stages between the networks in bfloat16 against float32, on
    the reference edit's values: the first UNet input, each DDIM step,
    the noise render of the seed's draw and the resize back."""
    dev, bf = r.device, torch.bfloat16
    ac = ref_ip2p.alphas_cumprod(dev)
    ts, ratio = ref_ip2p.timesteps(T, int(ed["diffusion_steps"]))
    g, gi = float(ed["guidance_scale"]), float(ed["image_guidance_scale"])
    mean, logvar = ref_ip2p.vae_moments(w_vae, img * 2 - 1, ed["vae"])
    noise_mean = ref_ip2p.vae_moments(w_vae, noise_img * 2 - 1,
                                      ed["vae"])[0]
    got = ref_ip2p.first_input(ac.to(bf), ts[0], mean.to(bf),
                               logvar.to(bf), draw.to(bf), mean.to(bf),
                               noise_mean.to(bf),
                               "outlier" in ed["noise_reg"])
    out = {"init_gap": rel_l1(got.float(), calls[0][0])}
    gaps = []
    for k, t in enumerate(ts):
        x, eps = calls[k][0][0:1, :mean.shape[1]], calls[k][3]
        want = ref_ip2p.ddim_step(ac, ref_ip2p.guide(eps, g, gi), t, ratio,
                                  x)
        got = ref_ip2p.ddim_step(ac.to(bf), ref_ip2p.guide(eps.to(bf), g, gi),
                                 t, ratio, x.to(bf))
        gaps.append(rel_l1(got.float(), want))
    out["ddim_gap"] = max(gaps)
    gen = torch.Generator(device=dev).manual_seed(int(r.seed) + 1)
    noise = torch.randn((params["xyz"].shape[0], 3), generator=gen,
                        device=dev)
    out["noise_gap"] = rel_l1(_noise_render(params, view, noise, bf),
                              _noise_render(params, view, noise,
                                            torch.float32))
    out["resize_gap"] = rel_l1(
        _resize(decoded.to(bf), img.shape[2:]).float(),
        _resize(decoded, img.shape[2:]))
    return out
