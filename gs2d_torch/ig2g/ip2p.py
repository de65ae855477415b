"""The InstructPix2Pix editor, with a stub and an SD backend.

Counterpart of ``gs2d_tpu/ig2g/ip2p.py`` (the reference wrapper's edit
flow, ip2p.py:196-401): draw an editing strength T in [lower, upper]·1000,
lay a 20-step DDIM grid over [0, T], initialise the diffusion noise per
``noise_type`` — 'None' (Gaussian), 'encoded' / 'encoded-normalized' (the
VAE-encoded rendered noise, standardised per ``noise_reg``), 'concat' (the
rendered noise's latents replace the image-conditioning row) — optionally
calibrate it (FFT noise calibration), then denoise with 3-way guidance
(text / image / uncond), including the fork's "intermediate" (fused-skip)
and "cfg" rendered-noise modes.

Backends:
 * "torch" — ``TorchSDBackend``: the SD-1.5 InstructPix2Pix UNet and VAE of
   ``sdnet.py`` / ``vae.py``, weights from a local diffusers snapshot
   (``$GS2D_SD_WEIGHTS``); without one it raises;
 * "stub" — latent space = pixel space and an ε-predictor that pulls
   toward the conditioning image, so the editing control flow runs
   without weights;
 * any object with the same methods (tests pass a ``TorchSDBackend`` of
   tiny random modules).

Every random draw — T, the Gaussian noise, the VAE posterior's sample —
goes through one ``Draws`` object: by default a ``torch.Generator`` seeded
from ``seed`` on the editor's device.

The SD backend's networks run in the dtype of their weights (float16 for
a snapshot stored as F16, the published precision); the latents, the
DDIM arithmetic and the guidance stay float32, as the networks' outputs
are handed back in float32. A non-finite output of the UNet or the VAE
raises ``FloatingPointError`` when the edit's decode ends: each output is
checked on the device, and the host reads the verdict once an edit.
Spans (``utils/trace.py``): ``ig2g.unet`` around each UNet call (counter
``ig2g.unet_call``), ``ig2g.vae_encode`` around each encode and
``ig2g.vae_decode`` around the decode.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..utils import trace
from .ops import (DDIMSchedule, cfg_combine, cfg_combine_rendered,
                  noise_calibration, normalize_latent_noise)

CONST_SCALE = 0.18215


@dataclasses.dataclass
class IP2PParams:
    """Fork knobs (arguments/__init__.py:96-131 subset)."""
    guidance_scale: float = 12.5
    image_guidance_scale: float = 1.5
    diffusion_steps: int = 20
    lower_bound: float = 0.70
    upper_bound: float = 0.98
    noise_type: str = "None"
    noise_reg: str = "outlier"
    freeu_mode: str = "None"  # None|intermediate|intermediate-reverse|cfg|cfg-simple
    lambda_intermediate: float = 1.0
    is_freeu: bool = False
    freeu_s1: float = 0.9
    freeu_s2: float = 0.2
    freeu_b1: float = 1.2
    freeu_b2: float = 1.4
    noise_guidance_scale: float = 0.0
    noise_guidance_scale2: float = 0.0
    is_noise_calibration: bool = False
    noise_calibration_steps: int = 3
    noise_calibration_scale: float = 1.0
    noise_calibration_scale_is_low: bool = False


class Draws:
    """The editor's random draws, from one ``torch.Generator``."""

    def __init__(self, seed: int, device="cuda"):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)

    def timestep(self, lo: int, hi: int) -> int:
        """An integer uniform in [lo, hi]."""
        return int(torch.randint(lo, hi + 1, (1,), generator=self.gen,
                                 device=self.device))

    def normal(self, shape) -> torch.Tensor:
        """The diffusion's Gaussian noise."""
        return torch.randn(tuple(shape), generator=self.gen,
                           device=self.device)

    def posterior(self, shape) -> torch.Tensor:
        """The standard normal draw of the VAE posterior's sample."""
        return self.normal(shape)


class StubBackend:
    """Latent space = pixel space; the ε-predictor pulls toward
    image_cond."""

    def encode(self, img, draws=None):
        return img * 2.0 - 1.0

    def encode_mode(self, img):
        return img * 2.0 - 1.0

    def decode(self, lat):
        return torch.clamp((lat + 1.0) / 2.0, 0.0, 1.0)

    def make_eps_predictor(self, schedule, image_cond_latents,
                           text_embeddings):
        cond = image_cond_latents[0]

        def predict(latents, t):
            a = schedule.alphas_cumprod[int(t)]
            # the exact ε for x0 = cond
            eps = (latents - torch.sqrt(a) * cond) / torch.sqrt(1.0 - a)
            return eps, eps, eps     # text / image / uncond
        return predict

    def make_fused_predictor(self, schedule, image_cond_latents,
                             text_embeddings, lam):
        """The fused-skip analogue: λ-blend the two ε estimates."""
        predict = self.make_eps_predictor(schedule, image_cond_latents,
                                          text_embeddings)

        def predict_fused(latents_backbone, latents_skips, t):
            e1 = predict(latents_backbone, t)
            e2 = predict(latents_skips, t)
            return tuple(a * (1.0 - lam) + b * lam for a, b in zip(e1, e2))
        return predict_fused


class TorchSDBackend:
    """The SD-1.5 InstructPix2Pix UNet and VAE of this package. ``unet``
    and ``vae`` may be passed (tests pass tiny random modules); otherwise
    they load from ``weights_root`` / ``$GS2D_SD_WEIGHTS`` on ``device``.
    The VAE conventions of the reference wrapper (ip2p.py:403-504):
    posterior sample for the edited image, the mode for conditioning, the
    0.18215 scale applied by the caller and undone in ``decode``."""

    def __init__(self, weights_root: Optional[str] = None, unet_cfg=None,
                 vae_cfg=None, unet=None, vae=None, freeu=None,
                 device="cuda"):
        from .sdnet import SD15_IP2P_UNET
        from .vae import SD15_VAE
        self.device = torch.device(device)
        # the snapshot the weights came from (None when both were passed);
        # the CLI reads the prompt's tokenizer and text tower there too
        self.root = None
        if unet is None or vae is None:
            from . import sd_weights
            root = self.root = sd_weights.weights_root(weights_root)
            if root is None:
                raise FileNotFoundError(
                    "no SD weights: set $GS2D_SD_WEIGHTS to a diffusers "
                    "snapshot of timbrooks/instruct-pix2pix, or pass "
                    "unet/vae explicitly")
            unet = unet or sd_weights.load_unet(
                root, unet_cfg or SD15_IP2P_UNET, device=self.device)
            vae = vae or sd_weights.load_vae(root, vae_cfg or SD15_VAE,
                                             device=self.device)
        self.unet, self.vae, self.freeu = unet, vae, freeu
        self._finite = None      # every output checked since the last decode

    def _note(self, x: torch.Tensor) -> torch.Tensor:
        ok = torch.isfinite(x).all()
        self._finite = ok if self._finite is None else self._finite & ok
        return x

    def _moments(self, img):
        from .vae import vae_encode_moments
        with trace.span("ig2g.vae_encode"):
            mean, logvar = vae_encode_moments(self.vae, img * 2.0 - 1.0)
            self._note(mean)
            self._note(logvar)
        return mean, logvar

    @torch.no_grad()
    def encode(self, img, draws: Draws):
        """Posterior sample (the reference's imgs_to_latent), unscaled."""
        from .vae import vae_sample
        mean, logvar = self._moments(img)
        return vae_sample(mean, logvar, draws.posterior(mean.shape))

    @torch.no_grad()
    def encode_mode(self, img):
        """Posterior mode (the reference's prepare_image_latents)."""
        return self._moments(img)[0]

    @torch.no_grad()
    def decode(self, lat):
        """The image in [0, 1]; raises if an output of the UNet or the VAE
        since the last decode was not finite."""
        from .vae import SD_LATENT_SCALE, vae_decode
        with trace.span("ig2g.vae_decode"):
            img = self._note(vae_decode(self.vae, lat / SD_LATENT_SCALE))
        ok, self._finite = self._finite, None
        trace.count("sync")
        if not bool(ok):
            raise FloatingPointError(
                "an output of the UNet or the VAE in this edit is not "
                "finite")
        return torch.clamp(img / 2.0 + 0.5, 0.0, 1.0)

    def _unet(self, fn, *args, **kw):
        with trace.span("ig2g.unet"):
            trace.count("ig2g.unet_call")
            out = fn(self.unet, *args, **kw)
            if torch.is_tensor(out):
                out = self._note(out.float())
        return out

    def make_eps_predictor(self, schedule, image_cond_latents,
                           text_embeddings):
        from .sdnet import unet_apply
        cond3 = image_cond_latents

        @torch.no_grad()
        def predict(latents, t):
            x = torch.cat([torch.cat([latents] * 3, dim=0), cond3], dim=1)
            eps = self._unet(unet_apply, x, int(t), text_embeddings,
                             freeu=self.freeu)
            return eps[0:1], eps[1:2], eps[2:3]
        return predict

    def make_fused_predictor(self, schedule, image_cond_latents,
                             text_embeddings, lam):
        """The fork's forward_intermediate + forward_fused pair: skips
        from one pass, backbone from the other, blended
        res1·(1−λ) + res2·λ."""
        from .sdnet import unet_apply_fused, unet_apply_intermediate
        cond3 = image_cond_latents

        @torch.no_grad()
        def predict_fused(latents_backbone, latents_skips, t):
            xs = torch.cat([torch.cat([latents_skips] * 3, dim=0), cond3],
                           dim=1)
            skips2 = self._unet(unet_apply_intermediate, xs, int(t),
                                text_embeddings)
            xb = torch.cat([torch.cat([latents_backbone] * 3, dim=0), cond3],
                           dim=1)
            eps = self._unet(unet_apply_fused, xb, skips2, float(lam),
                             int(t), text_embeddings, freeu=self.freeu)
            return eps[0:1], eps[1:2], eps[2:3]
        return predict_fused


class InstructPix2Pix:
    def __init__(self, params: IP2PParams, backend="stub", seed: int = 0,
                 device="cuda"):
        self.p = params
        self.device = torch.device(device)
        self.schedule = DDIMSchedule(device=self.device)
        if backend == "stub":
            self.backend = StubBackend()
        elif backend == "torch":
            freeu = None
            if params.is_freeu:
                from .sdnet import FreeUParams
                freeu = FreeUParams(s1=params.freeu_s1, s2=params.freeu_s2,
                                    b1=params.freeu_b1, b2=params.freeu_b2)
            self.backend = TorchSDBackend(freeu=freeu, device=self.device)
        elif isinstance(backend, str):
            raise ValueError(
                f"unknown editor backend {backend!r}: expected 'stub', "
                "'torch', or a pre-built backend object")
        else:
            self.backend = backend
        self.draws = Draws(seed, self.device)
        self.num_train_timesteps = 1000

    @torch.no_grad()
    def edit_image(self, text_embeddings, image: torch.Tensor,
                   image_cond: torch.Tensor,
                   rendered_noise: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
        """image / image_cond / rendered_noise: (1, 3, H, W) in [0, 1],
        on the editor's device."""
        for name, x in (("image", image), ("image_cond", image_cond),
                        ("rendered_noise", rendered_noise)):
            if x is not None and x.device.type != self.device.type:
                raise ValueError(f"edit_image on {self.device}: {name} is "
                                 f"on {x.device}")
        p, be, draws = self.p, self.backend, self.draws
        min_step = int(self.num_train_timesteps * p.lower_bound)
        max_step = int(self.num_train_timesteps * p.upper_bound)
        T = draws.timestep(min_step, max_step)
        self.schedule.set_timesteps(p.diffusion_steps,
                                    effective_train_timesteps=T)
        t0 = int(self.schedule.timesteps[0])

        latents_0 = be.encode(image, draws)
        if not isinstance(be, StubBackend):
            latents_0 = latents_0 * CONST_SCALE
        cond_lat = be.encode_mode(image_cond)
        image_cond_latents = torch.cat(
            [cond_lat, cond_lat, torch.zeros_like(cond_lat)], dim=0)

        latents_rendered = None
        if p.noise_type == "None" or "concat" in p.noise_type:
            noise = draws.normal(latents_0.shape)
            if "concat" in p.noise_type and rendered_noise is not None:
                image_cond_latents = image_cond_latents.clone()
                image_cond_latents[1] = be.encode_mode(rendered_noise)[0]
        else:
            noise = rendered_noise
            if "encoded" in p.noise_type:
                noise_r = be.encode_mode(rendered_noise)
                if "encoded-normalized" in p.noise_type:
                    noise_r = normalize_latent_noise(
                        noise_r,
                        use_outlier_clipping="outlier" in p.noise_reg,
                        use_scaling="scaling" in p.noise_reg)
                if p.freeu_mode in ("intermediate", "intermediate-reverse",
                                    "cfg", "cfg-simple"):
                    noise = draws.normal(latents_0.shape)
                    latents_rendered = self.schedule.add_noise(
                        latents_0, noise_r, t0)
                else:
                    noise = noise_r

        latents = self.schedule.add_noise(latents_0, noise, t0)
        predict = be.make_eps_predictor(self.schedule, image_cond_latents,
                                        text_embeddings)

        if p.is_noise_calibration:
            latents, _ = noise_calibration(
                latents_0, cond_lat[0:1], noise, self.schedule, t0,
                lambda x, t: predict(x, t)[1], p.noise_calibration_scale,
                p.noise_calibration_scale_is_low, p.noise_calibration_steps)

        fused = None
        if p.freeu_mode in ("intermediate", "intermediate-reverse") \
                and latents_rendered is not None:
            fused = be.make_fused_predictor(
                self.schedule, image_cond_latents, text_embeddings,
                p.lambda_intermediate)

        for t in self.schedule.timesteps:
            t = int(t)
            if fused is not None:
                # "intermediate": backbone = the Gaussian-noised latents,
                # skips = the rendered-noise latents; "-reverse" swaps
                # them (ip2p.py:321-343; latents_rendered stays fixed)
                if p.freeu_mode == "intermediate":
                    e_text, e_image, e_uncond = fused(
                        latents, latents_rendered, t)
                else:
                    e_text, e_image, e_uncond = fused(
                        latents_rendered, latents, t)
                eps = cfg_combine(e_text, e_image, e_uncond,
                                  p.guidance_scale, p.image_guidance_scale)
                latents = self.schedule.step(eps, t, latents)
                continue
            e_text, e_image, e_uncond = predict(latents, t)
            if p.freeu_mode in ("cfg", "cfg-simple") \
                    and latents_rendered is not None:
                r_text, r_image, r_uncond = predict(latents_rendered, t)
                eps = cfg_combine_rendered(
                    e_text, e_image, e_uncond, r_text, r_image, r_uncond,
                    p.guidance_scale, p.image_guidance_scale,
                    p.noise_guidance_scale, p.noise_guidance_scale2,
                    mode=p.freeu_mode)
            else:
                eps = cfg_combine(e_text, e_image, e_uncond,
                                  p.guidance_scale, p.image_guidance_scale)
            latents = self.schedule.step(eps, t, latents)

        return be.decode(latents)
