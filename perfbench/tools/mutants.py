"""Run a cell with one stage of the program broken, to show that the cell's
comparison catches it.

    python3 -m perfbench.tools.mutants <mutant> -- <perfbench.run's arguments>

The mutant replaces one function of the installed program for the
process, then hands the arguments to ``perfbench.run``; the result line
should read ``correct`` false, with the check named beside the mutant
over its limit. These reach the IG2G editor's stages between its
networks, which ``perfbench.run``'s own faults leave alone:

- ``swapped_guidance``: the text and image guidance scales trade places
  (``ddim_gap``);
- ``unnormalized_noise``: the encoded noise render is used without its
  per-channel standardisation (``init_gap``);
- ``noise_dropped``: the edit render's noise channels hold its colours
  (``noise_gap``);
- ``nearest_resize``: the edited image goes back to the render's size by
  nearest sampling (``resize_gap``).

Not part of a run: ``perfbench.run`` never imports it.
"""

from __future__ import annotations

import importlib
import sys


def _swapped_guidance(real):
    def cfg_combine(text, image, uncond, guidance, image_guidance):
        return real(text, image, uncond, image_guidance, guidance)
    return cfg_combine


def _unnormalized_noise(real):
    def normalize_latent_noise(noise, **kw):
        return noise
    return normalize_latent_noise


def _noise_dropped(real):
    def render(*a, **kw):
        pkg = real(*a, **kw)
        rgb = pkg["render"].clamp(0, 1)
        lo, hi = rgb.min(), rgb.max()
        return {**pkg, "rend_noise": (rgb - lo) / (hi - lo).clamp(min=1e-12)}
    return render


def _nearest_resize(real):
    def resize_bilinear(x, size):
        import torch.nn.functional as F
        return F.interpolate(x, size=tuple(int(s) for s in size),
                             mode="nearest")
    return resize_bilinear


# mutant → (module, function, the replacement made from the real one,
# the check that should catch it)
MUTANTS = {
    "swapped_guidance": ("gs2d_torch.ig2g.ip2p", "cfg_combine",
                         _swapped_guidance, "ddim_gap"),
    "unnormalized_noise": ("gs2d_torch.ig2g.ip2p", "normalize_latent_noise",
                           _unnormalized_noise, "init_gap"),
    "noise_dropped": ("gs2d_torch.train.loop", "render", _noise_dropped,
                      "noise_gap"),
    "nearest_resize": ("gs2d_torch.ig2g.ops", "resize_bilinear",
                       _nearest_resize, "resize_gap"),
}


def install(name: str):
    """Put the mutant in place → a function that takes it out again."""
    module, attr, make, _ = MUTANTS[name]
    mod = importlib.import_module(module)
    real = getattr(mod, attr)
    setattr(mod, attr, make(real))
    return lambda: setattr(mod, attr, real)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) < 2 or argv[0] not in MUTANTS or argv[1] != "--":
        print(__doc__, file=sys.stderr)
        return 2
    install(argv[0])
    from perfbench import run
    return run.main(argv[2:])


if __name__ == "__main__":
    sys.exit(main())
