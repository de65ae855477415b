"""The IG2G editor's configuration.

Counterpart of ``gs2d_tpu/ig2g/pipeline.py`` (the reference's
nerfstudio-style ``InstructGaussian2GaussianPipelineConfig``,
ig2g_pipeline.py:28-193), cut to what ``build_editor`` reads: the editor's
parameters and its backend. The editor's knobs live in ``IP2PParams``
alone, so each has one value and one default. The JAX configuration's
dataset, prompt, Iterative Dataset Update schedule, saving and CLIP-metric
fields have no reader in this package; ``cli/train_ig2g.py`` takes them as
flags and builds its editor directly.
"""

from __future__ import annotations

import dataclasses

from .ip2p import InstructPix2Pix, IP2PParams


@dataclasses.dataclass
class IG2GPipelineConfig:
    ip2p: IP2PParams = dataclasses.field(default_factory=IP2PParams)
    # "stub" runs the editing loop without SD weights; "torch" is the
    # SD-1.5 InstructPix2Pix of this package ($GS2D_SD_WEIGHTS)
    editor: str = "stub"


def build_editor(cfg: IG2GPipelineConfig, seed: int = 0,
                 device="cuda") -> InstructPix2Pix:
    """The configured editor on ``device``, its draws seeded from
    ``seed``."""
    return InstructPix2Pix(cfg.ip2p, backend=cfg.editor, seed=seed,
                           device=device)
