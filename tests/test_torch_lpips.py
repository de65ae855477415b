"""The port's LPIPS (gs2d_torch/eval/lpips.py) and the metrics CLI's LPIPS
against the JAX package's, on the CPU.

Weights: small random tensors in the torchvision/lpips state-dict layouts
(``tests/test_lpips.py::_random_state_dicts``, VGG16's topology at 1/8 of
its channels), converted by ``scripts/convert_lpips_weights.py`` into the
one npz both packages read. The bar is ``tests/test_lpips.py:98``'s: rel
1e-4 / abs 1e-6; identical images give 0 within 1e-8.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from gs2d_torch.cli import metrics as t_metrics
from gs2d_torch.eval.lpips import LPIPS as TLPIPS
from gs2d_torch.scene.images import encode_png
from gs2d_tpu.eval.lpips import LPIPS as JLPIPS

from .test_lpips import _random_state_dicts
from .test_torch_common import one_torch_thread  # noqa: F401

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))

from convert_lpips_weights import convert_state_dicts  # noqa: E402


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    path = tmp_path_factory.mktemp("lpips") / "lpips_small.npz"
    np.savez(path, **convert_state_dicts(*_random_state_dicts(seed=3)))
    return str(path)


def _pair(h, w, seed, noise=0.1):
    rng = np.random.default_rng(seed)
    x = rng.random((3, h, w), dtype=np.float32)
    y = np.clip(x + noise * rng.standard_normal((3, h, w)).astype(
        np.float32), 0, 1)
    return x, y


@pytest.mark.parametrize("size", [(64, 96), (61, 93), (40, 40)])
def test_lpips_matches_jax(npz, size):
    x, y = _pair(*size, seed=sum(size))
    port = TLPIPS(npz, device="cpu")
    ref = float(JLPIPS(npz)(x, y))
    got = float(port(torch.from_numpy(x), torch.from_numpy(y)))
    assert ref > 0
    assert got == pytest.approx(ref, rel=1e-4, abs=1e-6)
    assert float(port(torch.from_numpy(x), torch.from_numpy(x))) == \
        pytest.approx(0.0, abs=1e-8)


def test_lpips_leaves_the_tf32_flag_as_it_was(npz):
    port = TLPIPS(npz, device="cpu")
    x, y = (torch.from_numpy(a) for a in _pair(32, 32, 0))
    before = torch.backends.cudnn.allow_tf32
    try:
        for flag in (True, False):
            torch.backends.cudnn.allow_tf32 = flag
            port(x, y)
            assert torch.backends.cudnn.allow_tf32 is flag
    finally:
        torch.backends.cudnn.allow_tf32 = before


def test_lpips_unavailable_without_weights(monkeypatch, tmp_path):
    monkeypatch.delenv("GS2D_LPIPS_WEIGHTS", raising=False)
    for model in (TLPIPS(device="cpu"),
                  TLPIPS(str(tmp_path / "missing.npz"), device="cpu")):
        assert not model.available()
        with pytest.raises(RuntimeError):
            model(torch.zeros(3, 8, 8), torch.zeros(3, 8, 8))


def _model_dir(root):
    """<root>/test/ours_7/{renders,gt}: three seeded 48x40 views."""
    for sub in ("renders", "gt"):
        os.makedirs(root / "test" / "ours_7" / sub)
    for i in range(3):
        x, y = _pair(40, 48, seed=10 + i, noise=0.2)
        for sub, a in (("renders", x), ("gt", y)):
            encode_png(str(root / "test" / "ours_7" / sub / f"{i:05d}.png"),
                       (a.transpose(1, 2, 0) * 255).astype(np.uint8))


@pytest.mark.parametrize("weights", [True, False], ids=["npz", "none"])
def test_metrics_cli_writes_lpips(npz, tmp_path, monkeypatch, weights):
    """With GS2D_LPIPS_WEIGHTS set, cli.metrics writes per-view and mean
    LPIPS equal to the JAX metrics.py's within the bar; without, null."""
    import metrics as j_metrics          # the JAX package's metrics.py
    if weights:
        monkeypatch.setenv("GS2D_LPIPS_WEIGHTS", npz)
    else:
        monkeypatch.delenv("GS2D_LPIPS_WEIGHTS", raising=False)
    _model_dir(tmp_path / "t")
    _model_dir(tmp_path / "j")
    t_metrics.main(["-m", str(tmp_path / "t"), "--device", "cpu"])
    j_metrics.evaluate([str(tmp_path / "j")])
    got = json.loads((tmp_path / "t" / "results.json").read_text())
    ref = json.loads((tmp_path / "j" / "results.json").read_text())
    gv = json.loads((tmp_path / "t" / "per_view.json").read_text())
    rv = json.loads((tmp_path / "j" / "per_view.json").read_text())
    if not weights:
        assert got["ours_7"]["LPIPS"] is None is ref["ours_7"]["LPIPS"]
        assert set(gv["ours_7"]["LPIPS"].values()) == {None}
        return
    assert got["ours_7"]["LPIPS"] > 0
    assert got["ours_7"]["LPIPS"] == pytest.approx(ref["ours_7"]["LPIPS"],
                                                   rel=1e-4, abs=1e-6)
    assert gv["ours_7"]["LPIPS"].keys() == rv["ours_7"]["LPIPS"].keys()
    for k, v in gv["ours_7"]["LPIPS"].items():
        assert v == pytest.approx(rv["ours_7"]["LPIPS"][k], rel=1e-4,
                                  abs=1e-6)
