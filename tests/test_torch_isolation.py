"""The port stands alone: no JAX, no gs2d_tpu, no silent CPU fallback."""

import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "gs2d_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax_and_no_gs2d_tpu():
    assert len(PORT_FILES) > 10
    bad = [(str(p.relative_to(ROOT)), m) for p in PORT_FILES
           for m in _imported_modules(p)
           if m.split(".")[0] in ("jax", "jaxlib", "gs2d_tpu")]
    assert bad == []


def _run(code, **env):
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, **env})
    assert res.returncode == 0, res.stderr
    return res.stdout


def test_renderer_imports_with_jax_blocked():
    out = _run("import sys\n"
               "sys.modules['jax'] = None\n"
               "sys.modules['gs2d_tpu'] = None\n"
               "import gs2d_torch.render.renderer, gs2d_torch.models.io\n"
               "import gs2d_torch.train.step, gs2d_torch.train.loop\n"
               "import gs2d_torch.ops.gather, gs2d_torch.ops.knn\n"
               "import gs2d_torch.models.densify, gs2d_torch.config\n"
               "import gs2d_torch.scene.colmap, gs2d_torch.scene.dataset\n"
               "import gs2d_torch.scene.images, gs2d_torch.scene.scene\n"
               "import gs2d_torch.ops.tsdf, gs2d_torch.ops.marching\n"
               "import gs2d_torch.render.extract\n"
               "import gs2d_torch.utils.render_paths\n"
               "import gs2d_torch.utils.synthetic_scene\n"
               "import gs2d_torch.cli.train, gs2d_torch.cli.render\n"
               "import gs2d_torch.cli.metrics, gs2d_torch.cli.bench\n"
               "import gs2d_torch.utils.bench_scenes\n"
               "print(sorted(m for m in sys.modules "
               "if m.startswith(('jax', 'gs2d_tpu'))))\n")
    assert out.strip() == "['gs2d_tpu', 'jax']"   # only the blocked stubs


def test_render_without_a_card_raises():
    """With no card, the default device is still CUDA: building the camera
    or rendering CPU tensors without device="cpu" raises."""
    out = _run(
        "import numpy as np, torch\n"
        "from gs2d_torch.scene.cameras import make_camera\n"
        "from gs2d_torch.models.gaussians import state_from_numpy\n"
        "from gs2d_torch.render.renderer import render\n"
        "assert not torch.cuda.is_available()\n"
        "try:\n"
        "    make_camera(np.eye(3), np.zeros(3), 1.0, 0.6, 64, 32)\n"
        "    print('camera built')\n"
        "except (RuntimeError, AssertionError) as e:\n"
        "    print('camera raised')\n"
        "cam = make_camera(np.eye(3), np.array([0, 0, 4.0]), 1.0, 0.6, 64, "
        "32, device='cpu')\n"
        "n = 4\n"
        "st = state_from_numpy(np.zeros((n, 3)), np.zeros((n, 1, 3)), "
        "np.zeros((n, 15, 3)), np.zeros((n, 2)), np.ones((n, 4)), "
        "np.zeros((n, 1)), np.ones(n, bool), 3, device='cpu')\n"
        "try:\n"
        "    render(cam, st, torch.zeros(3))\n"
        "    print('rendered')\n"
        "except ValueError:\n"
        "    print('render raised')\n"
        "print(render(cam, st, torch.zeros(3), device='cpu')['render'].shape)\n",
        CUDA_VISIBLE_DEVICES="")
    assert out.split("\n")[:3] == ["camera raised", "render raised",
                                   "torch.Size([3, 32, 64])"]


def test_cli_without_a_card_raises(tmp_path):
    """With no card, the train and render CLIs' default device is still
    CUDA: without --device cpu they raise before loading anything, and
    neither trains nor renders on the CPU."""
    out = _run(
        "import sys, torch\n"
        "import gs2d_torch.train.loop as loop\n"
        "import gs2d_torch.scene.scene as scene\n"
        "from gs2d_torch.cli import render, train\n"
        "assert not torch.cuda.is_available()\n"
        "def never(*a, **k):\n"
        "    raise AssertionError('ran on the CPU')\n"
        "loop.train = never\n"
        "scene.Scene = never\n"
        f"model = {str(tmp_path / 'model')!r}\n"
        "for cli, argv in ((train, ['-s', 'data', '-m', model]),\n"
        "                  (render, ['-m', model])):\n"
        "    try:\n"
        "        cli.main(argv)\n"
        "        print('ran')\n"
        "    except RuntimeError as e:\n"
        "        print('raised', 'CUDA' in str(e))\n",
        CUDA_VISIBLE_DEVICES="")
    assert out.split("\n")[:2] == ["raised True", "raised True"]
    assert not (tmp_path / "model").exists()
