"""The port stands alone: no JAX, no gs2d_tpu, no silent CPU fallback."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

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


def test_port_imports_no_transformers_pil_or_cv2():
    """The card's machine has none of them: no file of the port and not
    chip_smoke.py imports them (matplotlib only where a plot is asked
    for, behind an ImportError)."""
    bad = [(str(p.relative_to(ROOT)), m) for p in PORT_FILES
           for m in _imported_modules(p)
           if m.split(".")[0] in ("transformers", "PIL", "cv2",
                                  "safetensors", "diffusers")]
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
               "import gs2d_torch.cli.bench_scale\n"
               "import gs2d_torch.utils.bench_scenes\n"
               "import gs2d_torch.scene.jpeg, gs2d_torch.eval.lpips\n"
               "import gs2d_torch.eval.geometry, gs2d_torch.eval.dtu\n"
               "import gs2d_torch.eval.tnt, gs2d_torch.cli.m360_eval\n"
               "import gs2d_torch.cli.dtu_eval, gs2d_torch.cli.tnt_eval\n"
               "import gs2d_torch.cli.train_ig2g, gs2d_torch.ig2g.pipeline\n"
               "import gs2d_torch.ig2g.sd_weights\n"
               "import gs2d_torch.parallel.multihost\n"
               "import gs2d_torch.parallel.data_parallel\n"
               "import gs2d_torch.parallel.gaussian_parallel\n"
               "import gs2d_torch.render.network_gui, gs2d_torch.cli.view\n"
               "print(sorted(m for m in sys.modules "
               "if m.startswith(('jax', 'gs2d_tpu'))))\n")
    assert out.strip() == "['gs2d_tpu', 'jax']"   # only the blocked stubs


def test_eval_slice_runs_without_pil_cv2_and_matplotlib(tmp_path):
    """The card's machine has none of PIL, OpenCV and matplotlib: with all
    three blocked, a JPEG decodes (C entropy decoder, pixel stages on the
    CPU), the DTU dilation and mask read and the TnT crop run, and the
    plot step says it was not drawn."""
    from PIL import Image
    jpg, png = tmp_path / "a.JPG", tmp_path / "m.png"
    Image.fromarray(np.full((9, 11, 3), 200, np.uint8)).save(jpg)
    Image.fromarray(np.full((9, 11, 3), 255, np.uint8)).save(png)
    out = _run("import sys\n"
               "for m in ('PIL', 'cv2', 'matplotlib', 'jax', 'gs2d_tpu'):\n"
               "    sys.modules[m] = None\n"
               "import numpy as np\n"
               "from gs2d_torch.scene.images import decode_image\n"
               "from gs2d_torch.eval import dtu, tnt\n"
               f"img = decode_image({str(jpg)!r}, 'cpu')\n"
               f"m = dtu.read_mask_gray({str(png)!r})\n"
               "d = dtu.dilate(m > 0, dtu.ellipse_footprint(5, 5), 'cpu')\n"
               "inside = tnt.points_in_polygon(np.zeros((1, 2)), np.array("
               "[[-1.0, -1], [1, -1], [0, 1]]))\n"
               "tnt._plot_graph('s', 0.5, 0.1, None, None, None, None, 5, "
               "'.')\n"
               "print(img.shape, m.shape, bool(d.all()), bool(inside[0]))\n")
    lines = out.strip().split("\n")
    assert "plot was not drawn" in lines[0]
    assert lines[1] == "(9, 11, 3) (9, 11) True True"


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
        "from gs2d_torch.cli import train_ig2g\n"
        "for cli, argv in ((train, ['-s', 'data', '-m', model]),\n"
        "                  (render, ['-m', model]),\n"
        "                  (train_ig2g, ['-s', 'data', '-m', model])):\n"
        "    try:\n"
        "        cli.main(argv)\n"
        "        print('ran')\n"
        "    except RuntimeError as e:\n"
        "        print('raised', 'CUDA' in str(e))\n",
        CUDA_VISIBLE_DEVICES="")
    assert out.split("\n")[:3] == ["raised True"] * 3
    assert not (tmp_path / "model").exists()


IG2G_FILES = sorted((ROOT / "gs2d_torch" / "ig2g").rglob("*.py")) + [
    ROOT / "gs2d_torch" / "utils" / "safetensors.py",
    ROOT / "gs2d_torch" / "cli" / "train_ig2g.py"]
NOT_ON_THE_CARD = ("transformers", "safetensors", "diffusers", "PIL", "cv2",
                   "regex", "ftfy")


def test_ig2g_imports_nothing_the_cards_machine_lacks():
    assert len(IG2G_FILES) == 15
    bad = [(str(p.relative_to(ROOT)), m) for p in IG2G_FILES
           for m in _imported_modules(p)
           if m.split(".")[0] in NOT_ON_THE_CARD]
    assert bad == []


def test_ig2g_runs_with_those_libraries_blocked(tmp_path):
    """With every library of NOT_ON_THE_CARD (and JAX) blocked: a
    safetensors file round-trips, a synthetic tokenizer encodes, the SD
    backend loads a tiny snapshot and edits, and the editor without a card
    raises unless the CPU is asked for."""
    blocked = list(NOT_ON_THE_CARD) + ["jax", "gs2d_tpu"]
    out = _run(
        f"import sys\nfor m in {blocked!r}:\n    sys.modules[m] = None\n"
        "import os, torch\n"
        "from gs2d_torch.utils import safetensors as st\n"
        "from gs2d_torch.ig2g import sdnet, vae, sd_weights, ip2p\n"
        "from gs2d_torch.ig2g.tokenizer import (CLIPTokenizer,\n"
        "    write_synthetic_tokenizer)\n"
        f"root = {str(tmp_path)!r}\n"
        "g = torch.Generator().manual_seed(0)\n"
        "for sub, spec in (('unet', sdnet.unet_param_shapes(sdnet.TINY_UNET)),\n"
        "                  ('vae', vae.vae_param_shapes(vae.TINY_VAE))):\n"
        "    os.makedirs(os.path.join(root, sub))\n"
        "    p = sdnet.init_params(spec, g, device='cpu', dtype=torch.float16)\n"
        "    st.save_file(p, os.path.join(root, sub,\n"
        "                 'diffusion_pytorch_model.safetensors'))\n"
        "write_synthetic_tokenizer(os.path.join(root, 'tokenizer'), ['snow'])\n"
        "tok = CLIPTokenizer.from_snapshot(os.path.join(root, 'tokenizer'))\n"
        "print(tok(['snow'])[0][:3])\n"
        "be = ip2p.TorchSDBackend(root, sdnet.TINY_UNET, vae.TINY_VAE,\n"
        "                         device='cpu')\n"
        "ed = ip2p.InstructPix2Pix(ip2p.IP2PParams(diffusion_steps=2),\n"
        "                          backend=be, device='cpu')\n"
        "img = torch.rand(1, 3, 24, 16, generator=g)\n"
        "out = ed.edit_image(torch.zeros(3, 5, 16), img, img, img)\n"
        "print(tuple(out.shape), bool(torch.isfinite(out).all()))\n"
        "try:\n"
        "    ip2p.InstructPix2Pix(ip2p.IP2PParams())\n"
        "    print('built on the CPU')\n"
        "except (RuntimeError, AssertionError):\n"
        "    print('raised')\n",
        CUDA_VISIBLE_DEVICES="")
    vocab = 256 * 2 + 3
    assert out.split("\n")[:3] == [f"[{vocab}, {vocab - 1}, {vocab + 1}]",
                                    "(1, 3, 24, 16) True", "raised"]


PARALLEL_FILES = sorted((ROOT / "gs2d_torch" / "parallel").rglob("*.py")) + [
    ROOT / "gs2d_torch" / "render" / "network_gui.py",
    ROOT / "gs2d_torch" / "cli" / "view.py",
    ROOT / "tests" / "test_torch_dist_common.py"]


def test_parallel_and_viewer_import_nothing_the_cards_machine_lacks():
    """The multi-GPU modules, the viewer and the module the test ranks
    run import neither JAX nor matplotlib, cv2 or PIL."""
    assert len(PARALLEL_FILES) == 7
    bad = [(str(p.relative_to(ROOT)), m) for p in PARALLEL_FILES
           for m in _imported_modules(p)
           if m.split(".")[0] in ("jax", "jaxlib", "gs2d_tpu", "matplotlib",
                                  "cv2", "PIL")]
    assert bad == []


def test_test_ranks_hold_no_jax():
    """The children of the multi-process tests (2 gloo ranks rendering
    their bands and running the backward) hold no JAX or gs2d_tpu module:
    ``results`` fails otherwise, for every multi-process test."""
    from .test_torch_dist_common import band_worker, start_ranks
    from .utils import random_cloud
    (img0, g0), (img1, g1) = start_ranks(band_worker, 2,
                                         random_cloud(100, 1)).results()
    assert img0 == img1 and np.isfinite([g0, g1]).all()


LAST_SLICE_MODULES = (
    "gs2d_torch.ig2g.clip_model", "gs2d_torch.ig2g.clip_image",
    "gs2d_torch.ig2g.metrics", "gs2d_torch.ig2g.analysis",
    "gs2d_torch.cli.convert", "gs2d_torch.cli.render_all",
    "gs2d_torch.cli.run_all", "gs2d_torch.cli.batch",
    "gs2d_torch.cli.make_synthetic_scene",
    "gs2d_torch.cli.quality_readout")


def test_last_slice_runs_with_jax_transformers_and_pil_blocked(tmp_path):
    """The CLIP metrics, the analysis, the JPEG encoder and the user
    scripts import with JAX, gs2d_tpu, transformers, PIL, cv2 and
    matplotlib blocked; a seeded tiny CLIP snapshot scores an image and a
    JPEG written by the encoder decodes again."""
    blocked = ["jax", "gs2d_tpu", "transformers", "PIL", "cv2",
               "matplotlib", "safetensors"]
    out = _run(
        f"import sys\nfor m in {blocked!r}:\n    sys.modules[m] = None\n"
        "import importlib, numpy as np, torch\n"
        f"for m in {LAST_SLICE_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "from gs2d_torch.ig2g import analysis, clip_model\n"
        "from gs2d_torch.ig2g.metrics import ClipMetrics\n"
        "from gs2d_torch.scene.images import decode_image\n"
        "from gs2d_torch.scene.jpeg import encode_jpeg\n"
        f"root = {str(tmp_path / 'clip')!r}\n"
        "clip_model.write_random_snapshot(root, clip_model.TINY,\n"
        "    torch.Generator().manual_seed(0), ['snow'], device='cpu')\n"
        "img = np.random.default_rng(0).random((3, 30, 50))\n"
        "img = img.astype(np.float32)\n"
        "m = ClipMetrics(root, device='cpu')\n"
        "print(np.isfinite(m.clip_score(img, 'snow')))\n"
        "print(analysis.radial_spectrum(img, device='cpu').shape)\n"
        "print(analysis.plot_spectra([img], ['a'], 'x.png'))\n"
        f"path = {str(tmp_path / 'a.jpg')!r}\n"
        "encode_jpeg(path, (img.transpose(1, 2, 0) * 255).astype(np.uint8))\n"
        "print(decode_image(path, 'cpu').shape)\n",
        CUDA_VISIBLE_DEVICES="")
    assert out.split("\n")[:4] == ["True", "torch.Size([64])", "False",
                                    "(30, 50, 3)"]
    assert not (ROOT / "x.png").exists()


def test_scale_bench_and_sharded_checkpoint_run_with_jax_blocked(tmp_path):
    """With JAX, gs2d_tpu and orbax blocked, the scale benchmark runs a
    tiny N on the CPU and a sharded checkpoint (torch.distributed.
    checkpoint, no orbax) round-trips in one process."""
    out = _run(
        "import sys\n"
        "for m in ('jax', 'gs2d_tpu', 'orbax'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np, torch\n"
        "from gs2d_torch.cli import bench_scale\n"
        "from gs2d_torch.models.gaussians import state_from_numpy\n"
        "from gs2d_torch.models.io import (load_checkpoint_sharded,\n"
        "    save_checkpoint_sharded)\n"
        "from gs2d_torch.train.optim import init_adam\n"
        "rec = bench_scale.bench_one(200, 32, 16, 1, torch.device('cpu'))\n"
        "print(rec['num_pairs'] > 0, rec['t_e2e_fwd_bwd_ms'] > 0)\n"
        "r = np.random.default_rng(0)\n"
        "st = state_from_numpy(r.random((5, 3)), r.random((5, 1, 3)),\n"
        "    r.random((5, 15, 3)), r.random((5, 2)), r.random((5, 4)),\n"
        "    r.random((5, 1)), np.ones(5, bool), 3, device='cpu')\n"
        f"path = {str(tmp_path / 'ck')!r}\n"
        "save_checkpoint_sharded(path, st, init_adam(st.params), 7)\n"
        "st2, opt2, it, _ = load_checkpoint_sharded(path, device='cpu')\n"
        "print(it, torch.equal(st2.params.xyz, st.params.xyz))\n",
        CUDA_VISIBLE_DEVICES="")
    assert out.split("\n")[:2] == ["True True", "7 True"]
