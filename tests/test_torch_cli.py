"""The port's CLIs (gs2d_torch/cli) on the CPU, against the JAX package's.

A tiny Blender scene of the coloured torus (40x30, 6 train + 2 test RGBA
views, a 300-point seed cloud), written by gs2d_torch/utils/
synthetic_scene.py.

- Train CLI (``--device cpu``, 30 iterations through densify): it writes
  ``cfg_args.json`` (the JAX ``load_cfg_args`` reads it, and the port's
  reads the JAX writer's), PLYs (the JAX ``load_ply`` reads them) and a
  checkpoint that holds the run's state at its iteration; two runs
  resumed from it end bit-identical.
- Render CLI on a model directory the JAX ``train()`` wrote: the port's
  renders within 2e-4 of JAX's ``render`` before quantisation (the
  extractor's maps), its PNGs within 1/255 of the JAX ``render.py``'s,
  and its bounded mesh at ``--mesh_res 16`` the JAX one's: vertex and
  face counts within 1%, every vertex within 1e-3 of the other mesh.
- Metrics CLI: ``results.json`` and ``per_view.json`` equal to the JAX
  ``metrics.py``'s on the same directories within 1e-5.

TensorBoard is blocked so the CLI takes its no-TensorBoard path (where
TensorFlow is installed, importing it takes tens of seconds).
"""

import json
import math
import shutil
import sys

import numpy as np
import pytest
import torch
from PIL import Image
from scipy.spatial import cKDTree

from gs2d_torch import config as t_cfg
from gs2d_torch.cli import metrics as t_metrics
from gs2d_torch.cli import render as t_render_cli
from gs2d_torch.cli import train as t_train_cli
from gs2d_torch.models.io import load_checkpoint as t_load_checkpoint
from gs2d_torch.models.io import load_ply as t_load_ply
from gs2d_torch.utils import synthetic_scene as ss
from gs2d_tpu import config as j_cfg

from .test_torch_common import one_torch_thread  # noqa: F401

ITERS = 20


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("torus")
    surf = ss.torus_surfels(4000)
    ss.write_blender_scene(str(root), ss.SurfelRenderer(surf, device="cpu"),
                           40, 30, 6, 2,
                           seed_points=ss.seed_cloud(surf[0], surf[4], 300))
    return root


def _ply(model_dir, it):
    return str(model_dir / "point_cloud" / f"iteration_{it}"
               / "point_cloud.ply")


def test_train_cli_writes_reads_and_resumes(dataset, tmp_path):
    out = tmp_path / "out"
    common = ["-s", str(dataset), "--eval", "--iterations", "30",
              "--sh_degree", "1", "--densify_from_iter", "5",
              "--densification_interval", "10", "--device", "cpu",
              "--quiet"]
    res = t_train_cli.main(common + [
        "-m", str(out), "--test_iterations", "30", "--save_iterations",
        "15", "--checkpoint_iterations", "15"])
    assert math.isfinite(res["psnr"][30])
    assert [w["iterations"] for w in res["windows"]] == ["1-30"]

    # cfg_args.json both ways
    jm, jp, jo = j_cfg.load_cfg_args(str(out / "cfg_args.json"))
    assert (jm.source_path, jm.eval, jm.sh_degree, jo.iterations,
            jo.densify_from_iter) == (str(dataset), True, 1, 30, 5)
    j_cfg.save_cfg_args(str(tmp_path / "j.json"), jm, jp, jo)
    tm, tp, to = t_cfg.load_cfg_args(str(tmp_path / "j.json"))
    assert (vars(tm), vars(tp), vars(to)) == (vars(jm), vars(jp), vars(jo))

    # the PLYs read in the JAX package as in the port
    from gs2d_tpu.models.io import load_ply as j_load_ply
    for it in (15, 30):
        ts = t_load_ply(_ply(out, it), max_sh_degree=1, device="cpu")
        js = j_load_ply(_ply(out, it), capacity=64, max_sh_degree=1)
        act = np.asarray(js.active)
        assert int(act.sum()) == ts.params.xyz.shape[0]
        for f in ("xyz", "features_dc", "features_rest", "scaling",
                  "rotation", "opacity"):
            np.testing.assert_array_equal(
                np.asarray(getattr(js.params, f))[act],
                getattr(ts.params, f).numpy())

    # the checkpoint holds the state the PLY at 15 holds; resume twice
    ck = str(out / "chkpnt15.npz")
    state, _, it, _ = t_load_checkpoint(ck, device="cpu")
    ply15 = t_load_ply(_ply(out, 15), max_sh_degree=1, device="cpu")
    assert it == 15
    for f in ("xyz", "features_dc", "scaling", "rotation", "opacity"):
        assert torch.equal(getattr(state.params, f),
                           getattr(ply15.params, f))
    finals = []
    for run in ("r1", "r2"):
        t_train_cli.main(common + ["-m", str(tmp_path / run),
                                   "--start_checkpoint", ck,
                                   "--test_iterations", "0"])
        finals.append((tmp_path / run / "point_cloud" / "iteration_30"
                       / "point_cloud.ply").read_bytes())
    assert finals[0] == finals[1]


@pytest.fixture(scope="module")
def jax_model(dataset, tmp_path_factory):
    """A model directory written by the JAX package: cfg_args.json, then
    ITERS iterations of its train() (interpret mode)."""
    from gs2d_tpu.train.loop import train
    root = tmp_path_factory.mktemp("jax_model")
    model = j_cfg.ModelParams(sh_degree=1, source_path=str(dataset),
                              model_path=str(root), eval=True)
    opt = j_cfg.OptimizationParams(iterations=ITERS)
    pipe = j_cfg.PipelineParams()
    j_cfg.save_cfg_args(str(root / "cfg_args.json"), model, pipe, opt)
    train(model, opt, pipe,
          j_cfg.RuntimeParams(initial_capacity=512, pairs_capacity=1 << 13,
                              chunk=128, interpret=True, seed=0),
          test_iterations=[], save_iterations=[ITERS])
    return root


@pytest.fixture(scope="module")
def rendered(jax_model, tmp_path_factory, monkeypatch_module):
    """The port's render CLI and the JAX render.py on copies of the JAX
    model directory, at --mesh_res 16."""
    base = tmp_path_factory.mktemp("rendered")
    p_dir, j_dir = base / "port", base / "jax"
    shutil.copytree(jax_model, p_dir)
    shutil.copytree(jax_model, j_dir)
    p_res = t_render_cli.main(["-m", str(p_dir), "--mesh_res", "16",
                               "--device", "cpu"])
    import render as j_render_cli      # the JAX package's render.py
    monkeypatch_module.setattr(sys, "argv", [
        "render.py", "-m", str(j_dir), "--mesh_res", "16", "--interpret"])
    j_render_cli.main()
    return p_dir, j_dir, p_res


@pytest.fixture(scope="module")
def monkeypatch_module():
    with pytest.MonkeyPatch.context() as mp:
        yield mp


def test_render_cli_pngs_match_jax(rendered):
    p_dir, j_dir, res = rendered
    assert res["iteration"] == ITERS
    n = 0
    for split, views in (("train", 6), ("test", 2)):
        for sub in ("renders", "gt", "vis"):
            d = p_dir / split / f"ours_{ITERS}" / sub
            names = sorted(f.name for f in d.iterdir())
            assert names == sorted(
                f.name for f in (j_dir / split / f"ours_{ITERS}" / sub)
                .iterdir())
            assert len(names) == views * (2 if sub == "vis" else 1)
            for name in names:
                a = np.asarray(Image.open(d / name)).astype(int)
                b = np.asarray(Image.open(j_dir / split / f"ours_{ITERS}"
                                          / sub / name)).astype(int)
                tol = 0 if sub == "gt" else 1
                assert np.abs(a - b).max() <= tol, (split, sub, name)
                n += 1
    assert n == 32


def test_render_cli_maps_match_jax_render(jax_model):
    """The extractor's maps before quantisation, both packages, on the
    model the JAX train() wrote."""
    from gs2d_torch.render.extract import GaussianExtractor as TEx
    from gs2d_torch.scene.scene import Scene as TScene
    from gs2d_tpu.render.extract import GaussianExtractor as JEx
    from gs2d_tpu.scene.scene import Scene as JScene
    jm, jp, _ = j_cfg.load_cfg_args(str(jax_model / "cfg_args.json"))
    tm, tp, _ = t_cfg.load_cfg_args(str(jax_model / "cfg_args.json"))
    js = JScene(jm, load_iteration=-1, shuffle=False)
    ts = TScene(tm, load_iteration=-1, shuffle=False, device="cpu")
    jx = JEx(js.gaussians, max_sh_degree=1, depth_ratio=jp.depth_ratio,
             interpret=True)
    tx = TEx(ts.gaussians, max_sh_degree=1, depth_ratio=tp.depth_ratio,
             device="cpu")
    jx.reconstruction(js.get_test_cameras())
    tx.reconstruction(ts.get_test_cameras())
    for name in ("rgbmaps", "alphamaps", "normalmaps"):
        for a, b in zip(getattr(jx, name), getattr(tx, name)):
            np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=2e-4,
                                       err_msg=name)
    assert tx.radius == pytest.approx(jx.radius, rel=1e-6)


def test_render_cli_mesh_matches_jax(rendered):
    from gs2d_torch.scene.ply import read_mesh_ply
    p_dir, j_dir, res = rendered
    meshes = [read_mesh_ply(str(d / "train" / f"ours_{ITERS}" / name))
              for name in ("fuse.ply", "fuse_post.ply")
              for d in (p_dir, j_dir)]
    for (vp, fp, cp), (vj, fj, cj) in (meshes[0:2], meshes[2:4]):
        assert len(fj) > 100
        assert abs(len(vp) - len(vj)) <= 0.01 * len(vj)
        assert abs(len(fp) - len(fj)) <= 0.01 * len(fj)
        assert cKDTree(vj).query(vp)[0].max() < 1e-3
        assert cKDTree(vp).query(vj)[0].max() < 1e-3
    assert res["verts"] == len(meshes[0][0])


def test_metrics_cli_matches_jax(rendered, tmp_path):
    import metrics as j_metrics          # the JAX package's metrics.py
    p_dir, _, _ = rendered
    j_copy = tmp_path / "jax_scores"
    shutil.copytree(p_dir / "test", j_copy / "test")
    t_metrics.main(["-m", str(p_dir), "--device", "cpu"])
    j_metrics.evaluate([str(j_copy)])
    for name in ("results.json", "per_view.json"):
        a = json.loads((p_dir / name).read_text())
        b = json.loads((j_copy / name).read_text())
        assert a.keys() == b.keys() == {f"ours_{ITERS}"}

        def flat(d, pre=""):
            for k, v in d.items():
                if isinstance(v, dict):
                    yield from flat(v, pre + k + "/")
                else:
                    yield pre + k, v
        fa, fb = dict(flat(a)), dict(flat(b))
        assert fa.keys() == fb.keys()
        for k in fa:
            if fb[k] is None:
                assert fa[k] is None, k
            else:
                assert fa[k] == pytest.approx(fb[k], abs=1e-5), k


def test_metrics_cli_isolates_a_broken_scene(rendered, tmp_path, capsys):
    """A scene that fails is reported and the next still gets scored."""
    p_dir, _, _ = rendered
    broken = tmp_path / "broken"
    (broken / "test" / "ours_1" / "renders").mkdir(parents=True)
    (broken / "test" / "ours_1" / "renders" / "00000.png").write_bytes(
        b"not a png")
    good = tmp_path / "good"
    shutil.copytree(p_dir / "test", good / "test")
    t_metrics.main(["-m", str(broken), str(good), "--device", "cpu"])
    assert "Unable to compute metrics for" in capsys.readouterr().out
    assert not (broken / "results.json").exists()
    assert (good / "results.json").exists()
