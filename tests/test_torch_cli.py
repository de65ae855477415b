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

- The eval harnesses (``m360_eval``, ``dtu_eval``, ``tnt_eval``) on a tiny
  COLMAP scene of the torus, 10 iterations each: the M360 one on JPEGs
  named .JPG with LPIPS from random weights, the DTU and TnT ones scoring
  equal (1e-9 relative) to the JAX ``evaluate_scan`` and
  ``run_tnt_evaluation`` on the same mesh and data.

TensorBoard is blocked so the CLI takes its no-TensorBoard path (where
TensorFlow is installed, importing it takes tens of seconds).
"""

import json
import math
import shutil
import sys
from pathlib import Path

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
              "--quiet", "--no_viewer"]
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


def test_train_cli_on_two_local_ranks(dataset, tmp_path, capfd):
    """``--data_devices 2`` on the CPU: two gloo ranks, each rendering one
    row band, through two densifies. The PLYs equal the one-rank run's at
    the gradient bar, and only the first rank writes and prints."""
    from .test_torch_kernel_bwd import assert_grad_close
    common = ["-s", str(dataset), "--iterations", "30", "--sh_degree", "1",
              "--densify_from_iter", "5", "--densification_interval", "10",
              "--device", "cpu", "--no_viewer", "--test_iterations", "30",
              "--save_iterations", "20"]
    one = t_train_cli.main(common + ["-m", str(tmp_path / "one")])
    capfd.readouterr()
    two = t_train_cli.main(common + ["-m", str(tmp_path / "two"),
                                     "--data_devices", "2"])
    out = capfd.readouterr().out
    assert out.count("Training complete.") == 1
    assert out.count("[ITER 30] eval PSNR") == 1
    assert abs(two["psnr"][30] - one["psnr"][30]) < 1e-3
    assert [w["points"] for w in two["windows"]] == \
        [w["points"] for w in one["windows"]]
    def listing(run):
        # the ranks are spawned, so TensorBoard is not blocked there
        return sorted(str(p.relative_to(tmp_path / run))
                      for p in (tmp_path / run).rglob("*")
                      if not p.name.startswith("events.out.tfevents"))

    assert listing("one") == listing("two")
    assert len(list((tmp_path / "two").glob("events.out.tfevents*"))) == 1
    for it in (20, 30):
        a = t_load_ply(_ply(tmp_path / "one", it), 1, device="cpu")
        b = t_load_ply(_ply(tmp_path / "two", it), 1, device="cpu")
        assert a.params.xyz.shape[0] == b.params.xyz.shape[0] > 300
        for f in ("xyz", "features_dc", "features_rest", "scaling",
                  "rotation", "opacity"):
            assert_grad_close(getattr(b.params, f).numpy(),
                              getattr(a.params, f).numpy(), f"{f} at {it}")


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


def test_render_cli_writes_the_trajectory_video(jax_model, tmp_path):
    """``--render_path`` without cv2 in the port: an uncompressed AVI whose
    frames, read back by OpenCV, are the trajectory's PNGs byte for
    byte."""
    import cv2
    model = tmp_path / "model"
    shutil.copytree(jax_model, model)
    res = t_render_cli.main(["-m", str(model), "--render_path",
                             "--skip_train", "--skip_test", "--skip_mesh",
                             "--device", "cpu"])
    assert res["video"].endswith("render_traj.avi")
    pngs = sorted((model / "traj" / f"ours_{ITERS}" / "renders").iterdir())
    cap = cv2.VideoCapture(res["video"])
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    cap.release()
    assert len(frames) == len(pngs) == 240
    for f, p in zip(frames, pngs):
        np.testing.assert_array_equal(f, np.asarray(Image.open(p)))


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


# --- the benchmark harnesses (m360_eval, dtu_eval, tnt_eval) ----------------

HARNESS_ITERS = ["--iterations", "10", "--quiet", "--no_viewer"]
COARSE_MESH = ["--num_cluster", "1", "--voxel_size", "0.1", "--sdf_trunc",
               "0.4", "--depth_trunc", "3.0"]


@pytest.fixture(scope="module")
def colmap_scene(tmp_path_factory):
    """A tiny COLMAP scene of the torus (8 views at 48x40, PNGs) and its
    surfels, for the harnesses."""
    root = tmp_path_factory.mktemp("harnesses") / "scene"
    surf = ss.torus_surfels(4000)
    renderer = ss.SurfelRenderer(surf, device="cpu")
    ss.write_colmap_scene(str(root), renderer, 48, 40, 8,
                          seed_points=ss.seed_cloud(surf[0], surf[4], 300))
    alphas = [renderer.rgba(c2w, 48, 40, math.radians(70.0))[..., 3]
              for c2w in ss.orbit(8)]
    return root, surf, alphas


def _copy_scene(src, dst):
    shutil.copytree(src, dst)
    return dst


def test_m360_harness_on_jpeg_scene(colmap_scene, tmp_path, monkeypatch):
    """m360_eval: an outdoor scene whose images_4 are JPEGs named .JPG;
    trained with --eval, rendered, scored with LPIPS from the weights npz
    (random weights in the converter's layout)."""
    from gs2d_torch.cli import m360_eval
    from gs2d_torch.scene import colmap as tc
    from .test_lpips import _random_state_dicts
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent
                           / "scripts"))
    from convert_lpips_weights import convert_state_dicts
    root, _, _ = colmap_scene
    scene = _copy_scene(root, tmp_path / "m360" / "bicycle")
    model = scene / "sparse" / "0" / "images.bin"
    imgs = tc.read_images_binary(str(model))
    (scene / "images_4").mkdir()
    for k, im in imgs.items():
        jpg = im.name.replace(".png", ".JPG")
        Image.open(scene / "images" / im.name).save(
            scene / "images_4" / jpg, format="JPEG", quality=95)
        im.name = jpg
    tc.write_images_binary(imgs, str(model))
    npz = tmp_path / "lpips.npz"
    np.savez(npz, **convert_state_dicts(*_random_state_dicts(seed=1)))
    monkeypatch.setenv("GS2D_LPIPS_WEIGHTS", str(npz))
    out = tmp_path / "out"
    paths = m360_eval.main(["-m360", str(tmp_path / "m360"), "-o", str(out),
                            "--scenes", "bicycle", "--device", "cpu"]
                           + HARNESS_ITERS)
    assert paths == [str(out / "bicycle")]
    res = json.loads((out / "bicycle" / "results.json").read_text())
    m = res["ours_10"]
    assert math.isfinite(m["PSNR"]) and 0 < m["SSIM"] <= 1
    assert m["LPIPS"] is not None and math.isfinite(m["LPIPS"])
    renders = sorted((out / "bicycle" / "test" / "ours_10" / "renders")
                     .iterdir())
    assert len(renders) == 1                       # view 0 of 8 held out
    assert not (out / "bicycle" / "train").exists()


def _idr_cameras(scene, alphas, dst):
    """cameras.npz (IDR world_mat = K[R|t], identity scale_mat) and RGB
    masks of the views' alpha, from the scene's COLMAP model."""
    from gs2d_torch.scene import colmap as tc
    from gs2d_torch.scene.images import encode_png
    cam = tc.read_cameras_binary(str(scene / "sparse" / "0"
                                     / "cameras.bin"))[1]
    fx, fy, cx, cy = cam.params
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
    imgs = tc.read_images_binary(str(scene / "sparse" / "0" / "images.bin"))
    cams = {}
    (dst / "mask").mkdir()
    for i, im in enumerate(sorted(imgs.values(), key=lambda x: x.name)):
        P = np.eye(4)
        P[:3, :4] = K @ np.hstack([tc.qvec2rotmat(im.qvec),
                                   im.tvec[:, None]])
        cams[f"world_mat_{i}"] = P
        cams[f"scale_mat_{i}"] = np.eye(4)
        m = np.where(alphas[i] > 8, 255, 0).astype(np.uint8)
        encode_png(str(dst / "mask" / f"{i:03d}.png"),
                   np.stack([m, m, m], -1))
    np.savez(dst / "cameras.npz", **cams)


def test_dtu_harness_scores_like_the_jax_protocol(colmap_scene, tmp_path,
                                                 monkeypatch):
    """dtu_eval: -r 2, λ_dist 1000, the mesh, the mask cull and the
    chamfer against an ObsMask and GT points; the chamfer equals the JAX
    evaluate_scan's on the same mesh and data within 1e-9 relative."""
    import scipy.io as sio

    from gs2d_torch.cli import dtu_eval
    from gs2d_torch.scene.ply import write_point_cloud
    from gs2d_tpu.eval.dtu import evaluate_scan
    root, surf, alphas = colmap_scene
    scan = _copy_scene(root, tmp_path / "dtu" / "scan24")
    _idr_cameras(scan, alphas, scan)
    official = tmp_path / "official"
    (official / "Points" / "stl").mkdir(parents=True)
    (official / "ObsMask").mkdir()
    gt = official / "Points" / "stl" / "stl024_total.ply"
    write_point_cloud(str(gt), surf[0].astype(np.float64),
                      np.full((len(surf[0]), 3), 0.5))
    bb = np.array([[-1.5, -1.5, -1.5], [1.5, 1.5, 1.5]])
    sio.savemat(official / "ObsMask" / "ObsMask24_10.mat",
                {"ObsMask": np.ones((30, 30, 30), np.uint8), "BB": bb,
                 "Res": 0.1, "P": np.array([[0.0], [0], [0], [1]])})
    monkeypatch.setattr(dtu_eval, "MESH_FLAGS", COARSE_MESH)
    out = tmp_path / "out"
    res = dtu_eval.main(["--dtu", str(tmp_path / "dtu"), "--DTU",
                         str(official), "-o", str(out), "--scans", "24",
                         "--device", "cpu"] + HARNESS_ITERS)
    cfg = json.loads((out / "scan24" / "cfg_args.json").read_text())
    assert (cfg["model"]["resolution"], cfg["optimization"]["lambda_dist"],
            cfg["pipeline"]["depth_ratio"]) == (2, 1000, 1.0)
    saved = json.loads((out / "results.json").read_text())
    r = saved["per_scan"]["24"]
    assert r == res[24] and saved["mean"] == r["overall"]
    assert all(math.isfinite(r[k]) for k in ("mean_d2s", "mean_s2d"))
    mesh = out / "scan24" / "train" / "ours_10" / "fuse_post.ply"
    ref = evaluate_scan(str(mesh), str(gt), str(official / "ObsMask"
                                                / "ObsMask24_10.mat"),
                        scan_dir=str(scan))
    for k in ("mean_d2s", "mean_s2d", "overall"):
        assert r[k] == pytest.approx(ref[k], rel=1e-9), k


def test_tnt_harness_scores_like_the_jax_protocol(colmap_scene, tmp_path,
                                                 monkeypatch):
    """tnt_eval: -r 2, λ_dist 100 (Barn, a 360° scene), the mesh, the
    trajectory log and the F-score at Barn's τ; the numbers equal the JAX
    run_tnt_evaluation's on the same mesh and data within 1e-9."""
    from gs2d_torch.cli import tnt_eval
    from gs2d_torch.scene.ply import write_point_cloud
    from gs2d_tpu.eval.tnt import run_tnt_evaluation
    root, surf, _ = colmap_scene
    scene = _copy_scene(root, tmp_path / "tnt" / "Barn")
    gt_dir = tmp_path / "gt" / "Barn"
    gt_dir.mkdir(parents=True)
    write_point_cloud(str(gt_dir / "Barn.ply"), surf[0].astype(np.float64),
                      np.full((len(surf[0]), 3), 0.5))
    np.savetxt(gt_dir / "Barn_trans.txt", np.eye(4))
    tnt_eval.export_trajectory(str(scene), str(gt_dir
                                               / "Barn_COLMAP_SfM.log"))
    (gt_dir / "Barn.json").write_text(json.dumps({
        "orthogonal_axis": "Z", "axis_min": -2.0, "axis_max": 2.0,
        "bounding_polygon": [[-2, -2, 0], [2, -2, 0], [2, 2, 0],
                             [-2, 2, 0]]}))
    monkeypatch.setattr(tnt_eval, "MESH_360", COARSE_MESH)
    out = tmp_path / "out"
    res = tnt_eval.main(["--TNT_data", str(tmp_path / "tnt"), "--TNT_GT",
                         str(tmp_path / "gt"), "-o", str(out), "--scenes",
                         "Barn", "--device", "cpu"] + HARNESS_ITERS)
    cfg = json.loads((out / "Barn" / "cfg_args.json").read_text())
    assert (cfg["model"]["resolution"],
            cfg["optimization"]["lambda_dist"]) == (2, 100)
    r = res["Barn"]
    assert json.loads((out / "results.json").read_text())["per_scene"][
        "Barn"]["fscore"] == r["fscore"]
    assert 0 <= r["fscore"] <= 1 and r["threshold"] == 0.01
    assert (out / "Barn" / "tnt_eval" / "Barn.recall.txt").exists()
    mesh = out / "Barn" / "train" / "ours_10" / "fuse_post.ply"
    ref = run_tnt_evaluation(str(mesh), str(gt_dir),
                             str(out / "Barn" / "Barn_traj.log"),
                             str(tmp_path / "jax_eval"), scene="Barn")
    for k in ("precision", "recall", "fscore"):
        assert r[k] == pytest.approx(ref[k], rel=1e-9, abs=1e-12), k
