"""The port's user scripts (``gs2d_torch/cli/{convert,render_all,run_all,
make_synthetic_scene,quality_readout}.py``) on the CPU, against the JAX
package's scripts where they can run here.

- convert: the port and the JAX ``convert.py`` under the same stub
  ``colmap`` (a script that logs its arguments and writes what
  ``image_undistorter`` writes): the same command sequence, the same
  ``sparse/0`` fixup, ``images_{2,4,8}`` equal (JPEG bytes, PNG pixels,
  RGBA and gray+alpha among them); a failing command ends both with its
  code; no ``colmap`` ends both with 1.
- make_synthetic_scene against ``scripts/make_synthetic_scene.py`` at
  64x64 (torus) and 64x48 (rich, with its seed cloud), 8 + 2 views: PNGs
  within 1/255, JSON within 1e-6, ``points3d.ply`` byte-equal.
- run_all: the scenes each ``--shard`` selects, the failure lines and the
  exit code equal to ``scripts/run_all.py``'s (both train CLIs rejecting
  a flag), and a real sweep that trains the good scenes past a bad one.
- render_all: a model that fails is reported and not copied (its stale
  renders stay behind), the others are copied, the exit code is 1.
- quality_readout: ``chamfer`` and ``gt_surface_points`` against
  ``scripts/quality_readout.py``'s (mirroring
  tests/test_quality_readout.py); ``main`` on a trained tiny model, its
  mesh stage timed out once and retried at half the resolution, writing
  only ``<model>/quality_readout.json``.
"""

import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from gs2d_torch.cli import (convert, make_synthetic_scene, quality_readout,
                            render_all, run_all)

from .test_torch_common import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))
import quality_readout as jax_readout  # noqa: E402

STUB = '''#!{python}
import json, os, shutil, sys
here = os.path.dirname(os.path.abspath(__file__))
with open(os.path.join(here, "colmap_calls.jsonl"), "a") as f:
    f.write(json.dumps(sys.argv[1:]) + "\\n")
if os.environ.get("STUB_COLMAP_FAIL") == sys.argv[1]:
    sys.exit(3)
if sys.argv[1] == "image_undistorter":
    a = dict(zip(sys.argv[2::2], sys.argv[3::2]))
    shutil.copytree(a["--image_path"], os.path.join(a["--output_path"],
                    "images"), dirs_exist_ok=True)
    os.makedirs(os.path.join(a["--output_path"], "sparse"), exist_ok=True)
    for n in ("cameras.bin", "images.bin", "points3D.bin"):
        open(os.path.join(a["--output_path"], "sparse", n), "wb").close()
'''


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def _inputs(dst: Path):
    """JPEGs (RGB 4:2:0, gray) and PNGs of every mode the loaders take."""
    dst.mkdir(parents=True)
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[:45, :67]
    smooth = (128 + 100 * np.sin(xx / 5) * np.cos(yy / 7)).astype(np.uint8)
    rgb = np.stack([smooth, 255 - smooth, np.roll(smooth, 9, 1)], -1)
    Image.fromarray(rgb).save(dst / "view_a.jpg", quality=90)
    Image.fromarray(smooth).save(dst / "view_b.JPG", quality=85)
    alpha = rng.integers(0, 256, smooth.shape, dtype=np.uint8)
    alpha[:, :10], alpha[:, -10:] = 0, 255
    Image.fromarray(np.dstack([rgb, alpha]), "RGBA").save(dst / "c.png")
    Image.fromarray(np.dstack([smooth, alpha]), "LA").save(dst / "d.png")
    Image.fromarray(rgb).save(dst / "e.png")
    Image.fromarray(smooth).save(dst / "f.png")


def _scene_with_stub(root: Path):
    src = root / "scene"
    _inputs(src / "input")
    stub = root / "colmap"
    stub.write_text(STUB.format(python=sys.executable))
    stub.chmod(0o755)
    return src, stub


def _calls(root: Path, src: Path):
    lines = (root / "colmap_calls.jsonl").read_text().splitlines()
    return [[a.replace(str(src), "<src>") for a in json.loads(x)]
            for x in lines]


def _run_jax_convert(argv, env=None):
    return subprocess.run([sys.executable, str(ROOT / "convert.py")] + argv,
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300, env={**os.environ, **(env or {})})


def test_convert_matches_jax(tmp_path):
    (jroot, troot) = (tmp_path / "jax", tmp_path / "port")
    jsrc, jstub = _scene_with_stub(jroot)
    tsrc, tstub = _scene_with_stub(troot)
    res = _run_jax_convert(["-s", str(jsrc), "--colmap_executable",
                            str(jstub), "--resize"])
    assert res.returncode == 0, res.stderr
    n = convert.main(["-s", str(tsrc), "--colmap_executable", str(tstub),
                      "--resize", "--device", "cpu"])
    assert n == 6 * 3
    assert _calls(troot, tsrc) == _calls(jroot, jsrc)
    assert [c[0] for c in _calls(troot, tsrc)] == [
        "feature_extractor", "exhaustive_matcher", "mapper",
        "image_undistorter"]
    for d in ("sparse/0", "images"):
        assert sorted(os.listdir(tsrc / d)) == sorted(os.listdir(jsrc / d))
    assert sorted(os.listdir(tsrc / "sparse")) == ["0"]
    for sub in ("images_2", "images_4", "images_8"):
        names = sorted(os.listdir(jsrc / sub))
        assert names == sorted(os.listdir(tsrc / sub)) and len(names) == 6
        for fn in names:
            a, b = (jsrc / sub / fn).read_bytes(), (tsrc / sub / fn).read_bytes()
            if fn.lower().endswith(".jpg"):
                assert a == b, (sub, fn)
            else:
                pa = Image.open(io.BytesIO(a))
                pb = Image.open(io.BytesIO(b))
                assert pa.mode == pb.mode, (sub, fn)
                np.testing.assert_array_equal(np.asarray(pa), np.asarray(pb))


@pytest.mark.parametrize("fail", ["mapper", "image_undistorter"])
def test_convert_stops_at_a_failing_command_like_jax(tmp_path, fail):
    (jroot, troot) = (tmp_path / "jax", tmp_path / "port")
    jsrc, jstub = _scene_with_stub(jroot)
    tsrc, tstub = _scene_with_stub(troot)
    env = {"STUB_COLMAP_FAIL": fail}
    res = _run_jax_convert(["-s", str(jsrc), "--colmap_executable",
                            str(jstub)], env)
    os.environ["STUB_COLMAP_FAIL"] = fail
    try:
        with pytest.raises(SystemExit) as e:
            convert.main(["-s", str(tsrc), "--colmap_executable",
                          str(tstub), "--device", "cpu"])
    finally:
        del os.environ["STUB_COLMAP_FAIL"]
    assert e.value.code == res.returncode == 3
    assert _calls(troot, tsrc) == _calls(jroot, jsrc)
    assert _calls(troot, tsrc)[-1][0] == fail


def test_convert_without_colmap_exits_like_jax(tmp_path):
    missing = str(tmp_path / "no_colmap")
    res = _run_jax_convert(["-s", str(tmp_path), "--colmap_executable",
                            missing])
    with pytest.raises(SystemExit) as e:
        convert.main(["-s", str(tmp_path), "--colmap_executable", missing])
    assert e.value.code == res.returncode == 1


@pytest.mark.parametrize("preset,flags", [
    ("torus", ["--size", "64"]),
    ("rich", ["--preset", "rich", "--width", "64", "--height", "48",
              "--n_surfels", "3000"])], ids=["torus", "rich"])
def test_make_synthetic_scene_matches_jax(tmp_path, preset, flags):
    jout, tout = tmp_path / "jax", tmp_path / "port"
    common = ["--n_train", "8", "--n_test", "2"] + flags
    res = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "make_synthetic_scene.py"),
         "--out", str(jout)] + common, cwd=ROOT, capture_output=True,
        text=True, timeout=600, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert res.returncode == 0, res.stderr[-2000:]
    make_synthetic_scene.main(["--out", str(tout), "--device", "cpu"]
                              + common)
    assert sorted(os.listdir(tout)) == sorted(os.listdir(jout))
    for split, n in (("train", 8), ("test", 2)):
        j = json.loads((jout / f"transforms_{split}.json").read_text())
        t = json.loads((tout / f"transforms_{split}.json").read_text())
        assert abs(j["camera_angle_x"] - t["camera_angle_x"]) <= 1e-6
        assert [f["file_path"] for f in j["frames"]] == \
            [f["file_path"] for f in t["frames"]]
        np.testing.assert_allclose(
            [f["transform_matrix"] for f in t["frames"]],
            [f["transform_matrix"] for f in j["frames"]], atol=1e-6)
        assert len(os.listdir(tout / split)) == n
        for fn in os.listdir(jout / split):
            a = np.asarray(Image.open(jout / split / fn)).astype(int)
            b = np.asarray(Image.open(tout / split / fn)).astype(int)
            assert a.shape == b.shape and b.shape[-1] == 4
            assert int(np.abs(a - b).max()) <= 1, (split, fn)
            assert b[..., 3].max() > 128
    if preset == "rich":
        assert (tout / "points3d.ply").read_bytes() == \
            (jout / "points3d.ply").read_bytes()


# --- run_all, render_all and the readout on tiny trained models ----------

TRAIN_FLAGS = ["--iterations", "30", "--sh_degree", "1", "--device", "cpu",
               "--quiet", "--no_viewer", "--eval", "--test_iterations", "0",
               "--save_iterations", "30"]


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    """Three scenes (a and c the rich preset at 48x36, b empty) swept by
    run_all with --shard 0/1: a and c train, b fails, the exit code is
    1."""
    root = tmp_path_factory.mktemp("sweep")
    data, out = root / "data", root / "out"
    for s in ("a", "c"):
        make_synthetic_scene.main([
            "--out", str(data / s), "--preset", "rich", "--width", "48",
            "--height", "36", "--n_train", "6", "--n_test", "2",
            "--n_surfels", "800", "--device", "cpu"])
    (data / "b").mkdir()
    with pytest.raises(SystemExit) as e:
        run_all.main(["--data_root", str(data), "--output_root", str(out),
                      "--"] + TRAIN_FLAGS)
    assert e.value.code == 1
    return data, out


def test_run_all_trains_past_a_failing_scene(sweep):
    _, out = sweep
    for s in ("a", "c"):
        assert (out / s / "point_cloud" / "iteration_30" /
                "point_cloud.ply").is_file()
    assert not (out / "b" / "point_cloud").exists()


@pytest.mark.parametrize("shard", ["0/1", "1/2"])
def test_run_all_shards_match_jax(sweep, tmp_path, shard, capfd):
    """Both scripts over the same scenes with a flag both train CLIs
    reject: the same scenes run, the same failure lines, exit code 1."""
    data, _ = sweep
    argv = ["--data_root", str(data), "--output_root", str(tmp_path),
            "--shard", shard, "--", "--no_such_flag"]
    res = subprocess.run([sys.executable, str(ROOT / "scripts" /
                                             "run_all.py")] + argv,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    capfd.readouterr()
    with pytest.raises(SystemExit) as e:
        run_all.main(argv)
    ours = capfd.readouterr().out

    def lines(text):
        return [x for x in text.splitlines()
                if x.startswith("===") or "failed" in x]

    assert e.value.code == res.returncode == 1
    assert lines(ours) == lines(res.stdout)
    want = ["a", "b", "c"] if shard == "0/1" else ["b"]
    assert [x.strip("= ") for x in lines(ours) if x.startswith("===")] \
        == want


def test_render_all_does_not_copy_a_failed_model(sweep, tmp_path, capsys):
    """Models a and c render and are copied; ``stale`` (renders of an
    earlier run, no config) fails and is not; the exit code is 1."""
    _, out = sweep
    stale = tmp_path / "stale"
    (stale / "test" / "ours_1").mkdir(parents=True)
    (stale / "test" / "ours_1" / "old.png").write_bytes(b"stale")
    root = tmp_path / "results"
    with pytest.raises(SystemExit) as e:
        render_all.main(["-md", str(out / "a"), str(stale), str(out / "c"),
                         "--out_root", str(root), "--", "--skip_train",
                         "--skip_mesh", "--device", "cpu"])
    assert e.value.code == 1
    text = capsys.readouterr().out
    assert f"render failed for {stale} (rc=1); skipping copy" in text
    assert f"failed models: {stale}" in text
    (stamp,) = os.listdir(root)
    assert sorted(os.listdir(root / stamp)) == ["a", "c"]
    for s in ("a", "c"):
        renders = root / stamp / s / "test" / "ours_30" / "renders"
        assert sorted(os.listdir(renders)) == ["00000.png", "00001.png"]
        assert not (root / stamp / s / "train").exists()


def test_render_all_succeeds_on_good_models(sweep):
    _, out = sweep
    assert render_all.main(["-md", str(out / "a"), "--", "--skip_train",
                            "--skip_mesh", "--device", "cpu"]) == []


def test_readout_chamfer_matches_the_jax_script(monkeypatch):
    rng = np.random.default_rng(3)
    a = rng.normal(size=(700, 3)).astype(np.float32)
    b = (rng.normal(size=(900, 3)) * 0.7 + 0.1).astype(np.float32)
    assert quality_readout.chamfer(a, b) == jax_readout.chamfer(a, b)
    assert quality_readout.chamfer(a, a.copy()) == (0.0, 0.0)
    # the blockwise fallback, both scripts without scipy
    monkeypatch.setitem(sys.modules, "scipy.spatial", None)
    got = quality_readout.chamfer(a, b, block=256)
    assert got == jax_readout.chamfer(a, b, block=256)
    assert np.allclose(got, quality_readout.chamfer(a, b, block=64),
                       rtol=1e-6)


def test_readout_gt_surface_points_match_the_jax_script():
    pts = quality_readout.gt_surface_points(n=20_000, seed=7)
    np.testing.assert_array_equal(
        pts, jax_readout.gt_surface_points(n=20_000, seed=7))
    fg = np.linalg.norm(pts, axis=1) < quality_readout.FOREGROUND_R
    rho = np.hypot(pts[:, 0], pts[:, 1])
    torus_err = np.abs(np.hypot(rho - 1.0, pts[:, 2]) - 0.35)
    disc_err = np.abs(pts[:, 2] + 0.4)
    assert fg.sum() > 1000
    assert float(np.minimum(torus_err, disc_err)[fg].max()) < 1e-3


def test_readout_main_retries_the_mesh_at_half_resolution(sweep, monkeypatch):
    """The mesh stage's first child is stopped at its time limit (set to
    1 ms here), the second meshes at half the resolution; the record holds
    both, and only ``<model>/quality_readout.json`` is written."""
    data, out = sweep
    model = out / "a"
    quality_file = ROOT / "QUALITY_scale.json"
    before = quality_file.read_bytes()
    monkeypatch.setattr(quality_readout, "MESH_BUDGETS_S", (0.001, 600))
    rec = quality_readout.main([
        "--model", str(model), "--data", str(data / "a"), "--iteration",
        "30", "--mesh_res", "128", "--mesh_gt_samples", "5000", "--device",
        "cpu"])
    assert rec["mesh_error"] == "128: TimeoutExpired"
    assert rec["mesh_res"] == 64
    assert rec["mesh_path"].endswith("fuse_post.ply")
    assert rec["mesh_faces"] > 0 and rec["fg_mesh_samples"] > 0
    assert np.isfinite(rec["chamfer_mean"])
    saved = json.loads((model / "results.json").read_text())
    assert rec["nvs"] == saved and "ours_30" in saved
    assert json.loads((model / "quality_readout.json").read_text()) == rec
    assert quality_file.read_bytes() == before
