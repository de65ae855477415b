"""The port's scale benchmark, ``python -m gs2d_torch.cli.bench_scale``.

Run as a user runs it, in a subprocess, on the CPU at a tiny size
(``--device cpu``, the kernels' plain versions): one record per N with
the keys of the JAX package's ``scripts/bench_scale.py`` (read from its
source), minus its capacity and chunk fields, with ``num_expanded`` as
``num_pairs_uncull`` and the port's device fields; the pair counts
against the port's culled binning and the JAX package's un-culled one
on the same seeded scene; ``--out`` appends; without a card it reports
``cuda_unavailable`` and no number.
"""

import ast
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs2d_torch.cli.bench import bench_camera
from gs2d_torch.ops.rasterize.api import bin_preprocessed
from gs2d_torch.ops.rasterize.preprocess import preprocess
from gs2d_torch.utils.bench_scenes import make_trained_like_scene
from gs2d_tpu.ops.rasterize.binning import bin_gaussians as j_bin
from gs2d_tpu.ops.rasterize.preprocess import preprocess as j_preprocess
from gs2d_tpu.scene.cameras import make_camera as j_make_camera
from gs2d_tpu.utils.bench_scenes import \
    make_trained_like_scene as j_make_trained_like_scene

ROOT = Path(__file__).resolve().parent.parent
NS, W, H = (300, 600), 64, 32
TINY = ["--device", "cpu", "--n", *map(str, NS), "--width", str(W),
        "--height", str(H), "--iters", "1"]
DROPPED = {"pairs_capacity", "final_capacity", "chunk", "padded_total",
           "overflow"}
RENAMED = {"num_expanded": "num_pairs_uncull"}
ADDED = {"device", "power_limit_w", "peak_hbm_gb", "kernel_launches"}
TIMES = ("t_preprocess_ms", "t_binning_ms", "t_gather_ms", "t_fwd_kernel_ms",
         "t_bwd_kernel_ms", "t_bwd_glue_ms", "t_e2e_fwd_ms",
         "t_e2e_fwd_bwd_ms")


def _bench_scale(args, **env):
    res = subprocess.run(
        [sys.executable, "-m", "gs2d_torch.cli.bench_scale", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1", **env})
    assert res.returncode == 0, res.stderr
    return [json.loads(x) for x in res.stdout.strip().splitlines()]


def _jax_record_keys():
    """The keys of scripts/bench_scale.py's record: the ``rec`` dict that
    ``bench_one`` builds and every ``rec[...]`` it assigns."""
    tree = ast.parse((ROOT / "scripts" / "bench_scale.py").read_text())
    fn = next(f for f in tree.body
              if isinstance(f, ast.FunctionDef) and f.name == "bench_one")
    keys = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "rec"
                for t in node.targets) and isinstance(node.value, ast.Dict):
            keys |= {k.value for k in node.value.keys}
        elif isinstance(node, ast.Subscript) \
                and isinstance(node.ctx, ast.Store) \
                and isinstance(node.value, ast.Name) \
                and node.value.id == "rec":
            keys.add(node.slice.value)
    return keys


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The tiny CPU run with ``--out`` onto a file that holds one line
    already; PERF_scale.jsonl's bytes before and after."""
    out = tmp_path_factory.mktemp("scale") / "scale.jsonl"
    out.write_text('{"earlier": true}\n')
    perf = (ROOT / "PERF_scale.jsonl").read_bytes()
    recs = _bench_scale(TINY + ["--out", str(out)])
    return recs, out, perf


def test_scale_records_have_the_jax_keys(run):
    recs, _, _ = run
    jax_keys = _jax_record_keys()
    assert {"n_gaussians", "num_pairs", "num_expanded", "t_gather_ms",
            "rays_per_s_fwd_bwd", "wall_s"} | DROPPED <= jax_keys
    want = {RENAMED.get(k, k) for k in jax_keys - DROPPED} | ADDED
    assert [r["n_gaussians"] for r in recs] == list(NS)
    for r in recs:
        assert set(r) == want, set(r) ^ want
        assert (r["width"], r["height"]) == (W, H)
        for k in TIMES + ("rays_per_s_fwd_bwd", "wall_s"):
            assert math.isfinite(r[k]) and r[k] > 0, k
        assert r["rays_per_s_fwd_bwd"] == pytest.approx(
            W * H / r["t_e2e_fwd_bwd_ms"] * 1e3)
        assert (r["device"], r["power_limit_w"], r["peak_hbm_gb"]) == \
            ("cpu", None, None)
        # on the CPU no kernel runs: the wrappers take their plain versions
        assert r["kernel_launches"] == {"rasterize_fwd": 0,
                                        "rasterize_bwd": 0,
                                        "gather_rows": 0,
                                        "preprocess_fwd": 0,
                                        "preprocess_bwd": 0}


@pytest.mark.parametrize("i", range(len(NS)))
def test_scale_pair_counts(run, i):
    """num_pairs is the port's culled binning of the same view;
    num_pairs_uncull is the JAX package's un-culled bin_gaussians of the
    same seeded scene, and no fewer."""
    rec = run[0][i]
    n = NS[i]
    cam = bench_camera(W, H, "cpu")
    m, s, q, o, c = (torch.as_tensor(x) for x in make_trained_like_scene(n))
    pre = preprocess(m, s, q, o, cam.world_view, cam.full_proj, cam.campos,
                     W, H, colors=c)
    assert rec["num_pairs"] == bin_preprocessed(pre, W, H).num_pairs > 0

    fovx = math.radians(70)
    fovy = 2 * math.atan(math.tan(fovx / 2) * H / W)
    jcam = j_make_camera(np.eye(3), np.array([0.0, 0.0, 3.0]), fovx, fovy,
                         W, H)
    jm, js, jq, jo, jc = (jnp.asarray(x)
                          for x in j_make_trained_like_scene(n))
    jp = j_preprocess(jm, js, jq, jo, jcam.world_view, jcam.full_proj,
                      jcam.campos, W, H, colors=jc)
    jb = j_bin(jp.center2d, jp.extent, jp.depth, jp.visible, W, H, 1 << 15,
               128, cull_abc=None)
    assert not bool(jb.overflow)
    assert rec["num_pairs_uncull"] == int(jb.num_pairs) >= rec["num_pairs"]


def test_scale_out_appends_and_leaves_perf_scale_alone(run):
    recs, out, perf = run
    lines = out.read_text().splitlines()
    assert json.loads(lines[0]) == {"earlier": True}
    assert [json.loads(x) for x in lines[1:]] == recs
    assert (ROOT / "PERF_scale.jsonl").read_bytes() == perf


def test_scale_without_a_card_reports_an_error():
    recs = _bench_scale([], CUDA_VISIBLE_DEVICES="")
    assert len(recs) == 1 and recs[0]["error"] == "cuda_unavailable"
    assert not set(TIMES) & set(recs[0])
    assert "n_gaussians" not in recs[0]
