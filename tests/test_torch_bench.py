"""The port's benchmark entry point, ``python -m gs2d_torch.cli.bench``.

Run as a user runs it, in a subprocess: on the CPU at a tiny size
(``--device cpu``, the kernels' plain versions) its one JSON line carries
every key that the JAX package's ``bench.py`` emits on its chip
(``bench.py:39-48`` and ``:223-247``, read from its source), and without a
card and without ``--device cpu`` it reports ``cuda_unavailable`` with a
null value, never a CPU number, and exits 0 either way.
"""

import ast
import json
import math
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
TINY = ["--device", "cpu", "--n", "300", "--width", "64", "--height", "32",
        "--iters", "1", "--uniform_n", "300"]
ERROR_ONLY = {"error", "detail", "deadline_s"}


def _bench(args, **env):
    res = subprocess.run(
        [sys.executable, "-m", "gs2d_torch.cli.bench", *args], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1", **env})
    assert res.returncode == 0, res.stderr
    return json.loads(res.stdout.strip().splitlines()[-1])


def _jax_bench_keys():
    """The keys of bench.py's JSON line on its chip: the record that
    ``emit`` builds and every key ``main`` puts into ``extra``, minus
    those that only a failure adds."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    keys = set()
    for fn in tree.body:
        if isinstance(fn, ast.FunctionDef) and fn.name in ("emit", "main"):
            for node in ast.walk(fn):
                if isinstance(node, ast.Dict):
                    keys |= {k.value for k in node.keys
                             if isinstance(k, ast.Constant)}
                elif isinstance(node, ast.Subscript) \
                        and isinstance(node.ctx, ast.Store) \
                        and isinstance(node.slice, ast.Constant):
                    keys.add(node.slice.value)
    return keys - ERROR_ONLY


def test_bench_line_on_the_cpu_has_the_jax_keys():
    rec = _bench(TINY, BENCH_BASELINE="1000")
    jax_keys = _jax_bench_keys()
    assert {"metric", "value", "vs_baseline", "train_step_it_per_s",
            "uniform_100k_rays_per_s", "headline_wall_s"} <= jax_keys
    assert jax_keys <= set(rec), jax_keys - set(rec)
    assert "error" not in rec
    assert rec["metric"] == "rays_per_s_per_chip_fwd_bwd_1080p"
    assert rec["unit"] == "rays/s"
    assert (rec["platform"], rec["device"], rec["n_devices"]) == \
        ("cpu", "cpu", 1)
    assert rec["power_limit_w"] is None
    assert (rec["scene"], rec["width"], rec["height"]) == \
        ("trained_like_300", 64, 32)
    for k in ("value", "train_step_it_per_s", "uniform_100k_rays_per_s"):
        assert math.isfinite(rec[k]) and rec[k] > 0, k
    assert rec["vs_baseline"] == rec["value"] / 1000
    # on the CPU no kernel runs: the wrappers take their plain versions
    assert rec["kernel_launches"] == {"rasterize_fwd": 0,
                                      "rasterize_bwd": 0, "gather_rows": 0}


def test_bench_without_a_card_reports_an_error():
    rec = _bench([], CUDA_VISIBLE_DEVICES="")
    assert rec["value"] is None and rec["error"] == "cuda_unavailable"
    assert rec["metric"] == "rays_per_s_per_chip_fwd_bwd_1080p"
    assert not {"platform", "headline_wall_s", "train_step_it_per_s"} \
        & set(rec)
