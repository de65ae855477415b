"""A configuration, a traffic mix and a metric added as new files and
entries only are found and run."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

RUN = """
import sys
from perfbench import run
sys.exit(run.main(["--workload", "tiny-room.short", "--seed", "977",
                   "--seconds", "3", "--trace", sys.argv[1]],
                  device="cpu", n=1200, scale=0.04))
"""


def test_new_files_and_entries_are_found(tmp_path):
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    pb = tmp_path / "perfbench"
    cfg = json.loads((pb / "configs" / "m360-indoor.json").read_text())
    cfg["name"] = "tiny-room"
    cfg["rig"]["views"] = 16
    (pb / "configs" / "tiny-room.json").write_text(json.dumps(cfg))
    mix = json.loads((pb / "traffic" / "render-testviews.json").read_text())
    mix["checked_views"] = 1
    (pb / "traffic" / "render-short.json").write_text(json.dumps(mix))
    (pb / "limits" / "tiny-room.short.json").write_text(
        (pb / "limits" / "m360-indoor.render.json").read_text())
    (pb / "metrics" / "views_traced.render.py").write_text(
        "def read(t):\n    return float(t.units) if t.kind == 'render' "
        "else None\n")
    bench["configs"].append({"name": "tiny-room", "source": "a test",
                             "file": "perfbench/configs/tiny-room.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny-room.short",
                               "config": "tiny-room",
                               "traffic": "render-short", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"]:
        if "render_views_s" == m["name"] or "render_ms_p95" == m["name"]:
            m["workloads"].append("tiny-room.short")
    bench["per_layer"].append({"name": "views_traced.render", "unit": "views",
                               "better": "higher", "source": "device_trace",
                               "layer": "render entry",
                               "moves": "render_views_s",
                               "workloads": ["tiny-room.short"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    for trace in ("0", "1"):
        p = subprocess.run([sys.executable, "-c", RUN, trace], cwd=tmp_path,
                           capture_output=True, text=True, env=env,
                           timeout=300)
        assert p.returncode == 0, p.stderr
        res = json.loads(p.stdout.strip().splitlines()[-1])
        assert res["correct"] is True
        if trace == "0":
            assert set(res["metrics"]) == {"render_views_s",
                                           "render_ms_p95", "setup_s"}
        else:
            assert res["metrics"]["views_traced.render"]["value"] == 2.0
