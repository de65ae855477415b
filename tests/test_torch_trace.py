"""The port's spans and counters (``gs2d_torch/utils/trace.py``) on the CPU.

- Off: with no profiler running a training step and a render record
  nothing, and ``span`` hands back one shared no-op context.
- On: one iteration of the loop under ``torch.profiler.profile`` records
  each stage's span once under its parent, self times within totals,
  the ``sync`` counts at their sites, and every ``gs2d::`` annotation in
  the exported Chrome trace.
- ``train(profile_dir=...)`` writes ``trace.json`` and ``spans.json``
  over iterations 50–60.
- The benchmark's readers: a tiny render cell run through
  ``perfbench.run.main`` with ``--trace 1`` reports each new ``.render``
  metric, and the ``.train`` readers on a hand-made summary.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from gs2d_torch import config as t_cfg
from gs2d_torch.models.gaussians import init_from_pcd
from gs2d_torch.render.renderer import render
from gs2d_torch.scene.cameras import CameraData
from gs2d_torch.train import loop
from gs2d_torch.train.step import TrainState, make_train_step
from gs2d_torch.train.optim import init_adam
from gs2d_torch.utils import trace

from .test_torch_common import port_camera
from .utils import random_cloud

ROOT = Path(__file__).resolve().parents[1]
W, H = 48, 32
SH = 1

# each span of a step and the span it opens under
PARENTS = {
    "loop.gt_upload": None, "loop.step": None,
    "render": "loop.step", "render.prepare": "render",
    "raster.bin": "render", "raster.composite_fwd": "render",
    "render.bridge": "render",
    "step.losses": "loop.step", "step.backward": "loop.step",
    "raster.composite_bwd": "step.backward",
    "raster.reduce": "raster.composite_bwd",
    "render.prepare_bwd": "step.backward",
    "step.update": "loop.step",
}
# the host's waits for the device in one step, by the span they fall in
SYNCS = {"loop.gt_upload": 1, "raster.bin": 4, "render.bridge": 3,
         "raster.reduce": 2, "step.update": 1}


class _Scene:
    """Two views of a 40-surfel cloud with random ground truth."""

    def __init__(self):
        means, _, _, _, rgb, _ = random_cloud(40, 3, spread=0.9)
        self.gaussians = init_from_pcd(means, rgb, max_sh_degree=SH, seed=0,
                                       device="cpu")
        g = torch.Generator().manual_seed(5)
        self.cams = [CameraData(camera=port_camera(W, H, dist=d),
                                image=torch.rand((3, H, W), generator=g),
                                uid=i)
                     for i, d in enumerate((4.0, 3.4))]
        self.model_path = ""
        self.cameras_extent = 1.5

    def get_train_cameras(self):
        return self.cams

    def save(self, iteration, state):
        pass


def _train(iterations, **kw):
    return loop.train(t_cfg.ModelParams(sh_degree=SH),
                      t_cfg.OptimizationParams(iterations=iterations),
                      t_cfg.PipelineParams(), t_cfg.RuntimeParams(seed=0),
                      scene=_Scene(), test_iterations=[], save_iterations=[],
                      device="cpu", **kw)


def test_off_records_nothing():
    """No profiler: a step and a render leave no record, and ``span`` is
    the one shared no-op context."""
    trace.reset()
    assert not torch.autograd._profiler_enabled()
    assert trace.span("loop.step") is trace.span("render")
    scene = _Scene()
    cam = scene.cams[0]
    bg = torch.zeros(3)
    step = make_train_step(t_cfg.OptimizationParams(), max_sh_degree=SH,
                           device="cpu")
    ts = TrainState(scene.gaussians, init_adam(scene.gaussians.params))
    step(ts, cam.camera, cam.image, 1, bg)
    with torch.no_grad():
        render(cam.camera, scene.gaussians, bg, max_sh_degree=SH,
               device="cpu")
    trace.count("sync")
    assert trace.summary() == {"spans": {}, "counts": {}}


def test_one_iteration_records_each_span_once(tmp_path):
    """One iteration of the loop under the profiler: every span of the
    step once, under its parent; self times within totals; the counts at
    their sites; every annotation in the Chrome trace."""
    trace.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _train(1)
    s = trace.summary()
    assert {k: v["calls"] for k, v in s["spans"].items()} \
        == {k: 1 for k in PARENTS}
    path = tmp_path / "spans.json"
    trace.write(str(path))
    recs = json.loads(path.read_text())["records"]
    parents = {r["name"]: (None if r["parent"] is None
                           else recs[r["parent"]]["name"]) for r in recs}
    assert parents == PARENTS
    for name, v in s["spans"].items():
        assert 0.0 <= v["host_self_s"] <= v["host_s"], name
        assert 0.0 <= v["device_self_s"] <= v["device_s"], name
    assert {k: v["counts"]["sync"] for k, v in s["spans"].items()
            if v["counts"]} == SYNCS
    assert s["spans"]["loop.gt_upload"]["counts"]["gt.upload"] == 1
    assert s["counts"] == {"sync": sum(SYNCS.values()), "gt.upload": 1}
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())
    events = events.get("traceEvents", events) \
        if isinstance(events, dict) else events
    names = {e.get("name", "") for e in events}
    assert {n[len(trace.PREFIX):] for n in names
            if n.startswith(trace.PREFIX)} == set(PARENTS)
    trace.reset()
    assert trace.summary() == {"spans": {}, "counts": {}}


def test_profile_dir_writes_trace_and_spans(tmp_path):
    """``profile_dir`` gets the profiler's trace of iterations 50–60 and
    the spans recorded over them: ten steps, and no upload (both views
    are in the cache by then)."""
    _train(60, profile_dir=str(tmp_path))
    assert (tmp_path / "trace.json").stat().st_size > 0
    spans = json.loads((tmp_path / "spans.json").read_text())
    assert spans["spans"]["loop.step"]["calls"] == 10
    assert spans["spans"]["render"]["calls"] == 10
    # the steps' syncs but the upload's, and the EMA's read at 50
    assert spans["counts"]["sync"] == 10 * (sum(SYNCS.values()) - 1) + 1
    assert "gt.upload" not in spans["counts"]
    assert len(spans["records"]) == sum(v["calls"] for v in
                                        spans["spans"].values())


RENDER_METRICS = ("preprocess_dev_ms.render", "bridge_dev_ms.render",
                  "render_host_ms.render", "host_syncs_per_view.render")
TRAIN_METRICS = ("preprocess_dev_ms.train", "losses_dev_ms.train",
                 "backward_self_dev_ms.train", "reduce_dev_ms.train",
                 "update_dev_ms.train", "step_host_ms.train",
                 "gt_upload_ms.train", "host_syncs_per_it.train",
                 "preprocess_bwd_dev_ms.train")

RUN = """
import json, sys
from perfbench import run
from gs2d_torch.utils import trace
rc = run.main(["--workload", "m360-outdoor.render", "--seed", "2147483911",
               "--seconds", "3", "--trace", "1"], device="cpu", n=1000,
               scale=0.03)
print(json.dumps(trace.summary()))
sys.exit(rc)
"""


def test_render_cell_reports_the_render_metrics():
    """A tiny CPU render cell, traced: each new ``.render`` metric is in
    the result line, and the ``render`` span ran once per view of the
    window."""
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    p = subprocess.run([sys.executable, "-c", RUN], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-4000:]
    *_, line, summary = p.stdout.strip().splitlines()
    res, summary = json.loads(line), json.loads(summary)
    assert res["correct"] is True
    for m in RENDER_METRICS:
        assert res["metrics"][m]["value"] >= 0.0, m
    assert not any(m in res["metrics"] for m in TRAIN_METRICS)
    assert summary["spans"]["render"]["calls"] == res["attempted"] == 25
    assert res["metrics"]["host_syncs_per_view.render"]["value"] \
        == summary["counts"]["sync"] / 25 == 7


def _span(device_s, device_self_s, host_s, calls=20):
    return {"calls": calls, "host_s": host_s, "host_self_s": host_s / 2,
            "device_s": device_s, "device_self_s": device_self_s,
            "counts": {}}


SUMMARY = {
    "spans": {"loop.step": _span(2.0, 0.1, 1.9),
              "loop.gt_upload": _span(0.3, 0.3, 0.4),
              "render.prepare": _span(0.2, 0.2, 0.05),
              "step.losses": _span(0.06, 0.06, 0.01),
              "step.backward": _span(0.9, 0.7, 0.3),
              "render.prepare_bwd": _span(0.04, 0.04, 0.02),
              "raster.reduce": _span(0.08, 0.08, 0.001),
              "step.update": _span(0.24, 0.24, 0.02)},
    "counts": {"sync": 62, "gt.upload": 20},
}
EXPECTED = {"preprocess_dev_ms.train": 10.0, "losses_dev_ms.train": 3.0,
            "backward_self_dev_ms.train": 35.0, "reduce_dev_ms.train": 4.0,
            "update_dev_ms.train": 12.0, "step_host_ms.train": 95.0,
            "gt_upload_ms.train": 20.0, "host_syncs_per_it.train": 3.1,
            "preprocess_bwd_dev_ms.train": 2.0}


@pytest.mark.parametrize("metric", TRAIN_METRICS)
def test_train_reader_on_a_hand_made_summary(metric, monkeypatch):
    """Each ``.train`` reader divides its span's seconds (or the sync
    total) by the window's iterations; it reads nothing in a render cell
    or where its span never ran."""
    from perfbench.readers import Traced
    from perfbench.run import load_module
    mod = load_module(ROOT / "perfbench" / "metrics" / f"{metric}.py")
    monkeypatch.setattr(trace, "summary", lambda: SUMMARY)
    assert mod.read(Traced("train", None, 20, [])) \
        == pytest.approx(EXPECTED[metric])
    assert mod.read(Traced("render", None, 20, [])) is None
    monkeypatch.setattr(trace, "summary",
                        lambda: {"spans": {}, "counts": {}})
    assert mod.read(Traced("train", None, 20, [])) is None
