"""Tests of the benchmark harness: CPU runs of tiny cells, and the
control and faults at a cell's size on a card (marked ``cuda``)."""

import json
import tempfile
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]

# Cells whose configuration, traffic and limits are in the benchmark's
# files but which BENCHMARK.json leaves out: the DTU object's training
# step is host-bound, and its rate spreads more across runs on a shared
# host than the bound of ``train_it_s`` allows. The tests run each from a
# copy of the benchmark with its entries added, listed wherever the cell
# named ``like`` is.
UNLISTED = {
    "dtu-object.train": {
        "config": "dtu-object", "traffic": "train-resumed",
        "like": "m360-outdoor.train"},
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips on machines without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")


def unlisted_bench(workload: str, where: Path) -> Path:
    """``BENCHMARK.json`` with an unlisted cell's entries added, written
    under ``where`` → its path."""
    cell = UNLISTED[workload]
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = ROOT / "perfbench" / "configs" / f"{cell['config']}.json"
    bench["configs"].append({
        "name": cell["config"], "source": json.loads(cfg.read_text())
        ["source"], "file": str(cfg), "reduced": [], "why": "a test"})
    bench["workloads"].append({
        "name": workload, "config": cell["config"],
        "traffic": cell["traffic"], "chips": 1, "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if cell["like"] in m.get("workloads", []):
            m["workloads"].append(workload)
    path = where / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return path


def dry(capsys, workload, *extra, n=1500, scale=0.04, seconds=4.0,
        seed=2147483913, **kw):
    """Run a cell on the CPU at a tiny size → (exit code, result, stderr)."""
    from perfbench import run
    capsys.readouterr()
    with tempfile.TemporaryDirectory() as tmp:
        if workload in UNLISTED:
            kw.setdefault("bench_path", unlisted_bench(workload, Path(tmp)))
        rc = run.main(["--workload", workload, "--seed", str(seed),
                       "--seconds", str(seconds), *extra], device="cpu",
                      n=n, scale=scale, **kw)
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err


CELLS = ("m360-outdoor.train", "m360-indoor.train", "m360-outdoor.render",
         "m360-indoor.render", *UNLISTED)
