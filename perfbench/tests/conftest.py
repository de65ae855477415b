"""Tests of the benchmark harness: CPU runs of tiny cells, and the
control and faults at a cell's size on a card (marked ``cuda``)."""

import json

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips on machines without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")


def dry(capsys, workload, *extra, n=1500, scale=0.04, seconds=4.0,
        seed=2147483913, **kw):
    """Run a cell on the CPU at a tiny size → (exit code, result, stderr)."""
    from perfbench import run
    capsys.readouterr()
    rc = run.main(["--workload", workload, "--seed", str(seed), "--seconds",
                   str(seconds), *extra], device="cpu", n=n, scale=scale,
                  **kw)
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err


CELLS = ("m360-outdoor.train", "m360-indoor.train", "m360-outdoor.render",
         "m360-indoor.render")
