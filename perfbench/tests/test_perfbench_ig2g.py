"""The ``ig2g-room.edit`` cell on the CPU at a tiny size: the scene at the
tests' scale, the editor's networks at TINY widths in float16 (the
configuration's dtype). A run prints the contract's line and reads
``correct``; the control (the reference in bfloat16 in the program's
place) and each fault read false; a traced run reads the trace, and no
device metric is read without a device."""

import json
from pathlib import Path

import pytest

from .conftest import ROOT, dry

WORKLOAD = "ig2g-room.edit"
TINY_EDITOR = {
    "unet": {"in_channels": 8, "out_channels": 4,
             "block_out_channels": [8, 16], "layers_per_block": 1,
             "cross_attention_dim": 16, "num_attention_heads": 2,
             "norm_groups": 4},
    "vae": {"in_channels": 3, "latent_channels": 4,
            "block_out_channels": [8, 8, 16, 16], "layers_per_block": 1,
            "norm_groups": 4},
    "text_encoder": {"vocab_size": 600, "hidden": 16, "layers": 2,
                     "heads": 2, "max_positions": 8}}


@pytest.fixture(scope="module")
def bench(tmp_path_factory) -> Path:
    """``BENCHMARK.json`` whose ``ig2g-room`` file has the TINY widths."""
    where = tmp_path_factory.mktemp("ig2g_bench")
    cfg = json.loads((ROOT / "perfbench" / "configs" / "ig2g-room.json")
                     .read_text())
    cfg["editor"].update(TINY_EDITOR)
    (where / "ig2g-room.json").write_text(json.dumps(cfg))
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in b["configs"]:
        if c["name"] == "ig2g-room":
            c["file"] = str(where / "ig2g-room.json")
    (where / "BENCHMARK.json").write_text(json.dumps(b))
    return where / "BENCHMARK.json"


def test_dry_run_prints_the_contracts_line(capsys, bench):
    rc, res, err = dry(capsys, WORKLOAD, bench_path=bench)
    assert rc == 0, err
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"setup_s", "train_it_s"}
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert set(res["checks"]) == set(json.loads(
        (ROOT / "perfbench" / "limits" / f"{WORKLOAD}.json").read_text()))
    assert res["checks"]["edits_off"]["value"] == 0.0
    assert "ig2g: edit at 20008" in err


def test_traced_dry_run_reads_the_trace(capsys, bench):
    rc, res, err = dry(capsys, WORKLOAD, "--trace", "1", bench_path=bench)
    assert rc == 0, err
    assert res["correct"] is True
    assert res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    # no device on the CPU: the device-time readers read nothing
    assert not any(k.endswith(".ig2g") for k in res["metrics"])
    assert "'ig2g.unet'" in err


@pytest.mark.parametrize("extra", [["--control"], ["--fault", "unchanged"],
                                   ["--fault", "half_batch"],
                                   ["--fault", "altered"]])
def test_the_control_and_the_faults_are_not_correct(capsys, bench, extra):
    rc, res, err = dry(capsys, WORKLOAD, *extra, bench_path=bench)
    assert rc == 0, err
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("mutant", ["swapped_guidance", "unnormalized_noise",
                                    "noise_dropped", "nearest_resize"])
def test_each_mutant_is_caught_by_its_check(capsys, bench, mutant):
    from perfbench.tools import mutants
    undo = mutants.install(mutant)
    try:
        rc, res, err = dry(capsys, WORKLOAD, bench_path=bench)
    finally:
        undo()
    assert rc == 0, err
    check = res["checks"][mutants.MUTANTS[mutant][3]]
    assert check["value"] > check["limit"], res["checks"]
    assert res["correct"] is False
