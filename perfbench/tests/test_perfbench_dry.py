"""A dry run of each cell on the CPU prints the contract's last line."""

import pytest

from .conftest import CELLS, dry

KEYS = ("correct", "attempted", "failed", "metrics", "device")


@pytest.mark.parametrize("workload", CELLS)
def test_dry_run_prints_the_contracts_line(capsys, workload):
    rc, res, err = dry(capsys, workload)
    assert rc == 0, err
    assert all(k in res for k in KEYS)
    assert list(res)[-1] == "checks"
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    want = {"setup_s", "train_it_s"} if workload.endswith(".train") \
        else {"setup_s", "render_views_s", "render_ms_p95"}
    assert set(res["metrics"]) == want
    assert all(v["value"] > 0 for v in res["metrics"].values())
    # the compared numbers end standard error, each beside its limit
    tail = err.strip().splitlines()[-len(res["checks"]):]
    assert [t.split()[1] for t in tail] == list(res["checks"])
    assert all("(limit " in t for t in tail)


@pytest.mark.parametrize("workload", ["m360-outdoor.train",
                                      "m360-indoor.render",
                                      "dtu-object.train"])
def test_traced_dry_run_reads_the_trace(capsys, workload):
    rc, res, err = dry(capsys, workload, "--trace", "1")
    assert rc == 0, err
    assert res["correct"] is True
    assert res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    # no device on the CPU: only the host-side readings are there
    kind = workload.rsplit(".", 1)[1]
    assert f"binning_ms.{kind}" in res["metrics"]
    assert not any("roofline" in k or "idle" in k for k in res["metrics"])
