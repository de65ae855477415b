"""The comparison that decides ``correct`` fails its control (the
reference in bfloat16 in the program's place) and each fault that a cell
can have, with the timed path broken underneath: on the CPU at a tiny
size, and on a card at the cell's own size (marked ``cuda``)."""

import pytest

from .conftest import dry


@pytest.mark.parametrize("workload,fault", [
    ("m360-outdoor.train", "unchanged"),
    ("m360-outdoor.train", "half_batch"),
    ("m360-indoor.train", "half_batch"),
    ("m360-outdoor.render", "altered"),
    ("m360-indoor.render", "altered"),
])
def test_a_broken_timed_path_is_not_correct(capsys, workload, fault):
    rc, res, err = dry(capsys, workload, "--fault", fault)
    assert rc == 0, err
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("workload", ["m360-outdoor.train",
                                      "m360-indoor.render"])
def test_the_control_is_not_correct(capsys, workload):
    rc, res, err = dry(capsys, workload, "--control")
    assert rc == 0, err
    assert res["correct"] is False, res["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["m360-outdoor.render",
                                      "m360-indoor.render"])
def test_the_control_fails_at_the_cells_size(capsys, card, workload):
    from perfbench import run
    capsys.readouterr()
    rc = run.main(["--workload", workload, "--seed", "2147483999",
                   "--seconds", "1", "--control"])
    out, err = capsys.readouterr()
    assert rc == 0, err
    import json
    assert json.loads(out.strip().splitlines()[-1])["correct"] is False
