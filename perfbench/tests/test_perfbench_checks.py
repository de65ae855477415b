"""The comparison that decides ``correct`` fails its control (the
reference in bfloat16 in the program's place) and each fault that a cell
can have, with the timed path broken underneath: on the CPU at a tiny
size, and on a card at the cell's own size (marked ``cuda``)."""

import dataclasses

import pytest

from .conftest import dry


@pytest.mark.parametrize("workload,fault", [
    ("m360-outdoor.train", "unchanged"),
    ("m360-outdoor.train", "half_batch"),
    ("m360-indoor.train", "half_batch"),
    ("dtu-object.train", "unchanged"),
    ("dtu-object.train", "half_batch"),
    ("m360-outdoor.render", "altered"),
    ("m360-indoor.render", "altered"),
])
def test_a_broken_timed_path_is_not_correct(capsys, workload, fault):
    rc, res, err = dry(capsys, workload, "--fault", fault)
    assert rc == 0, err
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("workload", ["m360-outdoor.train",
                                      "m360-indoor.render",
                                      "dtu-object.train"])
def test_the_control_is_not_correct(capsys, workload):
    rc, res, err = dry(capsys, workload, "--control")
    assert rc == 0, err
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("off", ["lambda_dist", "depth_ratio"])
def test_the_program_off_its_configuration_is_not_correct(capsys,
                                                          monkeypatch, off):
    """The DTU object's training cell sees a program that drops the
    distortion loss, or takes the expected depth in place of the median
    one: the run's own settings reach the reference, not the program's."""
    from gs2d_torch.render import renderer
    from gs2d_torch.train import step
    if off == "lambda_dist":
        losses = step.compute_losses
        monkeypatch.setattr(step, "compute_losses", lambda pkg, gt, it, o:
                            losses(pkg, gt, it,
                                   dataclasses.replace(o, lambda_dist=0.0)))
    else:
        bridge = renderer.bridge
        monkeypatch.setattr(renderer, "bridge",
                            lambda cam, pre, out, aux, bg, depth_ratio=0.0:
                            bridge(cam, pre, out, aux, bg, 0.0))
    rc, res, err = dry(capsys, "dtu-object.train")
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
