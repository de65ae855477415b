"""Checkpoints of the port (``gs2d_torch.models.io``) in the JAX package's
npz schema: a JAX checkpoint loads into the port, a port checkpoint loads
into the JAX package, and saving and restoring mid-training reproduces
the uninterrupted trajectory bit for bit (the CPU twin of
tests/test_resume.py)."""

import numpy as np
import torch

from gs2d_torch.config import OptimizationParams
from gs2d_torch.models.gaussians import init_from_pcd, state_from_numpy
from gs2d_torch.models.io import load_checkpoint, save_checkpoint
from gs2d_torch.train.optim import FIELDS, init_adam
from gs2d_torch.train.step import TrainState, make_train_step
from gs2d_tpu.models.io import load_checkpoint as j_load_checkpoint
from gs2d_tpu.models.io import save_checkpoint as j_save_checkpoint

from .test_torch_common import port_camera
from .test_torch_densify import _states
from .utils import random_cloud

STATS = ("max_radii2d", "grad_accum", "denom")


def _assert_same(a, b):
    """Two (state, opt) pairs of the port, bit for bit."""
    (sa, oa), (sb, ob) = a, b
    for f in FIELDS:
        for x, y in ((sa.params, sb.params), (oa.mu, ob.mu),
                     (oa.nu, ob.nu)):
            assert torch.equal(getattr(x, f), getattr(y, f)), f
    for f in STATS:
        assert torch.equal(getattr(sa, f), getattr(sb, f)), f
    assert sa.active_sh_degree == sb.active_sh_degree
    assert oa.step == ob.step


def test_jax_checkpoint_loads_into_the_port(tmp_path):
    js, jo, _, _ = _states(5, 0.005, 0.08)
    path = str(tmp_path / "jax.npz")
    j_save_checkpoint(path, js, jo, 1234, 2.5)
    state, opt, it, slr = load_checkpoint(path, device="cpu")
    assert (it, slr) == (1234, 2.5)
    act = np.asarray(js.active)
    ref = state_from_numpy(
        **{f: np.asarray(getattr(js.params, f)) for f in FIELDS},
        active=act, active_sh_degree=np.asarray(js.active_sh_degree),
        **{f: np.asarray(getattr(js, f)) for f in STATS}, device="cpu")
    assert state.params.xyz.shape[0] == int(act.sum())
    for f in FIELDS:
        assert torch.equal(getattr(state.params, f), getattr(ref.params, f))
        for mom in ("mu", "nu"):
            np.testing.assert_array_equal(
                getattr(getattr(opt, mom), f).numpy(),
                np.asarray(getattr(getattr(jo, mom), f))[act])
    for f in STATS:
        assert torch.equal(getattr(state, f), getattr(ref, f))
    assert opt.step == int(jo.step) and state.active_sh_degree == 3


def test_port_checkpoint_loads_into_jax(tmp_path):
    _, _, ts, to = _states(6, 0.005, 0.08)
    path = str(tmp_path / "port.npz")
    save_checkpoint(path, ts, to, 77, 1.25)
    js, jo, it, slr = j_load_checkpoint(path)
    assert (it, slr) == (77, 1.25)
    assert np.asarray(js.active).all()
    assert int(js.active_sh_degree) == 3 and int(jo.step) == to.step
    for f in FIELDS:
        for x, y in ((ts.params, js.params), (to.mu, jo.mu), (to.nu, jo.nu)):
            np.testing.assert_array_equal(getattr(x, f).numpy(),
                                          np.asarray(getattr(y, f)))
    for f in STATS:
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)))
    # and back into the port unchanged
    _assert_same(load_checkpoint(path, device="cpu")[:2], (ts, to))


def test_checkpoint_resume_bitexact(tmp_path):
    cam = port_camera(64, 32)
    means, scales, _, _, rgb, _ = random_cloud(20, 0, spread=0.8,
                                               scale_lo=0.1, scale_hi=0.3)
    state = init_from_pcd(means, rgb, init_scales=np.log(scales),
                          device="cpu")
    gt = torch.as_tensor(np.random.default_rng(1).random((3, 32, 64),
                                                         np.float32))
    bg = torch.zeros(3)
    step = make_train_step(OptimizationParams(), device="cpu")
    ts = TrainState(gaussians=state, opt=init_adam(state.params))

    ts_a = ts
    for i in range(1, 7):
        ts_a, _ = step(ts_a, cam, gt, i, bg)

    ts_b = ts
    for i in range(1, 4):
        ts_b, _ = step(ts_b, cam, gt, i, bg)
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, ts_b.gaussians, ts_b.opt, 3, 1.0)
    gs, opt, it, _ = load_checkpoint(path, device="cpu")
    assert it == 3
    _assert_same((gs, opt), (ts_b.gaussians, ts_b.opt))
    ts_c = TrainState(gaussians=gs, opt=opt)
    for i in range(4, 7):
        ts_c, _ = step(ts_c, cam, gt, i, bg)
    _assert_same((ts_a.gaussians, ts_a.opt), (ts_c.gaussians, ts_c.opt))
