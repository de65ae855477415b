"""Port parity of the backward: K2's plain version (the CPU side of
gs2d_torch/ops/rasterize/kernel_bwd.py), the per-Gaussian reduction and
gradients through the port's ``rasterize`` against the JAX package.

Bar: the gradient bar of tests/test_rasterize_bwd.py:50-57, rtol 1e-3 /
atol 5e-4 on values normalised by each field's largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs2d_torch.ops.rasterize.api import (pack_entries, rasterize,
                                          reduce_slot_grads)
from gs2d_torch.ops.rasterize.binning import bin_gaussians as t_bin
from gs2d_torch.ops.rasterize.common import DENTRY_F
from gs2d_torch.ops.rasterize.kernel_bwd import (rasterize_bwd,
                                                 rasterize_bwd_reference)
from gs2d_torch.ops.rasterize.kernel_fwd import rasterize_fwd_reference
from gs2d_torch.ops.rasterize.preprocess import preprocess as t_preprocess
from gs2d_tpu.ops.rasterize.api import RasterizeConfig
from gs2d_tpu.ops.rasterize.api import rasterize as j_rasterize
from gs2d_tpu.ops.rasterize.preprocess import preprocess as j_preprocess

from .test_torch_common import port_camera, to_t
from .utils import lookat_camera, random_cloud

RTOL, ATOL = 1e-3, 5e-4
# DFLD fields of the 22-float gradient row (common.py)
FIELDS = {"A": slice(0, 3), "B": slice(3, 6), "C": slice(6, 9),
          "c2": slice(9, 12), "opacity": slice(12, 13),
          "rgb": slice(13, 16), "normal": slice(16, 19),
          "noise": slice(19, 22)}
CASES = [(0, 60, None), (2, 120, 0.9)]      # tests/test_rasterize_bwd.py:28


def assert_grad_close(got, ref, what):
    got, ref = np.asarray(got), np.asarray(ref)
    scale = max(np.abs(ref).max(), 1e-6)
    np.testing.assert_allclose(got / scale, ref / scale, rtol=RTOL,
                               atol=ATOL, err_msg=what)


def _scene(seed, n, opaque):
    means, scales, quats, opac, rgb, noise = random_cloud(n, seed)
    if opaque is not None:
        opac = np.full_like(opac, opaque)
    return (means, scales, quats, opac, rgb, noise)


def _kernel_inputs(seed, n, opaque, w=128, h=64):
    means, scales, quats, opac, rgb, noise = _scene(seed, n, opaque)
    cam = port_camera(w, h)
    pre = t_preprocess(to_t(means), to_t(scales), to_t(quats), to_t(opac),
                       cam.world_view, cam.full_proj, cam.campos, w, h,
                       colors=to_t(rgb), noise=to_t(noise))
    b = t_bin(pre.center2d, pre.extent, pre.depth, pre.visible, w, h)
    return pack_entries(pre), b


@pytest.mark.parametrize("seed,n,opaque", CASES)
def test_plain_version_matches_autograd_of_forward(seed, n, opaque):
    """Per-slot rows of rasterize_bwd_reference against autograd through
    rasterize_fwd_reference, with one record per slot (packed[gid],
    gid = arange(P)) so that autograd yields per-slot rows."""
    w, h = 128, 64
    packed, b = _kernel_inputs(seed, n, opaque)
    P = b.num_pairs
    assert P > 0
    rows = packed[b.gid.long()].detach().requires_grad_()
    ident = torch.arange(P, dtype=torch.int32)
    out, med, nc = rasterize_fwd_reference(rows, ident, b.tile_start,
                                           b.tile_count, w, h)
    cot = torch.as_tensor(np.random.default_rng(seed + 100).normal(
        size=tuple(out.shape)).astype(np.float32))
    (out * cot).sum().backward()
    auto = torch.cat([rows.grad[:, :12], rows.grad[:, 14:]], dim=1)

    d = rasterize_bwd_reference(packed, b.gid, b.tile_start, b.tile_count,
                                out.detach(), cot, med, nc, w, h)
    assert d.shape == (P, DENTRY_F)
    for name, sl in FIELDS.items():
        assert_grad_close(d[:, sl], auto[:, sl], name)


def test_plain_version_tiles_and_checks():
    """``tiles=`` gives exactly those tiles' slot rows; slots no pixel
    reached are zero; bad inputs raise."""
    w, h = 128, 64
    packed, b = _kernel_inputs(9, 120, None)
    out, med, nc = rasterize_fwd_reference(packed, b.gid, b.tile_start,
                                           b.tile_count, w, h)
    cot = torch.ones_like(out)
    args = (packed, b.gid, b.tile_start, b.tile_count, out, cot, med, nc,
            w, h)
    full = rasterize_bwd(*args)
    tiles = [9, 2, 5]
    sub = rasterize_bwd_reference(*args, tiles=tiles)
    idx = torch.cat([torch.arange(int(b.tile_start[t]),
                                  int(b.tile_start[t] + b.tile_count[t]))
                     for t in tiles])
    assert torch.equal(full[idx], sub)
    for t in range(out.shape[0]):
        s, c = int(b.tile_start[t]), int(b.tile_count[t])
        assert (full[s + int(nc[t].max()):s + c] == 0).all()
    with pytest.raises(ValueError):
        rasterize_bwd(*args[:5], cot.double(), *args[6:])
    with pytest.raises(ValueError):
        rasterize_bwd(*args[:6], med.long(), *args[7:])
    with pytest.raises(ValueError):
        rasterize_bwd(*args[:5], cot[:-1], *args[6:])


def test_reduction_matches_scatter_add():
    """reduce_slot_grads (perm → segment sum → order) against a plain
    index_add_ of the slot rows by Gaussian id, center columns zero."""
    packed, b = _kernel_inputs(3, 150, None)
    n = packed.shape[0]
    rows = torch.as_tensor(np.random.default_rng(3).normal(
        size=(b.num_pairs, DENTRY_F)).astype(np.float32))
    got = reduce_slot_grads(rows, b, n)
    ref = torch.zeros((n, DENTRY_F)).index_add_(0, b.gid.long(), rows)
    assert got.shape == (n, 24)
    assert (got[:, 12:14] == 0).all()
    torch.testing.assert_close(torch.cat([got[:, :12], got[:, 14:]], 1),
                               ref, rtol=1e-5, atol=1e-5)
    # empty scene: no pairs, zero rows
    empty = t_bin(torch.zeros((4, 2)), torch.ones((4, 2)), torch.ones(4),
                  torch.zeros(4, dtype=torch.bool), 64, 32)
    assert empty.num_pairs == 0
    z = reduce_slot_grads(torch.zeros((0, DENTRY_F)), empty, 4)
    assert z.shape == (4, 24) and (z == 0).all()


def _j_loss(cam, cfg, cot):
    def loss(means, scales, quats, opac, rgb, noise, offsets):
        pre = j_preprocess(means, scales, quats, opac, cam.world_view,
                           cam.full_proj, cam.campos, cam.width, cam.height,
                           colors=rgb, noise=noise, screen_offsets=offsets)
        out, _ = j_rasterize(pre, cfg)
        return jnp.sum(out * cot)
    return loss


def _t_grads(arrays, w, h, cot, poison_row=None, cull=True):
    cam = port_camera(w, h)
    ps = [to_t(x).requires_grad_() for x in arrays]
    means, scales, quats, opac, rgb, noise, offsets = ps
    pre = t_preprocess(means, scales, quats, opac, cam.world_view,
                       cam.full_proj, cam.campos, w, h, colors=rgb,
                       noise=noise, screen_offsets=offsets)
    if poison_row is not None:
        bad = torch.zeros_like(pre.A)
        bad[poison_row] = float("inf")
        pre = pre._replace(A=pre.A + bad)
    out, _ = rasterize(pre, w, h, cull=cull)
    return torch.autograd.grad((out * cot).sum(), ps)


@pytest.mark.parametrize("seed,n,opaque", CASES)
def test_rasterize_grads_match_jax(seed, n, opaque):
    """Gradients of all 7 inputs (screen offsets included) through the
    port's rasterize against jax.grad through the JAX rasterize (Pallas K2
    in interpret mode, un-culled, chunk 16)."""
    w, h = 128, 64
    arrays = _scene(seed, n, opaque) + (np.zeros((n, 2), np.float32),)
    cot = np.random.default_rng(seed + 100).normal(
        size=(15, h, w)).astype(np.float32)
    cfg = RasterizeConfig(width=w, height=h, pairs_capacity=1 << 13,
                          chunk=16, interpret=True, cull=False)
    g_jax = jax.grad(_j_loss(lookat_camera(w, h), cfg, jnp.asarray(cot)),
                     argnums=tuple(range(7)))(
                         *(jnp.asarray(x) for x in arrays))
    g_port = _t_grads(arrays, w, h, to_t(cot), cull=False)
    names = ["means", "scales", "quats", "opac", "rgb", "noise", "offsets"]
    for name, a, b in zip(names, g_jax, g_port):
        assert_grad_close(b.numpy(), a, name)


@pytest.mark.parametrize("seed,n,opaque", CASES)
def test_rasterize_grads_match_jax_culled(seed, n, opaque):
    """The same with the interval cull on in both packages (the JAX
    default, RasterizeConfig.cull=True): the kernels see the culled lists,
    and gradients stay at the gradient bar."""
    w, h = 128, 64
    arrays = _scene(seed, n, opaque) + (np.zeros((n, 2), np.float32),)
    cot = np.random.default_rng(seed + 100).normal(
        size=(15, h, w)).astype(np.float32)
    cfg = RasterizeConfig(width=w, height=h, pairs_capacity=1 << 13,
                          chunk=16, interpret=True, cull=True)
    g_jax = jax.grad(_j_loss(lookat_camera(w, h), cfg, jnp.asarray(cot)),
                     argnums=tuple(range(7)))(
                         *(jnp.asarray(x) for x in arrays))
    g_port = _t_grads(arrays, w, h, to_t(cot), cull=True)
    names = ["means", "scales", "quats", "opac", "rgb", "noise", "offsets"]
    for name, a, b in zip(names, g_jax, g_port):
        assert_grad_close(b.numpy(), a, name)


def test_screen_offset_grad_nonzero():
    """Twin of tests/test_rasterize_bwd.py::test_screen_offset_grad_nonzero:
    the densification side channel carries signal."""
    w, h = 128, 64
    arrays = random_cloud(40, 1) + (np.zeros((40, 2), np.float32),)
    cot = torch.zeros((15, h, w))
    cot[0:3] = 1.0
    g = _t_grads(arrays, w, h, cot)[6]
    assert float(g.abs().max()) > 0.0


def test_nonfinite_entry_does_not_poison_grads():
    """Twin of tests/test_rasterize_bwd.py::
    test_nonfinite_entry_does_not_poison_grads: a Gaussian whose A
    coefficients go to inf after preprocess composites as zero and gives
    finite (zero) gradients, not NaN."""
    w, h = 64, 32
    arrays = random_cloud(30, 4) + (np.zeros((30, 2), np.float32),)
    g = _t_grads(arrays, w, h, torch.ones((15, h, w)), poison_row=3)
    for gi in g[:4]:
        assert torch.isfinite(gi).all(), "NaN/Inf leaked into grads"
