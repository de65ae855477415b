"""Port parity of the forward kernel's plain version (the CPU side of
gs2d_torch/ops/rasterize/kernel_fwd.py) against the JAX package's Pallas
K1 in interpret mode, plus its tile subset, input checks and autograd.

Bar: 2e-4 (tests/test_rasterize_fwd.py:79-80); the median slot exactly.
"""

import numpy as np
import pytest
import torch

from gs2d_torch.ops.rasterize.api import pack_entries, rasterize
from gs2d_torch.ops.rasterize.binning import bin_gaussians as t_bin
from gs2d_torch.ops.rasterize.kernel_fwd import (rasterize_fwd,
                                                 rasterize_fwd_reference)
from gs2d_torch.ops.rasterize.oracle import rasterize_oracle as t_oracle
from gs2d_torch.ops.rasterize.preprocess import PreprocessOut
from gs2d_torch.ops.rasterize.preprocess import preprocess as t_preprocess
from gs2d_tpu.ops.rasterize.api import RasterizeConfig, _block_entries
from gs2d_tpu.ops.rasterize.api import pack_entries as j_pack
from gs2d_tpu.ops.rasterize.api import rasterize as j_rasterize
from gs2d_tpu.ops.rasterize.binning import bin_gaussians as j_bin
from gs2d_tpu.ops.rasterize.kernel_fwd import rasterize_fwd_pallas

from .test_torch_common import port_camera, to_t
from .test_torch_rasterize import _both
from .utils import random_cloud


def test_kernel_plain_version_matches_pallas_interpret():
    """The plain version of K1 against the Pallas K1 (interpret mode) on
    identical records: images at 2e-4 and the median slot per pixel."""
    w, h = 256, 128
    jp, _ = _both(w, h, random_cloud(200, 3))
    cfg = RasterizeConfig(width=w, height=h, pairs_capacity=1 << 14,
                          chunk=16, interpret=True, cull=False)
    j_img, _ = j_rasterize(jp, cfg)
    jb = j_bin(jp.center2d, jp.extent, jp.depth, jp.visible, w, h,
               1 << 14, 16)
    j_out, j_med = rasterize_fwd_pallas(
        _block_entries(j_pack(jp), jb.gid, 16), jb.tile_start,
        jb.tile_count, width=w, height=h, chunk=16, interpret=True)

    tp = PreprocessOut(*(to_t(x) for x in jp))
    tb = t_bin(tp.center2d, tp.extent, tp.depth, tp.visible, w, h)
    out, med, ncon = rasterize_fwd(pack_entries(tp), tb.gid, tb.tile_start,
                                   tb.tile_count, w, h)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(med.numpy(),
                                  np.asarray(j_med)[:, 0].astype(np.int32))
    img, _ = rasterize(tp, w, h, cull=False)
    np.testing.assert_allclose(img.numpy(), np.asarray(j_img),
                               rtol=2e-4, atol=2e-4)
    # n_contrib: one past the last composited slot, so it bounds med_idx
    assert (ncon.numpy() > np.asarray(j_med)[:, 0]).all()


def test_plain_version_tile_subset_and_checks():
    """``tiles=`` returns exactly those tiles; bad inputs raise."""
    _, tp = _both(128, 64, random_cloud(120, 9))
    b = t_bin(tp.center2d, tp.extent, tp.depth, tp.visible, 128, 64)
    args = (pack_entries(tp), b.gid, b.tile_start, b.tile_count, 128, 64)
    full = rasterize_fwd_reference(*args)
    tiles = [15, 3, 7]
    sub = rasterize_fwd_reference(*args, tiles=tiles)
    for a, s in zip(full, sub):
        assert torch.equal(a[tiles], s)
    with pytest.raises(ValueError):
        rasterize_fwd(args[0].double(), *args[1:])
    with pytest.raises(ValueError):
        rasterize_fwd(args[0], b.gid.long(), *args[2:])
    with pytest.raises(ValueError):
        rasterize_fwd(*args[:4], 64, 64)


def test_cpu_path_differentiable_like_oracle():
    """On the CPU, autograd through the plain version matches autograd
    through the oracle (rgb, alpha and depth channels; rtol/atol 1e-3 on
    gradients normalised by their scale, tests/test_rasterize_bwd.py:55)."""
    means, scales, quats, opac, rgb, noise = random_cloud(40, 13)
    cam = port_camera(64, 32)

    def grads(fn):
        ps = [to_t(x).requires_grad_() for x in (means, scales, opac, rgb)]
        pre = t_preprocess(ps[0], ps[1], to_t(quats), ps[2],
                           cam.world_view, cam.full_proj, cam.campos, 64, 32,
                           colors=ps[3])
        out = fn(pre)
        (out[0:5] * torch.linspace(0.5, 1.5, 5)[:, None, None]).sum() \
            .backward()
        return [p.grad for p in ps]

    g_tiled = grads(lambda p: rasterize(p, 64, 32)[0])
    g_oracle = grads(lambda p: t_oracle(p, 64, 32))
    for a, b in zip(g_tiled, g_oracle):
        scale = b.abs().max().clamp(min=1e-6)
        torch.testing.assert_close(a / scale, b / scale, rtol=1e-3,
                                   atol=5e-4)
