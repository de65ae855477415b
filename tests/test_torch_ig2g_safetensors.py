"""The port's safetensors codec (gs2d_torch/utils/safetensors.py) against
the ``safetensors`` package, and the SD weight loader
(gs2d_torch/ig2g/sd_weights.py) on snapshots it writes.

- The port's writer read by ``safetensors.torch.load_file`` (and, for F32
  and F16, ``safetensors.numpy.load_file``), and the package's writer read
  by the port: names, shapes, dtypes and every bit equal, for F32, F16 and
  BF16; the port's metadata read by the package.
- A TINY snapshot written by the port loads through ``load_unet``,
  ``load_vae`` and ``load_text_encoder`` bit for bit in the dtype stored
  (F16 on disk loads as float16, and as the F32 of the same values when
  float32 is asked for), and through the JAX package's loader; a
  wrong shape or a missing name raises naming it, as
  tests/test_sdnet.py:148-190 expects of the JAX loader; without weights
  the SD backend raises naming $GS2D_SD_WEIGHTS.
"""

import os

import jax
import numpy as np
import pytest
import safetensors.numpy
import safetensors.torch
import torch

from gs2d_torch.ig2g import clip_text as TC
from gs2d_torch.ig2g import sd_weights as TW
from gs2d_torch.ig2g import sdnet as T
from gs2d_torch.ig2g import vae as TV
from gs2d_torch.ig2g.ip2p import TorchSDBackend
from gs2d_torch.utils import safetensors as port_st
from gs2d_tpu.ig2g import sdnet as J

from .test_torch_common import one_torch_thread  # noqa: F401

DTYPES = [torch.float32, torch.float16, torch.bfloat16]


def _tensors(seed):
    g = torch.Generator().manual_seed(seed)
    out = {}
    for i, dt in enumerate(DTYPES):
        out[f"layer.{i}.weight"] = torch.randn((5, 3, 2), generator=g).to(dt)
        out[f"layer.{i}.bias"] = torch.randn((7,), generator=g).to(dt)
        out[f"layer.{i}.scalar"] = torch.randn((), generator=g).to(dt)
        out[f"layer.{i}.empty"] = torch.zeros((0, 4), dtype=dt)
    out["odd.f16"] = torch.randn((3,), generator=g).half()   # misaligns
    out["after.f32"] = torch.randn((2, 2), generator=g)      # what follows
    return out


def _bits(t):
    return t.view(torch.int16) if t.element_size() == 2 else \
        t.view(torch.int32)


def _same(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert torch.equal(_bits(a[k]), _bits(b[k])), k


def test_port_writer_read_by_safetensors(tmp_path):
    ts = _tensors(0)
    path = str(tmp_path / "a.safetensors")
    port_st.save_file(ts, path, metadata={"format": "pt"})
    _same(safetensors.torch.load_file(path), ts)
    with safetensors.safe_open(path, "pt") as f:
        assert f.metadata() == {"format": "pt"}
    plain = {k: v for k, v in ts.items() if v.dtype != torch.bfloat16}
    path2 = str(tmp_path / "b.safetensors")
    port_st.save_file(plain, path2)
    got = safetensors.numpy.load_file(path2)
    for k, v in plain.items():
        assert got[k].dtype == v.numpy().dtype
        assert got[k].tobytes() == v.numpy().tobytes(), k


def test_safetensors_writer_read_by_port(tmp_path):
    ts = _tensors(1)
    path = str(tmp_path / "c.safetensors")
    safetensors.torch.save_file(ts, path, metadata={"k": "v"})
    _same(port_st.load_file(path), ts)


def test_codec_refuses_other_dtypes(tmp_path):
    path = str(tmp_path / "d.safetensors")
    with pytest.raises(ValueError, match="int64"):
        port_st.save_file({"x": torch.zeros(2, dtype=torch.int64)}, path)
    safetensors.torch.save_file({"x": torch.zeros(2, dtype=torch.int64)},
                                path)
    with pytest.raises(ValueError, match="I64"):
        port_st.load_file(path)


def _tiny_jax_params():
    from gs2d_tpu.ig2g import clip_text as JC
    from gs2d_tpu.ig2g import vae as JV
    return {
        "unet": J.init_params(J.unet_param_shapes(J.TINY_UNET),
                              jax.random.PRNGKey(0)),
        "vae": J.init_params(JV.vae_param_shapes(JV.TINY_VAE),
                             jax.random.PRNGKey(1)),
        "text_encoder": J.init_params(JC.clip_param_shapes(JC.TINY_CLIP),
                                      jax.random.PRNGKey(2))}


FILES = {"unet": "diffusion_pytorch_model.safetensors",
         "vae": "diffusion_pytorch_model.safetensors",
         "text_encoder": "model.safetensors"}


def _snapshot(root, params, dtype):
    for sub, p in params.items():
        os.makedirs(root / sub, exist_ok=True)
        port_st.save_file({k: torch.as_tensor(np.array(v)).to(dtype)
                           for k, v in p.items()},
                          str(root / sub / FILES[sub]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_loader_on_a_snapshot_the_port_wrote(tmp_path, dtype):
    params = _tiny_jax_params()
    _snapshot(tmp_path, params, dtype)
    loaded = {"unet": TW.load_unet(str(tmp_path), T.TINY_UNET, device="cpu"),
              "vae": TW.load_vae(str(tmp_path), TV.TINY_VAE, device="cpu"),
              "text_encoder": TW.load_text_encoder(str(tmp_path),
                                                   TC.TINY_CLIP,
                                                   device="cpu")}
    as_f32 = {"unet": TW.load_unet(str(tmp_path), T.TINY_UNET, device="cpu",
                                   dtype=torch.float32),
              "vae": TW.load_vae(str(tmp_path), TV.TINY_VAE, device="cpu",
                                 dtype=torch.float32),
              "text_encoder": TW.load_text_encoder(
                  str(tmp_path), TC.TINY_CLIP, device="cpu",
                  dtype=torch.float32)}
    for sub, module in loaded.items():
        sd, sd32 = module.state_dict(), as_f32[sub].state_dict()
        assert sorted(sd) == sorted(params[sub])
        for k, v in params[sub].items():
            want = torch.as_tensor(np.array(v)).to(dtype)
            assert sd[k].dtype == dtype and sd32[k].dtype == torch.float32
            assert torch.equal(sd[k], want), (sub, k)
            assert torch.equal(sd32[k], want.float()), (sub, k)
    if dtype == torch.float32:
        from gs2d_tpu.ig2g import sd_weights as JW
        up = JW.load_unet(str(tmp_path), J.TINY_UNET)
        for k, v in up.items():
            np.testing.assert_array_equal(np.asarray(v),
                                          np.asarray(params["unet"][k]))


def test_loader_rejects_wrong_shapes_and_missing_names(tmp_path):
    unet_p = {k: np.asarray(v) for k, v in
              J.init_params(J.unet_param_shapes(J.TINY_UNET),
                            jax.random.PRNGKey(0)).items()}
    bad = dict(unet_p)
    bad["conv_in.weight"] = bad["conv_in.weight"][:, :1]
    _snapshot(tmp_path / "bad", {"unet": bad}, torch.float32)
    with pytest.raises(ValueError, match="conv_in.weight"):
        TW.load_unet(str(tmp_path / "bad"), T.TINY_UNET, device="cpu")
    gone = dict(unet_p)
    del gone["conv_out.bias"]
    _snapshot(tmp_path / "gone", {"unet": gone}, torch.float32)
    with pytest.raises(ValueError, match="missing 1 params.*conv_out.bias"):
        TW.load_unet(str(tmp_path / "gone"), T.TINY_UNET, device="cpu")
    with pytest.raises(FileNotFoundError, match="GS2D_SD_WEIGHTS"):
        TW.load_vae(str(tmp_path / "gone"), TV.TINY_VAE, device="cpu")


def test_weights_root_and_backend_without_weights(monkeypatch, tmp_path):
    monkeypatch.delenv("GS2D_SD_WEIGHTS", raising=False)
    assert TW.weights_root() is None
    with pytest.raises(FileNotFoundError, match="GS2D_SD_WEIGHTS"):
        TorchSDBackend(device="cpu")
    monkeypatch.setenv("GS2D_SD_WEIGHTS", str(tmp_path / "nowhere"))
    with pytest.raises(FileNotFoundError, match="not a directory"):
        TW.weights_root()
    monkeypatch.setenv("GS2D_SD_WEIGHTS", str(tmp_path))
    assert TW.weights_root() == str(tmp_path)
