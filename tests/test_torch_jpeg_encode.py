"""The port's JPEG encoder (``gs2d_torch/scene/jpeg.py::encode_jpeg``, the
pixel stages in torch, the Huffman coding in ``csrc/jpeg_entropy.cpp``)
against PIL 12.1 / libjpeg-turbo's ``save(quality=95, subsampling=0)``:
the same bytes for RGB and gray at 1x1, 7x9, 37x53, at sizes hypothesis
draws up to 64 px, at other qualities, and for a 1080p render; the port's
decoder reads them back as PIL does; what the encoder does not write
raises naming the file."""

import io
import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from gs2d_torch.scene.images import decode_image
from gs2d_torch.scene.jpeg import encode_jpeg
from gs2d_torch.utils import synthetic_scene as ss

from .test_torch_common import one_torch_thread  # noqa: F401


def _pil_bytes(img, quality=95):
    buf = io.BytesIO()
    Image.fromarray(img, "L" if img.ndim == 2 else "RGB").save(
        buf, "JPEG", quality=quality, subsampling=0)
    return buf.getvalue()


def _image(h, w, channels, seed):
    """Half smooth, half noise, so that long zero runs (ZRL) and large
    coefficients both occur."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    smooth = 128 + 90 * np.sin(xx / 4.0) * np.cos(yy / 6.0)
    noise = rng.integers(0, 256, (h, w))
    base = np.where(xx < w // 2, smooth, noise)
    if channels == 1:
        return base.astype(np.uint8)
    return np.stack([base, 255 - base, np.roll(base, 3, 1)],
                    -1).astype(np.uint8)


def _ours(tmp_path, img, **kw):
    path = tmp_path / "ours.jpg"
    encode_jpeg(str(path), img, **kw)
    return path.read_bytes()


@pytest.mark.parametrize("hw", [(1, 1), (7, 9), (37, 53)],
                         ids=["1x1", "7x9", "37x53"])
@pytest.mark.parametrize("channels", [3, 1], ids=["rgb", "gray"])
def test_bytes_equal_pil(tmp_path, hw, channels):
    img = _image(*hw, channels, seed=hw[0] * 7 + channels)
    data = _ours(tmp_path, img)
    assert data == _pil_bytes(img)
    back = decode_image(str(tmp_path / "ours.jpg"), "cpu")
    np.testing.assert_array_equal(
        back, np.asarray(Image.open(io.BytesIO(data))))


@settings(max_examples=30, deadline=None)
@given(h=st.integers(1, 64), w=st.integers(1, 64),
       channels=st.sampled_from([1, 3]), seed=st.integers(0, 2**16))
def test_hypothesis_sizes_equal_pil(tmp_path_factory, h, w, channels, seed):
    img = _image(h, w, channels, seed)
    assert _ours(tmp_path_factory.mktemp("enc"), img) == _pil_bytes(img)


@pytest.mark.parametrize("quality", [100, 75, 50, 10, 1])
def test_other_qualities_equal_pil(tmp_path, quality):
    img = _image(24, 40, 3, seed=quality)
    assert _ours(tmp_path, img, quality=quality) == _pil_bytes(img, quality)


def test_tensor_input_and_a_trailing_channel(tmp_path):
    img = _image(16, 24, 1, seed=3)
    assert _ours(tmp_path, torch.from_numpy(img)) == _pil_bytes(img)
    assert _ours(tmp_path, img[..., None]) == _pil_bytes(img)


def test_1080p_render_equals_pil(tmp_path):
    """A 1920x1080 render of the coloured torus by the port's renderer on
    the CPU."""
    r = ss.SurfelRenderer(ss.torus_surfels(1500), device="cpu")
    img = r.rgba(ss.orbit(1)[0], 1920, 1080, math.radians(50.0))[..., :3]
    assert img.std() > 10
    assert _ours(tmp_path, img) == _pil_bytes(img)


@pytest.mark.parametrize("img,kw,why", [
    (np.zeros((8, 8, 4), np.uint8), {}, "shape"),
    (np.zeros((8, 8, 2), np.uint8), {}, "shape"),
    (np.zeros((8, 8, 3), np.float32), {}, "float32"),
    (np.zeros((0, 8, 3), np.uint8), {}, "shape"),
    (np.zeros((8, 8, 3), np.uint8), {"subsampling": 2}, "subsampling"),
], ids=["rgba", "gray_alpha", "float", "empty", "subsampled"])
def test_what_it_does_not_write_raises(tmp_path, img, kw, why):
    path = str(tmp_path / "x.jpg")
    with pytest.raises(ValueError, match=why) as e:
        encode_jpeg(path, img, **kw)
    assert path in str(e.value)
