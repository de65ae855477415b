"""The port's JPEG decoder (gs2d_torch/scene/jpeg.py) against PIL.

PIL (12.1, libjpeg-turbo 3.1) writes the JPEGs and decodes them; the port
must give ``np.asarray(PIL.Image.open(path))`` byte for byte (tolerance 0)
through both entropy decoders, the C one of the main path
(``csrc/jpeg_entropy.cpp``, built with ``c++`` at first use) and the
Python one, with the pixel stages on CPU tensors:

- odd sizes under every sampling factor (4:4:4, 4:2:2, 4:2:0 by PIL;
  4:4:0 by OpenCV, as PIL writes none), restart markers, optimised
  Huffman tables, grayscale, EXIF, and sizes, qualities and restart
  intervals drawn by hypothesis up to 64 px;
- the committed fixtures (tests/fixtures/jpeg, written by
  ``make_fixtures.py``) equal to their PIL decodes stored beside them;
- every unsupported kind (progressive, lossless, arithmetic-coded,
  12-bit, CMYK, Adobe RGB, 4:1:1, truncated, not a JPEG) raises a
  ValueError that names the file.
"""

import json
from pathlib import Path

import cv2
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from gs2d_torch.scene import images, jpeg

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "jpeg"


def _picture(h, w, seed=0, gray=False):
    """Smooth gradients with noise: every coefficient band is used."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(x / (5 + 3 * i) + y / (9 + 2 * i))
                    for i in range(3)], -1)
    img = np.clip(img + rng.normal(0, 25, img.shape), 0, 255).astype(
        np.uint8)
    return img[..., 0] if gray else img


def _write(path, img, sampling=None, **opts):
    if sampling == "4:4:0" or sampling == "4:1:1":
        flag = {"4:4:0": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
                "4:1:1": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}[sampling]
        bgr = np.ascontiguousarray(img[..., ::-1])
        assert cv2.imwrite(str(path), bgr, [
            cv2.IMWRITE_JPEG_QUALITY, opts.get("quality", 90),
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, flag])
        return
    if sampling is not None:
        opts["subsampling"] = sampling
    Image.fromarray(img).save(path, **opts)


def _assert_both_exact(path):
    ref = np.asarray(Image.open(path))
    coefs = {}
    for entropy in ("c", "plain"):
        c = jpeg.read_coefficients(str(path), entropy)
        coefs[entropy] = [x.coef for x in c.components]
        got = jpeg.pixels(c, "cpu").numpy()
        assert got.shape == ref.shape and got.dtype == np.uint8
        np.testing.assert_array_equal(got, ref, err_msg=entropy)
    for a, b in zip(coefs["c"], coefs["plain"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("sampling", ["4:4:4", "4:2:2", "4:2:0", "4:4:0"])
@pytest.mark.parametrize("size", [(97, 61), (33, 130), (5, 3)])
def test_sampling_factors_match_pil(tmp_path, sampling, size):
    h, w = size
    path = tmp_path / "a.jpg"
    _write(path, _picture(h, w), sampling, quality=92)
    got = jpeg.read_coefficients(str(path), "plain").components
    hv = {"4:4:4": (1, 1), "4:2:2": (2, 1), "4:2:0": (2, 2),
          "4:4:0": (1, 2)}[sampling]
    assert (got[0].h, got[0].v) == hv and (got[1].h, got[1].v) == (1, 1)
    _assert_both_exact(path)


@pytest.mark.parametrize("opts", [
    {"restart_marker_blocks": 3, "subsampling": 2},
    {"restart_marker_rows": 1, "subsampling": 0},
    {"optimize": True, "subsampling": 1, "quality": 60},
    {"quality": 100, "subsampling": 2},
    {"exif": b"Exif\x00\x00MM\x00*\x00\x00\x00\x08\x00\x01\x01\x12\x00\x03"
             b"\x00\x00\x00\x01\x00\x06\x00\x00\x00\x00\x00\x00"},
], ids=["restart-blocks", "restart-rows", "optimize", "q100", "exif"])
def test_writer_options_match_pil(tmp_path, opts):
    path = tmp_path / "b.jpg"
    Image.fromarray(_picture(75, 123, seed=2)).save(path, **opts)
    _assert_both_exact(path)


def test_grayscale_matches_pil(tmp_path):
    path = tmp_path / "g.jpg"
    Image.fromarray(_picture(45, 77, gray=True)).save(path, quality=85)
    assert np.asarray(Image.open(path)).ndim == 2
    _assert_both_exact(path)


@settings(max_examples=30, deadline=None)
@given(h=st.integers(1, 64), w=st.integers(1, 64),
       sampling=st.sampled_from([0, 1, 2, "4:4:0", "gray"]),
       quality=st.integers(5, 100), restart=st.integers(0, 4),
       seed=st.integers(0, 2 ** 16))
def test_hypothesis_sizes_match_pil(tmp_path_factory, h, w, sampling,
                                    quality, restart, seed):
    path = tmp_path_factory.mktemp("hyp") / "h.jpg"
    if sampling == "gray":
        Image.fromarray(_picture(h, w, seed, gray=True)).save(
            path, quality=quality, restart_marker_blocks=restart)
    elif sampling == "4:4:0":
        _write(path, _picture(h, w, seed), "4:4:0", quality=quality)
    else:
        Image.fromarray(_picture(h, w, seed)).save(
            path, quality=quality, subsampling=sampling,
            restart_marker_blocks=restart)
    _assert_both_exact(path)


def _fixtures():
    return json.loads((FIXTURES / "index.json").read_text())


@pytest.mark.parametrize("name", sorted(
    n for n, e in _fixtures().items() if "decoded" in e))
def test_committed_fixtures_equal_their_pil_decodes(name):
    entry = _fixtures()[name]
    ref = images.decode_png(str(FIXTURES / entry["decoded"]))
    path = str(FIXTURES / name)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), ref)
    assert images.image_size(path) == tuple(entry["size"])
    np.testing.assert_array_equal(images.decode_image(path, "cpu"), ref)
    if max(entry["size"]) <= 400:       # the large ones: C decoder only
        _assert_both_exact(path)


def _patched(tmp_path, name, edit):
    src = tmp_path / "src.jpg"
    Image.fromarray(_picture(24, 40)).save(src, quality=90)
    data = bytearray(src.read_bytes())
    sof = data.index(b"\xff\xc0")
    edit(data, sof)
    out = tmp_path / name
    out.write_bytes(bytes(data))
    return out


def _set(offset, value):
    def edit(data, sof):
        data[sof + offset] = value
    return edit


@pytest.mark.parametrize("kind,why", [
    ("progressive", "progressive"),
    ("lossless", "lossless"),
    ("arithmetic", "arithmetic-coded"),
    ("12bit", "12-bit"),
    ("cmyk", "CMYK"),
    ("adobe_rgb", "RGB JPEG"),
    ("411", "sampling factors"),
    ("truncated", "ends"),
    ("not_jpeg", "not a JPEG"),
])
def test_unsupported_kinds_raise_and_name_the_file(tmp_path, kind, why):
    pic = _picture(24, 40)
    if kind == "progressive":
        path = tmp_path / "p.jpg"
        Image.fromarray(pic).save(path, progressive=True)
    elif kind == "lossless":
        path = _patched(tmp_path, "l.jpg", _set(1, 0xC3))
    elif kind == "arithmetic":
        path = _patched(tmp_path, "a.jpg", _set(1, 0xC9))
    elif kind == "12bit":
        path = _patched(tmp_path, "t.jpg", _set(4, 12))
    elif kind == "cmyk":
        path = tmp_path / "c.jpg"
        Image.fromarray(pic).convert("CMYK").save(path)
    elif kind == "adobe_rgb":
        path = tmp_path / "r.jpg"
        Image.fromarray(pic).save(path, keep_rgb=True)
    elif kind == "411":
        path = tmp_path / "f.jpg"
        _write(path, pic, "4:1:1")
    elif kind == "truncated":
        path = tmp_path / "x.jpg"
        Image.fromarray(pic).save(path, quality=95)
        data = path.read_bytes()
        sos = data.index(b"\xff\xda")
        path.write_bytes(data[:(sos + len(data)) // 2])
    else:
        path = tmp_path / "n.jpg"
        path.write_bytes(b"GIF89a" + bytes(40))
    for entropy in ("c", "plain"):
        with pytest.raises(ValueError, match=why) as e:
            jpeg.read_coefficients(str(path), entropy)
        assert str(path) in str(e.value)
    with pytest.raises(ValueError) as e:
        images.decode_image(str(path), "cpu")
    assert str(path) in str(e.value)


def test_dispatch_reads_the_magic_bytes_not_the_extension(tmp_path):
    """Mip-NeRF 360 names its JPEGs *.JPG; a PNG named .JPG and a JPEG
    named .png decode as what they are."""
    pic = _picture(20, 30)
    j, p = tmp_path / "a.png", tmp_path / "b.JPG"
    Image.fromarray(pic).save(j, format="JPEG", quality=90)
    Image.fromarray(pic).save(p, format="PNG")
    np.testing.assert_array_equal(images.decode_image(str(j), "cpu"),
                                  np.asarray(Image.open(j)))
    np.testing.assert_array_equal(images.decode_image(str(p), "cpu"), pic)
    assert images.image_size(str(j)) == images.image_size(str(p)) == (30, 20)


def test_decoder_defaults_to_the_card(tmp_path):
    """Without a card, the default device raises: the pixel stages never
    quietly run on the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    path = tmp_path / "d.jpg"
    Image.fromarray(_picture(16, 16)).save(path)
    with pytest.raises((RuntimeError, AssertionError)):
        images.decode_image(str(path))
