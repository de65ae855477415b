"""The port's PNG codec and resize (gs2d_torch/scene/images.py) against PIL.

- Decode is bit-exact to ``np.asarray(PIL.Image.open(path))``: on PNGs
  PIL writes (every supported colour type, odd widths, ``optimize=True``,
  PIL's adaptive per-row filters) and on hand-built PNGs that force one
  filter on every row, or a seeded mix, with the filters applied by a
  per-pixel loop here (the PNG spec's definitions, independent of the
  port's encoder).
- Unsupported inputs (16-bit, palette, 1-bit, Adam7, JPEG) raise a
  ValueError naming the file and the format.
- The encoder round-trips through PIL for both of its filters (Sub,
  Paeth) and every colour type, and refuses the others.
- ``resize`` is ``PIL.Image.resize`` (its default bicubic) bit for bit;
  ``torch.nn.functional.interpolate(mode="bicubic", antialias=True)``,
  the nearest library call, is not: its residual is held here.
"""

import struct
import zlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from PIL import Image

from gs2d_torch.scene.images import decode_png, encode_png, png_size, resize

from .test_torch_common import one_torch_thread  # noqa: F401

MODES = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}
COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}


def _image(h, w, c, seed=0, noise=40):
    """Smooth bands plus noise, clipped: rows a filter predicts well and
    values at both ends of the range."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    base = np.stack([127 + 120 * np.sin(0.11 * (k + 1) * xx + 0.07 * yy + k)
                     for k in range(c)], -1)
    img = base + rng.integers(-noise, noise + 1, (h, w, c))
    return np.clip(img, 0, 255).astype(np.uint8)


def _pil_image(arr, mode):
    return Image.fromarray(arr[..., 0] if mode == "L" else arr, mode)


def _filter_loop(img, ftype):
    """The PNG spec's filter on every row, one byte at a time."""
    h, w, bpp = img.shape
    x = img.astype(np.int64).reshape(h, w * bpp)
    out = np.zeros((h, 1 + w * bpp), np.uint8)
    for r in range(h):
        out[r, 0] = ftype[r]
        for i in range(w * bpp):
            a = x[r, i - bpp] if i >= bpp else 0
            b = x[r - 1, i] if r > 0 else 0
            c = x[r - 1, i - bpp] if r > 0 and i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            paeth = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            pred = (0, a, b, (a + b) // 2, paeth)[ftype[r]]
            out[r, 1 + i] = (x[r, i] - pred) % 256
    return out


def _write_png(path, w, h, ctype, payload, depth=8, interlace=0):
    def chunk(t, data):
        return (struct.pack(">I", len(data)) + t + data
                + struct.pack(">I", zlib.crc32(t + data)))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                           0, 0, interlace)))
        f.write(chunk(b"IDAT", zlib.compress(payload)))
        f.write(chunk(b"IEND", b""))


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("size", [(37, 53), (1, 1), (5, 3), (64, 200)])
def test_decode_matches_pil_on_pil_pngs(tmp_path, mode, size):
    arr = _image(*size, MODES[mode], seed=sum(size))
    for optimize in (True, False):
        path = str(tmp_path / f"{mode}_{optimize}.png")
        _pil_image(arr, mode).save(path, optimize=optimize)
        ref = np.asarray(Image.open(path))
        got = decode_png(path)
        assert got.dtype == np.uint8 and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)
        assert png_size(path) == (size[1], size[0])


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4, "mixed"])
def test_decode_forced_filters(tmp_path, mode, ftype):
    """Hand-built PNGs: one filter on every row (or a seeded mix)."""
    h, w, bpp = 9, 13, MODES[mode]
    img = _image(h, w, bpp, seed=3)
    types = (np.random.default_rng(5).integers(0, 5, h) if ftype == "mixed"
             else np.full(h, ftype))
    path = str(tmp_path / "forced.png")
    _write_png(path, w, h, COLOR_TYPE[bpp], _filter_loop(img, types)
               .tobytes())
    ref = np.asarray(Image.open(path))
    np.testing.assert_array_equal(ref.reshape(h, w, bpp), img)
    np.testing.assert_array_equal(decode_png(path), ref)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("ftype", [1, 4])
def test_encoder_round_trips_through_pil(tmp_path, mode, ftype):
    arr = _image(31, 45, MODES[mode], seed=ftype)
    src = arr[..., 0] if mode == "L" else arr
    path = str(tmp_path / "enc.png")
    encode_png(path, src, filter_type=ftype)
    with Image.open(path) as im:
        assert im.mode == mode
        np.testing.assert_array_equal(np.asarray(im), src)
    # every row carries the forced filter
    with open(path, "rb") as f:
        data = f.read()
    idat_len = struct.unpack(">I", data[33:37])[0]
    raw = zlib.decompress(data[41:41 + idat_len])
    rows = np.frombuffer(raw, np.uint8).reshape(31, -1)
    assert (rows[:, 0] == ftype).all()
    np.testing.assert_array_equal(decode_png(path), src)


@pytest.mark.parametrize("ftype", [0, 2, 3, 5])
def test_encoder_refuses_other_filters(tmp_path, ftype):
    with pytest.raises(ValueError, match=f"filter type {ftype}"):
        encode_png(str(tmp_path / "x.png"), _image(4, 4, 3), ftype)


def test_decode_large_mixed_filters(tmp_path):
    """A 1080-row PIL PNG (adaptive filters: the wavefront path) and the
    same pixels Sub-filtered (the row path)."""
    arr = _image(1080, 480, 3, seed=9)
    p1, p2 = str(tmp_path / "pil.png"), str(tmp_path / "sub.png")
    Image.fromarray(arr).save(p1)
    encode_png(p2, arr, filter_type=1)
    np.testing.assert_array_equal(decode_png(p1), arr)
    np.testing.assert_array_equal(decode_png(p2), arr)


def test_unsupported_formats_raise(tmp_path):
    cases = {}
    p = str(tmp_path / "i16.png")
    Image.fromarray(np.arange(64, dtype=np.uint16).reshape(8, 8) * 999) \
        .save(p)
    cases[p] = "16-bit"
    p = str(tmp_path / "pal.png")
    Image.fromarray(_image(8, 8, 3)).convert("P").save(p)
    cases[p] = "palette"
    p = str(tmp_path / "bits.png")
    Image.fromarray(_image(8, 8, 1)[..., 0] > 128).save(p)
    cases[p] = "1-bit"
    p = str(tmp_path / "adam7.png")
    _write_png(p, 8, 8, 2, bytes(8 * 25), interlace=1)
    cases[p] = "Adam7"
    p = str(tmp_path / "photo.jpg")
    Image.fromarray(_image(8, 8, 3)).save(p, quality=90)
    cases[p] = "JPEG"
    for path, what in cases.items():
        with pytest.raises(ValueError, match=what) as e:
            decode_png(path)
        assert path in str(e.value)


@pytest.mark.parametrize("shape,size", [
    ((1080, 1920, 3), (1600, 900)),      # the default policy's 1080p case
    ((300, 2001, 3), (1600, 240)),
    ((96, 1700, 1), (1600, 90)),
    ((97, 130, 3), (67, 50)),
    ((50, 67, 3), (130, 97)),            # enlarging
    ((40, 60, 3), (60, 21)),             # one axis only
    ((1, 3, 3), (2, 1)),
])
def test_resize_is_pil_bit_for_bit(shape, size):
    arr = _image(*shape, seed=shape[1])
    src = arr[..., 0] if shape[2] == 1 else arr
    ref = np.asarray(Image.fromarray(src).resize(size))
    np.testing.assert_array_equal(resize(src, *size), ref)


@pytest.mark.parametrize("mode", ["LA", "RGBA"])
@pytest.mark.parametrize("size", [(33, 24), (8, 6), (66, 48), (66, 24)],
                         ids=["half", "eighth", "same", "one_axis"])
def test_resize_with_alpha_is_pil_bit_for_bit(mode, size):
    """PIL resizes gray+alpha and RGBA premultiplied (``La`` / ``RGBa``
    and back) and returns them unchanged at their own size; alphas of 0
    and 255 on whole columns, the rest random."""
    rng = np.random.default_rng(len(mode) + size[0])
    img = rng.integers(0, 256, (48, 66, len(mode)), dtype=np.uint8)
    img[:, :9, -1], img[:, -9:, -1] = 0, 255
    ref = np.asarray(Image.fromarray(img, mode).resize(size))
    np.testing.assert_array_equal(resize(img, *size), ref)


def test_interpolate_is_not_pil():
    """Why the port carries its own resample: on 1920x1080 -> 1600x900 RGB
    the library's bicubic antialias route is off PIL on a share of bytes,
    by up to 2 levels, whether fed uint8 or float (two passes, rounded
    and clipped between them as PIL does)."""
    arr = _image(1080, 1920, 3, seed=1)
    ref = np.asarray(Image.fromarray(arr).resize((1600, 900))).astype(int)
    t = torch.from_numpy(arr).permute(2, 0, 1)[None]
    u8 = F.interpolate(t, size=(900, 1600), mode="bicubic",
                       antialias=True)[0].permute(1, 2, 0).numpy()
    f = t.float()
    for size in ((1080, 1600), (900, 1600)):
        f = torch.clamp(torch.floor(F.interpolate(
            f, size=size, mode="bicubic", antialias=True) + 0.5), 0, 255)
    two = f[0].permute(1, 2, 0).numpy()
    for got in (u8, two):
        d = np.abs(got.astype(int) - ref)
        assert 0 < (d > 0).mean() < 0.01 and d.max() <= 2
