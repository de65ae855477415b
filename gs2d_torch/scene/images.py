"""The port's PNG codec, the image dispatch and the resize of the dataset
resolution policy.

The port does not depend on PIL (the H100 hosts it is written for do not
install it), so it decodes and encodes its own images (the JAX package
uses PIL: ``gs2d_tpu/scene/dataset.py:19``,
``gs2d_tpu/render/extract.py:350``).

``decode_image`` and ``image_size`` dispatch on the file's first bytes,
not its extension (Mip-NeRF 360 names its JPEGs ``*.JPG``): PNG goes to
the codec below, JPEG to ``jpeg.py`` (baseline and extended sequential,
byte for byte what PIL gives), anything else raises a ``ValueError`` that
names the file and the format.

PNG decode: 8-bit gray, gray+alpha, RGB and RGBA, non-interlaced, all five
scanline filters, giving the array ``np.asarray(PIL.Image.open(path))``
gives, byte for byte. Every other PNG (palette, 16-bit, sub-byte depths,
Adam7) raises a ``ValueError`` that names the file and the format. Paeth
and Average depend on the left neighbour, so a per-pixel loop would cost
seconds per 1080p image. A pixel
depends only on (r, c-1), (r-1, c) and (r-1, c-1), so the pixels of one
anti-diagonal r + c = d depend only on diagonals d-1 and d-2: the decoder
stores the image skewed (diagonal-major), where each diagonal is one
contiguous row, and reconstructs all filter types of a diagonal at once in
H + W - 1 vectorised steps. Images whose rows are all None, Sub or Up take
a row-wise path (Sub is a running sum mod 256).

Encode: Sub (the default) or Paeth on every row, through ``zlib``.

Resize: ``PIL.Image.resize`` at its default (bicubic, a = -0.5, support
scaled by the reduction factor), which the JAX loaders and ``convert.py``
call, reproduced bit for bit (gray+alpha and RGBA premultiplied, as PIL
does): PIL's coefficients in double precision, quantised to 22
fractional bits, a horizontal then a vertical pass, each rounding and
clipping to uint8. ``torch.nn.functional.interpolate(mode="bicubic",
antialias=True)`` is the nearest library call, but it is not PIL: fed
uint8, or float in two passes rounded and clipped between them, it leaves
a fraction of a percent of bytes off by up to 2 levels on a 1920x1080 ->
1600x900 resize (``tests/test_torch_images.py::test_interpolate_is_not_pil``
holds that residual).
"""

from __future__ import annotations

import math
import struct
import zlib

import numpy as np
import torch

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}     # colour type → samples per pixel
_COLOR_NAMES = {0: "gray", 2: "RGB", 3: "palette", 4: "gray+alpha",
                6: "RGBA"}


def _format_of(head: bytes) -> str:
    if head.startswith(_SIGNATURE):
        return "PNG"
    if head.startswith(b"\xff\xd8\xff"):
        return "JPEG"
    return "an unknown format"


def _chunks(data: bytes, path: str):
    """Yields (type, payload) of every chunk, CRCs checked."""
    off = len(_SIGNATURE)
    while off + 8 <= len(data):
        (length,) = struct.unpack_from(">I", data, off)
        ctype = data[off + 4:off + 8]
        payload = data[off + 8:off + 8 + length]
        (crc,) = struct.unpack_from(">I", data, off + 8 + length)
        if zlib.crc32(ctype + payload) != crc:
            raise ValueError(f"{path}: PNG chunk {ctype!r} fails its CRC")
        yield ctype, payload
        if ctype == b"IEND":
            return
        off += 12 + length
    raise ValueError(f"{path}: PNG ends before its IEND chunk")


def _header(data: bytes, path: str):
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: {_format_of(data[:8])}, not a PNG; the "
                         "port decodes 8-bit PNG only")
    if data[12:16] != b"IHDR":
        raise ValueError(f"{path}: PNG without an IHDR chunk first")
    return struct.unpack(">IIBBBBB", data[16:29])


def _sniff(path: str) -> str:
    with open(path, "rb") as f:
        head = f.read(8)
    fmt = _format_of(head)
    if fmt not in ("PNG", "JPEG"):
        raise ValueError(f"{path}: {fmt}; the port decodes PNG and JPEG")
    return fmt


def image_size(path: str):
    """(width, height) of a PNG or JPEG, from its header."""
    if _sniff(path) == "JPEG":
        from .jpeg import jpeg_size
        return jpeg_size(path)
    return png_size(path)


def decode_image(path: str, device="cuda") -> np.ndarray:
    """PNG or JPEG file → the uint8 array PIL gives: (H, W) for gray, else
    (H, W, C). A JPEG's pixel stages run on ``device``; a PNG decodes on
    the host."""
    if _sniff(path) == "JPEG":
        from .jpeg import decode_jpeg
        return decode_jpeg(path, device)
    return decode_png(path)


def png_size(path: str):
    """(width, height) from the header, without decoding."""
    with open(path, "rb") as f:
        w, h, *_ = _header(f.read(29), path)
    return w, h


def decode_png(path: str) -> np.ndarray:
    """PNG file → uint8 array (H, W) for gray, else (H, W, C)."""
    with open(path, "rb") as f:
        data = f.read()
    w, h, depth, ctype, comp, filt, interlace = _header(data, path)
    what = (f"{depth}-bit {_COLOR_NAMES.get(ctype, f'colour type {ctype}')}"
            f"{', Adam7-interlaced' if interlace else ''} PNG")
    if depth != 8 or ctype not in _CHANNELS or interlace or comp or filt:
        raise ValueError(f"{path}: {what}; the port decodes 8-bit gray, "
                         "gray+alpha, RGB and RGBA PNGs, non-interlaced")
    idat = b"".join(p for t, p in _chunks(data, path) if t == b"IDAT")
    bpp = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    if raw.size != h * (1 + w * bpp):
        raise ValueError(f"{path}: {what} holds {raw.size} bytes of "
                         f"scanlines, expected {h * (1 + w * bpp)}")
    rows = raw.reshape(h, 1 + w * bpp)
    types = rows[:, 0]
    if types.max(initial=0) > 4:
        raise ValueError(f"{path}: scanline filter type "
                         f"{int(types.max())} (PNG defines 0-4)")
    x = rows[:, 1:].reshape(h, w, bpp)
    if np.isin(types, (3, 4)).any():
        img = _unfilter_wavefront(x, types)
    else:
        img = _unfilter_rows(x, types)
    return img[..., 0] if bpp == 1 else img


def _unfilter_rows(x: np.ndarray, types: np.ndarray) -> np.ndarray:
    """None / Sub / Up rows, one row at a time (uint8 arithmetic wraps
    mod 256, as PNG's does)."""
    out = np.empty_like(x)
    prev = np.zeros_like(x[0])
    for r, t in enumerate(types.tolist()):
        if t == 0:
            out[r] = x[r]
        elif t == 1:
            out[r] = np.cumsum(x[r], axis=0, dtype=np.uint8)
        else:
            out[r] = x[r] + prev
        prev = out[r]
    return out


def _unfilter_wavefront(x: np.ndarray, types: np.ndarray) -> np.ndarray:
    """Every filter type at once, one anti-diagonal per step.

    ``s[d + 2, r + 1]`` holds pixel (r, d - r); diagonals -2 and -1 and
    row -1 are zeros, and so is every slot off the image, which is never
    written: the left, upper and upper-left neighbours of row r on
    diagonal d are then ``s[d + 1, r + 1]``, ``s[d + 1, r]`` and
    ``s[d, r]``, with PNG's zeros outside the image for free."""
    h, w, bpp = x.shape
    rr, cc = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    skew = (rr + cc + 2, rr + 1)
    xs = np.zeros((h + w + 1, h + 1, bpp), np.int16)
    xs[skew] = x
    s = np.zeros_like(xs)
    # only the filter types the image uses are computed; rows of the
    # other types overwrite the Paeth (or zero) prediction in place
    used = set(types.tolist())
    masks = {t: (types == t)[:, None] for t in used - {4}}
    for d in range(h + w - 1):
        lo, hi = max(0, d - w + 1), min(h - 1, d) + 1
        a = s[d + 1, lo + 1:hi + 1]
        b = s[d + 1, lo:hi]
        c = s[d, lo:hi]
        pred = _paeth(a, b, c) if 4 in used else np.zeros_like(a)
        for t, m in masks.items():
            v = 0 if t == 0 else a if t == 1 else b if t == 2 else \
                (a + b) >> 1
            np.copyto(pred, v, where=m[lo:hi])
        out = s[d + 2, lo + 1:hi + 1]
        np.add(xs[d + 2, lo + 1:hi + 1], pred, out=out)
        np.bitwise_and(out, 255, out=out)
    return s[skew].astype(np.uint8)


def _paeth(a, b, c):
    pa = np.abs(b - c)
    pb = np.abs(a - c)
    pc = np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def encode_png(path: str, img: np.ndarray, filter_type: int = 1,
               level: int = 6) -> None:
    """uint8 (H, W) or (H, W, C), C in 1–4 → an 8-bit PNG with
    ``filter_type`` on every row, compressed by zlib at ``level``: 1 (Sub),
    which the port writes, or 4 (Paeth), which decodes through the
    wavefront as the adaptive filters of other writers do."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"encode_png: uint8 image expected, got {img.dtype}")
    if filter_type not in (1, 4):
        raise ValueError(f"encode_png: filter type {filter_type}; the port "
                         "writes 1 (Sub) or 4 (Paeth)")
    if img.ndim == 2:
        img = img[..., None]
    h, w, bpp = img.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[bpp]
    x = img.astype(np.int16)
    a = np.zeros_like(x)
    a[:, 1:] = x[:, :-1]
    if filter_type == 1:
        pred = a
    else:
        b = np.zeros_like(x)
        b[1:] = x[:-1]
        c = np.zeros_like(x)
        c[1:, 1:] = x[:-1, :-1]
        pred = _paeth(a, b, c)
    rows = np.empty((h, 1 + w * bpp), np.uint8)
    rows[:, 0] = filter_type
    rows[:, 1:] = ((x - pred) & 255).reshape(h, w * bpp)

    def chunk(ctype_: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + ctype_ + payload
                + struct.pack(">I", zlib.crc32(ctype_ + payload)))

    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0,
                                           0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(rows.tobytes(), level)))
        f.write(chunk(b"IEND", b""))


# --- resize: PIL's 8-bit bicubic resample -----------------------------------

_PRECISION_BITS = 32 - 8 - 2          # Pillow's libImaging/Resample.c


def _bicubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def _coeffs(in_size: int, out_size: int):
    """Pillow's precompute_coeffs + normalize_coeffs_8bpc for the bicubic
    filter (support 2): per output pixel its first input index and its
    taps, quantised to _PRECISION_BITS fractional bits → (first (out,),
    taps (out, K) int64; taps past an output's window are 0)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64),
                      in_size) - xmin
    k = np.arange(ksize)
    w = _bicubic((k[None] + xmin[:, None] - center[:, None] + 0.5)
                 / filterscale)
    w = np.where(k[None] < xmax[:, None], w, 0.0)
    # the reference sums the taps in order; a left-to-right cumulative sum
    # keeps that order (np.sum would pair them)
    ww = np.cumsum(w, axis=1)[:, -1]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None],
                 w)
    q = np.where(w < 0, -0.5 + w * (1 << _PRECISION_BITS),
                 0.5 + w * (1 << _PRECISION_BITS))
    return xmin, np.trunc(q).astype(np.int64), xmax


def _resample_axis(img: torch.Tensor, out_size: int, dim: int):
    """One pass of PIL's resample along ``dim`` of a uint8 tensor."""
    in_size = img.shape[dim]
    first, taps, span = _coeffs(in_size, out_size)
    acc = torch.full(img.shape[:dim] + (out_size,) + img.shape[dim + 1:],
                     1 << (_PRECISION_BITS - 1), dtype=torch.int32,
                     device=img.device)
    shape = [1] * img.dim()
    shape[dim] = out_size
    src = img.to(torch.int32)
    for k in range(taps.shape[1]):
        live = k < span
        if not live.any():
            break
        idx = torch.as_tensor(np.minimum(first + k, in_size - 1),
                              device=img.device)
        wk = torch.as_tensor(np.where(live, taps[:, k], 0).astype(np.int32),
                             device=img.device).view(shape)
        acc += src.index_select(dim, idx) * wk
    return torch.clamp(acc >> _PRECISION_BITS, 0, 255).to(torch.uint8)


def resize(img: np.ndarray, width: int, height: int,
           device=None) -> np.ndarray:
    """``PIL.Image.fromarray(img).resize((width, height))`` for a uint8
    (H, W) or (H, W, C) array, bit for bit, computed on ``device`` (the
    CPU by default): the horizontal pass, then the vertical, each skipped
    where that size does not change. Gray+alpha and RGBA (C = 2, 4) are
    resized premultiplied, as PIL converts them to ``La`` / ``RGBa`` and
    back (colour·alpha/255 rounded, then colour·255/alpha truncated and
    clipped where alpha is neither 0 nor 255); at their own size they
    come back unchanged, as PIL returns a copy."""
    t = torch.as_tensor(np.ascontiguousarray(img), device=device)
    alpha = t.dim() == 3 and t.shape[2] in (2, 4) \
        and tuple(t.shape[:2]) != (height, width)
    if alpha:
        a = t[..., -1:].to(torch.int32)
        m = t[..., :-1].to(torch.int32) * a + 128
        t = torch.cat([((m >> 8) + m) >> 8, a], -1).to(torch.uint8)
    if t.shape[1] != width:
        t = _resample_axis(t, width, 1)
    if t.shape[0] != height:
        t = _resample_axis(t, height, 0)
    if alpha:
        a = t[..., -1:].to(torch.int32)
        c = t[..., :-1].to(torch.int32)
        un = torch.clamp(c * 255 // torch.clamp(a, min=1), max=255)
        keep = (a == 0) | (a == 255)
        t = torch.cat([torch.where(keep, c, un), a], -1).to(torch.uint8)
    return t.cpu().numpy()
