"""The port's baseline JPEG decoder, byte for byte what PIL gives.

The JAX package reads images through PIL (``gs2d_tpu/scene/dataset.py:
136``, ``:200``), which decodes JPEG with libjpeg-turbo; the H100 hosts the
port is written for install no PIL, and Mip-NeRF 360 and Tanks and Temples
ship their views as ``.JPG``. ``decode_jpeg(path)`` gives the array
``np.asarray(PIL.Image.open(path))`` gives (libjpeg-turbo 3.1 at its
defaults), in two stages:

1. **Entropy decoding** (host): the markers are parsed here; each scan's
   Huffman-coded data becomes int16 coefficient blocks per component, in
   natural (row-major) order, not yet dequantised. Two decoders share that
   contract: ``csrc/jpeg_entropy.cpp`` (host C++, built with ``c++`` at
   first use, ``cuda_build.load("jpeg_entropy")``), which the main path
   takes, and ``_scan_plain``, pure Python, which the tests hold it
   against (seconds per 1080p image, so never a fallback).
2. **Pixel stages** (``pixels``, torch integer operations on every block at
   once, on the CPU or the card alike): dequantisation; libjpeg's
   ``jpeg_idct_islow`` (``CONST_BITS`` 13, ``PASS1_BITS`` 2, in int64 as
   its ``JLONG`` is, then its range-limit table); cropping each component
   to its downsampled size; libjpeg's fancy (triangle) upsampling for
   2x1, 1x2 and 2x2 chroma (the 3/4 + 1/4 blend with its alternating
   rounding biases, edges replicated; box replication where a component is
   at most 2 samples wide, as libjpeg falls back to); and YCbCr to RGB with
   libjpeg's fixed-point tables (``SCALEBITS`` 16, ``ONE_HALF``).

Supported: baseline and extended sequential Huffman (SOF0, SOF1) at 8
bits, 8- and 16-bit quantisation tables, restart intervals, one or several
sequential scans, 1 component (gray) or 3 (YCbCr) with every component's
sampling factors dividing the largest by 1 or 2 (4:4:4, 4:2:2, 4:2:0,
4:4:0). APPn (EXIF among them: PIL's ``np.asarray`` applies no
orientation, so neither does the port) and COM segments are skipped.
Everything else raises a ``ValueError`` that names the file and the
reason: progressive, lossless, hierarchical or arithmetic-coded frames,
12-bit samples, CMYK/YCCK, RGB (Adobe transform 0 or component ids 'R',
'G', 'B'), other sampling ratios, and truncated or corrupt data.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Optional

import numpy as np
import torch

# natural (row-major) index of the k-th coefficient in zig-zag order
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63],
    np.int64)

_SOF_KINDS = {
    0xC2: "progressive", 0xC3: "lossless", 0xC5: "hierarchical sequential",
    0xC6: "hierarchical progressive", 0xC7: "hierarchical lossless",
    0xC9: "arithmetic-coded sequential", 0xCA: "arithmetic-coded progressive",
    0xCB: "arithmetic-coded lossless", 0xCD: "hierarchical arithmetic-coded",
    0xCE: "hierarchical arithmetic-coded progressive",
    0xCF: "hierarchical arithmetic-coded lossless"}


@dataclasses.dataclass
class Component:
    cid: int
    h: int                       # sampling factors
    v: int
    tq: int                      # quantisation table id
    dw: int = 0                  # downsampled size (libjpeg's
    dh: int = 0                  # downsampled_width / _height)
    coef: Optional[np.ndarray] = None    # int16 (rows, cols, 64), natural
    qt: Optional[np.ndarray] = None      # int32 (64,), natural, latched at
    #                                      the component's first scan


@dataclasses.dataclass
class Coefficients:
    """What the entropy stage gives the pixel stages."""
    width: int
    height: int
    components: List[Component]


@dataclasses.dataclass
class _Scan:
    comps: list                  # [(Component, dc table, ac table)]
    mcux: int
    mcuy: int
    units: list                  # per MCU: (scan comp index, row, col)


def _fail(path, why):
    raise ValueError(f"{path}: {why}")


def _huff_codes(counts, symbols, path):
    """JPEG Annex C: [(length, code, symbol)] of a DHT table."""
    out, code, k = [], 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            out.append((length, code, symbols[k]))
            code += 1
            k += 1
        if code > (1 << length):
            _fail(path, "bad Huffman table")
        code <<= 1
    return out


def _lut16(codes):
    """65536-entry lookup by the next 16 bits: length << 8 | symbol, 0 for
    bit patterns no code starts."""
    lut = [0] * 65536
    for length, code, sym in codes:
        lo = code << (16 - length)
        n = 1 << (16 - length)
        lut[lo:lo + n] = [length << 8 | sym] * n
    return lut


def _scan_extent(data: bytes, pos: int, path):
    """Bounds of the restart segments of the scan starting at ``pos`` and
    the offset of the marker that ends it."""
    bounds, start, p, n = [], pos, pos, len(data)
    while True:
        p = data.find(b"\xff", p)
        if p < 0 or p + 1 >= n:
            _fail(path, "JPEG data ends inside a scan")
        q = p + 1
        if data[q] == 0:
            p += 2
            continue
        while q < n and data[q] == 0xFF:        # fill bytes before a marker
            q += 1
        if q >= n:
            _fail(path, "JPEG data ends inside a scan")
        if 0xD0 <= data[q] <= 0xD7:
            bounds.append((start, p, data[q] - 0xD0))
            start = p = q + 1
            continue
        bounds.append((start, p, None))
        return bounds, p


def _scan_plain(data: bytes, pos: int, scan: _Scan, luts, restart: int,
                path) -> int:
    """Pure-Python entropy decoder of one sequential scan: fills each
    component's ``coef`` and returns the offset of the marker after it."""
    bounds, end = _scan_extent(data, pos, path)
    n_mcu = scan.mcux * scan.mcuy
    per_seg = restart or n_mcu
    if len(bounds) != -(-n_mcu // per_seg):
        _fail(path, f"{len(bounds)} restart segments in a scan of {n_mcu} "
              f"MCUs at an interval of {restart}")
    outs = [[0] * c.coef.size for c, _, _ in scan.comps]
    cols = [c.coef.shape[1] for c, _, _ in scan.comps]
    dcl = [luts[(0, td)] for _, td, _ in scan.comps]
    acl = [luts[(1, ta)] for _, _, ta in scan.comps]
    zz = ZIGZAG.tolist()
    units = scan.units
    mcu = 0
    for seg_i, (a, b, rst) in enumerate(bounds):
        if rst is not None and rst != seg_i % 8:
            _fail(path, f"restart marker RST{rst} where RST{seg_i % 8} was "
                  "due")
        seg = data[a:b].replace(b"\xff\x00", b"\xff")
        nbits = len(seg) * 8
        seg += bytes(8)
        p = 0
        pred = [0] * len(scan.comps)
        for m in range(mcu, min(mcu + per_seg, n_mcu)):
            my, mx = divmod(m, scan.mcux)
            for ci, uy, ux in units:
                c = scan.comps[ci][0]
                out = outs[ci]
                base = ((my * c.v + uy) * cols[ci] + mx * c.h + ux) * 64
                # DC: the size category, then that many bits
                w = int.from_bytes(seg[p >> 3:(p >> 3) + 5], "big")
                sh = p & 7
                e = dcl[ci][(w >> (24 - sh)) & 0xFFFF]
                if not e:
                    _fail(path, "invalid Huffman code in a scan")
                ln, s = e >> 8, e & 255
                if s:
                    val = (w >> (40 - sh - ln - s)) & ((1 << s) - 1)
                    if val < 1 << (s - 1):
                        val -= (1 << s) - 1
                    pred[ci] += val
                p += ln + s
                out[base] = pred[ci]
                lut = acl[ci]
                k = 1
                while k < 64:
                    w = int.from_bytes(seg[p >> 3:(p >> 3) + 5], "big")
                    sh = p & 7
                    e = lut[(w >> (24 - sh)) & 0xFFFF]
                    if not e:
                        _fail(path, "invalid Huffman code in a scan")
                    ln, rs = e >> 8, e & 255
                    s = rs & 15
                    if s:
                        k += rs >> 4
                        if k > 63:
                            _fail(path, "coefficient index past 63")
                        val = (w >> (40 - sh - ln - s)) & ((1 << s) - 1)
                        if val < 1 << (s - 1):
                            val -= (1 << s) - 1
                        out[base + zz[k]] = val
                        k += 1
                    elif rs == 0xF0:
                        k += 16
                    else:
                        k = 64                  # end of block
                    p += ln + s
                if k > 64:
                    _fail(path, "zero run past the end of a block")
        if p > nbits:
            _fail(path, "JPEG scan data ends before its last MCU")
        mcu += per_seg
    for (c, _, _), out in zip(scan.comps, outs):
        c.coef[...] = np.asarray(out, np.int16).reshape(c.coef.shape)
    return end


def _scan_c(data: bytes, pos: int, scan: _Scan, tables, restart: int,
            path) -> int:
    """The same contract through ``csrc/jpeg_entropy.cpp``."""
    from .. import cuda_build
    lib = cuda_build.load("jpeg_entropy")
    fn = lib.jpeg_decode_scan
    fn.restype = ctypes.c_int64
    fn.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
                   ctypes.c_int32]
    huff = np.zeros((8, 16 + 256), np.uint8)
    for (cls, tid), (counts, symbols) in tables.items():
        huff[cls * 4 + tid, :16] = counts
        huff[cls * 4 + tid, 16:16 + len(symbols)] = symbols
    params = np.array([[c.h, c.v, td, ta, c.coef.shape[1]]
                       for c, td, ta in scan.comps], np.int32)
    ptrs = (ctypes.c_void_p * len(scan.comps))(
        *[c.coef.ctypes.data for c, _, _ in scan.comps])
    end = fn(data, len(data), pos, len(scan.comps), params.ctypes.data,
             ctypes.addressof(ptrs), huff.ctypes.data, scan.mcux, scan.mcuy,
             restart)
    if end < 0:
        why = {-1: "invalid Huffman code in a scan",
               -2: "JPEG scan data ends before its last MCU",
               -3: "restart marker missing or out of order",
               -4: "coefficient index past 63",
               -5: "JPEG data ends inside a scan"}.get(int(end), int(end))
        _fail(path, why)
    return int(end)


def read_coefficients(path: str, entropy: str = "c",
                      data: Optional[bytes] = None) -> Coefficients:
    """Parse the markers of ``path`` and entropy-decode its scans with the
    C decoder (``entropy="c"``, the main path) or the Python one
    (``"plain"``)."""
    if data is None:
        with open(path, "rb") as f:
            data = f.read()
    if entropy not in ("c", "plain"):
        raise ValueError(f"entropy decoder {entropy!r}: 'c' or 'plain'")
    if not data.startswith(b"\xff\xd8"):
        _fail(path, "not a JPEG (no SOI marker)")
    n = len(data)
    pos = 2
    qts, tables, luts = {}, {}, {}
    restart = 0
    comps: List[Component] = []
    width = height = 0
    jfif, adobe = False, None
    scanned = set()
    while True:
        if pos >= n or data[pos] != 0xFF:
            _fail(path, f"expected a marker at byte {pos}")
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            _fail(path, "JPEG data ends before its EOI marker")
        m = data[pos]
        pos += 1
        if m == 0xD9:                                   # EOI
            break
        if m == 0x01 or 0xD0 <= m <= 0xD7:
            continue                                    # TEM, stray RSTn
        if pos + 2 > n:
            _fail(path, "JPEG data ends inside a marker segment")
        length = int.from_bytes(data[pos:pos + 2], "big")
        seg = data[pos + 2:pos + length]
        if length < 2 or len(seg) != length - 2:
            _fail(path, f"marker 0x{m:02X} segment runs past the file")
        pos += length
        if m == 0xE0 and seg.startswith(b"JFIF\x00"):
            jfif = True
        elif m == 0xEE and seg.startswith(b"Adobe") and len(seg) >= 12:
            adobe = seg[11]
        elif m == 0xCC:
            _fail(path, "arithmetic-coded JPEG; the port decodes Huffman "
                  "baseline and extended sequential JPEG only")
        elif m == 0xDB:                                 # DQT
            k = 0
            while k < len(seg):
                pq, tq = seg[k] >> 4, seg[k] & 15
                size = 128 if pq else 64
                raw = seg[k + 1:k + 1 + size]
                if pq > 1 or tq > 3 or len(raw) != size:
                    _fail(path, "bad quantisation table")
                vals = np.frombuffer(raw, ">u2" if pq else np.uint8)
                qt = np.zeros(64, np.int32)
                qt[ZIGZAG] = vals
                qts[tq] = qt
                k += 1 + size
        elif m == 0xC4:                                 # DHT
            k = 0
            while k < len(seg):
                tc, th = seg[k] >> 4, seg[k] & 15
                counts = list(seg[k + 1:k + 17])
                total = sum(counts)
                symbols = list(seg[k + 17:k + 17 + total])
                if tc > 1 or th > 3 or len(counts) != 16 or \
                        len(symbols) != total or total > 256:
                    _fail(path, "bad Huffman table")
                _huff_codes(counts, symbols, path)          # validates
                tables[(tc, th)] = (counts, symbols)
                luts.pop((tc, th), None)    # a redefined table: rebuild
                k += 17 + total
        elif m == 0xDD:                                 # DRI
            restart = int.from_bytes(seg[:2], "big")
        elif m in _SOF_KINDS:
            _fail(path, f"{_SOF_KINDS[m]} JPEG (SOF{m - 0xC0}); the port "
                  "decodes Huffman baseline and extended sequential JPEG "
                  "only")
        elif m in (0xC0, 0xC1):                         # SOF0, SOF1
            if comps:
                _fail(path, "a second frame header")
            precision = seg[0]
            height, width = (int.from_bytes(seg[1:3], "big"),
                             int.from_bytes(seg[3:5], "big"))
            nc = seg[5]
            if precision != 8:
                _fail(path, f"{precision}-bit JPEG; the port decodes 8-bit "
                      "samples only")
            if height == 0 or width == 0:
                _fail(path, "JPEG with a zero or DNL-defined size")
            if nc == 4:
                _fail(path, "CMYK/YCCK JPEG (4 components); the port "
                      "decodes gray and YCbCr only")
            if nc not in (1, 3) or len(seg) != 6 + 3 * nc:
                _fail(path, f"JPEG with {nc} components; the port decodes "
                      "gray and YCbCr only")
            for i in range(nc):
                cid, hv, tq = seg[6 + 3 * i:9 + 3 * i]
                comps.append(Component(cid, hv >> 4, hv & 15, tq))
            hmax = max(c.h for c in comps)
            vmax = max(c.v for c in comps)
            for c in comps:
                if not (1 <= c.h <= 4 and 1 <= c.v <= 4) or \
                        hmax // c.h not in (1, 2) or \
                        vmax // c.v not in (1, 2) or hmax % c.h or \
                        vmax % c.v:
                    _fail(path, "JPEG sampling factors " + ", ".join(
                        f"{x.h}x{x.v}" for x in comps) + "; the port "
                        "decodes 4:4:4, 4:2:2, 4:2:0 and 4:4:0")
                c.dw = -(-width * c.h // hmax)
                c.dh = -(-height * c.v // vmax)
                c.coef = np.zeros((-(-height // (8 * vmax)) * c.v,
                                   -(-width // (8 * hmax)) * c.h, 64),
                                  np.int16)
            if nc == 3:
                ids = [c.cid for c in comps]
                if not jfif and ((adobe == 0) or (
                        adobe is None and ids == [82, 71, 66])):
                    _fail(path, "RGB JPEG (Adobe transform 0 or component "
                          "ids R, G, B); the port decodes YCbCr only")
        elif m == 0xDA:                                 # SOS
            if not comps:
                _fail(path, "scan before the frame header")
            ns = seg[0]
            sel = []
            for i in range(ns):
                cid, t = seg[1 + 2 * i], seg[2 + 2 * i]
                match = [c for c in comps if c.cid == cid]
                if not match or cid in scanned:
                    _fail(path, f"scan of unknown or repeated component "
                          f"{cid}")
                sel.append((match[0], t >> 4, t & 15))
            ss, se, ahal = seg[1 + 2 * ns:4 + 2 * ns]
            if (ss, se, ahal) != (0, 63, 0):
                _fail(path, "progressive scan parameters in a sequential "
                      "JPEG")
            for c, td, ta in sel:
                scanned.add(c.cid)
                if c.tq not in qts:
                    _fail(path, f"quantisation table {c.tq} not defined")
                c.qt = qts[c.tq].copy()
                for key in ((0, td), (1, ta)):
                    if key not in tables:
                        _fail(path, f"Huffman table {key} not defined")
            hmax = max(c.h for c in comps)
            vmax = max(c.v for c in comps)
            if ns == 1:
                c = sel[0][0]
                scan = _Scan(sel, -(-c.dw // 8), -(-c.dh // 8), [(0, 0, 0)])
                # one block per MCU, laid out as in a 1x1 component
                c_h, c_v = c.h, c.v
                c.h = c.v = 1
                try:
                    pos = _run_scan(entropy, data, pos, scan, tables, luts,
                                    restart, path)
                finally:
                    c.h, c.v = c_h, c_v
            else:
                units = [(i, y, x) for i, (c, _, _) in enumerate(sel)
                         for y in range(c.v) for x in range(c.h)]
                if len(units) > 10:
                    _fail(path, "more than 10 blocks per MCU")
                scan = _Scan(sel, -(-width // (8 * hmax)),
                             -(-height // (8 * vmax)), units)
                pos = _run_scan(entropy, data, pos, scan, tables, luts,
                                restart, path)
        # APPn, COM and other segments: skipped
    if not comps:
        _fail(path, "JPEG without a frame header")
    if len(scanned) != len(comps):
        _fail(path, "JPEG without a scan of every component")
    return Coefficients(width, height, comps)


def _run_scan(entropy, data, pos, scan, tables, luts, restart, path):
    if entropy == "plain":
        for c, td, ta in scan.comps:
            for key in ((0, td), (1, ta)):
                if key not in luts:
                    luts[key] = _lut16(_huff_codes(*tables[key], path))
        return _scan_plain(data, pos, scan, luts, restart, path)
    return _scan_c(data, pos, scan, tables, restart, path)


def jpeg_size(path: str):
    """(width, height) from the frame header, without decoding."""
    with open(path, "rb") as f:
        data = f.read()
    pos, n = 2, len(data)
    if not data.startswith(b"\xff\xd8"):
        _fail(path, "not a JPEG (no SOI marker)")
    while pos + 4 <= n and data[pos] == 0xFF:
        while pos < n and data[pos] == 0xFF:
            pos += 1
        m = data[pos]
        if 0xC0 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC):
            return (int.from_bytes(data[pos + 6:pos + 8], "big"),
                    int.from_bytes(data[pos + 4:pos + 6], "big"))
        pos += 1 + int.from_bytes(data[pos + 1:pos + 3], "big")
    _fail(path, "JPEG without a frame header")


# --- pixel stages ------------------------------------------------------------

CONST_BITS, PASS1_BITS = 13, 2
(FIX_0_298631336, FIX_0_390180644, FIX_0_541196100, FIX_0_765366865,
 FIX_0_899976223, FIX_1_175875602, FIX_1_501321110, FIX_1_847759065,
 FIX_1_961570560, FIX_2_053119869, FIX_2_562915447, FIX_3_072711026) = (
    2446, 3196, 4433, 6270, 7373, 9633, 12299, 15137, 16069, 16819, 20995,
    25172)


def _idct_1d(x, shift):
    """One pass of jpeg_idct_islow on the 8 inputs ``x[0..7]`` (int64
    tensors), descaled by ``shift`` bits with rounding."""
    z2, z3 = x[2], x[6]
    z1 = (z2 + z3) * FIX_0_541196100
    tmp2 = z1 + z3 * -FIX_1_847759065
    tmp3 = z1 + z2 * FIX_0_765366865
    tmp0 = (x[0] + x[4]) << CONST_BITS
    tmp1 = (x[0] - x[4]) << CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * FIX_1_175875602
    t0 = t0 * FIX_0_298631336
    t1 = t1 * FIX_2_053119869
    t2 = t2 * FIX_3_072711026
    t3 = t3 * FIX_1_501321110
    z1 = z1 * -FIX_0_899976223
    z2 = z2 * -FIX_2_562915447
    z3 = z3 * -FIX_1_961570560 + z5
    z4 = z4 * -FIX_0_390180644 + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    half = 1 << (shift - 1)
    outs = (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
            tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)
    return [(o + half) >> shift for o in outs]


def _range_limit(device):
    """libjpeg's post-IDCT range-limit table, indexed by (value & 1023)
    where value is the descaled output before the +128 level shift."""
    t = np.zeros(1024, np.int32)
    t[:128] = np.arange(128, 256)
    t[128:512] = 255
    t[896:] = np.arange(0, 128)
    return torch.as_tensor(t, device=device)


def idct_islow(coef: torch.Tensor, qt: torch.Tensor) -> torch.Tensor:
    """int16 (R, C, 64) coefficients, int32 (64,) table → uint8 plane
    (R*8, C*8): dequantise, the two passes of jpeg_idct_islow, the
    range-limit table."""
    rows, cols = coef.shape[:2]
    x = (coef.to(torch.int64) * qt.to(torch.int64)).view(-1, 8, 8)
    # pass 1 on the columns: inputs x[:, k, :] → workspace rows
    ws = torch.stack(_idct_1d([x[:, k, :] for k in range(8)],
                              CONST_BITS - PASS1_BITS), 1)
    # pass 2 on the rows of the workspace
    out = torch.stack(_idct_1d([ws[:, :, k] for k in range(8)],
                               CONST_BITS + PASS1_BITS + 3), 2)
    pix = _range_limit(coef.device)[(out & 1023)]
    return pix.view(rows, cols, 8, 8).permute(0, 2, 1, 3).reshape(
        rows * 8, cols * 8)


def _fancy_v(p: torch.Tensor) -> torch.Tensor:
    """h1v2_fancy_upsample: output row 2i = (3·p[i] + p[i-1] + 1) >> 2,
    row 2i+1 = (3·p[i] + p[i+1] + 2) >> 2, edge rows replicated."""
    up = torch.cat([p[:1], p[:-1]], 0)
    dn = torch.cat([p[1:], p[-1:]], 0)
    return torch.stack([(3 * p + up + 1) >> 2, (3 * p + dn + 2) >> 2],
                       1).reshape(-1, p.shape[1])


def _fancy_h(p: torch.Tensor) -> torch.Tensor:
    """h2v1_fancy_upsample, as _fancy_v along columns."""
    lf = torch.cat([p[:, :1], p[:, :-1]], 1)
    rt = torch.cat([p[:, 1:], p[:, -1:]], 1)
    return torch.stack([(3 * p + lf + 1) >> 2, (3 * p + rt + 2) >> 2],
                       2).reshape(p.shape[0], -1)


def _fancy_hv(p: torch.Tensor) -> torch.Tensor:
    """h2v2_fancy_upsample: column sums 3·nearer + further row (edges
    replicated), then 3·this + other column sum with biases 8 and 7,
    >> 4."""
    up = torch.cat([p[:1], p[:-1]], 0)
    dn = torch.cat([p[1:], p[-1:]], 0)
    cs = torch.stack([3 * p + up, 3 * p + dn], 1).reshape(-1, p.shape[1])
    lf = torch.cat([cs[:, :1], cs[:, :-1]], 1)
    rt = torch.cat([cs[:, 1:], cs[:, -1:]], 1)
    return torch.stack([(3 * cs + lf + 8) >> 4, (3 * cs + rt + 7) >> 4],
                       2).reshape(cs.shape[0], -1)


def _upsample(p: torch.Tensor, fh: int, fv: int) -> torch.Tensor:
    """libjpeg's choice per component: fancy 2x1 and 2x2 only where the
    component is more than 2 samples wide (box replication otherwise),
    fancy 1x2 always."""
    if fh == 1 and fv == 1:
        return p
    if fh == 1:
        return _fancy_v(p)
    if p.shape[1] > 2:
        return _fancy_h(p) if fv == 1 else _fancy_hv(p)
    return p.repeat_interleave(fv, 0).repeat_interleave(2, 1)


def _fix(x: float) -> int:
    return int(x * (1 << 16) + 0.5)


def ycc_to_rgb(y, cb, cr):
    """libjpeg's ycc_rgb_convert on int32 planes: R = y + Cr_r_tab[cr],
    G = y + ((Cb_g_tab[cb] + Cr_g_tab[cr]) >> 16), B = y + Cb_b_tab[cb],
    each clamped to 0..255."""
    xb, xr = cb - 128, cr - 128
    half = 1 << 15
    r = y + ((_fix(1.40200) * xr + half) >> 16)
    g = y + ((-_fix(0.34414) * xb + half - _fix(0.71414) * xr) >> 16)
    b = y + ((_fix(1.77200) * xb + half) >> 16)
    return torch.stack([r, g, b], -1).clamp_(0, 255)


def pixels(coefs: Coefficients, device="cuda") -> torch.Tensor:
    """The pixel stages on ``device`` → uint8 (H, W) or (H, W, 3)."""
    comps = coefs.components
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    planes = []
    for c in comps:
        coef = torch.from_numpy(c.coef).to(device)
        qt = torch.from_numpy(c.qt).to(device)
        p = idct_islow(coef, qt)[:c.dh, :c.dw].to(torch.int32)
        p = _upsample(p, hmax // c.h, vmax // c.v)
        planes.append(p[:coefs.height, :coefs.width])
    if len(planes) == 1:
        return planes[0].to(torch.uint8)
    return ycc_to_rgb(*planes).to(torch.uint8)


def decode_jpeg(path: str, device="cuda") -> np.ndarray:
    """JPEG file → uint8 (H, W) for gray, else (H, W, 3): the C entropy
    decoder on the host, the pixel stages on ``device``."""
    return pixels(read_coefficients(path), device).cpu().numpy()


# --- encoder -----------------------------------------------------------------
#
# ``encode_jpeg`` writes what PIL 12.1 (libjpeg-turbo 3.1) writes for
# ``Image.save(path, quality=q, subsampling=0)`` of an RGB or L image, byte
# for byte: SOI, a JFIF 1.01 APP0 (no density unit, 1:1, no thumbnail), one
# DQT per table (the standard tables of ITU T.81 Annex K scaled by
# libjpeg's jpeg_quality_scaling, capped at 255 for baseline), SOF0, one DHT
# per table (Annex K.3's tables: libjpeg's defaults), one interleaved
# baseline scan (4:4:4), EOI. The pixel stages run as integer torch
# operations on the image's device: libjpeg's RGB → YCbCr (jccolor.c's
# fixed point), edges replicated to whole blocks, the islow forward DCT
# (jfdctint.c, int64 as its JLONG) and the reciprocal quantisation of
# jcdctmgr.c; the Huffman coding runs in ``csrc/jpeg_entropy.cpp``.

_STD_QUANT = (np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99],
    np.int64), np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99]
    + [99] * 32, np.int64))
_AC_LUMA = bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a43444546474849"
    "4a535455565758595a636465666768696a737475767778797a83848586878889"
    "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
    "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
    "f9fa")
_AC_CHROMA = bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa")
# (class << 4 | id, counts of code lengths 1..16, symbols): DC and AC of
# luma, then DC and AC of chroma
_STD_HUFF = (
    (0x00, (0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0), bytes(range(12))),
    (0x10, (0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125), _AC_LUMA),
    (0x01, (0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0), bytes(range(12))),
    (0x11, (0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119), _AC_CHROMA))


def quant_tables(quality: int):
    """The two baseline tables (natural order, int64 (64,)) libjpeg's
    ``jpeg_set_quality(quality, force_baseline=TRUE)`` sets."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return tuple(np.clip((t * scale + 50) // 100, 1, 255) for t in _STD_QUANT)


def rgb_to_ycc(rgb: torch.Tensor) -> torch.Tensor:
    """libjpeg's rgb_ycc_convert on an int64 (..., 3) tensor → (3, ...):
    Y rounds with ONE_HALF, Cb and Cr with ONE_HALF - 1 about 128."""
    r, g, b = rgb.unbind(-1)
    half, off = 1 << 15, 128 << 16
    y = _fix(0.29900) * r + _fix(0.58700) * g + _fix(0.11400) * b + half
    cb = -_fix(0.16874) * r - _fix(0.33126) * g + _fix(0.5) * b \
        + off + half - 1
    cr = _fix(0.5) * r - _fix(0.41869) * g - _fix(0.08131) * b \
        + off + half - 1
    return torch.stack([y, cb, cr]) >> 16


def _fdct_1d(x, shift_even, shift_odd):
    """One pass of jpeg_fdct_islow on the 8 inputs ``x[0..7]`` (int64):
    outputs 0 and 4 shifted left by ``-shift_even`` bits if it is
    negative, else descaled by it, the rest descaled by ``shift_odd``."""
    t0, t7 = x[0] + x[7], x[0] - x[7]
    t1, t6 = x[1] + x[6], x[1] - x[6]
    t2, t5 = x[2] + x[5], x[2] - x[5]
    t3, t4 = x[3] + x[4], x[3] - x[4]
    t10, t13 = t0 + t3, t0 - t3
    t11, t12 = t1 + t2, t1 - t2

    def descale(v, n):
        return (v + (1 << (n - 1))) >> n

    if shift_even < 0:
        o0, o4 = (t10 + t11) << -shift_even, (t10 - t11) << -shift_even
    else:
        o0 = descale(t10 + t11, shift_even)
        o4 = descale(t10 - t11, shift_even)
    z1 = (t12 + t13) * FIX_0_541196100
    o2 = descale(z1 + t13 * FIX_0_765366865, shift_odd)
    o6 = descale(z1 + t12 * -FIX_1_847759065, shift_odd)
    z1, z2, z3, z4 = t4 + t7, t5 + t6, t4 + t6, t5 + t7
    z5 = (z3 + z4) * FIX_1_175875602
    t4 = t4 * FIX_0_298631336
    t5 = t5 * FIX_2_053119869
    t6 = t6 * FIX_3_072711026
    t7 = t7 * FIX_1_501321110
    z1 = z1 * -FIX_0_899976223
    z2 = z2 * -FIX_2_562915447
    z3 = z3 * -FIX_1_961570560 + z5
    z4 = z4 * -FIX_0_390180644 + z5
    o7 = descale(t4 + z1 + z3, shift_odd)
    o5 = descale(t5 + z2 + z4, shift_odd)
    o3 = descale(t6 + z2 + z3, shift_odd)
    o1 = descale(t7 + z1 + z4, shift_odd)
    return [o0, o1, o2, o3, o4, o5, o6, o7]


def fdct_islow(blocks: torch.Tensor) -> torch.Tensor:
    """jpeg_fdct_islow on int64 (N, 8, 8) level-shifted samples → (N, 8,
    8), scaled up by 8 as libjpeg leaves it: rows with PASS1_BITS of
    headroom, then columns."""
    ws = torch.stack(_fdct_1d([blocks[:, :, k] for k in range(8)],
                              -PASS1_BITS, CONST_BITS - PASS1_BITS), 2)
    return torch.stack(_fdct_1d([ws[:, k, :] for k in range(8)],
                                PASS1_BITS, CONST_BITS + PASS1_BITS), 1)


def _reciprocals(qt: np.ndarray):
    """jcdctmgr.c's compute_reciprocal for the divisors qt << 3 (16-bit
    DCTELEM): (reciprocal, correction, shift) per coefficient."""
    recip, corr, shift = [], [], []
    for d in (np.asarray(qt, np.int64) << 3).tolist():
        r = 16 + d.bit_length() - 1
        fq, fr = divmod(1 << r, d)
        c = d // 2
        if fr == 0:
            fq, r = fq >> 1, r - 1
        elif fr <= d // 2:
            c += 1
        else:
            fq += 1
        recip.append(fq)
        corr.append(c)
        shift.append(r)
    return (np.array(recip, np.int64), np.array(corr, np.int64),
            np.array(shift, np.int64))


def quantize(coef: torch.Tensor, qt: np.ndarray) -> torch.Tensor:
    """jcdctmgr.c's quantize on int64 (N, 64) DCT outputs: |x| plus the
    correction times the reciprocal, shifted, the sign restored → int16."""
    recip, corr, shift = (torch.as_tensor(a, device=coef.device)
                          for a in _reciprocals(qt))
    mag = ((coef.abs() + corr) * recip) >> shift
    return torch.where(coef < 0, -mag, mag).to(torch.int16)


def _blocks(plane: torch.Tensor) -> torch.Tensor:
    """An (H, W) plane → (rows·cols, 64) level-shifted blocks, the last row
    and column replicated to whole blocks as libjpeg's edge expansion."""
    h, w = plane.shape
    rows = torch.clamp(torch.arange(-(-h // 8) * 8, device=plane.device),
                       max=h - 1)
    cols = torch.clamp(torch.arange(-(-w // 8) * 8, device=plane.device),
                       max=w - 1)
    p = plane[rows][:, cols] - 128
    nr, nc = p.shape[0] // 8, p.shape[1] // 8
    return p.view(nr, 8, nc, 8).permute(0, 2, 1, 3).reshape(-1, 8, 8)


def _segment(marker: int, payload: bytes) -> bytes:
    return bytes((0xFF, marker)) + (len(payload) + 2).to_bytes(2, "big") \
        + payload


def encode_jpeg(path: str, img, quality: int = 95, subsampling: int = 0):
    """Write ``img`` (uint8 (H, W, 3) RGB or (H, W) / (H, W, 1) gray, a
    NumPy array or a tensor on any device) to ``path`` as PIL writes
    ``save(path, quality=quality, subsampling=0)``. The pixel stages run on
    the tensor's device (the CPU for an array). Anything else (another
    channel count or dtype, a chroma subsampling) raises a ValueError that
    names the file."""
    t = torch.as_tensor(img)
    if t.dim() == 3 and t.shape[2] == 1:
        t = t[..., 0]
    if t.dtype != torch.uint8 or t.dim() not in (2, 3) \
            or (t.dim() == 3 and t.shape[2] != 3) or 0 in t.shape:
        raise ValueError(f"{path}: cannot write a {t.dtype} image of shape "
                         f"{tuple(t.shape)} as JPEG; the port writes 8-bit "
                         "RGB (H, W, 3) and gray (H, W)")
    if t.dim() == 3 and subsampling != 0:
        raise ValueError(f"{path}: JPEG subsampling {subsampling}; the port "
                         "writes 4:4:4 (subsampling=0) only")
    h, w = t.shape[:2]
    if max(h, w) > 65535:
        raise ValueError(f"{path}: {w}x{h} is past JPEG's 65535 limit")
    x = t.to(torch.int64)
    planes = rgb_to_ycc(x) if x.dim() == 3 else x[None]
    ncomp = planes.shape[0]
    qts = quant_tables(quality)[:1 if ncomp == 1 else 2]
    coefs = [quantize(fdct_islow(_blocks(p)).reshape(-1, 64),
                      qts[min(c, 1)]) for c, p in enumerate(planes)]
    blocks = torch.stack(coefs, 1).cpu().numpy()    # (blocks, ncomp, 64)

    from .. import cuda_build
    fn = cuda_build.load("jpeg_entropy").jpeg_encode_scan
    fn.restype = ctypes.c_int64
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
    huff = np.zeros((4, 16 + 256), np.uint8)
    for k, (_, counts, symbols) in enumerate(_STD_HUFF):
        huff[k, :16] = counts
        huff[k, 16:16 + len(symbols)] = np.frombuffer(symbols, np.uint8)
    n_blocks = blocks.shape[0] * ncomp
    out = np.empty(n_blocks * 448 + 16, np.uint8)
    n = fn(blocks.ctypes.data, n_blocks, ncomp, huff.ctypes.data,
           out.ctypes.data, out.size)
    if n < 0:
        raise ValueError(f"{path}: the JPEG entropy encoder failed ({n})")

    head = [b"\xff\xd8",
            _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for tid, qt in enumerate(qts):
        head.append(_segment(0xDB, bytes([tid]) + bytes(
            qt[ZIGZAG].astype(np.uint8))))
    comps = b"".join(bytes((c + 1, 0x11, min(c, 1))) for c in range(ncomp))
    head.append(_segment(0xC0, bytes([8]) + h.to_bytes(2, "big")
                         + w.to_bytes(2, "big") + bytes([ncomp]) + comps))
    for cls_id, counts, symbols in _STD_HUFF[:2 if ncomp == 1 else 4]:
        head.append(_segment(0xC4, bytes([cls_id]) + bytes(counts)
                             + symbols))
    sel = b"".join(bytes((c + 1, 0x11 * min(c, 1))) for c in range(ncomp))
    head.append(_segment(0xDA, bytes([ncomp]) + sel + b"\x00\x3f\x00"))
    with open(path, "wb") as f:
        f.write(b"".join(head))
        f.write(out[:n].tobytes())
        f.write(b"\xff\xd9")
