// Huffman entropy coding of sequential JPEG scans (host C++): the decoder
// of one scan and the encoder of a baseline one.
//
// Decoder, the contract of gs2d_torch/scene/jpeg.py::_scan_plain: from the
// first byte after a scan's SOS header, decode every MCU of the scan into
// int16 coefficient blocks in natural (row-major) order, not dequantised,
// and return the offset of the marker that ends the scan. It handles byte
// stuffing (FF 00), fill bits and fill bytes before a marker, the DC
// prediction reset and RSTn resync every `restart` MCUs. No TPU kernel
// stands behind it: the JAX package decodes JPEG through PIL on the host.
// A 1080p photo holds ~10^6 Huffman symbols, seconds in Python, so the
// port's main path decodes here and only the tests take the Python twin.
//
// Encoder (gs2d_torch/scene/jpeg.py::encode_jpeg): quantised blocks in, the
// entropy-coded segment of one interleaved baseline scan out, as
// libjpeg's jchuff.c writes it (DC differences per component, runs of 16
// zeros as ZRL, EOB, 0xFF stuffed with 0x00, the last byte filled with
// 1-bits). Tested byte for byte against PIL's writer.
//
// Built by gs2d_torch/cuda_build.py with the host compiler (`c++`) into a
// shared library with a plain C interface, loaded with ctypes.
//
// Decoder errors (negative returns): -1 an invalid Huffman code, -2 the
// data of a segment ends before its last MCU, -3 a restart marker missing
// or out of order, -4 a coefficient index past 63, -5 the file ends inside
// the scan. Encoder errors: -1 a symbol the table has no code for (a
// coefficient out of the baseline range), -2 the output buffer is full.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// 65536-entry table indexed by the next 16 bits: length << 8 | symbol,
// 0 where no code starts with those bits.
bool build_lut(const uint8_t* counts, const uint8_t* symbols,
               std::vector<uint16_t>& lut) {
  lut.assign(65536, 0);
  uint32_t code = 0;
  int k = 0;
  for (int len = 1; len <= 16; ++len) {
    for (int i = 0; i < counts[len - 1]; ++i) {
      uint32_t lo = code << (16 - len), n = 1u << (16 - len);
      if (lo + n > 65536) return false;
      for (uint32_t j = 0; j < n; ++j)
        lut[lo + j] = static_cast<uint16_t>(len << 8 | symbols[k]);
      ++code;
      ++k;
    }
    if (code > (1u << len)) return false;
    code <<= 1;
  }
  return true;
}

struct Bits {
  const uint8_t* d;
  int64_t len, pos;
  uint64_t buf = 0;   // the next `cnt` bits, left-aligned
  int cnt = 0;
  bool marker = false;
  int64_t pad = 0;    // zero bits appended after a marker was reached

  void fill() {
    while (cnt <= 56) {
      uint32_t byte = 0;
      if (marker) {
        pad += 8;
      } else if (pos >= len) {
        marker = true;
        pad += 8;
      } else if (d[pos] == 0xFF) {
        if (pos + 1 < len && d[pos + 1] == 0x00) {
          byte = 0xFF;
          pos += 2;
        } else {
          marker = true;  // stop before it: feed zeros from here on
          pad += 8;
        }
      } else {
        byte = d[pos++];
      }
      buf |= static_cast<uint64_t>(byte) << (56 - cnt);
      cnt += 8;
    }
  }
  uint32_t peek16() {
    if (cnt < 16) fill();
    return static_cast<uint32_t>(buf >> 48);
  }
  void skip(int n) {
    buf <<= n;
    cnt -= n;
  }
  int32_t get(int n) {  // n in 1..16
    if (cnt < n) fill();
    int32_t v = static_cast<int32_t>(buf >> (64 - n));
    skip(n);
    return v;
  }
  bool overrun() const { return pad > cnt; }
};

inline int32_t extend(int32_t v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

}  // namespace

extern "C" int64_t jpeg_decode_scan(const char* data_, int64_t len,
                                    int64_t pos, int32_t ncomp,
                                    const int32_t* params, int16_t** coefs,
                                    const uint8_t* huff, int32_t mcux,
                                    int32_t mcuy, int32_t restart) {
  const uint8_t* data = reinterpret_cast<const uint8_t*>(data_);
  // params per component: h, v, dc table, ac table, blocks per row
  std::vector<uint16_t> luts[8];
  for (int c = 0; c < ncomp; ++c) {
    for (int t : {params[c * 5 + 2], params[c * 5 + 3] + 4}) {
      if (!luts[t].empty()) continue;
      const uint8_t* h = huff + t * 272;
      if (!build_lut(h, h + 16, luts[t])) return -1;
    }
  }
  struct Unit { int c, y, x; };
  std::vector<Unit> units;
  for (int c = 0; c < ncomp; ++c)
    for (int y = 0; y < params[c * 5 + 1]; ++y)
      for (int x = 0; x < params[c * 5]; ++x) units.push_back({c, y, x});

  Bits bits{data, len, pos};
  int32_t pred[4] = {0, 0, 0, 0};
  const int64_t n_mcu = static_cast<int64_t>(mcux) * mcuy;
  int rst = 0;
  for (int64_t m = 0; m < n_mcu; ++m) {
    if (restart && m && m % restart == 0) {
      // the segment's fill bits are dropped; RSTn must come next
      if (bits.overrun()) return -2;
      int64_t p = bits.pos;
      if (p >= len || data[p] != 0xFF) return -3;
      while (p < len && data[p] == 0xFF) ++p;
      if (p >= len || data[p] != 0xD0 + rst) return -3;
      rst = (rst + 1) & 7;
      bits = Bits{data, len, p + 1};
      pred[0] = pred[1] = pred[2] = pred[3] = 0;
    }
    const int64_t my = m / mcux, mx = m % mcux;
    for (const Unit& u : units) {
      const int32_t* pr = params + u.c * 5;
      int16_t* blk = coefs[u.c] +
          ((my * pr[1] + u.y) * static_cast<int64_t>(pr[4]) + mx * pr[0] +
           u.x) * 64;
      std::memset(blk, 0, 64 * sizeof(int16_t));
      const std::vector<uint16_t>& dc = luts[pr[2]];
      const std::vector<uint16_t>& ac = luts[pr[3] + 4];
      uint16_t e = dc[bits.peek16()];
      if (!e) return -1;
      bits.skip(e >> 8);
      int s = e & 255;
      if (s) pred[u.c] += extend(bits.get(s), s);
      blk[0] = static_cast<int16_t>(pred[u.c]);
      for (int k = 1; k < 64;) {
        e = ac[bits.peek16()];
        if (!e) return -1;
        bits.skip(e >> 8);
        int rs = e & 255, r = rs >> 4;
        s = rs & 15;
        if (s) {
          k += r;
          if (k > 63) return -4;
          blk[kZigzag[k]] = static_cast<int16_t>(extend(bits.get(s), s));
          ++k;
        } else if (rs == 0xF0) {
          k += 16;
          if (k > 64) return -4;
        } else {
          break;  // end of block
        }
      }
    }
  }
  if (bits.overrun()) return -2;
  // the marker that ends the scan: skip stuffed bytes and RSTn left in the
  // stream, stop at the first other marker
  int64_t p = bits.pos;
  while (true) {
    while (p < len && data[p] != 0xFF) ++p;
    if (p + 1 >= len) return -5;
    int64_t q = p + 1;
    while (q < len && data[q] == 0xFF) ++q;
    if (q >= len) return -5;
    if (data[q] == 0x00 || (data[q] >= 0xD0 && data[q] <= 0xD7)) {
      p = q + 1;
      continue;
    }
    return p;
  }
}

namespace {

struct BitWriter {
  uint8_t* out;
  int64_t cap, pos = 0;
  uint64_t acc = 0;  // pending bits, right-aligned
  int cnt = 0;
  bool full = false;

  void byte(uint8_t b) {
    if (pos + 2 > cap) {
      full = true;
      return;
    }
    out[pos++] = b;
    if (b == 0xFF) out[pos++] = 0x00;
  }
  void put(uint32_t code, int size) {  // size in 0..16
    acc = (acc << size) | (code & ((1u << size) - 1));
    cnt += size;
    while (cnt >= 8) {
      cnt -= 8;
      byte(static_cast<uint8_t>(acc >> cnt));
    }
  }
  void flush() {  // fill the last byte with 1-bits
    if (cnt) put(0x7F, 8 - cnt);
  }
};

// ehufco / ehufsi of jpeg_make_c_derived_tbl: code and length per symbol,
// length 0 where the table has no code for it.
void build_codes(const uint8_t* counts, const uint8_t* symbols,
                 uint16_t* code, uint8_t* size) {
  std::memset(size, 0, 256);
  uint32_t c = 0;
  int k = 0;
  for (int len = 1; len <= 16; ++len) {
    for (int i = 0; i < counts[len - 1]; ++i, ++k, ++c) {
      code[symbols[k]] = static_cast<uint16_t>(c);
      size[symbols[k]] = static_cast<uint8_t>(len);
    }
    c <<= 1;
  }
}

inline int nbits_of(int32_t v) {
  int n = 0;
  for (uint32_t a = v < 0 ? -v : v; a; a >>= 1) ++n;
  return n;
}

}  // namespace

// blocks: n_blocks int16 blocks of 64 quantised coefficients in natural
// order, in scan order: block b belongs to component b % ncomp. huff: four
// tables of 16 counts + 256 symbols, DC and AC of component 0, then DC and
// AC of the other components. Returns the bytes written to `out`.
extern "C" int64_t jpeg_encode_scan(const int16_t* blocks, int64_t n_blocks,
                                    int32_t ncomp, const uint8_t* huff,
                                    uint8_t* out, int64_t cap) {
  uint16_t code[4][256];
  uint8_t size[4][256];
  for (int t = 0; t < 4; ++t)
    build_codes(huff + t * 272, huff + t * 272 + 16, code[t], size[t]);
  BitWriter w{out, cap};
  int32_t pred[4] = {0, 0, 0, 0};
  for (int64_t b = 0; b < n_blocks; ++b) {
    const int c = static_cast<int>(b % ncomp);
    const int dc = c ? 2 : 0, ac = dc + 1;
    const int16_t* blk = blocks + b * 64;
    int32_t diff = blk[0] - pred[c];
    pred[c] = blk[0];
    int n = nbits_of(diff);
    if (!size[dc][n]) return -1;
    w.put(code[dc][n], size[dc][n]);
    if (n) w.put(static_cast<uint32_t>(diff < 0 ? diff - 1 : diff), n);
    int run = 0;
    for (int k = 1; k < 64; ++k) {
      int32_t v = blk[kZigzag[k]];
      if (!v) {
        ++run;
        continue;
      }
      for (; run > 15; run -= 16) {
        if (!size[ac][0xF0]) return -1;
        w.put(code[ac][0xF0], size[ac][0xF0]);
      }
      n = nbits_of(v);
      const int rs = (run << 4) + n;
      if (n > 15 || !size[ac][rs]) return -1;
      w.put(code[ac][rs], size[ac][rs]);
      w.put(static_cast<uint32_t>(v < 0 ? v - 1 : v), n);
      run = 0;
    }
    if (run) {
      if (!size[ac][0]) return -1;
      w.put(code[ac][0], size[ac][0]);
    }
    if (w.full) return -2;
  }
  w.flush();
  return w.full ? -2 : w.pos;
}
