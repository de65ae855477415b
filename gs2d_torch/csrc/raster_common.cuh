// What the forward (rasterize_fwd.cu, K1) and backward (rasterize_bwd.cu,
// K2) compositing kernels share, so that the two cannot drift apart: the
// numeric contract of ops/rasterize/common.py, the record geometry, the
// two conservative skips (per warp row and per pixel) and the asynchronous
// staging of records.
//
// Both kernels are built without fast math and with -fmad=false
// (cuda_build.py), so every expression here rounds once per operation, in
// the order written, as the plain PyTorch versions do.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace gs2d {

constexpr int TILE_W = 32;
constexpr int TILE_H = 16;
constexpr int TILE_PX = TILE_W * TILE_H;
constexpr int NUM_WARPS = TILE_PX / 32;
constexpr int ENTRY_F = 24;      // record floats, FLD_* of common.py
constexpr int ENTRY_V = ENTRY_F / 4;   // 16-byte pieces of a record
constexpr int DENTRY_F = 22;     // gradient row floats, DFLD_*
constexpr int NUM_OUT = 15;
static_assert(TILE_W == 32, "a warp is one pixel row of a tile");

constexpr float ALPHA_CLAMP = 0.99f;
constexpr float ALPHA_CUTOFF = (float)(1.0 / 255.0);
constexpr float T_EPS = 1e-4f;
constexpr float NEAR_N = 0.2f;
constexpr float M_SCALE = (float)(100.0 / (100.0 - 0.2));
constexpr float M_SCALE_NEAR = (float)(100.0 / (100.0 - 0.2) * 0.2);
constexpr float FILTER_INV_SQUARE = 2.0f;

// The skip's margin on rho, CULL_MARGIN of common.py (the margin preprocess
// folds into rho2max). Why 0.05 is enough: the skip rejects a pair only if
// both rho3d and rho2d, each formed without division, exceed
// r = 2 ln(255 opacity) + margin. The exact path then computes
// alpha = opacity * expf(-rho / 2) with rho = min(rho3d, rho2d). Every
// rounding between the two is relative and small: u = p0/p2 and
// u*u + v*v against p0*p0 + p1*p1 and r*(p2*p2) differ by at most ~8 ulp
// (5e-7 of rho), logf and the product 255 * opacity by ~2 ulp of r, expf by
// 2 ulp and opacity * G by one (2e-7 of alpha, i.e. 4e-7 on rho). With
// rho ~ r <= 2 ln 255 + 0.05 ~ 11.1 for an opacity <= 1 the sum is < 1e-5
// on rho, 5,000 times below the margin; a larger opacity only scales the
// relative terms. Overflow cannot make the skip reject what the exact path
// keeps: an infinite p0*p0 + p1*p1 against a finite r*(p2*p2) means
// u*u + v*v > r already, and an infinite r*(p2*p2) rejects nothing.
constexpr float CULL_MARGIN = 0.05f;

// torch.minimum semantics: a NaN operand gives NaN (fminf would drop it)
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

// The largest rho at which a record can reach the alpha cutoff, widened by
// the margin: 2 ln(opacity / ALPHA_CUTOFF) + CULL_MARGIN. Negative (reject
// every pixel) when the opacity is below the cutoff; NaN (reject none)
// when it is NaN or negative. Formed once per staged record.
__device__ __forceinline__ float skip_radius(float opacity) {
  return 2.0f * logf(opacity * 255.0f) + CULL_MARGIN;
}

// The conservative per-pixel skip (plain twin: common.py::skip_pair).
// True only if p0^2 + p1^2 > r p2^2 (rho3d > r without the divisions) and
// rho2d > r: then alpha < 1/255 on the exact path, and the pair is not
// composited. Any NaN, or |p2| <= 1e-12, gives false: the exact path
// decides. It changes no decision, only how fast a hopeless pair is
// rejected.
__device__ __forceinline__ bool skip_pair(float p0, float p1, float p2,
                                          float rho2d, float r) {
  const float q3 = p0 * p0 + p1 * p1;
  return fabsf(p2) > 1e-12f && q3 > r * (p2 * p2) && rho2d > r;
}

// A staged record: ENTRY_F floats, 16-byte aligned for float4 reads.
struct __align__(16) Record {
  float f[ENTRY_F];
};

// The row test (plain twin: common.py::row_may_hit). A warp holds one
// pixel row of its tile: pixels x in [xa, xa + 31] at y = py. Once per
// staged (record, row) it asks whether any of those pixels can composite
// the record; false means the exact test rejects the record on every pixel
// of the row, and the warp leaves the record out without a per-pixel test.
// Conservative by construction, with every rounding bounded:
// - Low-pass branch: rho2d is smallest at the row's pixel nearest the
//   centre; rounding is monotonic, so every pixel's rho2d is >= the value
//   formed from that distance.
// - rho3d: along the row the ray-plane point p(x) = A + x B + y C is linear
//   in x, so while p2 keeps its sign (u, v) = (p0/p2, p1/p2) runs along the
//   straight segment between the row's end pixels, and rho3d >= the squared
//   distance from the origin to that segment. Each pixel forms p with
//   |p~ - p| <= 2^-22 E (E = |A| + |x B| + |y C|, four roundings), hence
//   (u, v) within delta = sum_i (err_i + W err_2) / (|p2|min - err_2) plus
//   the division's rounding, W bounding |u|, |v| on the row; the computed
//   segment lies within delta of the true one, so each pixel's point is
//   within 2 delta of it. The distance itself is formed with an error below
//   2^-18 W. The bounds use 2^-20 E (a factor 4 spare) and a spare factor
//   on every term.
// The skip radius r keeps CULL_MARGIN, which covers expf and the opacity
// product as for skip_pair. Rows where p2 changes sign or comes near 0 are
// never left out; a NaN leaves a row out only where r < 0, when no pixel
// can reach the cutoff (alpha <= opacity < 1/255).
__device__ __forceinline__ bool row_may_hit(const Record& rec, float r,
                                            float xa, float py) {
  const float4* v = reinterpret_cast<const float4*>(rec.f);
  const float4 a = v[0];   // e0..e3
  const float4 b = v[1];   // e4..e7
  const float4 c = v[2];   // e8..e11
  const float4 d = v[3];   // e12..e15
  const float xb = xa + (float)(TILE_W - 1);
  // the low-pass branch: rho2d at the row's pixel nearest the centre
  if (!(d.x == d.x)) return true;
  const float dxm = d.x < xa ? xa - d.x : (d.x > xb ? d.x - xb : 0.0f);
  const float dy = py - d.y;
  const float rho2d_min = FILTER_INV_SQUARE * (dxm * dxm + dy * dy);
  if (!(rho2d_min > r)) return true;
  // the ray-plane points of the end pixels, as each pixel forms them
  const float pa2 = a.z + xa * b.y + py * c.x;
  const float pb2 = a.z + xb * b.y + py * c.x;
  const float err2 = 0x1p-20f * (fabsf(a.z) + xb * fabsf(b.y)
                                 + py * fabsf(c.x));
  const float p2min = fminf(fabsf(pa2), fabsf(pb2));
  if ((pa2 > 0.0f) != (pb2 > 0.0f) || !(p2min > 4.0f * err2)) return true;
  const float pa0 = a.x + xa * a.w + py * b.z;
  const float pb0 = a.x + xb * a.w + py * b.z;
  const float pa1 = a.y + xa * b.x + py * b.w;
  const float pb1 = a.y + xb * b.x + py * b.w;
  const float err01 = 0x1p-20f * (fabsf(a.x) + xb * fabsf(a.w)
                                  + py * fabsf(b.z) + fabsf(a.y)
                                  + xb * fabsf(b.x) + py * fabsf(b.w));
  const float ia = __frcp_rn(pa2);
  const float ib = __frcp_rn(pb2);
  const float ua = pa0 * ia;
  const float va = pa1 * ia;
  const float ub = pb0 * ib;
  const float vb = pb1 * ib;
  const float W = fmaxf(fmaxf(fabsf(ua), fabsf(va)),
                        fmaxf(fabsf(ub), fabsf(vb)));
  const float iden = __frcp_rn(p2min - err2);
  const float Wt = 1.5f * (W + err01 * iden) + 0x1p-20f * W;
  const float delta = (err01 + 2.0f * Wt * err2) * iden * 1.25f
                      + 0x1p-20f * Wt;
  // distance from the origin to the segment (ua, va)-(ub, vb)
  const float sx = ub - ua;
  const float sy = vb - va;
  const float tc = fminf(fmaxf(-(ua * sx + va * sy)
                               * __frcp_rn(sx * sx + sy * sy), 0.0f), 1.0f);
  const float qx = ua + tc * sx;
  const float qy = va + tc * sy;
  const float D = __fsqrt_rn(qx * qx + qy * qy);
  const float lb = fmaxf(D * (1.0f - 0x1p-20f) - 0x1p-18f * W
                         - 2.0f * delta, 0.0f);
  return !(lb * lb * (1.0f - 0x1p-20f) > r);
}

// The ray-plane point of pixel (px, py) on record e (FLD_A + x FLD_B +
// y FLD_C) and the low-pass distance rho2d, in the plain versions' order.
struct Geometry {
  float p0, p1, p2, rho2d;
};

__device__ __forceinline__ Geometry record_geometry(const Record& rec,
                                                    float px, float py) {
  const float4* v = reinterpret_cast<const float4*>(rec.f);
  const float4 a = v[0];   // e0..e3
  const float4 b = v[1];   // e4..e7
  const float4 c = v[2];   // e8..e11
  const float4 d = v[3];   // e12..e15
  Geometry g;
  g.p0 = a.x + px * a.w + py * b.z;
  g.p1 = a.y + px * b.x + py * b.w;
  g.p2 = a.z + px * b.y + py * c.x;
  const float dx = px - d.x;
  const float dy = py - d.y;
  g.rho2d = FILTER_INV_SQUARE * (dx * dx + dy * dy);
  return g;
}

// cp.async with a source size: 0 fills the destination with zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Issue the asynchronous copies of packed[gid[first + r]] into rec[r] for
// r < n, spread over the CTA's TILE_PX threads, and commit them as one
// group: a 96-byte row is six 16-byte copies, so packed must be 16-byte
// aligned (the C entry points refuse it otherwise; the Python wrappers
// copy such a table first). An id outside the table stages a zero record,
// which p2 == 0 then skips.
__device__ __forceinline__ void stage_records(Record* rec,
                                              const float* __restrict__ packed,
                                              const int* __restrict__ gid,
                                              int first, int n,
                                              int num_gaussians, int tid) {
  for (int i = tid; i < n * ENTRY_V; i += TILE_PX) {
    const int r = i / ENTRY_V;
    const int k = i - r * ENTRY_V;
    const int g = gid[first + r];
    const bool ok = (unsigned)g < (unsigned)num_gaussians;
    const float* src = packed + (ok ? (size_t)g * ENTRY_F : 0) + 4 * k;
    cp_async16(rec[r].f + 4 * k, src, ok ? 16 : 0);
  }
  cp_async_commit();
}

// packed's alignment, which stage_records needs
inline bool records_aligned(const float* packed) {
  return (reinterpret_cast<uintptr_t>(packed) & 15) == 0;
}

}  // namespace gs2d
