// The per-surfel arithmetic of the render's preprocess, shared by its
// forward kernel (preprocess_fwd.cu) and its backward kernel
// (preprocess_bwd.cu), which recomputes the forward's intermediates in
// registers instead of reading them back.
//
// Every expression repeats, in the same float32 operation order, the
// plain PyTorch version: ops/rasterize/preprocess.py::preprocess on the
// activated parameters (exp of the log-scales, sigmoid of the opacity
// logit, the quaternion's normalisation), ops/sh.py::eval_sh at the
// active degree, and pack_entries (a row with any non-finite value is
// zeroed). Built with -fmad=false and without fast math: expf, logf,
// sqrtf, rsqrtf, IEEE division and one rounding per operation.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gs2d_pre {

constexpr int THREADS = 128;   // surfels of a block
constexpr int REC = 24;        // floats of K1's record (common.py FLD_*)

// ops/rasterize/common.py (Python floats, rounded to float32 where the
// plain version meets them)
// rho2max divides by ALPHA_CUTOFF as PyTorch's CUDA kernels divide a
// tensor by a Python float: a product by its reciprocal, taken in double
// and rounded to float32, 255 (measured on the H100 with torch 2.11; its
// CPU kernels divide, which can differ by an ulp)
constexpr float INV_ALPHA_CUTOFF = (float)(1.0 / (1.0 / 255.0));
constexpr float NEAR_N = 0.2f;
constexpr float FILTER_INV_SQUARE = 2.0f;
constexpr float SIGMA_CUTOFF = 3.0f;
constexpr float CULL_MARGIN = 0.05f;

// ops/sh.py
constexpr float SC0 = (float)0.28209479177387814;
constexpr float SC1 = (float)0.4886025119029199;
constexpr float SC2_0 = (float)1.0925484305920792;
constexpr float SC2_1 = (float)-1.0925484305920792;
constexpr float SC2_2 = (float)0.31539156525252005;
constexpr float SC2_3 = (float)-1.0925484305920792;
constexpr float SC2_4 = (float)0.5462742152960396;
constexpr float SC3_0 = (float)-0.5900435899266435;
constexpr float SC3_1 = (float)2.890611442640554;
constexpr float SC3_2 = (float)-0.4570457994644658;
constexpr float SC3_3 = (float)0.3731763325901154;
constexpr float SC3_4 = (float)-0.4570457994644658;
constexpr float SC3_5 = (float)1.445305721320277;
constexpr float SC3_6 = (float)-0.5900435899266435;
constexpr float SC4_0 = (float)2.5033429417967046;
constexpr float SC4_1 = (float)-1.7701307697799304;
constexpr float SC4_2 = (float)0.9461746957575601;
constexpr float SC4_3 = (float)-0.6690465435572892;
constexpr float SC4_4 = (float)0.10578554691520431;
constexpr float SC4_5 = (float)-0.6690465435572892;
constexpr float SC4_6 = (float)0.47308734787878004;
constexpr float SC4_7 = (float)-1.7701307697799304;
constexpr float SC4_8 = (float)0.6258357354491761;

// torch.maximum and torch.clamp(min=) keep a NaN; fmaxf would drop it
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? a + b : (a > b ? a : b);
}
__device__ __forceinline__ float clamp_min(float a, float lo) {
  return a < lo ? lo : a;
}

// The camera, in shared memory: world_view as stored (row-vector, M[i][j]
// at 4i + j), the columns x̃, ỹ, w̃ of full_proj @ ndc2pix
// (preprocess.py::world_to_pix, w2p[3i + j]) and the camera's centre.
struct Cam {
  float wv[16];
  float w2p[12];
  float campos[3];
};

__device__ __forceinline__ void load_cam(Cam& c, const float* wv,
                                         const float* fp, const float* campos,
                                         int width, int height) {
  const int t = threadIdx.x;
  if (t < 16) c.wv[t] = wv[t];
  if (t < 4) {
    const float hw = (float)((double)width / 2.0);
    const float cw = (float)(((double)width - 1.0) / 2.0);
    const float hh = (float)((double)height / 2.0);
    const float ch = (float)(((double)height - 1.0) / 2.0);
    const float w = fp[4 * t + 3];
    c.w2p[3 * t + 0] = fp[4 * t + 0] * hw + w * cw;
    c.w2p[3 * t + 1] = fp[4 * t + 1] * hh + w * ch;
    c.w2p[3 * t + 2] = w;
  }
  if (t < 3) c.campos[t] = campos[t];
}

// One surfel's raw parameters (opacity is the logit; colors, noise and
// offsets null where absent).
struct In {
  float m[3], sc[2], q[4], op;
  const float* dc;     // 3 floats, SH coefficient 0
  const float* rest;   // coefficient k >= 1, channel c at 3(k - 1) + c
  float col[3];        // colors, when given
  float noise[3];
  float off[2];
  bool has_colors, has_noise, has_off;
};

// The forward's intermediates that the record, the aux and the gradient
// need.
struct Geo {
  float s0, s1, su, sv, o;
  float qn, nrm, qh[4];
  float tu[3], tv[3], tw[3];       // the rotation's columns
  float c[3][3];                   // c[j] = column j of Tm: (row 0, 1, 2)
  float B[3], C[3];
  float dd, den, cx, cy;
  bool dd_ok;
  float pv[3], nv[3], flip;
  float d[3], r, dir[3];           // SH direction (with SH only)
  float v[3];                      // the SH sum before + 0.5 (with SH)
  float rec[REC];
  bool finite;
};

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// r = a x b, rounded as torch.linalg.cross rounds it: its kernel's
// a_i b_j - a_j b_i is contracted to fma(a_i, b_j, -(a_j b_i)) (measured
// bit for bit on the CPU; the one fused expression of the plain version)
__device__ __forceinline__ void cross3(const float* a, const float* b,
                                       float* r) {
  r[0] = fmaf(a[1], b[2], -(a[2] * b[1]));
  r[1] = fmaf(a[2], b[0], -(a[0] * b[2]));
  r[2] = fmaf(a[0], b[1], -(a[1] * b[0]));
}

// The SH basis up to degree D, each factor formed as eval_sh forms it,
// so that sum_k b[k] sh_k in order k is eval_sh's sum (k = 1 and 3 enter
// there subtracted: a - t == a + (-t)).
template <int D>
__device__ __forceinline__ void sh_basis(float x, float y, float z,
                                         float* b) {
  b[0] = SC0;
  if (D >= 1) {
    b[1] = -(SC1 * y);
    b[2] = SC1 * z;
    b[3] = -(SC1 * x);
  }
  if (D >= 2) {
    const float xx = x * x, yy = y * y, zz = z * z;
    const float xy = x * y, yz = y * z, xz = x * z;
    b[4] = SC2_0 * xy;
    b[5] = SC2_1 * yz;
    b[6] = SC2_2 * (2.0f * zz - xx - yy);
    b[7] = SC2_3 * xz;
    b[8] = SC2_4 * (xx - yy);
    if (D >= 3) {
      b[9] = SC3_0 * y * (3.0f * xx - yy);
      b[10] = SC3_1 * xy * z;
      b[11] = SC3_2 * y * (4.0f * zz - xx - yy);
      b[12] = SC3_3 * z * (2.0f * zz - 3.0f * xx - 3.0f * yy);
      b[13] = SC3_4 * x * (4.0f * zz - xx - yy);
      b[14] = SC3_5 * z * (xx - yy);
      b[15] = SC3_6 * x * (xx - 3.0f * yy);
    }
    if (D >= 4) {
      b[16] = SC4_0 * xy * (xx - yy);
      b[17] = SC4_1 * yz * (3.0f * xx - yy);
      b[18] = SC4_2 * xy * (7.0f * zz - 1.0f);
      b[19] = SC4_3 * yz * (7.0f * zz - 3.0f);
      b[20] = SC4_4 * (zz * (35.0f * zz - 30.0f) + 3.0f);
      b[21] = SC4_5 * xz * (7.0f * zz - 3.0f);
      b[22] = SC4_6 * (xx - yy) * (7.0f * zz - 1.0f);
      b[23] = SC4_7 * xz * (xx - 3.0f * yy);
      b[24] = SC4_8 * (xx * (xx - 3.0f * yy) - yy * (3.0f * xx - yy));
    }
  }
}

__device__ __forceinline__ float sh_coef(const In& in, int k, int ch) {
  return k == 0 ? in.dc[ch] : in.rest[3 * (k - 1) + ch];
}

// Everything preprocess + pack_entries compute for the record, and the
// intermediates of the gradient. D: the active SH degree (unused with
// colors).
template <int D>
__device__ __forceinline__ void geometry(const Cam& cam, const In& in,
                                         float smod, Geo& g) {
  // activation: exp of the log-scales, sigmoid of the logit
  g.s0 = expf(in.sc[0]);
  g.s1 = expf(in.sc[1]);
  g.su = g.s0 * smod;
  g.sv = g.s1 * smod;
  g.o = 1.0f / (1.0f + expf(-in.op));

  // the quaternion, normalised (quat.py)
  const float* q = in.q;
  g.qn = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  g.nrm = clamp_min(g.qn, 1e-12f);
  for (int k = 0; k < 4; ++k) g.qh[k] = q[k] / g.nrm;
  const float w = g.qh[0], x = g.qh[1], y = g.qh[2], z = g.qh[3];
  // quat_to_rotmat, by columns: tu = R[:, 0], tv = R[:, 1], tw = R[:, 2]
  g.tu[0] = 1.0f - 2.0f * (y * y + z * z);
  g.tu[1] = 2.0f * (x * y + w * z);
  g.tu[2] = 2.0f * (x * z - w * y);
  g.tv[0] = 2.0f * (x * y - w * z);
  g.tv[1] = 1.0f - 2.0f * (x * x + z * z);
  g.tv[2] = 2.0f * (y * z + w * x);
  g.tw[0] = 2.0f * (x * z + w * y);
  g.tw[1] = 2.0f * (y * z - w * x);
  g.tw[2] = 1.0f - 2.0f * (x * x + y * y);

  // the homography: rows [su·tu | 0], [sv·tv | 0], [mean | 1] times w2p
  const float U[3] = {g.su * g.tu[0], g.su * g.tu[1], g.su * g.tu[2]};
  const float V[3] = {g.sv * g.tv[0], g.sv * g.tv[1], g.sv * g.tv[2]};
  const float* M = cam.w2p;
  for (int j = 0; j < 3; ++j) {
    g.c[j][0] = U[0] * M[j] + U[1] * M[3 + j] + U[2] * M[6 + j];
    g.c[j][1] = V[0] * M[j] + V[1] * M[3 + j] + V[2] * M[6 + j];
    g.c[j][2] = in.m[0] * M[j] + in.m[1] * M[3 + j] + in.m[2] * M[6 + j]
                + M[9 + j];
  }
  float A[3];
  cross3(g.c[0], g.c[1], A);
  cross3(g.c[1], g.c[2], g.B);
  cross3(g.c[2], g.c[0], g.C);
  if (in.has_off) {
    for (int k = 0; k < 3; ++k)
      A[k] = A[k] - in.off[0] * g.B[k] - in.off[1] * g.C[k];
  }

  // the centre: _dual_aabb at r2 = 1, sgn = (1, 1, -1)
  const float* c0 = g.c[0];
  const float* c1 = g.c[1];
  const float* c2 = g.c[2];
  g.dd = c2[0] * c2[0] * 1.0f + c2[1] * c2[1] * 1.0f + c2[2] * c2[2] * -1.0f;
  g.dd_ok = fabsf(g.dd) > 1e-12f;
  g.den = g.dd_ok ? g.dd : 1.0f;
  const float f01 = 1.0f / g.den, f2 = -1.0f / g.den;
  g.cx = f01 * c0[0] * c2[0] + f01 * c0[1] * c2[1] + f2 * c0[2] * c2[2];
  g.cy = f01 * c1[0] * c2[0] + f01 * c1[1] * c2[1] + f2 * c1[2] * c2[2];

  // view space: the centre's depth and the camera-facing normal
  const float* V4 = cam.wv;
  for (int j = 0; j < 3; ++j) {
    g.pv[j] = in.m[0] * V4[j] + in.m[1] * V4[4 + j] + in.m[2] * V4[8 + j]
              + V4[12 + j];
    g.nv[j] = g.tw[0] * V4[j] + g.tw[1] * V4[4 + j] + g.tw[2] * V4[8 + j];
  }
  g.flip = dot3(g.pv, g.nv) < 0.0f ? 1.0f : -1.0f;

  // the colour
  float rgb[3];
  if (in.has_colors) {
    for (int k = 0; k < 3; ++k) rgb[k] = in.col[k];
  } else {
    for (int k = 0; k < 3; ++k) g.d[k] = in.m[k] - cam.campos[k];
    g.r = rsqrtf(dot3(g.d, g.d) + 1e-16f);
    for (int k = 0; k < 3; ++k) g.dir[k] = g.d[k] * g.r;
    float b[(D + 1) * (D + 1)];
    sh_basis<D>(g.dir[0], g.dir[1], g.dir[2], b);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      float v = b[0] * sh_coef(in, 0, ch);
#pragma unroll
      for (int k = 1; k < (D + 1) * (D + 1); ++k)
        v = v + b[k] * sh_coef(in, k, ch);
      g.v[ch] = v;
      rgb[ch] = clamp_min(v + 0.5f, 0.0f);
    }
  }

  // K1's record (common.py FLD_*), zeroed where any value is not finite
  float* e = g.rec;
  for (int k = 0; k < 3; ++k) {
    e[k] = A[k];
    e[3 + k] = g.B[k];
    e[6 + k] = g.C[k];
    e[9 + k] = c2[k];
    e[15 + k] = rgb[k];
    e[18 + k] = g.nv[k] * g.flip;
    e[21 + k] = in.has_noise ? in.noise[k] : 0.0f;
  }
  e[12] = g.cx;
  e[13] = g.cy;
  e[14] = g.o;
  bool finite = true;
#pragma unroll
  for (int k = 0; k < REC; ++k) finite = finite && isfinite(e[k]);
  g.finite = finite;
  if (!finite) {
#pragma unroll
    for (int k = 0; k < REC; ++k) e[k] = 0.0f;
  }
}

// Rows [r0, r0 + rows) of a row-major (n, m) float array, columns [0, mc),
// to shared memory at a row stride of m. 16-byte copies where whole rows
// are wanted and the block's span is 16-byte aligned (a block starts at
// r0 = 128·b, 512·m bytes in), else one float a thread at a time.
__device__ __forceinline__ void stage_in(float* s, const float* g,
                                         long long r0, int rows, int m,
                                         int mc) {
  const float* src = g + r0 * m;
  if (mc == m && ((uintptr_t)src & 15) == 0) {
    const int total = rows * m, n4 = total / 4;
    for (int i = threadIdx.x; i < n4; i += THREADS)
      reinterpret_cast<float4*>(s)[i] = reinterpret_cast<const float4*>(src)[i];
    for (int i = 4 * n4 + threadIdx.x; i < total; i += THREADS) s[i] = src[i];
    return;
  }
  for (int i = threadIdx.x; i < rows * mc; i += THREADS) {
    const int r = i / mc, k = i - r * mc;
    s[r * m + k] = src[(long long)r * m + k];
  }
}

// Whole rows [r0, r0 + rows) of an (n, m) array from shared memory (row
// stride m) to device memory, in 16-byte copies where aligned.
__device__ __forceinline__ void stage_out(float* g, const float* s,
                                          long long r0, int rows, int m) {
  float* dst = g + r0 * m;
  const int total = rows * m;
  if (((uintptr_t)dst & 15) == 0) {
    const int n4 = total / 4;
    for (int i = threadIdx.x; i < n4; i += THREADS)
      reinterpret_cast<float4*>(dst)[i] = reinterpret_cast<const float4*>(s)[i];
    for (int i = 4 * n4 + threadIdx.x; i < total; i += THREADS) dst[i] = s[i];
    return;
  }
  for (int i = threadIdx.x; i < total; i += THREADS) dst[i] = s[i];
}

// One surfel's inputs; `rest` points at its staged row in shared memory.
__device__ __forceinline__ void load_in(In& in, long long i,
                                        const float* xyz, const float* scaling,
                                        const float* rotation,
                                        const float* opacity,
                                        const float* dc, const float* rest,
                                        const float* colors,
                                        const float* noise,
                                        const float* offsets) {
  for (int k = 0; k < 3; ++k) in.m[k] = xyz[3 * i + k];
  in.sc[0] = scaling[2 * i];
  in.sc[1] = scaling[2 * i + 1];
  for (int k = 0; k < 4; ++k) in.q[k] = rotation[4 * i + k];
  in.op = opacity[i];
  in.dc = dc ? dc + 3 * i : nullptr;
  in.rest = rest;
  in.has_colors = colors != nullptr;
  in.has_noise = noise != nullptr;
  in.has_off = offsets != nullptr;
  for (int k = 0; k < 3; ++k) {
    in.col[k] = colors ? colors[3 * i + k] : 0.0f;
    in.noise[k] = noise ? noise[3 * i + k] : 0.0f;
  }
  in.off[0] = offsets ? offsets[2 * i] : 0.0f;
  in.off[1] = offsets ? offsets[2 * i + 1] : 0.0f;
}

}  // namespace gs2d_pre
