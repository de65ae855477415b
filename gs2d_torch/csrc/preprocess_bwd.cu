// The render's preprocess, backward: the gradient of K1's record → every
// raw parameter's gradient in its own layout, in one pass, sm_90a.
//
// Replaces no TPU kernel: in the JAX package XLA differentiates and fuses
// this layer. Under eager autograd the same gradient ran as some 400
// kernels over (N,)-vectors, and each of the 16 SH coefficient selects
// filled a zero (N, 16, 3) tensor of 576 MB at 3.0M surfels that autograd
// then summed: ~9 GB of fills and 26 GB of adds an iteration. This kernel
// reads the record's gradient (the (N, 24) that _Composite.backward
// returns) and the raw parameters, recomputes the forward's intermediates
// in registers (preprocess_common.cuh, the forward kernel's own code, so
// it makes the forward's decisions: the zeroed rows, the flip, the colour
// clamp), and writes each gradient once. It transcribes
// ops/rasterize/preprocess.py::preprocess_bwd_reference step by step.
//
// Design. One thread per surfel, 128 surfels a block. The block stages the
// records' gradients (96 bytes a row) and the SH rows (180 bytes at degree
// 3) into shared memory in 16-byte copies contiguous across the block; a
// thread reads its rows from there and writes its SH gradient row back in
// place (coefficients above the active degree as exact zeros); the block
// then writes the SH gradient rows out in 16-byte copies. The other
// gradients (xyz 12 bytes, scaling 8, rotation 16, opacity 4, SH
// coefficient 0, colours, noise, offsets) are written per thread. A row
// the forward zeroed (a non-finite value) gets zero gradients.
//
// Bound on the H100 (3.35 TB/s): bytes. At SH degree 3 a surfel reads the
// record's gradient (96 bytes) and its parameters (240 with offsets) and
// writes their gradients (240): 576 bytes, 1.73 GB at 3.0M surfels,
// 0.52 ms. The arithmetic (~1500 FP32 operations a surfel: the forward
// again, the chain through the crosses, the centre, the rotation and the
// SH basis's derivatives) is ~4.5 GFLOP, 0.07 ms.

#include "preprocess_common.cuh"

namespace {

using namespace gs2d_pre;

// sum_k w[k] grad b_k of the basis of sh_basis<D>, as
// preprocess.py::_sh_dir_grad forms it.
template <int D>
__device__ __forceinline__ void sh_dir_grad(float x, float y, float z,
                                            const float* w, float* g) {
  g[0] = g[1] = g[2] = 0.0f;
#define ACC(k, c, dx, dy, dz)                                                \
  {                                                                          \
    const float t_ = (c) * w[k];                                             \
    g[0] = g[0] + t_ * (dx);                                                 \
    g[1] = g[1] + t_ * (dy);                                                 \
    g[2] = g[2] + t_ * (dz);                                                 \
  }
  if (D >= 1) {
    ACC(1, -SC1, 0.0f, 1.0f, 0.0f);
    ACC(2, SC1, 0.0f, 0.0f, 1.0f);
    ACC(3, -SC1, 1.0f, 0.0f, 0.0f);
  }
  if (D >= 2) {
    const float xx = x * x, yy = y * y, zz = z * z;
    ACC(4, SC2_0, y, x, 0.0f);
    ACC(5, SC2_1, 0.0f, z, y);
    ACC(6, SC2_2, -2.0f * x, -2.0f * y, 4.0f * z);
    ACC(7, SC2_3, z, 0.0f, x);
    ACC(8, SC2_4, 2.0f * x, -2.0f * y, 0.0f);
    if (D >= 3) {
      const float xy = x * y, yz = y * z, xz = x * z;
      ACC(9, SC3_0, 6.0f * xy, 3.0f * (xx - yy), 0.0f);
      ACC(10, SC3_1, yz, xz, xy);
      ACC(11, SC3_2, -2.0f * xy, 4.0f * zz - xx - 3.0f * yy, 8.0f * yz);
      ACC(12, SC3_3, -6.0f * xz, -6.0f * yz, 6.0f * zz - 3.0f * xx - 3.0f * yy);
      ACC(13, SC3_4, 4.0f * zz - 3.0f * xx - yy, -2.0f * xy, 8.0f * xz);
      ACC(14, SC3_5, 2.0f * xz, -2.0f * yz, xx - yy);
      ACC(15, SC3_6, 3.0f * (xx - yy), -6.0f * xy, 0.0f);
      if (D >= 4) {
        const float xyz = xy * z;
        const float z7m1 = 7.0f * zz - 1.0f, z7m3 = 7.0f * zz - 3.0f;
        ACC(16, SC4_0, y * (3.0f * xx - yy), x * (xx - 3.0f * yy), 0.0f);
        ACC(17, SC4_1, 6.0f * xyz, 3.0f * z * (xx - yy), y * (3.0f * xx - yy));
        ACC(18, SC4_2, y * z7m1, x * z7m1, 14.0f * xyz);
        ACC(19, SC4_3, 0.0f, z * z7m3, y * (21.0f * zz - 3.0f));
        ACC(20, SC4_4, 0.0f, 0.0f, z * (140.0f * zz - 60.0f));
        ACC(21, SC4_5, z * z7m3, 0.0f, x * (21.0f * zz - 3.0f));
        ACC(22, SC4_6, 2.0f * x * z7m1, -2.0f * y * z7m1, 14.0f * z * (xx - yy));
        ACC(23, SC4_7, z * (3.0f * xx - 3.0f * yy), -6.0f * xyz,
            x * (xx - 3.0f * yy));
        ACC(24, SC4_8, 4.0f * x * (xx - 3.0f * yy), 4.0f * y * (yy - 3.0f * xx),
            0.0f);
      }
    }
  }
#undef ACC
}

template <int D>
__global__ void __launch_bounds__(THREADS)
preprocess_bwd_kernel(const float* __restrict__ d_packed,
                      const float* __restrict__ xyz,
                      const float* __restrict__ scaling,
                      const float* __restrict__ rotation,
                      const float* __restrict__ opacity,
                      const float* __restrict__ features_dc,
                      const float* __restrict__ features_rest,
                      const float* __restrict__ colors,
                      const float* __restrict__ noise,
                      const float* __restrict__ offsets,
                      const float* __restrict__ world_view,
                      const float* __restrict__ full_proj,
                      const float* __restrict__ campos, int m, int mc,
                      int width, int height, float smod, long long n,
                      float* __restrict__ g_xyz, float* __restrict__ g_scaling,
                      float* __restrict__ g_rotation,
                      float* __restrict__ g_opacity,
                      float* __restrict__ g_dc, float* __restrict__ g_rest,
                      float* __restrict__ g_colors,
                      float* __restrict__ g_noise,
                      float* __restrict__ g_off) {
  extern __shared__ float4 smem4[];
  float* s_rec = reinterpret_cast<float*>(smem4);   // THREADS x REC
  float* s_sh = s_rec + THREADS * REC;              // THREADS x m
  __shared__ Cam cam;
  load_cam(cam, world_view, full_proj, campos, width, height);
  const long long r0 = (long long)blockIdx.x * THREADS;
  const int rows = (int)(n - r0 < THREADS ? n - r0 : THREADS);
  stage_in(s_rec, d_packed, r0, rows, REC, REC);
  if (mc > 0) stage_in(s_sh, features_rest, r0, rows, m, mc);
  __syncthreads();

  const int t = threadIdx.x;
  if (t < rows) {
    const long long i = r0 + t;
    float* sh_row = s_sh + t * m;
    In in;
    load_in(in, i, xyz, scaling, rotation, opacity, features_dc, sh_row,
            colors, noise, offsets);
    Geo g;
    geometry<D>(cam, in, smod, g);
    float gr[REC];
    const float4* src = reinterpret_cast<const float4*>(s_rec + t * REC);
#pragma unroll
    for (int k = 0; k < REC / 4; ++k) {
      const float4 v = src[k];
      // a zeroed row's gradient is zero (the finite rows' cotangent kept)
      gr[4 * k] = g.finite ? v.x : 0.0f;
      gr[4 * k + 1] = g.finite ? v.y : 0.0f;
      gr[4 * k + 2] = g.finite ? v.z : 0.0f;
      gr[4 * k + 3] = g.finite ? v.w : 0.0f;
    }
    const float* gA = gr;
    const float* gB = gr + 3;
    const float* gC = gr + 6;
    const float* c0 = g.c[0];
    const float* c1 = g.c[1];
    const float* c2 = g.c[2];

    // the screen offsets: A = c0 x c1 - off0 B - off1 C
    float gBt[3], gCt[3];
    for (int k = 0; k < 3; ++k) {
      gBt[k] = gB[k];
      gCt[k] = gC[k];
    }
    if (in.has_off) {
      if (g_off) {
        g_off[2 * i] = g.finite ? -dot3(gA, g.B) : 0.0f;
        g_off[2 * i + 1] = g.finite ? -dot3(gA, g.C) : 0.0f;
      }
      for (int k = 0; k < 3; ++k) {
        gBt[k] = gB[k] - in.off[0] * gA[k];
        gCt[k] = gC[k] - in.off[1] * gA[k];
      }
    }
    // the three crosses
    float gc0[3], gc1[3], gc2[3], t1[3], t2[3];
    cross3(c1, gA, t1);
    cross3(gCt, c2, t2);
    for (int k = 0; k < 3; ++k) gc0[k] = t1[k] + t2[k];
    cross3(gA, c0, t1);
    cross3(c2, gBt, t2);
    for (int k = 0; k < 3; ++k) gc1[k] = t1[k] + t2[k];
    cross3(gBt, c1, t1);
    cross3(c0, gCt, t2);
    for (int k = 0; k < 3; ++k) gc2[k] = gr[9 + k] + t1[k] + t2[k];
    // the centre: cx = <c0, eta c2> / dd, cy = <c1, eta c2> / dd
    const float ic = 1.0f / g.den;
    const float kx = gr[12] * ic, ky = gr[13] * ic;
    const float tc =
        g.dd_ok ? 2.0f * (gr[12] * g.cx + gr[13] * g.cy) * ic : 0.0f;
    const float eta[3] = {1.0f, 1.0f, -1.0f};
    for (int k = 0; k < 3; ++k) {
      gc0[k] = gc0[k] + eta[k] * (kx * c2[k]);
      gc1[k] = gc1[k] + eta[k] * (ky * c2[k]);
      gc2[k] = gc2[k] + eta[k] * (kx * c0[k] + ky * c1[k] - tc * c2[k]);
    }
    // the rows of Tm
    const float* M = cam.w2p;
    float gU[3], gV[3], gx[3];
    for (int r = 0; r < 3; ++r) {
      gU[r] = gc0[0] * M[3 * r] + gc1[0] * M[3 * r + 1] + gc2[0] * M[3 * r + 2];
      gV[r] = gc0[1] * M[3 * r] + gc1[1] * M[3 * r + 1] + gc2[1] * M[3 * r + 2];
      gx[r] = gc0[2] * M[3 * r] + gc1[2] * M[3 * r + 1] + gc2[2] * M[3 * r + 2];
    }
    // the scales
    g_scaling[2 * i] = dot3(gU, g.tu) * smod * g.s0;
    g_scaling[2 * i + 1] = dot3(gV, g.tv) * smod * g.s1;
    // the normal: flip (tw @ world_view[:3, :3])
    const float* W4 = cam.wv;
    const float gnv[3] = {gr[18] * g.flip, gr[19] * g.flip, gr[20] * g.flip};
    float gtw[3];
    for (int r = 0; r < 3; ++r)
      gtw[r] = gnv[0] * W4[4 * r] + gnv[1] * W4[4 * r + 1] + gnv[2] * W4[4 * r + 2];
    // the rotation's columns su tu, sv tv, tw → the unit quaternion
    float G[3][3];
    for (int r = 0; r < 3; ++r) {
      G[r][0] = g.su * gU[r];
      G[r][1] = g.sv * gV[r];
      G[r][2] = gtw[r];
    }
    const float w_ = g.qh[0], x_ = g.qh[1], y_ = g.qh[2], z_ = g.qh[3];
    float gqh[4];
    gqh[0] = 2.0f * (-z_ * G[0][1] + y_ * G[0][2] + z_ * G[1][0]
                     - x_ * G[1][2] - y_ * G[2][0] + x_ * G[2][1]);
    gqh[1] = 2.0f * (y_ * G[0][1] + z_ * G[0][2] + y_ * G[1][0]
                     - w_ * G[1][2] + z_ * G[2][0] + w_ * G[2][1])
             - 4.0f * x_ * (G[1][1] + G[2][2]);
    gqh[2] = 2.0f * (x_ * G[0][1] + w_ * G[0][2] + x_ * G[1][0]
                     + z_ * G[1][2] - w_ * G[2][0] + z_ * G[2][1])
             - 4.0f * y_ * (G[0][0] + G[2][2]);
    gqh[3] = 2.0f * (-w_ * G[0][1] + x_ * G[0][2] + w_ * G[1][0]
                     + y_ * G[1][2] + x_ * G[2][0] + y_ * G[2][1])
             - 4.0f * z_ * (G[0][0] + G[1][1]);
    // the normalisation q / max(|q|, 1e-12)
    const float proj = g.qn >= 1e-12f
        ? gqh[0] * g.qh[0] + gqh[1] * g.qh[1] + gqh[2] * g.qh[2]
              + gqh[3] * g.qh[3]
        : 0.0f;
    float4 gq;
    gq.x = (gqh[0] - g.qh[0] * proj) / g.nrm;
    gq.y = (gqh[1] - g.qh[1] * proj) / g.nrm;
    gq.z = (gqh[2] - g.qh[2] * proj) / g.nrm;
    gq.w = (gqh[3] - g.qh[3] * proj) / g.nrm;
    // the opacity's sigmoid
    g_opacity[i] = gr[14] * g.o * (1.0f - g.o);
    // the colour
    if (in.has_colors) {
      if (g_colors)
        for (int k = 0; k < 3; ++k) g_colors[3 * i + k] = gr[15 + k];
    } else {
      constexpr int NK = (D + 1) * (D + 1);
      float b[NK], w[NK], gv[3];
      sh_basis<D>(g.dir[0], g.dir[1], g.dir[2], b);
      for (int ch = 0; ch < 3; ++ch)
        gv[ch] = g.v[ch] + 0.5f >= 0.0f ? gr[15 + ch] : 0.0f;
#pragma unroll
      for (int k = 0; k < NK; ++k)
        w[k] = gv[0] * sh_coef(in, k, 0) + gv[1] * sh_coef(in, k, 1)
               + gv[2] * sh_coef(in, k, 2);
      float gdir[3];
      sh_dir_grad<D>(g.dir[0], g.dir[1], g.dir[2], w, gdir);
      const float gdd = dot3(gdir, g.d) * (g.r * g.r * g.r);
      for (int k = 0; k < 3; ++k)
        gx[k] = gx[k] + (g.r * gdir[k] - g.d[k] * gdd);
      // coefficient k's gradient b_k gv; none above the active degree.
      // The row in shared memory is this thread's own: its coefficients
      // have been read above.
      for (int ch = 0; ch < 3; ++ch)
        g_dc[3 * i + ch] = g.finite ? b[0] * gv[ch] : 0.0f;
#pragma unroll
      for (int k = 1; k < NK; ++k)
        for (int ch = 0; ch < 3; ++ch)
          sh_row[3 * (k - 1) + ch] = g.finite ? b[k] * gv[ch] : 0.0f;
      for (int k = 3 * (NK - 1); k < m; ++k) sh_row[k] = 0.0f;
    }
    if (g_noise)
      for (int k = 0; k < 3; ++k) g_noise[3 * i + k] = gr[21 + k];
    // a zeroed row: also where an infinite input met its zero cotangent
    if (!g.finite) {
      gx[0] = gx[1] = gx[2] = 0.0f;
      gq = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      g_scaling[2 * i] = g_scaling[2 * i + 1] = 0.0f;
      g_opacity[i] = 0.0f;
    }
    for (int k = 0; k < 3; ++k) g_xyz[3 * i + k] = gx[k];
    reinterpret_cast<float4*>(g_rotation)[i] = gq;
  }
  __syncthreads();
  if (g_rest != nullptr && m > 0) stage_out(g_rest, s_sh, r0, rows, m);
}

template <int D>
int launch(const float* d_packed, const float* const* in, int m, int mc,
           int width, int height, float smod, long long n, float* const* out,
           cudaStream_t stream) {
  const size_t bytes = (size_t)THREADS * (REC + m) * sizeof(float);
  // past 48 KB of shared memory in all (the camera is static) a block
  // needs the opt-in
  if (bytes + sizeof(Cam) > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        preprocess_bwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (n + THREADS - 1) / THREADS;
  preprocess_bwd_kernel<D><<<(unsigned)blocks, THREADS, bytes, stream>>>(
      d_packed, in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], in[8],
      in[9], in[10], in[11], m, mc, width, height, smod, n, out[0], out[1],
      out[2], out[3], out[4], out[5], out[6], out[7], out[8]);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. d_packed (n, 24) float32, contiguous;
// the inputs as gs2d_preprocess_fwd takes them. Outputs, each in its
// input's layout: g_xyz, g_scaling, g_rotation (16-byte aligned), g_opacity
// always; g_dc and g_rest with SH features; g_colors, g_noise, g_offsets
// where not null (only when that input is given). Launches on `stream`
// (n > 0) and returns cudaGetLastError().
extern "C" int gs2d_preprocess_bwd(
    const float* d_packed, const float* xyz, const float* scaling,
    const float* rotation, const float* opacity, const float* features_dc,
    const float* features_rest, const float* colors, const float* noise,
    const float* offsets, const float* world_view, const float* full_proj,
    const float* campos, int k_rest, int sh_degree, int width, int height,
    float scale_modifier, long long n, float* g_xyz, float* g_scaling,
    float* g_rotation, float* g_opacity, float* g_dc, float* g_rest,
    float* g_colors, float* g_noise, float* g_offsets, void* stream) {
  const float* in[12] = {xyz, scaling, rotation, opacity, features_dc,
                         features_rest, colors, noise, offsets, world_view,
                         full_proj, campos};
  float* out[9] = {g_xyz, g_scaling, g_rotation, g_opacity, g_dc, g_rest,
                   g_colors, g_noise, g_offsets};
  const bool sh = colors == nullptr;
  const int m = sh ? 3 * k_rest : 0;
  const int mc = sh ? 3 * ((sh_degree + 1) * (sh_degree + 1) - 1) : 0;
  const int d = sh ? sh_degree : 0;
  cudaStream_t s = (cudaStream_t)stream;
#define GS2D_PRE_BWD(D)                                                      \
  launch<D>(d_packed, in, m, mc, width, height, scale_modifier, n, out, s)
  switch (d) {
    case 0: return GS2D_PRE_BWD(0);
    case 1: return GS2D_PRE_BWD(1);
    case 2: return GS2D_PRE_BWD(2);
    case 3: return GS2D_PRE_BWD(3);
    case 4: return GS2D_PRE_BWD(4);
    default: return (int)cudaErrorInvalidValue;
  }
#undef GS2D_PRE_BWD
}
