// The render's preprocess, forward: raw surfel parameters → K1's record
// and the binning's aux in one pass, sm_90a.
//
// Replaces no TPU kernel: the JAX package leaves this layer
// (gs2d_tpu/ops/rasterize/preprocess.py, ops/sh.py, the activation and
// api.py's packing) to XLA, which fuses it. Eager PyTorch has no such
// fusion: the same maths ran as ~350 kernels of (N,)-vectors, a 576 MB
// (N, 16, 3) copy of the SH coefficients, its masked copy, a cat into the
// record and two synchronising uploads; at 3.0M surfels 15 ms where this
// kernel's bytes take 0.32 ms. It computes what
// ops/rasterize/preprocess.py::preprocess_fwd_reference computes
// (preprocess_common.cuh sets out the arithmetic).
//
// Design. One thread per surfel, 128 surfels a block. The block stages its
// surfels' SH rows (features_rest, 180 bytes a row at degree 3) from device
// memory into shared memory in 16-byte copies, contiguous across the
// block, and each thread reads its own row from there (a stride of 45
// floats: no bank conflicts). Each thread writes its 24-float record into
// shared memory in six 16-byte stores; the block then writes the records
// out in 16-byte copies, contiguous across the block. The small inputs
// (xyz, scaling, rotation, opacity, SH coefficient 0) and the aux are read
// and written per thread: neighbouring threads touch neighbouring rows,
// and the cache lines a warp's three or four accesses share are served
// from L1. The camera (world_view, full_proj's three pixel columns formed
// from width and height, campos) is read from device memory into shared
// memory by the block, so nothing is copied from the host per call. Only
// the active degree's coefficients are read: degrees 0-4 are template
// instances, and coefficients above the active degree are neither read nor
// summed (the plain version multiplies them by a zero mask).
//
// Bound on the H100 (3.35 TB/s, 67 TFLOP/s FP32): bytes. A surfel at SH
// degree 3 reads 240 bytes (xyz 12, scaling 8, rotation 16, opacity 4, SH
// 192, offsets 8) and writes 117 (the 96-byte record, depth 4, extent 8,
// radii 4, visible 1, rho2max 4): 1.07 GB at 3.0M surfels, 0.32 ms. The
// arithmetic (~600 FP32 operations a surfel, two dual-conic boxes, the SH
// sum) is 1.8 GFLOP, 0.03 ms.

#include "preprocess_common.cuh"

namespace {

using namespace gs2d_pre;

template <int D>
__global__ void __launch_bounds__(THREADS)
preprocess_fwd_kernel(const float* __restrict__ xyz,
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
                      float* __restrict__ packed, float* __restrict__ depth,
                      float* __restrict__ extent, int* __restrict__ radii,
                      unsigned char* __restrict__ visible,
                      float* __restrict__ rho2max) {
  extern __shared__ float4 smem4[];
  float* s_rec = reinterpret_cast<float*>(smem4);   // THREADS x REC
  float* s_sh = s_rec + THREADS * REC;              // THREADS x m
  __shared__ Cam cam;
  load_cam(cam, world_view, full_proj, campos, width, height);
  const long long r0 = (long long)blockIdx.x * THREADS;
  const int rows = (int)(n - r0 < THREADS ? n - r0 : THREADS);
  if (mc > 0) stage_in(s_sh, features_rest, r0, rows, m, mc);
  __syncthreads();

  const int t = threadIdx.x;
  if (t < rows) {
    const long long i = r0 + t;
    In in;
    load_in(in, i, xyz, scaling, rotation, opacity, features_dc,
            s_sh + t * m, colors, noise, offsets);
    Geo g;
    geometry<D>(cam, in, smod, g);

    // the binning's aux (preprocess.py::preprocess, in its order)
    const float* c0 = g.c[0];
    const float* c1 = g.c[1];
    const float* c2 = g.c[2];
    const float f01 = 1.0f / g.den, f2 = -1.0f / g.den;
    const float tx = f01 * c0[0] * c0[0] + f01 * c0[1] * c0[1]
                     + f2 * c0[2] * c0[2];
    const float ty = f01 * c1[0] * c1[0] + f01 * c1[1] * c1[1]
                     + f2 * c1[2] * c1[2];
    const float e3x = SIGMA_CUTOFF * sqrtf(clamp_min(g.cx * g.cx - tx, 1e-4f));
    const float e3y = SIGMA_CUTOFF * sqrtf(clamp_min(g.cy * g.cy - ty, 1e-4f));
    const float r2m =
        2.0f * logf(clamp_min(g.o, 1e-12f) * INV_ALPHA_CUTOFF) + CULL_MARGIN;
    // the dual-conic box of the level set rho = rho2max
    const float r2 = clamp_min(r2m, 1e-6f);
    const float sg = -1.0f / r2;
    const float dd = c2[0] * c2[0] * 1.0f + c2[1] * c2[1] * 1.0f
                     + c2[2] * c2[2] * sg;
    const bool ok = fabsf(dd) > 1e-12f;
    const float den = ok ? dd : 1.0f;
    const float h01 = 1.0f / den, h2 = sg / den;
    const float cxr = h01 * c0[0] * c2[0] + h01 * c0[1] * c2[1]
                      + h2 * c0[2] * c2[2];
    const float cyr = h01 * c1[0] * c2[0] + h01 * c1[1] * c2[1]
                      + h2 * c1[2] * c2[2];
    const float txr = h01 * c0[0] * c0[0] + h01 * c0[1] * c0[1]
                      + h2 * c0[2] * c0[2];
    const float tyr = h01 * c1[0] * c1[0] + h01 * c1[1] * c1[1]
                      + h2 * c1[2] * c1[2];
    const float hx2 = cxr * cxr - txr, hy2 = cyr * cyr - tyr;
    const bool good = ok && hx2 > 0.0f && hy2 > 0.0f && isfinite(hx2)
                      && isfinite(hy2);
    const float erx = sqrtf(clamp_min(hx2, 0.0f));
    const float ery = sqrtf(clamp_min(hy2, 0.0f));
    const float hx = nan_max(fabsf(cxr + erx - g.cx), fabsf(g.cx - (cxr - erx)));
    const float hy = nan_max(fabsf(cyr + ery - g.cy), fabsf(g.cy - (cyr - ery)));
    const float fr = sqrtf(clamp_min(r2m, 0.0f) / FILTER_INV_SQUARE);
    const float ex = nan_max(good ? hx : e3x, fr);
    const float ey = nan_max(good ? hy : e3y, fr);
    const float z = g.pv[2];
    const bool vis = z > NEAR_N && g.dd_ok && r2m > 0.0f && isfinite(ex)
                     && isfinite(ey) && g.cx + ex >= 0.0f
                     && g.cx - ex <= (float)(width - 1.0)
                     && g.cy + ey >= 0.0f
                     && g.cy - ey <= (float)(height - 1.0);

    float4* dst = reinterpret_cast<float4*>(s_rec + t * REC);
#pragma unroll
    for (int k = 0; k < REC / 4; ++k)
      dst[k] = make_float4(g.rec[4 * k], g.rec[4 * k + 1], g.rec[4 * k + 2],
                           g.rec[4 * k + 3]);
    depth[i] = z;
    reinterpret_cast<float2*>(extent)[i] = make_float2(ex, ey);
    radii[i] = vis ? (int)ceilf(nan_max(e3x, e3y)) : 0;
    // a zeroed record is binned nowhere; its radii stay the surfel's
    visible[i] = vis && g.finite ? 1 : 0;
    rho2max[i] = r2m;
  }
  __syncthreads();
  stage_out(packed, s_rec, r0, rows, REC);
}

template <int D>
int launch(const float* const* in, int m, int mc, int width, int height,
           float smod, long long n, float* packed, float* depth,
           float* extent, int* radii, unsigned char* visible, float* rho2max,
           cudaStream_t stream) {
  const size_t bytes = (size_t)THREADS * (REC + m) * sizeof(float);
  // past 48 KB of shared memory in all (the camera is static) a block
  // needs the opt-in
  if (bytes + sizeof(Cam) > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        preprocess_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (n + THREADS - 1) / THREADS;
  preprocess_fwd_kernel<D><<<(unsigned)blocks, THREADS, bytes, stream>>>(
      in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], in[8], in[9],
      in[10], in[11], m, mc, width, height, smod, n, packed, depth, extent,
      radii, visible, rho2max);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. Inputs (contiguous float32, n rows):
// xyz (n, 3), scaling (n, 2) log-scales, rotation (n, 4), opacity (n, 1)
// logits; features_dc (n, 1, 3) and features_rest (n, k_rest, 3), or null
// with colors (n, 3); noise (n, 3) and offsets (n, 2), or null; world_view
// and full_proj (4, 4), campos (3,). sh_degree: the active degree,
// (sh_degree + 1)^2 <= k_rest + 1. Outputs: packed (n, 24), depth (n,),
// extent (n, 2), radii (n,) int32, visible (n,) bytes, rho2max (n,).
// Launches on `stream` (n > 0) and returns cudaGetLastError().
extern "C" int gs2d_preprocess_fwd(
    const float* xyz, const float* scaling, const float* rotation,
    const float* opacity, const float* features_dc,
    const float* features_rest, const float* colors, const float* noise,
    const float* offsets, const float* world_view, const float* full_proj,
    const float* campos, int k_rest, int sh_degree, int width, int height,
    float scale_modifier, long long n, float* packed, float* depth,
    float* extent, int* radii, unsigned char* visible, float* rho2max,
    void* stream) {
  const float* in[12] = {xyz, scaling, rotation, opacity, features_dc,
                         features_rest, colors, noise, offsets, world_view,
                         full_proj, campos};
  const bool sh = colors == nullptr;
  const int m = sh ? 3 * k_rest : 0;
  const int mc = sh ? 3 * ((sh_degree + 1) * (sh_degree + 1) - 1) : 0;
  const int d = sh ? sh_degree : 0;
  cudaStream_t s = (cudaStream_t)stream;
#define GS2D_PRE_FWD(D)                                                      \
  launch<D>(in, m, mc, width, height, scale_modifier, n, packed, depth,      \
            extent, radii, visible, rho2max, s)
  switch (d) {
    case 0: return GS2D_PRE_FWD(0);
    case 1: return GS2D_PRE_FWD(1);
    case 2: return GS2D_PRE_FWD(2);
    case 3: return GS2D_PRE_FWD(3);
    case 4: return GS2D_PRE_FWD(4);
    default: return (int)cudaErrorInvalidValue;
  }
#undef GS2D_PRE_FWD
}
