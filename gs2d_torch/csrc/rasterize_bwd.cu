// Backward tile compositing for the 2D Gaussian surfel rasterizer, sm_90a.
//
// Replaces the TPU kernel gs2d_tpu/ops/rasterize/kernel_bwd.py::
// rasterize_bwd_pallas (body _bwd_kernel, _recompute_chunk, _dw_terms). It
// computes the gradient of every slot's record, as 22 floats in the DFLD_*
// layout of ops/rasterize/common.py, from the forward's outputs and their
// cotangent, in one front-to-back pass that recomputes the transmittance.
//
// Maths (closed form of kernel_bwd.py:1-37). With w_e = alpha_e * T_e:
//   dalpha_e = T_e * dw_e - (sum_{j>e} w_j dw_j + T_F dT_F) / (1 - alpha_e)
// dw_e is closed form in the record and the per-pixel totals S0 (ch 4),
// M1 (ch 13), M2 (ch 14); the suffix sum is the grand total
// G_wdw = sum_ch g_ch out_ch (distortion channel twice) minus the running
// inclusive prefix. The median-depth gradient goes to the slot equal to the
// forward's med_idx; the 0.99 clamp cuts the opacity gradient and the
// low-pass branch (rho2d < rho3d) carries none.
//
// Design. K1's structure: one CTA per 16x32 tile, 512 threads, one pixel
// per thread; records gathered through gid into shared memory in batches
// of BATCH. A pixel takes part up to its n_contrib (one past its last
// composited slot, from the forward), and the CTA stops at the tile's
// largest n_contrib; the rows of later slots are written as zeros. Per
// (record, pixel) each thread forms its 22 contributions; every warp with
// a live pixel reduces them with __shfl_down_sync and writes one partial
// row to shared memory; after the batch, the partials are summed in warp
// order and one row per slot is written. No atomics: slots are
// tile-disjoint and every sum has a fixed order, so the result repeats bit
// for bit.
//
// Numerics. Built as K1 (no fast math, -fmad=false, expf, IEEE division),
// in the operation order of the plain PyTorch version
// (kernel_bwd.py::rasterize_bwd_reference), so that the per-pixel
// decisions (alpha cutoff, near plane, clamp, low-pass branch, median)
// see the forward's bits.
//
// Bound on the H100 (published SXM peaks: 3.35 TB/s, 67 TFLOP/s FP32 off
// the tensor cores). Per slot the kernel writes a 88 B row (2.35 GB at the
// 1M-splat 1080p view, ~27M slots) and reads its record; per evaluated
// (record, pixel) it does the geometry of K1 plus ~100 FP32 operations
// of the chain and 22 warp-reduced sums. chip_smoke.py prints both bounds
// from the run's own counts (n_contrib). The reduction over pixels costs
// 5 shuffles per value per warp; a transposed (butterfly) reduction over
// several records at once and cp.async staging of the records are later
// steps.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TILE_W = 32;
constexpr int TILE_H = 16;
constexpr int TILE_PX = TILE_W * TILE_H;
constexpr int NUM_WARPS = TILE_PX / 32;
constexpr int ENTRY_F = 24;
constexpr int DENTRY_F = 22;
constexpr int NUM_OUT = 15;
constexpr int BATCH = 32;

constexpr float ALPHA_CLAMP = 0.99f;
constexpr float ALPHA_CUTOFF = (float)(1.0 / 255.0);
constexpr float NEAR_N = 0.2f;
constexpr float M_SCALE = (float)(100.0 / (100.0 - 0.2));
constexpr float M_SCALE_NEAR = (float)(100.0 / (100.0 - 0.2) * 0.2);
constexpr float FILTER_INV_SQUARE = 2.0f;

// torch.minimum semantics: a NaN operand gives NaN (fminf would drop it)
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

__global__ void __launch_bounds__(TILE_PX)
rasterize_bwd_kernel(const float* __restrict__ packed,
                     const int* __restrict__ gid,
                     const int* __restrict__ tile_start,
                     const int* __restrict__ tile_count,
                     const float* __restrict__ out,
                     const float* __restrict__ cot,
                     const int* __restrict__ med_idx,
                     const int* __restrict__ n_contrib, int num_gaussians,
                     int num_slots, int width, int height, int ntx,
                     float* __restrict__ d_slots) {
  __shared__ float rec[BATCH][ENTRY_F];
  __shared__ int rec_gid[BATCH];
  __shared__ float part[BATCH][NUM_WARPS][DENTRY_F];
  __shared__ int warp_max[NUM_WARPS];

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float px = (float)((t % ntx) * TILE_W + tid % TILE_W);
  const float py = (float)((t / ntx) * TILE_H + tid / TILE_W);
  const int start = tile_start[t];
  const int count = max(0, min(tile_count[t], num_slots - start));

  // per-pixel forward totals and cotangents
  const size_t px_off = (size_t)t * NUM_OUT * TILE_PX + tid;
  float o[NUM_OUT], g[NUM_OUT];
#pragma unroll
  for (int c = 0; c < NUM_OUT; ++c) {
    o[c] = out[px_off + c * TILE_PX];
    g[c] = cot[px_off + c * TILE_PX];
  }
  const float S0 = o[4];
  const float T_F = 1.0f - S0;
  const float M1 = o[13];
  const float M2 = o[14];
  const float dT_F = -g[4];
  // grand total sum_j w_j dw_j = sum_ch g_ch out_ch, distortion twice,
  // summed channel by channel in this order (as the plain version)
  float G_wdw = g[0] * o[0];
  G_wdw = G_wdw + g[1] * o[1];
  G_wdw = G_wdw + g[2] * o[2];
  G_wdw = G_wdw + g[3] * o[3];
  G_wdw = G_wdw + g[5] * o[5];
  G_wdw = G_wdw + g[6] * o[6];
  G_wdw = G_wdw + g[7] * o[7];
  G_wdw = G_wdw + 2.0f * g[9] * o[9];
  G_wdw = G_wdw + g[10] * o[10];
  G_wdw = G_wdw + g[11] * o[11];
  G_wdw = G_wdw + g[12] * o[12];
  G_wdw = G_wdw + g[13] * o[13];
  G_wdw = G_wdw + g[14] * o[14];
  const int med = med_idx[(size_t)t * TILE_PX + tid];
  const int nc = n_contrib[(size_t)t * TILE_PX + tid];

  // the tile's largest n_contrib: no pixel takes part past it
  const int wmax = __reduce_max_sync(0xffffffffu, nc);
  if (lane == 0) warp_max[warp] = wmax;
  __syncthreads();
  int limit = 0;
#pragma unroll
  for (int w = 0; w < NUM_WARPS; ++w) limit = max(limit, warp_max[w]);
  limit = min(limit, count);

  float T = 1.0f;
  float P_incl = 0.0f;
  for (int base = 0; base < limit; base += BATCH) {
    const int nb = min(BATCH, limit - base);
    if (tid < nb) rec_gid[tid] = gid[start + base + tid];
    __syncthreads();
    for (int i = tid; i < nb * ENTRY_F; i += TILE_PX) {
      const int r = i / ENTRY_F;
      const int f = i - r * ENTRY_F;
      const int gi = rec_gid[r];
      // an id outside the table reads as a zero record, which p2 == 0 skips
      rec[r][f] = (unsigned)gi < (unsigned)num_gaussians
                      ? packed[(size_t)gi * ENTRY_F + f] : 0.0f;
    }
    __syncthreads();
    for (int j = 0; j < nb; ++j) {
      const int slot = base + j;
      const float* e = rec[j];
      float d[DENTRY_F];
#pragma unroll
      for (int f = 0; f < DENTRY_F; ++f) d[f] = 0.0f;
      bool live = false;
      if (slot < nc) {
        // the forward's geometry, operation for operation (rasterize_fwd.cu)
        const float p0 = e[0] + px * e[3] + py * e[6];
        const float p1 = e[1] + px * e[4] + py * e[7];
        const float p2 = e[2] + px * e[5] + py * e[8];
        if (fabsf(p2) > 1e-12f) {
          const float u = p0 / p2;
          const float v = p1 / p2;
          const float rho3d = u * u + v * v;
          const float dx = px - e[12];
          const float dy = py - e[13];
          const float rho2d = FILTER_INV_SQUARE * (dx * dx + dy * dy);
          const float rho = nan_min(rho3d, rho2d);
          const float G = expf(-0.5f * rho);
          const float raw = e[14] * G;
          const float alpha = nan_min(raw, ALPHA_CLAMP);
          const float z = u * e[9] + v * e[10] + e[11];
          live = z >= NEAR_N && alpha >= ALPHA_CUTOFF;
          if (live) {
            const float T_before = T;
            const float w = alpha * T_before;
            const float m = M_SCALE * (1.0f - NEAR_N / z);
            // dw = dL/dw_e with the other w fixed (kernel_bwd.py:93-99)
            float dw = e[15] * g[0];
            dw = dw + e[16] * g[1];
            dw = dw + e[17] * g[2];
            dw = dw + z * g[3];
            dw = dw + e[18] * g[5];
            dw = dw + e[19] * g[6];
            dw = dw + e[20] * g[7];
            dw = dw + e[21] * g[10];
            dw = dw + e[22] * g[11];
            dw = dw + e[23] * g[12];
            dw = dw + m * g[13];
            dw = dw + m * m * g[14];
            dw = dw + g[9] * (m * m * S0 + M2 - 2.0f * m * M1);
            const float dm = w * g[13] + 2.0f * m * w * g[14]
                             + g[9] * 2.0f * w * (m * S0 - M1);
            // suffix sum_{j>e} w_j dw_j = grand total - inclusive prefix
            P_incl = P_incl + w * dw;
            const float S_wdw = G_wdw - P_incl;
            const float dalpha =
                T_before * dw - (S_wdw + T_F * dT_F) / (1.0f - alpha);
            float dz = w * g[3] + (slot == med ? g[8] : 0.0f);
            dz = dz + dm * (M_SCALE_NEAR / (z * z));
            // alpha -> (opacity, rho3d); the clamp cuts both
            const bool clamped = raw >= ALPHA_CLAMP;
            const float dopa = clamped ? 0.0f : dalpha * G;
            const float dG = clamped ? 0.0f : dalpha * e[14];
            const float drho = -0.5f * G * dG;
            const float drho3d = rho3d <= rho2d ? drho : 0.0f;
            const float rp2 = 1.0f / p2;
            const float du = drho3d * 2.0f * u + dz * e[9];
            const float dv = drho3d * 2.0f * v + dz * e[10];
            const float dp0 = du * rp2;
            const float dp1 = dv * rp2;
            const float dp2 = -(du * u + dv * v) * rp2;
            d[0] = dp0;
            d[1] = dp1;
            d[2] = dp2;
            d[3] = dp0 * px;
            d[4] = dp1 * px;
            d[5] = dp2 * px;
            d[6] = dp0 * py;
            d[7] = dp1 * py;
            d[8] = dp2 * py;
            d[9] = dz * u;
            d[10] = dz * v;
            d[11] = dz;
            d[12] = dopa;
            d[13] = w * g[0];
            d[14] = w * g[1];
            d[15] = w * g[2];
            d[16] = w * g[5];
            d[17] = w * g[6];
            d[18] = w * g[7];
            d[19] = w * g[10];
            d[20] = w * g[11];
            d[21] = w * g[12];
            T = T * (1.0f - alpha);
          }
        }
      }
      // one partial row per warp; warps without a live pixel write zeros
      if (__any_sync(0xffffffffu, live)) {
#pragma unroll
        for (int f = 0; f < DENTRY_F; ++f) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            d[f] += __shfl_down_sync(0xffffffffu, d[f], off);
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int f = 0; f < DENTRY_F; ++f) part[j][warp][f] = d[f];
      }
    }
    __syncthreads();
    // the batch's rows: partials summed in warp order. The next batch
    // writes `part` only after its own two barriers.
    for (int i = tid; i < nb * DENTRY_F; i += TILE_PX) {
      const int r = i / DENTRY_F;
      const int f = i - r * DENTRY_F;
      float s = part[r][0][f];
#pragma unroll
      for (int w = 1; w < NUM_WARPS; ++w) s = s + part[r][w][f];
      d_slots[(size_t)(start + base + r) * DENTRY_F + f] = s;
    }
  }
  // slots no pixel reached carry no gradient
  float* rest = d_slots + (size_t)(start + limit) * DENTRY_F;
  const int n_rest = (count - limit) * DENTRY_F;
  for (int i = tid; i < n_rest; i += TILE_PX) rest[i] = 0.0f;
}

}  // namespace

// Plain C entry point for ctypes. Launches on `stream` and returns
// cudaGetLastError(), so a refused launch reaches the caller.
extern "C" int gs2d_rasterize_bwd(const float* packed, const int* gid,
                                  const int* tile_start,
                                  const int* tile_count, const float* out,
                                  const float* cot, const int* med_idx,
                                  const int* n_contrib, int num_gaussians,
                                  int num_slots, int num_tiles, int width,
                                  int height, float* d_slots, void* stream) {
  const int ntx = (width + TILE_W - 1) / TILE_W;
  rasterize_bwd_kernel<<<num_tiles, TILE_PX, 0, (cudaStream_t)stream>>>(
      packed, gid, tile_start, tile_count, out, cot, med_idx, n_contrib,
      num_gaussians, num_slots, width, height, ntx, d_slots);
  return (int)cudaGetLastError();
}
