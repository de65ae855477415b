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
// per thread; records gathered through gid into shared memory by cp.async,
// double-buffered (batch b + 1 lands while batch b is processed), in
// batches of BATCH = 64. A pixel takes part up to its n_contrib (one past
// its last composited slot, from the forward); a warp stops at the largest
// n_contrib of its lanes and the CTA at the tile's; the rows of later slots
// are zeros. As in K1, a warp is one pixel row and leaves out, with one
// row test per (record, row) (row_may_hit of raster_common.cuh, balloted
// into a 64-bit mask), every record of the batch that cannot reach its
// row; of the rest, each lane's pair goes through skip_pair before the
// divisions and expf. Both reject only pairs that the exact alpha test
// rejects too. For a record it walks, each thread forms its 22
// contributions; a warp with a live pixel sums them over its 32 lanes with
// a transposed butterfly: at each of five xor stages a lane keeps half of
// the values it still holds and trades the other half with its partner
// (11 + 6 + 3 + 2 + 1 = 23 shuffles, where a shuffle per value and stage
// took 110), after which lane L holds the warp's sum of value
// butterfly_field(L) and stores it with one shared-memory write. The xor
// stages pair the lanes as the shuffle-down tree did, so the sums keep
// their bits. After the batch, the partials of the warps that walked a
// record are summed in warp order and one row per slot is written. No
// atomics: slots are tile-disjoint and every sum has a fixed order, so the
// result repeats bit for bit.
//
// Numerics. Built as K1 (no fast math, -fmad=false, expf, IEEE division),
// in the operation order of the plain PyTorch version
// (kernel_bwd.py::rasterize_bwd_reference), so that the per-pixel
// decisions (alpha cutoff, near plane, clamp, low-pass branch, median)
// see the forward's bits.
//
// Bound on the H100 (published SXM peaks: 3.35 TB/s, 67 TFLOP/s FP32 off
// the tensor cores). Per slot the kernel writes a 88 B row (2.35 GB at the
// 1M-splat 1080p view, ~27M slots) and reads its record. The operations
// the function needs: ~40 FP32 per evaluated (record, pixel) (up to each
// pixel's n_contrib) for the geometry and the test, plus ~150 for the
// gradient chain and 22 sums per composited pair; chip_smoke.py prints
// both bounds from the run's own counts. Two CTAs share an SM (103 KB of
// shared memory each), which __launch_bounds__ buys with a 64-register
// cap and a few spilled bytes; at one CTA per SM the kernel was slower.

#include <atomic>

#include "raster_common.cuh"

namespace {

using namespace gs2d;

constexpr int BATCH = 64;   // one bit a record in a warp's 64-bit mask
// warp partials of a batch, part[BATCH][NUM_WARPS][DENTRY_F], beside the
// two record buffers and their skip radii: dynamic shared memory
constexpr size_t PART_BYTES = sizeof(float) * BATCH * NUM_WARPS * DENTRY_F;
constexpr size_t SMEM_BYTES = PART_BYTES + sizeof(Record) * 2 * BATCH
                              + sizeof(float) * 2 * BATCH;

// After the butterfly, lane L = (b4 b3 b2 b1 b0) holds value
// 11 b4 + 6 b3 + 3 b2 + 2 b1 + b0, or padding: 22 lanes hold the 22 sums.
__device__ __forceinline__ int butterfly_field(int lane) {
  const int b1b0 = 2 * ((lane >> 1) & 1) + (lane & 1);
  const int low = 6 * ((lane >> 3) & 1) + 3 * ((lane >> 2) & 1) + b1b0;
  return (b1b0 < 3 && low < 11) ? 11 * ((lane >> 4) & 1) + low : -1;
}

// One butterfly stage: of the 2H values in x the lane keeps half `hi` (its
// bit of the stage's offset), gives the other half to its partner and adds
// the partner's half of the same values: y[k] = x[k + H*hi] + partner's.
template <int H>
__device__ __forceinline__ void butterfly_stage(const float* x, float* y,
                                                bool hi, int offset) {
#pragma unroll
  for (int k = 0; k < H; ++k) {
    const float keep = hi ? x[H + k] : x[k];
    const float send = hi ? x[k] : x[H + k];
    y[k] = keep + __shfl_xor_sync(0xffffffffu, send, offset);
  }
}

// The warp's sum of d[0..21] over its 32 lanes, transposed: lane L returns
// the sum of value butterfly_field(L) (padding lanes return 0). 23 shuffles.
__device__ __forceinline__ float warp_sum_transposed(const float (&d)[DENTRY_F],
                                                     int lane) {
  float a[12], b[6], c[4], e[2];
  butterfly_stage<11>(d, a, (lane >> 4) & 1, 16);
  a[11] = 0.0f;
  butterfly_stage<6>(a, b, (lane >> 3) & 1, 8);
  butterfly_stage<3>(b, c, (lane >> 2) & 1, 4);
  c[3] = 0.0f;
  butterfly_stage<2>(c, e, (lane >> 1) & 1, 2);
  float f;
  butterfly_stage<1>(e, &f, lane & 1, 1);
  return f;
}

__global__ void __launch_bounds__(TILE_PX, 2)
rasterize_bwd_kernel(const float* __restrict__ packed,
                     const int* __restrict__ gid,
                     const int* __restrict__ tile_start,
                     const int* __restrict__ tile_count,
                     const float* __restrict__ out,
                     const float* __restrict__ cot,
                     const int* __restrict__ med_idx,
                     const int* __restrict__ n_contrib, int num_gaussians,
                     int num_slots, int width, int height, int row0,
                     int ntx, float* __restrict__ d_slots) {
  extern __shared__ __align__(16) unsigned char smem[];
  float (*part)[NUM_WARPS][DENTRY_F] =
      reinterpret_cast<float (*)[NUM_WARPS][DENTRY_F]>(smem);
  Record (*rec)[BATCH] = reinterpret_cast<Record (*)[BATCH]>(
      smem + PART_BYTES);
  float (*radius)[BATCH] = reinterpret_cast<float (*)[BATCH]>(
      smem + PART_BYTES + sizeof(Record) * 2 * BATCH);
  __shared__ int warp_max[NUM_WARPS];
  __shared__ unsigned long long hits[NUM_WARPS];   // BATCH bits a warp

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // a warp is one pixel row of the tile
  const float row_x = (float)((t % ntx) * TILE_W);
  const float px = row_x + (float)lane;
  const float py = (float)(row0 + (t / ntx) * TILE_H + warp);
  const int start = tile_start[t];
  const int count = max(0, min(tile_count[t], num_slots - start));
  const int field = butterfly_field(lane);

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
  const float tail = T_F * dT_F;
  const int med = med_idx[(size_t)t * TILE_PX + tid];
  const int nc = n_contrib[(size_t)t * TILE_PX + tid];

  // the warp's and the tile's largest n_contrib: no lane takes part past
  // its warp's, no warp past the tile's
  const int wmax = min(__reduce_max_sync(0xffffffffu, nc), count);
  if (lane == 0) warp_max[warp] = wmax;
  __syncthreads();
  int limit = 0;
#pragma unroll
  for (int w = 0; w < NUM_WARPS; ++w) limit = max(limit, warp_max[w]);

  float T = 1.0f;
  float P_incl = 0.0f;
  if (limit > 0)
    stage_records(rec[0], packed, gid, start, min(BATCH, limit),
                  num_gaussians, tid);
  for (int base = 0, buf = 0; base < limit; base += BATCH, buf ^= 1) {
    const int nb = min(BATCH, limit - base);
    const bool more = base + BATCH < limit;
    if (more)
      stage_records(rec[buf ^ 1], packed, gid, start + base + BATCH,
                    min(BATCH, limit - base - BATCH), num_gaussians, tid);
    if (more) cp_async_wait<1>(); else cp_async_wait<0>();
    __syncthreads();
    if (tid < nb) radius[buf][tid] = skip_radius(rec[buf][tid].f[14]);
    __syncthreads();
    // the warp's slots of this batch (none past its largest n_contrib) that
    // can reach a pixel of its row, one bit each, from one row test per
    // (record, row); only these get a partial row
    const int wn = max(0, min(nb, wmax - base));
    const bool hit_lo = lane < wn && row_may_hit(rec[buf][lane],
                                                 radius[buf][lane], row_x, py);
    const bool hit_hi = lane + 32 < wn
                        && row_may_hit(rec[buf][lane + 32],
                                       radius[buf][lane + 32], row_x, py);
    const unsigned long long wh =
        (unsigned long long)__ballot_sync(0xffffffffu, hit_hi) << 32
        | __ballot_sync(0xffffffffu, hit_lo);
    if (lane == 0) hits[warp] = wh;
    for (unsigned long long mk = wh; mk != 0ull; mk &= mk - 1ull) {
      const int j = __ffsll(mk) - 1;
      const int slot = base + j;
      const Record& R = rec[buf][j];
      const float* e = R.f;
      float d[DENTRY_F];
#pragma unroll
      for (int f = 0; f < DENTRY_F; ++f) d[f] = 0.0f;
      bool live = false;
      if (slot < nc) {
        // the forward's geometry and test (rasterize_fwd.cu)
        const Geometry q = record_geometry(R, px, py);
        if (fabsf(q.p2) > 1e-12f
            && !skip_pair(q.p0, q.p1, q.p2, q.rho2d, radius[buf][j])) {
          const float p2 = q.p2;
          const float u = q.p0 / p2;
          const float v = q.p1 / p2;
          const float rho3d = u * u + v * v;
          const float rho2d = q.rho2d;
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
                T_before * dw - (S_wdw + tail) / (1.0f - alpha);
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
      // the warp's partial row, one value per lane
      const float s = __any_sync(0xffffffffu, live)
                          ? warp_sum_transposed(d, lane) : 0.0f;
      if (field >= 0) part[j][warp][field] = s;
    }
    __syncthreads();
    // the batch's rows: the partials of the warps that have one, summed in
    // warp order (the others would add zeros); a slot no warp walked is a
    // zero row. The next batch writes `part` and `hits` only after its own
    // first barrier.
    unsigned long long walked = 0ull;
#pragma unroll
    for (int w = 0; w < NUM_WARPS; ++w) walked |= hits[w];
    for (int i = tid; i < nb * DENTRY_F; i += TILE_PX) {
      const int r = i / DENTRY_F;
      const int f = i - r * DENTRY_F;
      float s = 0.0f;
      if ((walked >> r) & 1ull) {
#pragma unroll
        for (int w = 0; w < NUM_WARPS; ++w)
          if ((hits[w] >> r) & 1ull) s = s + part[r][w][f];
      }
      d_slots[(size_t)(start + base + r) * DENTRY_F + f] = s;
    }
  }
  // slots no pixel reached carry no gradient
  float* rest = d_slots + (size_t)(start + limit) * DENTRY_F;
  const int n_rest = (count - limit) * DENTRY_F;
  for (int i = tid; i < n_rest; i += TILE_PX) rest[i] = 0.0f;
}

// Lets the kernel use SMEM_BYTES of dynamic shared memory (above the 48 KB
// default), once per device.
cudaError_t allow_shared_memory() {
  constexpr int kMaxDevices = 64;
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev].load()) return cudaSuccess;
  err = cudaFuncSetAttribute(rasterize_bwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)SMEM_BYTES);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev].store(true);
  return err;
}

}  // namespace

// Plain C entry point for ctypes. Launches on `stream` and returns
// cudaGetLastError(), so a refused launch reaches the caller; a packed
// table off a 16-byte boundary is refused (cudaErrorMisalignedAddress).
// The tiles cover rows [row0, row0 + height) of an image, as in
// rasterize_fwd.cu.
extern "C" int gs2d_rasterize_bwd(const float* packed, const int* gid,
                                  const int* tile_start,
                                  const int* tile_count, const float* out,
                                  const float* cot, const int* med_idx,
                                  const int* n_contrib, int num_gaussians,
                                  int num_slots, int num_tiles, int width,
                                  int height, int row0, float* d_slots,
                                  void* stream) {
  if (!records_aligned(packed)) return (int)cudaErrorMisalignedAddress;
  const cudaError_t err = allow_shared_memory();
  if (err != cudaSuccess) return (int)err;
  const int ntx = (width + TILE_W - 1) / TILE_W;
  rasterize_bwd_kernel<<<num_tiles, TILE_PX, SMEM_BYTES,
                         (cudaStream_t)stream>>>(
      packed, gid, tile_start, tile_count, out, cot, med_idx, n_contrib,
      num_gaussians, num_slots, width, height, row0, ntx, d_slots);
  return (int)cudaGetLastError();
}
