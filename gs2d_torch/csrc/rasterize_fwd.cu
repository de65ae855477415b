// Forward tile compositing for the 2D Gaussian surfel rasterizer, sm_90a.
//
// Replaces the TPU kernel gs2d_tpu/ops/rasterize/kernel_fwd.py::
// rasterize_fwd_pallas (body _fwd_kernel; per-record maths in
// kernel_common.py chunk_geometry / entry_validity / mapped_depth). It
// computes what that kernel computes, not how: the TPU's chunk-blocked
// wire, MXU identity transposes and shift-scans have no counterpart here.
//
// Design. One CTA per 16x32 tile, 512 threads, one pixel per thread. The
// CTA walks its tile's slot range [tile_start, tile_start + tile_count) in
// batches of BATCH records, double-buffered in shared memory: while the
// threads composite batch b, cp.async gathers batch b + 1
// (packed[gid[slot]], 24 floats in the FLD_* layout of
// ops/rasterize/common.py, six 16-byte copies a row). Every thread
// composites a batch front to back with T *= (1 - alpha), which replaces
// the TPU kernel's transmittance product scan. A pixel freezes at the
// first kept record with T * (1 - alpha) < 1e-4 (that record is not
// composited); pixels outside the image start frozen; the CTA stops once
// every pixel is frozen.
//
// Most (record, pixel) pairs of a tile's list cannot composite on that
// pixel (at the 1M-splat 1080p view 0.8% of the pairs walked do). Two
// conservative tests of raster_common.cuh leave them out before the two
// divisions and expf of the exact test. A warp is one pixel row: for each
// staged batch it runs row_may_hit once per (record, row), one record per
// lane, and ballots the result into a mask; it then walks only the set
// bits, in slot order. There each lane first applies skip_pair (two
// quadratic forms against the record's skip radius, formed once per staged
// record). Both reject only pairs the exact test rejects, so every
// decision, and every bit of the outputs, is what the exact path alone
// gives.
//
// Numerics. Built without --use_fast_math and with -fmad=false: expf, IEEE
// division and one rounding per operation, in the operation order of the
// plain PyTorch version (kernel_fwd.py::rasterize_fwd_reference). The
// per-pixel decisions (alpha cutoff, near plane, freeze, median) then see
// the same bits on both sides; only the channel sums differ in summation
// order.
//
// Bound on the H100 (published SXM peaks: 3.35 TB/s, 67 TFLOP/s FP32 off
// the tensor cores). At the 1M-splat 1080p scene, ~27M slots: reading each
// input once (the N x 96 B table, 4 B of gid per slot) and writing 125 MB
// of outputs is ~0.3 GB; this design gathers 96 B per slot, ~2.7 GB, once.
// The operations the function needs: ~70 FP32 operations per composited
// (record, pixel) (the geometry, the exact test and 13 accumulations);
// chip_smoke.py prints both bounds from the run's own counts. What the
// design spends beyond that: the row tests (~16 per staged record), the
// gather and the per-batch barriers.

#include "raster_common.cuh"

namespace {

using namespace gs2d;

constexpr int BATCH = 128;

__global__ void __launch_bounds__(TILE_PX)
rasterize_fwd_kernel(const float* __restrict__ packed,
                     const int* __restrict__ gid,
                     const int* __restrict__ tile_start,
                     const int* __restrict__ tile_count,
                     int num_gaussians, int num_slots, int width, int height,
                     int row0, int ntx, float* __restrict__ out,
                     int* __restrict__ med_idx, int* __restrict__ n_contrib) {
  __shared__ Record rec[2][BATCH];
  __shared__ float radius[2][BATCH];

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;    // a warp is one pixel row of the tile
  const int ix = (t % ntx) * TILE_W + lane;
  const int iy = (t / ntx) * TILE_H + tid / TILE_W;
  const float px = (float)ix;
  const float py = (float)(row0 + iy);   // the image's row: see row0 below
  const float row_x = (float)((t % ntx) * TILE_W);
  const int start = tile_start[t];
  const int count = max(0, min(tile_count[t], num_slots - start));

  bool done = ix >= width || iy >= height;
  float T = 1.0f;
  float r0 = 0.f, r1 = 0.f, r2 = 0.f, dsum = 0.f;
  float n0 = 0.f, n1 = 0.f, n2 = 0.f;
  float z0 = 0.f, z1 = 0.f, z2 = 0.f;
  float m1 = 0.f, m2 = 0.f, med = 0.f;
  int med_slot = -1;
  int contrib = 0;

  if (count > 0)
    stage_records(rec[0], packed, gid, start, min(BATCH, count),
                  num_gaussians, tid);
  for (int base = 0, buf = 0; base < count; base += BATCH, buf ^= 1) {
    const int nb = min(BATCH, count - base);
    // gather the next batch while this one composites
    const bool more = base + BATCH < count;
    if (more)
      stage_records(rec[buf ^ 1], packed, gid, start + base + BATCH,
                    min(BATCH, count - base - BATCH), num_gaussians, tid);
    if (more) cp_async_wait<1>(); else cp_async_wait<0>();
    __syncthreads();
    if (tid < nb) radius[buf][tid] = skip_radius(rec[buf][tid].f[14]);
    __syncthreads();
    // the records of the batch that can reach a pixel of this warp's row,
    // one bit each, from one row test per (record, row)
    unsigned hits[BATCH / 32];
    const bool row_done = __all_sync(0xffffffffu, done);
#pragma unroll
    for (int k = 0; k < BATCH / 32; ++k) {
      const int j = 32 * k + lane;
      hits[k] = __ballot_sync(0xffffffffu, !row_done && j < nb
                              && row_may_hit(rec[buf][j], radius[buf][j],
                                             row_x, py));
    }
#pragma unroll
    for (int k = 0; k < BATCH / 32; ++k) {
      for (unsigned m = hits[k]; m != 0u && !__all_sync(0xffffffffu, done);
           m &= m - 1u) {
        const int j = 32 * k + __ffs(m) - 1;
        if (done) continue;
        const Record& R = rec[buf][j];
        const float* e = R.f;
        const Geometry q = record_geometry(R, px, py);
        if (!(fabsf(q.p2) > 1e-12f)) continue;
        if (skip_pair(q.p0, q.p1, q.p2, q.rho2d, radius[buf][j])) continue;
        const float u = q.p0 / q.p2;
        const float v = q.p1 / q.p2;
        const float rho3d = u * u + v * v;
        const float rho = nan_min(rho3d, q.rho2d);
        const float alpha = nan_min(e[14] * expf(-0.5f * rho), ALPHA_CLAMP);
        const float z = u * e[9] + v * e[10] + e[11];
        if (!(z >= NEAR_N) || !(alpha >= ALPHA_CUTOFF)) continue;
        const float test_T = T * (1.0f - alpha);
        if (test_T < T_EPS) {
          done = true;
          continue;
        }
        const float w = alpha * T;
        const float mz = M_SCALE * (1.0f - NEAR_N / z);
        r0 += e[15] * w;
        r1 += e[16] * w;
        r2 += e[17] * w;
        dsum += z * w;
        n0 += e[18] * w;
        n1 += e[19] * w;
        n2 += e[20] * w;
        z0 += e[21] * w;
        z1 += e[22] * w;
        z2 += e[23] * w;
        m1 += w * mz;
        m2 += w * mz * mz;
        if (T > 0.5f) {
          med = z;
          med_slot = base + j;
        }
        contrib = base + j + 1;
        T = test_T;
      }
    }
    // also the barrier before the next batch's copies overwrite this buffer
    if (__syncthreads_count(done) == TILE_PX) break;
  }
  cp_async_wait<0>();   // a batch gathered past the last frozen pixel

  const float s0 = 1.0f - T;
  float* o = out + (size_t)t * NUM_OUT * TILE_PX + tid;
  o[0 * TILE_PX] = r0;
  o[1 * TILE_PX] = r1;
  o[2 * TILE_PX] = r2;
  o[3 * TILE_PX] = dsum;
  o[4 * TILE_PX] = s0;
  o[5 * TILE_PX] = n0;
  o[6 * TILE_PX] = n1;
  o[7 * TILE_PX] = n2;
  o[8 * TILE_PX] = med;
  o[9 * TILE_PX] = s0 * m2 - m1 * m1;   // distortion = S0*M2 - M1^2
  o[10 * TILE_PX] = z0;
  o[11 * TILE_PX] = z1;
  o[12 * TILE_PX] = z2;
  o[13 * TILE_PX] = m1;
  o[14 * TILE_PX] = m2;
  med_idx[(size_t)t * TILE_PX + tid] = med_slot;
  n_contrib[(size_t)t * TILE_PX + tid] = contrib;
}

}  // namespace

// Plain C entry point for ctypes. Launches on `stream` and returns
// cudaGetLastError(), so a refused launch reaches the caller; a packed
// table off a 16-byte boundary is refused (cudaErrorMisalignedAddress).
// The tiles cover rows [row0, row0 + height) of an image: a row band of
// several GPUs' render evaluates p = A + x·B + y·C at the image's own y,
// so a band's pixels are the whole view's bit for bit.
extern "C" int gs2d_rasterize_fwd(const float* packed, const int* gid,
                                  const int* tile_start,
                                  const int* tile_count, int num_gaussians,
                                  int num_slots, int num_tiles, int width,
                                  int height, int row0, float* out,
                                  int* med_idx, int* n_contrib,
                                  void* stream) {
  const int ntx = (width + TILE_W - 1) / TILE_W;
  if (!records_aligned(packed)) return (int)cudaErrorMisalignedAddress;
  rasterize_fwd_kernel<<<num_tiles, TILE_PX, 0, (cudaStream_t)stream>>>(
      packed, gid, tile_start, tile_count, num_gaussians, num_slots, width,
      height, row0, ntx, out, med_idx, n_contrib);
  return (int)cudaGetLastError();
}
