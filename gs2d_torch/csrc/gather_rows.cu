// Row gather out = table[idx] of an (N, F) float32 table, sm_90a.
//
// Replaces the five TPU probes of this one function:
// scripts/probe_gather_kernel.py lane_gather (G1), sub_gather (G2) and
// onehot_gather (G3), and scripts/probe_gather_kernel2.py lane_gather (G4)
// and sub_gather (G5). Their transposed (F, N) tables, sublane-broadcast
// indices, VMEM-resident tables and one-hot MXU products are ways around
// a TPU without a fast gather; on Hopper the row-major table is read in
// place. In the port the function selects the rows of every parameter and
// Adam moment when densification clones, splits and prunes
// (models/densify.py); K1 and K2 gather their records themselves.
//
// Design. One thread per output element, grid-stride: an element is one
// float, or a float4 when F % 4 == 0 and both pointers are 16-byte aligned.
// Neighbouring threads write neighbouring addresses of `out` and the
// threads of one row read its F contiguous floats of the table; each
// thread reads its row's index (the same address for a row's threads, so
// one transaction serves them). Element offsets use 32-bit division when
// the output has fewer than 2^31 elements. Negative indices count from the
// end, as torch indexing does; an index outside [-N, N) writes zeros and
// sets *bad, which the wrapper reads and raises on. A copy moves bits, so
// the result equals table[idx] bit for bit.
//
// Bound: bytes. The function reads the table once (4·N·F), the indices
// (M·sizeof(idx)) and writes the output (4·M·F): 0.197 ms at the probes'
// shape (2^20 × 24, M = 5,600,256, int32) and 0.828 ms at the view-0 pair
// count of the 1M-splat 1080p scene (M = 26,732,911), at 3.35 TB/s. A
// random gather with M > N reads more than the table once (a 96-byte row
// is three 32-byte sectors, and the 50 MB L2 holds part of the table);
// staging rows through shared memory would not change that, so the
// kernel is a plain copy for now.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 16;

template <typename V>
__device__ __forceinline__ V zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.0f; }
template <>
__device__ __forceinline__ float4 zero<float4>() {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// V: float or float4; I: int or long long (the index type); E: the type of
// element offsets, unsigned int when M·(F/width(V)) < 2^31.
template <typename V, typename I, typename E>
__global__ void __launch_bounds__(THREADS)
gather_rows_kernel(const V* __restrict__ table, const I* __restrict__ idx,
                   long long n_rows, E m, E fv, V* __restrict__ out,
                   int* __restrict__ bad) {
  const E total = m * fv;
  const E stride = (E)gridDim.x * THREADS;
  for (E e = (E)blockIdx.x * THREADS + threadIdx.x; e < total; e += stride) {
    const E i = e / fv;
    const E c = e - i * fv;
    long long r = (long long)idx[i];
    if (r < 0) r += n_rows;
    if (r < 0 || r >= n_rows) {
      *bad = 1;
      out[e] = zero<V>();
      continue;
    }
    out[e] = table[r * (long long)fv + c];
  }
}

template <typename V, typename I>
int launch(const void* table, const void* idx, long long n_rows,
           long long m, long long fv, void* out, int* bad,
           cudaStream_t stream) {
  const long long total = m * fv;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long blocks = (total + THREADS - 1) / THREADS;
  const long long cap = (long long)(sms > 0 ? sms : 1) * BLOCKS_PER_SM;
  if (blocks > cap) blocks = cap;
  const V* t = (const V*)table;
  const I* ix = (const I*)idx;
  V* o = (V*)out;
  if (total < (1LL << 31)) {
    gather_rows_kernel<V, I, unsigned int><<<(int)blocks, THREADS, 0, stream>>>(
        t, ix, n_rows, (unsigned int)m, (unsigned int)fv, o, bad);
  } else {
    gather_rows_kernel<V, I, unsigned long long>
        <<<(int)blocks, THREADS, 0, stream>>>(t, ix, n_rows,
                                              (unsigned long long)m,
                                              (unsigned long long)fv, o, bad);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. table (n_rows, f) float32 and out (m, f)
// float32, both contiguous; idx (m,) int32 (idx_is_64 == 0) or int64; bad
// one int32, zero on entry. Launches on `stream` (m·f > 0) and returns
// cudaGetLastError(), so a refused launch reaches the caller. vec4 != 0
// asks for 16-byte copies: f % 4 == 0 and both pointers 16-byte aligned.
extern "C" int gs2d_gather_rows(const float* table, const void* idx,
                                int idx_is_64, long long n_rows, long long m,
                                int f, int vec4, float* out, int* bad,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (vec4) {
    return idx_is_64
               ? launch<float4, long long>(table, idx, n_rows, m, f / 4, out,
                                           bad, s)
               : launch<float4, int>(table, idx, n_rows, m, f / 4, out, bad,
                                     s);
  }
  return idx_is_64
             ? launch<float, long long>(table, idx, n_rows, m, f, out, bad, s)
             : launch<float, int>(table, idx, n_rows, m, f, out, bad, s);
}
