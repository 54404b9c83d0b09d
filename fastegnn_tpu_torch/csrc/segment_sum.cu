// Sorted-CSR segment-sum for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel fastegnn_tpu/ops/spmm.py::_segment_sum_kernel
// (launched by _segment_sum_fwd_impl and _segment_sum_csr_impl; public ops
// sorted_segment_sum, sorted_segment_sum_csr, and the backward of gather_dst /
// gather_src).  For every row r of the CSR row pointer:
//
//   out[r] = sum over p in [rowptr[r], rowptr[r + 1]) of data[perm ? perm[p] : p]
//
// data [E, F] f32 or bf16, out [N, F] f32 (f32 accumulation).  Without perm it
// sums dst-sorted rows (the forward aggregation and gather_dst's backward);
// with perm it reads the rows of an edge-ordered tensor through the src-sorted
// permutation (gather_src's backward).  Rows past rowptr[N] (the padded
// sentinel tail) and before rowptr[0] are never read.
//
// What bounds it on the H100: bytes.  It does one add per input value, so it
// reads each data row once and writes each output row once: for the Water-3D
// graph (580,032 real edges, F = 67, N = 8000) 157.6 MB in f32, about 47 us at
// 3.35 TB/s, and half the data bytes in bf16.
//
// Design: the TPU kernel's 128-lane feature padding, chunk-aligned
// double-buffered DMA and one-hot P^T @ data products exist because the TPU
// has no fast gather; none of it is carried over.  One warp owns one output
// row: it walks the row's CSR range, its lanes stride the features (lane l
// holds features l, l + 32, l + 64, l + 96 of each 128-wide pass), so every
// row read is coalesced, and it keeps the sums in f32 registers.  Each output
// row is written exactly once (empty rows write 0), so there is no memset, no
// atomic, and the result is deterministic.  (Loading a row's edge ids 32 at a
// time and holding 8 rows' loads in flight was measured slower on the H100;
// PERF.md.)
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int PER_LANE = 4;               // features per lane and pass
constexpr int PASS = 32 * PER_LANE;       // features per pass

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
segment_sum_kernel(const T* __restrict__ data, const int* __restrict__ rowptr,
                   const int* __restrict__ perm, float* __restrict__ out, int n, int f) {
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n) return;
  const int p0 = rowptr[row];
  const int p1 = rowptr[row + 1];
  for (int c0 = 0; c0 < f; c0 += PASS) {
    float acc[PER_LANE];
#pragma unroll
    for (int k = 0; k < PER_LANE; ++k) acc[k] = 0.f;
#pragma unroll 4
    for (int p = p0; p < p1; ++p) {
      const long e = perm ? (long)perm[p] : (long)p;
      const T* src = data + e * f + c0;
#pragma unroll
      for (int k = 0; k < PER_LANE; ++k) {
        const int c = lane + 32 * k;
        if (c0 + c < f) acc[k] += to_f32(src[c]);
      }
    }
    float* dst = out + (long)row * f + c0;
#pragma unroll
    for (int k = 0; k < PER_LANE; ++k) {
      const int c = lane + 32 * k;
      if (c0 + c < f) dst[c] = acc[k];
    }
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).  perm may be
// null.  Launches on `stream` and does not synchronise.
extern "C" int fastegnn_segment_sum(int bf16, const void* data, const int* rowptr,
                                    const int* perm, float* out, int n, int f,
                                    void* stream) {
  if (n < 0 || f <= 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const dim3 grid((n + WARPS - 1) / WARPS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    segment_sum_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(data), rowptr, perm, out, n, f);
  } else {
    segment_sum_kernel<float><<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(data), rowptr, perm, out, n, f);
  }
  return (int)cudaGetLastError();
}
