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
// What bounds it on the H100: bytes in the mean, latency in the tail.  It does
// one add per input value, so it reads each data row once and writes each
// output row once: for the Water-3D graph (580,032 real edges, F = 67,
// N = 8000) 157.6 MB in f32, about 47 us at 3.35 TB/s, and half the data
// bytes in bf16.  But the 8000 rows fit in one wave of warps, so the launch
// lasts as long as its longest row (degree up to 202 against a mean of 73)
// takes to walk: a walk with one edge row in flight per warp is a chain of
// ~200 dependent loads, and it was that chain, not the bytes, that set the
// first version's time (bf16, half the bytes, was only 18% faster).
//
// Design: the TPU kernel's 128-lane feature padding, chunk-aligned
// double-buffered DMA and one-hot P^T @ data products exist because the TPU
// has no fast gather; none of it is carried over.  A team of ROW_WARPS = 4
// warps owns one output row, and each warp splits into GROUPS = 4 lane groups
// of GLANES = 8 lanes: the team's 16 groups each walk every 16th edge of the
// row, so 16 edge rows' loads are in flight per row and a 202-edge row is
// ~13 dependent steps.  The lanes of a group stride the features (lane l of
// a group holds features l, l + GLANES, ... of each PASS-wide pass), so each
// load of a group is one 32-byte sector, and a lane issues all its loads of
// an edge row before it adds them.  The groups' f32 partial sums combine in
// a fixed order, two __shfl_xor_sync steps inside a warp and then the other
// warps' through shared memory, so the result is deterministic; each output
// row is written exactly once (empty rows write 0): no memset, no atomics.
// Against one warp per row, the extra warps per row were what moved the time
// (PERF.md, from scripts/torch_kernel_lab.py).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int ROW_WARPS = 4;              // warps per output row
constexpr int ROWS = WARPS / ROW_WARPS;   // output rows per block
constexpr int GROUPS = 4;                 // lane groups per warp, each its own edges
constexpr int GLANES = 32 / GROUPS;       // lanes per group, striding the features
constexpr int STRIDE = ROW_WARPS * GROUPS;  // edge stride of one group
constexpr int F_PATH = 67;               // H + 3 features on the variant path: one pass
constexpr int PER_LANE = (F_PATH + GLANES - 1) / GLANES;  // features per lane and pass
constexpr int PASS = GLANES * PER_LANE;   // features per pass

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
segment_sum_kernel(const T* __restrict__ data, const int* __restrict__ rowptr,
                   const int* __restrict__ perm, float* __restrict__ out, int n, int f) {
  __shared__ float part[WARPS][PASS];  // each warp's sums
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int team = warp / ROW_WARPS, sub = warp % ROW_WARPS;
  const int row = blockIdx.x * ROWS + team;
  const bool live = row < n;  // no early return: the block meets at barriers
  const int g = lane / GLANES, gl = lane % GLANES;
  const int p0 = live ? rowptr[row] : 0;
  const int p1 = live ? rowptr[row + 1] : 0;
  for (int c0 = 0; c0 < f; c0 += PASS) {
    const int cl = c0 + gl;  // this lane's first feature in the pass
    float acc[PER_LANE];
#pragma unroll
    for (int k = 0; k < PER_LANE; ++k) acc[k] = 0.f;
    for (int p = p0 + sub * GROUPS + g; p < p1; p += STRIDE) {
      const T* r = data + (perm ? (long)perm[p] : (long)p) * f;
      float v[PER_LANE];  // all of the row's loads issued before the adds
#pragma unroll
      for (int k = 0; k < PER_LANE; ++k) {
        const int c = cl + GLANES * k;
        v[k] = c < f ? to_f32(r[c]) : 0.f;
      }
#pragma unroll
      for (int k = 0; k < PER_LANE; ++k) acc[k] += v[k];
    }
    // the warp's groups, in a fixed order: (g0 + g1) + (g2 + g3) in every lane
#pragma unroll
    for (int k = 0; k < PER_LANE; ++k)
#pragma unroll
      for (int o = GLANES; o < 32; o <<= 1) acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], o);
    // then the other warps' sums into the first's, in warp order
    if (sub > 0 && g == 0) {
#pragma unroll
      for (int k = 0; k < PER_LANE; ++k) part[warp][gl + GLANES * k] = acc[k];
    }
    __syncthreads();
    if (sub == 0 && live) {
      float* dst = out + (long)row * f;
#pragma unroll
      for (int k = 0; k < PER_LANE; ++k) {
        const int c = cl + GLANES * k;
        // group g stores the features of its k = g (mod GROUPS)
        if (k % GROUPS == g && c < f) {
          float v = acc[k];
          for (int j = 1; j < ROW_WARPS; ++j) v += part[warp + j][gl + GLANES * k];
          dst[c] = v;
        }
      }
    }
    __syncthreads();
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
  const dim3 grid((n + ROWS - 1) / ROWS);
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
