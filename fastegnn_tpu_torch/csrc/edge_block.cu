// Fused FastEGNN real-edge block for Hopper (sm_90a): forward and backward.
//
// Replaces the Pallas TPU kernels fastegnn_tpu/ops/edge_kernel_v5.py::_fwd_kernel
// and ::_bwd_kernel (public op fused_edge_block_v5).  Per real edge
// e = (d, s) of the dst-sorted CSR:
//
//   z1   = Ud[d] + Us[s] + |x_d - x_s|^2 w1r + ea_e W1e    (Ud = h W1_dst + b1,
//   m    = silu(silu(z1) W2 + b2)                            Us = h W1_src,
//   gate = silu(m Wg1 + bg1) . wg2                           built outside)
//   m_sum[d] += m          t_sum[d] += (x_d - x_s) gate
//
// and the backward recomputes that chain per edge from d m_sum / d t_sum.
// The two 64x64 chain products (W2, Wg1) and, in the backward, their
// transposes and the weight-gradient outer products run in these kernels.
//
// What bounds it on the H100: the chain products, 2 x 64 x 64 MACs per edge
// forward and 6 backward, against a few hundred bytes of gathered rows per
// edge, so operations, not bytes (about 10 us forward and 29 us backward per
// layer at the bf16 tensor-core rate for the Water-3D graph's 580k edges).
// Every per-edge intermediate stays out of device memory.
//
// bf16 mode (the main path) runs on the tensor cores: one block of 8 warps
// owns TC_ROWS = 4 dst rows and walks their edges in tiles of TC_TE = 64,
// each tile staged as bf16 [64][64] in shared memory.  Both kernels build a
// tile with the same stage code (TileWalk): the per-edge scalars (src, dst
// row, x_d - x_s, radial, rounded edge attributes; src ids a tile ahead), the
// Us rows by cp.async a tile ahead, then z1 and a1 = silu(z1); z2 = a1 W2
// (tile_product: wmma bf16 16x16x16, f32 accumulators, through one f32
// scratch tile) and m = silu(z2); zg = m Wg1 and the gate (gate_of, one warp
// reduction per edge).  Every operand of those products is already a bf16
// value (a1, m, the W2 / Wg1 pack rows; the JAX kernel casts them there), so
// the tensor cores form the same products exactly and only the order of the
// f32 sums changes.  The backward runs the forward's stages on the same
// operands over the same tiles, so it recomputes the forward's chain bit for
// bit.  Between products, one warp per edge row runs the elementwise chain
// with an exact logistic (expf, IEEE division).
//
// - forward in bf16 (edge_fwd_tc_kernel): per tile, (x_d - x_s) gate goes to
//   per-warp t_sum rows in shared memory, and m_sum += P @ m, one more
//   product with P [16 x 64 edges] the tile's one-hot dst rows, in
//   accumulator fragments kept across tiles (exact: m is a bf16 value, P is
//   0 or 1).  After the last tile the block stores its m_sum rows once and
//   its t_sum rows as the fixed-order sum of the per-warp rows: no atomics,
//   deterministic; rows without edges, blocks without edges too, get zeros.
//   With the products off the CUDA cores, the elementwise passes (three
//   sigmoids per feature per edge) and the products' round trips through
//   the scratch tile bound it (PERF.md, from scripts/torch_kernel_lab.py),
//   at FWD_BLOCKS = 3 blocks per SM, ~70 KB of shared memory each.
// - backward in bf16 (edge_bwd_tc_kernel): after the forward's stages, per
//   tile d_m = d_zg Wg1^T and d_a1 = d_z2 W2^T; dW2 += a1^T d_z2 and dWg1 +=
//   m^T d_zg in accumulator fragments kept across tiles; and PQ @ d_z1, where
//   PQ holds the tile's one-hot dst rows and its rounded radial and edge
//   attributes, which sums the dst-role dUd rows and the dW1 radial /
//   edge-attr rows in one more fragment per warp (each dUd row stored once,
//   by the block that owns it).  The dst-role dx sums go to per-warp rows in
//   shared memory, the src-role sums (dUs, dx_src) out with f32 atomics.
//   The sigmoids take the largest share of its time, then the products'
//   round trips, the warp reductions and the atomics (PERF.md), at 2 blocks
//   per SM, where 128 registers and ~111 KB of shared memory per block hold it.
//
// f32 mode stays on the CUDA cores as exact FP32 FMAs: the only f32
// tensor-core path, TF32, rounds the operands to 10 mantissa bits and would
// break the f32 contract.
// - forward in f32 (edge_fwd_kernel): one warp per dst row walks
//   rowptr[row]..rowptr[row+1]; each lane owns two of the 64 features; W2 and
//   Wg1 sit in shared memory; the row's sums stay in registers and are
//   written once (no atomics, deterministic); one edge per warp at a time,
//   ~100x above the bound (PERF.md).
// - backward in f32 (edge_bwd_kernel) replaces edge_kernel_v5.py::_bwd_kernel
//   (:503) with its body _chain_bwd (:438).  Its six 64x64 products per edge
//   (the recompute's a1 W2 and m Wg1, then d_zg Wg1^T, d_z2 W2^T, and the
//   weight gradients a1^T d_z2, m^T d_zg) set its bound at the FP32 rate, 67
//   TFLOP/s.  What holds it is shared memory: it delivers 128 bytes of
//   operands per clock per SM, a broadcast counting once per lane, and the
//   FP32 rate needs 4 FMAs per float loaded.  One edge per warp, each
//   product a matvec, gave ~1.6 FMAs per float.  So the block walks its dst
//   rows' edges in tiles of TE and runs the four chain products as products
//   of whole tiles (f32_product): each thread keeps RE x RF sums in
//   registers (6 edges x 2 features) and reads the edge rows as float4s
//   along k, 12 FMAs for 8 floats (a warp spans 4 edge rows x 8 feature
//   groups, rows padded to LDT, so no load conflicts).  A product with W^T
//   reads W's rows along k as the A operand is read, so no transposed copy
//   is kept.  Between products one warp per edge row runs the elementwise
//   chain without branches (z1; the gate and d_zg; d_radial and the
//   src-role atomics; each warp's per-feature weight-gradient sums go to
//   shared memory once per pass), and the product epilogues apply the rest
//   in place: dsilu(z2) and dsilu(z1) are stored when the sigmoid is taken
//   and become d_z2 and d_z1; m Wg1 becomes d_zg.  Three exact logistics per feature per edge, as before.  Phase 2
//   accumulates dW2 += a1^T d_z2 and dWg1 += m^T d_zg in 4 x BWD_DWC
//   register tiles, and each thread the dUd sums of one row over that row's
//   edges in the tile (stored once, no atomics, deterministic); dx_dst goes
//   to per-warp row sums combined in a fixed order; dUs and dx_src go out
//   with f32 atomics.  A persistent grid of BWD_BLOCKS blocks per SM takes
//   ranges of BWD_ROWS rows from a counter, so the SMs stay balanced and
//   each block adds its weight gradients to dw once, at its end.  ~107 KB of shared memory per block (W2, Wg1 and
//   five [TE][LDT] tiles) and at most 128 registers: 2 blocks per SM.  Larger
//   register tiles need more registers or shared memory than 2 blocks of 8
//   warps have, and fewer warps per SM lost more than they gained
//   (scripts/torch_kernel_lab.py, PERF.md).
// The atomics make dUs, dx and dw vary in the last bits from run to run; dUd
// and the forward are deterministic.
//
// Compute modes: f32 (exact f32 arithmetic) and bf16 (tables bf16, weights
// rounded to bf16, z1 / z2 / zg / sigmoid / silu outputs and the backward's
// d_zg, d_z2, d_z1 rounded to bf16 where the JAX kernel casts them; every
// sum in f32).  The plain PyTorch versions in ops/edge_kernel.py round at the
// same points.
//
// Weight pack (f32 [PACK_ROWS, 64], also the layout of the dw output):
// rows 0:64 W2, 64:128 Wg1 ([in, out]), 128:128+fe W1 edge-attr rows, 131 W1
// radial row, 132 wg2, 133 b2, 134 bg1.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int H = 64;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int FE_MAX = 3;
constexpr int ROW_W2 = 0, ROW_WG1 = 64, ROW_W1E = 128, ROW_W1R = 131,
              ROW_WG2 = 132, ROW_B2 = 133, ROW_BG1 = 134;
// the per-feature weights, f32 [LW_ROWS][H] in shared memory
constexpr int LW_W1R = 0, LW_WG2 = 1, LW_B2 = 2, LW_BG1 = 3, LW_W1E = 4, LW_ROWS = 7;
// f32 backward: blocks of BWD_WARPS warps walk ranges of BWD_ROWS dst rows in
// tiles of TE edges; BWD_FG feature groups in the products; BWD_BLOCKS blocks
// per SM, each taking the next range from a counter until none is left
// (BWD_PERSIST 1), or one block per range (0)
constexpr int TE = 48;
constexpr int BWD_ROWS = 8;
constexpr int BWD_WARPS = 8;
constexpr int BWD_PWARPS = 8;   // warps that run the chain products
constexpr int BWD_FG = 32;
constexpr int BWD_BLOCKS = 2;
constexpr int BWD_PERSIST = 1;
constexpr int BWD_THREADS = BWD_WARPS * 32;
constexpr int LDT = H + 4;                      // f32 tile row stride
constexpr int BWD_EG = BWD_PWARPS * 32 / BWD_FG;  // edge groups of the products
constexpr int RF = H / BWD_FG;                  // features per thread
constexpr int RE = TE / BWD_EG;                 // edges per thread
constexpr int EPW = TE / BWD_WARPS;             // edge rows per warp, elementwise passes
// edge rows a warp's elementwise passes run at once, their loads and
// reductions interleaved; more than one spills registers at 2 blocks per SM
constexpr int PG = 1;
constexpr int DF = H * BWD_ROWS / BWD_THREADS;  // dUd features per thread
constexpr int BWD_DWC = 4;                      // columns of a thread's dW2 / dWg1 tiles
constexpr int DW_KG = H / BWD_DWC;              // column groups of the dW tiles
constexpr int DWT = 16 * DW_KG;                 // threads that own dW tiles
static_assert(BWD_FG % 8 == 0 && BWD_PWARPS % (BWD_FG / 8) == 0 && RF % 2 == 0 &&
                  BWD_PWARPS <= BWD_WARPS,
              "f32_product: a warp spans 4 edge groups x 8 feature groups");
static_assert(TE % BWD_EG == 0 && TE % BWD_WARPS == 0 && EPW <= 32 && EPW % PG == 0,
              "edges of a tile");
static_assert(DF % 2 == 0 && BWD_THREADS % BWD_ROWS == 0, "dUd: float2s of one row per thread");
static_assert(BWD_DWC % 4 == 0 && DW_KG % 8 == 0 && DWT <= BWD_THREADS,
              "dW2 and dWg1 in 4 x BWD_DWC tiles, a warp spanning 4 x 8 of them");
constexpr size_t BWD_SMEM =
    (2 * H * LDT + 5 * TE * LDT + 2 * LW_ROWS * H + BWD_ROWS * H + 2 * BWD_ROWS * 4 + 3 * TE * 4 +
     BWD_WARPS * BWD_ROWS * 4) * sizeof(float) + (2 * TE + BWD_ROWS + 2) * sizeof(int);
static_assert(BWD_BLOCKS * (BWD_SMEM + 1024) <= 228 * 1024,
              "BWD_BLOCKS f32 backward blocks fit in one SM's shared memory");

// round to bf16 and back
__device__ __forceinline__ float rnd(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float2 rnd2(float2 v) { return make_float2(rnd(v.x), rnd(v.y)); }

__device__ __forceinline__ float2 load2(const float* p, long i) {
  return *reinterpret_cast<const float2*>(p + i);
}

__device__ __forceinline__ float2 load2(const __nv_bfloat16* p, long i) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p + i));
}

__device__ __forceinline__ float sigmoid(float z) { return 1.f / (1.f + expf(-z)); }

__device__ __forceinline__ float dsilu(float z, float s) {
  return s * (1.f + z * (1.f - s));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float pick3(const float* a, int i) {
  return i == 0 ? a[0] : (i == 1 ? a[1] : a[2]);
}

// Columns k0, k0 + 1 of v[0:64] @ W for W [64][64] ([in][out], row-major);
// v and W in shared memory.
__device__ __forceinline__ float2 matvec(const float* v, const float* W, int k0) {
  float2 acc = make_float2(0.f, 0.f);
#pragma unroll 4
  for (int j = 0; j < H; j += 4) {
    const float4 a = *reinterpret_cast<const float4*>(v + j);
    const float2 w0 = *reinterpret_cast<const float2*>(W + (j + 0) * H + k0);
    const float2 w1 = *reinterpret_cast<const float2*>(W + (j + 1) * H + k0);
    const float2 w2 = *reinterpret_cast<const float2*>(W + (j + 2) * H + k0);
    const float2 w3 = *reinterpret_cast<const float2*>(W + (j + 3) * H + k0);
    acc.x += a.x * w0.x; acc.y += a.x * w0.y;
    acc.x += a.y * w1.x; acc.y += a.y * w1.y;
    acc.x += a.z * w2.x; acc.y += a.z * w2.y;
    acc.x += a.w * w3.x; acc.y += a.w * w3.y;
  }
  return acc;
}

// The per-feature weights a lane needs, for its features k0, k0 + 1.
struct LaneW {
  float2 w1r, wg2, b2, bg1;
  float2 w1e[FE_MAX];
};

__device__ __forceinline__ LaneW load_lane_weights(const float* wpack, int k0, int fe) {
  LaneW w;
  w.w1r = load2(wpack, ROW_W1R * H + k0);
  w.wg2 = load2(wpack, ROW_WG2 * H + k0);
  w.b2 = load2(wpack, ROW_B2 * H + k0);
  w.bg1 = load2(wpack, ROW_BG1 * H + k0);
#pragma unroll
  for (int f = 0; f < FE_MAX; ++f)
    w.w1e[f] = f < fe ? load2(wpack, (ROW_W1E + f) * H + k0) : make_float2(0.f, 0.f);
  return w;
}

// One edge's forward chain, as seen by one lane.
struct Chain {
  float2 z1, s1, a1, z2, s2, m, zg, sg, g1;
  float diff[3];
  float radial, gate;
  float ea[FE_MAX];
};

// The f32 chain of edge (d, s), for the f32 forward.  bufA /
// bufM are this warp's 64-float shared buffers for a1 and m (the operands of
// the two chain products); the caller synchronises the warp before a buffer
// is reused.
__device__ __forceinline__ void chain_fwd(Chain& c, float2 ud, const float* __restrict__ us,
                                          int s, const float* __restrict__ x,
                                          const float* xd, const float* __restrict__ ea_row,
                                          int fe, const LaneW& w, const float* sW2,
                                          const float* sWg1, float* bufA, float* bufM,
                                          int k0) {
  c.diff[0] = xd[0] - x[3 * s];
  c.diff[1] = xd[1] - x[3 * s + 1];
  c.diff[2] = xd[2] - x[3 * s + 2];
  c.radial = c.diff[0] * c.diff[0] + c.diff[1] * c.diff[1] + c.diff[2] * c.diff[2];
  const float2 u = load2(us, (long)s * H + k0);
  float2 eterm = make_float2(0.f, 0.f);
#pragma unroll
  for (int f = 0; f < FE_MAX; ++f) {
    c.ea[f] = f < fe ? ea_row[f] : 0.f;
    eterm.x += c.ea[f] * w.w1e[f].x;
    eterm.y += c.ea[f] * w.w1e[f].y;
  }
  c.z1 = make_float2((ud.x + u.x) + c.radial * w.w1r.x + eterm.x,
                     (ud.y + u.y) + c.radial * w.w1r.y + eterm.y);
  c.s1 = make_float2(sigmoid(c.z1.x), sigmoid(c.z1.y));
  c.a1 = make_float2(c.z1.x * c.s1.x, c.z1.y * c.s1.y);
  bufA[k0] = c.a1.x;
  bufA[k0 + 1] = c.a1.y;
  __syncwarp();
  float2 t = matvec(bufA, sW2, k0);
  c.z2 = make_float2(t.x + w.b2.x, t.y + w.b2.y);
  c.s2 = make_float2(sigmoid(c.z2.x), sigmoid(c.z2.y));
  c.m = make_float2(c.z2.x * c.s2.x, c.z2.y * c.s2.y);
  bufM[k0] = c.m.x;
  bufM[k0 + 1] = c.m.y;
  __syncwarp();
  t = matvec(bufM, sWg1, k0);
  c.zg = make_float2(t.x + w.bg1.x, t.y + w.bg1.y);
  c.sg = make_float2(sigmoid(c.zg.x), sigmoid(c.zg.y));
  c.g1 = make_float2(c.zg.x * c.sg.x, c.zg.y * c.sg.y);
  c.gate = warp_sum(c.g1.x * w.wg2.x + c.g1.y * w.wg2.y);
}

__global__ void __launch_bounds__(THREADS)
edge_fwd_kernel(const float* __restrict__ ud, const float* __restrict__ us,
                const float* __restrict__ x, const int* __restrict__ rowptr,
                const int* __restrict__ src, const float* __restrict__ ea, int fe,
                const float* __restrict__ wpack, float* __restrict__ msum,
                float* __restrict__ tsum, int n) {
  __shared__ __align__(16) float sW2[H * H];
  __shared__ __align__(16) float sWg1[H * H];
  __shared__ __align__(16) float sbuf[WARPS][2][H];
  for (int i = threadIdx.x; i < H * H; i += THREADS) {
    sW2[i] = wpack[ROW_W2 * H + i];
    sWg1[i] = wpack[ROW_WG1 * H + i];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, k0 = 2 * lane;
  const LaneW w = load_lane_weights(wpack, k0, fe);
  float* bufA = sbuf[warp][0];
  float* bufM = sbuf[warp][1];
  for (int row = blockIdx.x * WARPS + warp; row < n; row += gridDim.x * WARPS) {
    const int e0 = rowptr[row], e1 = rowptr[row + 1];
    const float2 udr = load2(ud, (long)row * H + k0);
    const float xd[3] = {x[3 * row], x[3 * row + 1], x[3 * row + 2]};
    float2 accm = make_float2(0.f, 0.f);
    float acct[3] = {0.f, 0.f, 0.f};
    for (int e = e0; e < e1; ++e) {
      Chain c;
      __syncwarp();
      chain_fwd(c, udr, us, src[e], x, xd, ea + (long)e * fe, fe, w, sW2, sWg1, bufA, bufM,
                k0);
      accm.x += c.m.x;
      accm.y += c.m.y;
#pragma unroll
      for (int k = 0; k < 3; ++k) acct[k] += c.diff[k] * c.gate;
    }
    *reinterpret_cast<float2*>(msum + (long)row * H + k0) = accm;
    if (lane < 3) tsum[3 * row + lane] = pick3(acct, lane);
  }
}

// ---------------------------------------------------------------------------
// f32 backward: register-tiled FP32 products over tiles of edges
// ---------------------------------------------------------------------------

// A lane's features 2 lane, 2 lane + 1 of v added to a row of 64 sums in
// shared memory, kept as [2][32] (feature 2 l + c at 32 c + l) so that a
// warp's additions fall in distinct banks; several warps add to one row.
__device__ __forceinline__ void add2(float* row, int lane, float2 v) {
  atomicAdd(row + lane, v.x);
  atomicAdd(row + 32 + lane, v.y);
}

// the f32 backward's logistic: exact (expf, IEEE division)
__device__ __forceinline__ float sig_f32(float z) { return sigmoid(z); }

template <int N>
__device__ __forceinline__ void load_row(const float* p, float* v) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int j = 0; j < N; j += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + j);
      v[j] = t.x; v[j + 1] = t.y; v[j + 2] = t.z; v[j + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; j += 2) {
      const float2 t = *reinterpret_cast<const float2*>(p + j);
      v[j] = t.x; v[j + 1] = t.y;
    }
  }
}

// Feature j of thread group ng in X @ W: float4s of a W row 4 BWD_FG apart
// (RF a multiple of 4), else RF consecutive features.
__device__ __forceinline__ int nt_feature(int ng, int j) {
  return RF % 4 == 0 ? 4 * ng + (j & 3) + (j >> 2) * 4 * BWD_FG : RF * ng + j;
}

// Column c of a dW tile of column group kg: float4s 4 DW_KG apart.
__device__ __forceinline__ int dw_col(int kg, int c) {
  return 4 * kg + (c & 3) + (c >> 2) * 4 * DW_KG;
}

// Out = X @ W (TRANS false) or X @ W^T (TRANS true) over one tile of edges,
// in exact f32 on the CUDA cores: X [TE][LDT] and W [H][LDT] ([in][out]) in
// shared memory.  Thread (eg, ng) keeps RE x RF sums in registers, for edges
// eg + BWD_EG i and features nt_feature(ng, j) (X @ W: float4s of a W row
// per k) or ng + BWD_FG j (X @ W^T: a float4 of W row ng + BWD_FG j per
// 4 k, W's rows read along k as X's are).  A warp spans 4 edge groups x 8
// feature groups, so each load is one shared-memory wavefront.  Every sum
// goes to epi(edge, feature, sum).  The first BWD_PWARPS warps run it.
template <bool TRANS, class Epi>
__device__ __forceinline__ void f32_product(const float* X, const float* W, Epi epi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp >= BWD_PWARPS) return;
  const int ng = (warp % (BWD_FG / 8)) * 8 + (lane & 7);
  const int eg = (warp / (BWD_FG / 8)) * 4 + (lane >> 3);
  float acc[RE][RF];
#pragma unroll
  for (int i = 0; i < RE; ++i)
#pragma unroll
    for (int j = 0; j < RF; ++j) acc[i][j] = 0.f;
#pragma unroll 2
  for (int k = 0; k < H; k += 4) {
    float a[RE][4];
#pragma unroll
    for (int i = 0; i < RE; ++i) load_row<4>(X + (eg + BWD_EG * i) * LDT + k, a[i]);
    if constexpr (TRANS) {
#pragma unroll
      for (int j = 0; j < RF; ++j) {
        float b[4];
        load_row<4>(W + (ng + BWD_FG * j) * LDT + k, b);
#pragma unroll
        for (int i = 0; i < RE; ++i)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) acc[i][j] += a[i][kk] * b[kk];
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float b[RF];
        if constexpr (RF % 4 == 0) {
#pragma unroll
          for (int j = 0; j < RF; j += 4) load_row<4>(W + (k + kk) * LDT + nt_feature(ng, j), b + j);
        } else {
          load_row<RF>(W + (k + kk) * LDT + RF * ng, b);
        }
#pragma unroll
        for (int i = 0; i < RE; ++i)
#pragma unroll
          for (int j = 0; j < RF; ++j) acc[i][j] += a[i][kk] * b[j];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RE; ++i)
#pragma unroll
    for (int j = 0; j < RF; ++j)
      epi(eg + BWD_EG * i, TRANS ? ng + BWD_FG * j : nt_feature(ng, j), acc[i][j]);
}

// the f32 backward's next row range, zeroed on the stream before each launch:
// two launches of the kernel must not overlap on two streams
__device__ int bwd_next_range;

__global__ void __launch_bounds__(BWD_THREADS, BWD_BLOCKS)
edge_bwd_kernel(const float* __restrict__ ud, const float* __restrict__ us,
                const float* __restrict__ x, const int* __restrict__ rowptr,
                const int* __restrict__ src, const int* __restrict__ dst,
                const float* __restrict__ ea, int fe, const float* __restrict__ wpack,
                const float* __restrict__ dms, const float* __restrict__ dts,
                float* __restrict__ dud, float* __restrict__ dus,
                float* __restrict__ dxd, float* __restrict__ dxs,
                float* __restrict__ dw, int n) {
  extern __shared__ __align__(16) float smem[];
  float* sW2 = smem;                     // [H][LDT]
  float* sWg1 = sW2 + H * LDT;           // [H][LDT]
  float* sA1 = sWg1 + H * LDT;           // [TE][LDT] a1 = silu(z1)
  float* sM = sA1 + TE * LDT;            // [TE][LDT] m = silu(z2)
  float* sD1 = sM + TE * LDT;            // [TE][LDT] dsilu(z1), then d_z1
  float* sD2 = sD1 + TE * LDT;           // [TE][LDT] dsilu(z2), then d_z2
  float* sG = sD2 + TE * LDT;            // [TE][LDT] m Wg1, then d_zg
  float* sLW = sG + TE * LDT;            // [LW_ROWS][H] per-feature weights
  float* sGW = sLW + LW_ROWS * H;        // [LW_ROWS][2][32] their gradients (add2)
  float* sDM = sGW + LW_ROWS * H;        // [BWD_ROWS][H] d m_sum of the range's rows
  float* sXD = sDM + BWD_ROWS * H;       // [BWD_ROWS][4] x of the rows
  float* sDT = sXD + BWD_ROWS * 4;       // [BWD_ROWS][4] d t_sum of the rows
  float* sDIFF = sDT + BWD_ROWS * 4;     // [TE][4] x_d - x_s, radial
  float* sEA = sDIFF + TE * 4;           // [TE][4] edge attributes
  float* sDD = sEA + TE * 4;             // [TE][4] dt gate
  float* sDXD = sDD + TE * 4;            // [BWD_WARPS][BWD_ROWS][4] per-warp dx_dst sums
  int* sSRC = reinterpret_cast<int*>(sDXD + BWD_WARPS * BWD_ROWS * 4);  // [TE]
  int* sROW = sSRC + TE;                 // [TE] dst row - r0; -1 past the range's edges
  int* sRP = sROW + TE;                  // [BWD_ROWS + 1] rowptr[r0 ..]
  int* sRANGE = sRP + BWD_ROWS + 1;      // the block's current range

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, k0 = 2 * lane;
  for (int i = tid; i < H * H; i += BWD_THREADS) {
    const int j = i / H, k = i % H;
    sW2[j * LDT + k] = wpack[ROW_W2 * H + i];
    sWg1[j * LDT + k] = wpack[ROW_WG1 * H + i];
  }
  for (int i = tid; i < LW_ROWS * H; i += BWD_THREADS) {
    const int row = i / H, k = i % H;
    const int from = row == LW_W1R ? ROW_W1R : row == LW_WG2 ? ROW_WG2
                     : row == LW_B2 ? ROW_B2 : row == LW_BG1 ? ROW_BG1
                     : ROW_W1E + row - LW_W1E;
    sLW[i] = row < LW_W1E || row - LW_W1E < fe ? wpack[from * H + k] : 0.f;
    sGW[i] = 0.f;
  }
  // threads tid < DWT own a 4 x BWD_DWC tile of dW2 and one of dWg1: rows
  // 4 jg .., columns dw_col(kg, c); a warp spans 4 jg x 8 kg
  const int jg = (warp / (DW_KG / 8)) * 4 + (lane >> 3);
  const int kg = (warp % (DW_KG / 8)) * 8 + (lane & 7);
  float tW2[4][BWD_DWC], tWg1[4][BWD_DWC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < BWD_DWC; ++b) tW2[a][b] = tWg1[a][b] = 0.f;
  // this thread's dUd row of the range and its DF features
  const int drow = tid / (BWD_THREADS / BWD_ROWS), df0 = (tid % (BWD_THREADS / BWD_ROWS)) * DF;

  const int n_ranges = (n + BWD_ROWS - 1) / BWD_ROWS;
  for (int it = 0;; ++it) {
    __syncthreads();  // every thread has read the last range and is done with its rows
    if (tid == 0)
      *sRANGE = BWD_PERSIST ? atomicAdd(&bwd_next_range, 1) : it == 0 ? blockIdx.x : n_ranges;
    __syncthreads();
    const int range = *sRANGE;
    if (range >= n_ranges) break;
    const int r0 = range * BWD_ROWS, nr = min(n - r0, BWD_ROWS);
    const int e0 = rowptr[r0], e1 = rowptr[r0 + nr];
    if (e0 >= e1) continue;  // block-uniform: the wrapper zeroes the outputs
    for (int i = tid; i < BWD_ROWS * H; i += BWD_THREADS)
      sDM[i] = i / H < nr ? dms[(long)r0 * H + i] : 0.f;
    if (tid < BWD_ROWS * 4) {
      const int r = tid >> 2, c = tid & 3;
      const bool live = r < nr && c < 3;
      sXD[tid] = live ? x[3 * (r0 + r) + c] : 0.f;
      sDT[tid] = live ? dts[3 * (r0 + r) + c] : 0.f;
    }
    if (tid <= nr) sRP[tid] = rowptr[r0 + tid];
    for (int i = tid; i < BWD_WARPS * BWD_ROWS * 4; i += BWD_THREADS) sDXD[i] = 0.f;
    float dacc[DF];
#pragma unroll
    for (int f = 0; f < DF; ++f) dacc[f] = 0.f;
    __syncthreads();

    for (int t0 = e0; t0 < e1; t0 += TE) {
      // ---- per edge row: scalars, z1, a1 = silu(z1), dsilu(z1); PG rows at
      // a time, without branches, so that their loads and chains overlap
      // (rows past the range's last edge recompute it and store zeros) ----
      {
        const int el = min(t0 + warp * EPW + (lane < EPW ? lane : 0), e1 - 1);
        const int s_l = src[el], d_l = dst[el];
        const float2 w1r = load2(sLW, LW_W1R * H + k0);
        float2 w1e[FE_MAX];
#pragma unroll
        for (int f = 0; f < FE_MAX; ++f) w1e[f] = load2(sLW, (LW_W1E + f) * H + k0);
#pragma unroll
        for (int g = 0; g < EPW; g += PG) {
#pragma unroll
          for (int i = g; i < g + PG; ++i) {
            const int te = warp * EPW + i, e = min(t0 + te, e1 - 1);
            const bool live = t0 + te < e1;
            const int s = __shfl_sync(0xffffffffu, s_l, i);
            const int d = __shfl_sync(0xffffffffu, d_l, i);
            const int r = d - r0;
            float diff[3];
#pragma unroll
            for (int c = 0; c < 3; ++c) diff[c] = sXD[4 * r + c] - x[3 * s + c];
            const float radial = diff[0] * diff[0] + diff[1] * diff[1] + diff[2] * diff[2];
            const float2 u = load2(us, (long)s * H + k0);
            const float2 udr = load2(ud, (long)d * H + k0);
            float2 eterm = make_float2(0.f, 0.f);
            float eav[FE_MAX];
#pragma unroll
            for (int f = 0; f < FE_MAX; ++f) {
              eav[f] = f < fe ? ea[(long)e * fe + f] : 0.f;
              eterm.x += eav[f] * w1e[f].x;
              eterm.y += eav[f] * w1e[f].y;
            }
            const float2 z1 = make_float2((udr.x + u.x) + radial * w1r.x + eterm.x,
                                          (udr.y + u.y) + radial * w1r.y + eterm.y);
            const float2 s1 = make_float2(sig_f32(z1.x), sig_f32(z1.y));
            const float2 a1 = live ? make_float2(z1.x * s1.x, z1.y * s1.y) : make_float2(0.f, 0.f);
            const float2 ds1 = live ? make_float2(dsilu(z1.x, s1.x), dsilu(z1.y, s1.y))
                                    : make_float2(0.f, 0.f);
            *reinterpret_cast<float2*>(sA1 + te * LDT + k0) = a1;
            *reinterpret_cast<float2*>(sD1 + te * LDT + k0) = ds1;
            if (lane == 0) {
              sSRC[te] = s;
              sROW[te] = live ? r : -1;
            }
            if (lane < 3) {
              sDIFF[4 * te + lane] = pick3(diff, lane);
              sEA[4 * te + lane] = pick3(eav, lane);
            } else if (lane == 3) {
              sDIFF[4 * te + 3] = radial;
            }
          }
        }
      }
      __syncthreads();

      // ---- z2 = a1 W2 + b2: m = silu(z2) and dsilu(z2) ----
      f32_product<false>(sA1, sW2, [&](int e, int k, float t) {
        const float z2 = t + sLW[LW_B2 * H + k];
        const float s2 = sig_f32(z2);
        sM[e * LDT + k] = sROW[e] >= 0 ? z2 * s2 : 0.f;
        sD2[e * LDT + k] = dsilu(z2, s2);
      });
      __syncthreads();

      // ---- m Wg1 ----
      f32_product<false>(sM, sWg1, [&](int e, int k, float t) { sG[e * LDT + k] = t; });
      __syncthreads();

      // ---- per edge row: zg = m Wg1 + bg1, the gate, d_zg over m Wg1; PG
      // rows at a time, their gate reductions interleaved ----
      {
        const float2 bg1 = load2(sLW, LW_BG1 * H + k0);
        const float2 wg2 = load2(sLW, LW_WG2 * H + k0);
        float2 gbg1 = make_float2(0.f, 0.f), gwg2 = gbg1;
#pragma unroll
        for (int g = 0; g < EPW; g += PG) {
          float2 zg[PG], sg[PG], g1[PG];
          float p[PG];
#pragma unroll
          for (int i = 0; i < PG; ++i) {
            const float2 t = load2(sG, (warp * EPW + g + i) * LDT + k0);
            zg[i] = make_float2(t.x + bg1.x, t.y + bg1.y);
            sg[i] = make_float2(sig_f32(zg[i].x), sig_f32(zg[i].y));
            g1[i] = make_float2(zg[i].x * sg[i].x, zg[i].y * sg[i].y);
            p[i] = g1[i].x * wg2.x + g1[i].y * wg2.y;
          }
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
#pragma unroll
            for (int i = 0; i < PG; ++i) p[i] += __shfl_xor_sync(0xffffffffu, p[i], o);
#pragma unroll
          for (int i = 0; i < PG; ++i) {
            const int te = warp * EPW + g + i, r = sROW[te];
            const float* dt = sDT + 4 * max(r, 0);
            const float* df = sDIFF + 4 * te;
            const float d_gate = r >= 0 ? df[0] * dt[0] + df[1] * dt[1] + df[2] * dt[2] : 0.f;
            const float2 dzg = make_float2(d_gate * wg2.x * dsilu(zg[i].x, sg[i].x),
                                           d_gate * wg2.y * dsilu(zg[i].y, sg[i].y));
            if (lane < 3) sDD[4 * te + lane] = dt[lane] * p[i];
            gbg1.x += dzg.x;
            gbg1.y += dzg.y;
            gwg2.x += g1[i].x * d_gate;
            gwg2.y += g1[i].y * d_gate;
            *reinterpret_cast<float2*>(sG + te * LDT + k0) = dzg;
          }
        }
        add2(sGW + LW_BG1 * H, lane, gbg1);
        add2(sGW + LW_WG2 * H, lane, gwg2);
      }
      __syncthreads();

      // ---- d_z2 = (dm + d_zg Wg1^T) dsilu(z2), over dsilu(z2) ----
      f32_product<true>(sG, sWg1, [&](int e, int k, float t) {
        const int r = sROW[e];
        float& v = sD2[e * LDT + k];
        v = r >= 0 ? (sDM[r * H + k] + t) * v : 0.f;
      });
      __syncthreads();

      // ---- d_z1 = d_z2 W2^T dsilu(z1), over dsilu(z1) ----
      f32_product<true>(sD2, sW2, [&](int e, int k, float t) {
        float& v = sD1[e * LDT + k];
        v = sROW[e] >= 0 ? t * v : 0.f;
      });
      __syncthreads();

      // ---- per edge row: d_radial, d(x_d - x_s); src role out with atomics,
      // dst role into this warp's dx_dst rows; PG rows at a time ----
      {
        const float2 w1r = load2(sLW, LW_W1R * H + k0);
        float2 gb2 = make_float2(0.f, 0.f), gw1r = gb2, gw1e[FE_MAX];
#pragma unroll
        for (int f = 0; f < FE_MAX; ++f) gw1e[f] = gb2;
#pragma unroll
        for (int g = 0; g < EPW; g += PG) {
          float2 dz1[PG];
          float p[PG];
#pragma unroll
          for (int i = 0; i < PG; ++i) {
            dz1[i] = load2(sD1, (warp * EPW + g + i) * LDT + k0);
            p[i] = dz1[i].x * w1r.x + dz1[i].y * w1r.y;
          }
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
#pragma unroll
            for (int i = 0; i < PG; ++i) p[i] += __shfl_xor_sync(0xffffffffu, p[i], o);
#pragma unroll
          for (int i = 0; i < PG; ++i) {
            const int te = warp * EPW + g + i, r = sROW[te];
            if (r >= 0) {  // warp-uniform
              const int s = sSRC[te];
              atomicAdd(reinterpret_cast<float2*>(dus + (long)s * H + k0), dz1[i]);
              if (lane < 3) {
                const float dd = sDD[4 * te + lane] + 2.f * sDIFF[4 * te + lane] * p[i];
                atomicAdd(dxs + 3 * s + lane, dd);
                sDXD[(warp * BWD_ROWS + r) * 4 + lane] += dd;
              }
            }
            // d_z1 and d_z2 are zeros past the last edge
            const float2 dz2 = load2(sD2, te * LDT + k0);
            const float radial = sDIFF[4 * te + 3];
            gb2.x += dz2.x;
            gb2.y += dz2.y;
            gw1r.x += radial * dz1[i].x;
            gw1r.y += radial * dz1[i].y;
#pragma unroll
            for (int f = 0; f < FE_MAX; ++f) {
              gw1e[f].x += sEA[4 * te + f] * dz1[i].x;
              gw1e[f].y += sEA[4 * te + f] * dz1[i].y;
            }
          }
        }
        add2(sGW + LW_B2 * H, lane, gb2);
        add2(sGW + LW_W1R * H, lane, gw1r);
#pragma unroll
        for (int f = 0; f < FE_MAX; ++f)
          if (f < fe) add2(sGW + (LW_W1E + f) * H, lane, gw1e[f]);
      }

      // ---- phase 2: dW2 += a1^T d_z2, dWg1 += m^T d_zg over the tile ----
      if (tid < DWT) {
#pragma unroll 4
        for (int te = 0; te < TE; ++te) {  // weight-gradient products
          float av[4], pv[4], bv[BWD_DWC], qv[BWD_DWC];
          load_row<4>(sA1 + te * LDT + 4 * jg, av);
          load_row<4>(sM + te * LDT + 4 * jg, pv);
#pragma unroll
          for (int c = 0; c < BWD_DWC; c += 4) {
            load_row<4>(sD2 + te * LDT + dw_col(kg, c), bv + c);
            load_row<4>(sG + te * LDT + dw_col(kg, c), qv + c);
          }
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < BWD_DWC; ++c) {
              tW2[r][c] += av[r] * bv[c];
              tWg1[r][c] += pv[r] * qv[c];
            }
        }
      }
      // dUd: this thread's row, over its edges in the tile (edges are
      // dst-sorted, so a row's edges are contiguous)
      if (drow < nr) {
        const int lo = max(sRP[drow], t0) - t0, hi = min(sRP[drow + 1], t0 + TE) - t0;
        for (int te = lo; te < hi; ++te) {
          float v[DF];
          load_row<DF>(sD1 + te * LDT + df0, v);
#pragma unroll
          for (int f = 0; f < DF; ++f) dacc[f] += v[f];
        }
      }
      __syncthreads();
    }

    // ---- the range's dUd and dx_dst rows, each stored once ----
    if (drow < nr) {
#pragma unroll
      for (int f = 0; f < DF; f += 2)
        *reinterpret_cast<float2*>(dud + (long)(r0 + drow) * H + df0 + f) =
            make_float2(dacc[f], dacc[f + 1]);
    }
    if (tid < nr * 3) {
      const int r = tid / 3, c = tid % 3;
      float acc = 0.f;
      for (int v = 0; v < BWD_WARPS; ++v) acc += sDXD[(v * BWD_ROWS + r) * 4 + c];
      dxd[3 * r0 + tid] = acc;
    }
  }

  {  // ---- this block's weight grads into dw, once ----
    if (tid < DWT) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < BWD_DWC; ++c) {
          atomicAdd(dw + (ROW_W2 + 4 * jg + r) * H + dw_col(kg, c), tW2[r][c]);
          atomicAdd(dw + (ROW_WG1 + 4 * jg + r) * H + dw_col(kg, c), tWg1[r][c]);
        }
    }
    // the per-feature rows, summed in shared memory (the loop ended on a
    // barrier after the last additions)
    for (int i = tid; i < (LW_W1E + fe) * H; i += BWD_THREADS) {
      const int row = i / H, j = i % H;
      const int to = row == LW_W1R ? ROW_W1R : row == LW_WG2 ? ROW_WG2
                     : row == LW_B2 ? ROW_B2 : row == LW_BG1 ? ROW_BG1
                     : ROW_W1E + row - LW_W1E;
      atomicAdd(dw + to * H + 2 * (j & 31) + (j >> 5), sGW[i]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 forward and backward on the tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragAT = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBT = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

constexpr int TC_TE = 64;               // edges per tile (the products' M dimension)
constexpr int TC_ROWS = 4;              // dst rows per block
constexpr int FWD_BLOCKS = 3;           // forward blocks per SM
constexpr int TC_EPW = TC_TE / WARPS;   // edges per warp in the elementwise passes
constexpr int LDB = H + 8;              // bf16 tile row stride (elements)
constexpr int LDF = H + 4;              // f32 scratch row stride (elements)
constexpr int TC_TILE = TC_TE * LDB;    // one bf16 [TC_TE][LDB] tile
// rows of the per-tile matrix PQ [PQ_ROWS][TC_TE]: one-hot dst rows 0..15,
// then the rounded radial and edge attributes, then zeros; PQ @ d_z1 gives
// the dst-role dUd rows and the dW1 radial / edge-attr rows.  The forward's
// P is the one-hot part, PQ's first PQ_RAD rows.
constexpr int PQ_ROWS = 32, PQ_RAD = 16, PQ_EA = 17;
static_assert(TC_TE == H, "the weight tiles and the edge tiles share one size");
static_assert(TC_EPW * 4 == 32, "fetch_rows: four lanes per Us row, eight rows per warp");
static_assert(TC_ROWS <= PQ_RAD, "one-hot rows of PQ");
static_assert(PQ_ROWS * H == WARPS * 256, "PQ @ d_z1: one 16x16 output tile per warp");
static_assert(PQ_RAD * H / 256 * 2 == WARPS && TC_TE % 32 == 0,
              "P @ m: four 16x16 output tiles, each over two halves of the edges");
static_assert(6 * TC_TILE * sizeof(bf16) >= H * LDF * sizeof(float),
              "the epilogue's [H][LDF] f32 sums fit over the edge tiles");
constexpr size_t TC_SMEM =
    9 * TC_TILE * sizeof(bf16)                    // W2, Wg1, Z1, A1, Z2, M, DZG, DZ2, Us
    + PQ_ROWS * LDB * sizeof(bf16)                // PQ
    + TC_TE * LDF * sizeof(float)                 // f32 scratch
    + LW_ROWS * H * sizeof(float)                 // per-feature weights
    + 2 * TC_ROWS * 4 * sizeof(float)             // x and dt rows of the block
    + 3 * TC_TE * 4 * sizeof(float)               // per edge: diff | radial, ea, d_diff
    + WARPS * TC_ROWS * 4 * sizeof(float)         // per-warp dx_dst sums
    + (2 * TC_TE + TC_ROWS + 1) * sizeof(int);    // per edge: src, row; rowptr
constexpr size_t FWD_SMEM =
    5 * TC_TILE * sizeof(bf16)                    // W2, Wg1, A1, M, Us
    + PQ_RAD * LDB * sizeof(bf16)                 // P: one-hot dst rows
    + TC_TE * LDF * sizeof(float)                 // f32 scratch
    + LW_ROWS * H * sizeof(float)                 // per-feature weights
    + TC_ROWS * 4 * sizeof(float)                 // x rows of the block
    + 2 * TC_TE * 4 * sizeof(float)               // per edge: diff | radial, ea
    + WARPS * TC_ROWS * 4 * sizeof(float)         // per-warp t_sum rows
    + (2 * TC_TE + TC_ROWS + 1) * sizeof(int);    // per edge: src, row; rowptr
static_assert(FWD_BLOCKS * (FWD_SMEM + 1024) <= 228 * 1024,
              "FWD_BLOCKS forward blocks fit in one SM's shared memory");

__device__ __forceinline__ void store_bf2(bf16* p, float2 v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v.x, v.y);
}

__device__ __forceinline__ float2 load_bf2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float2 load_f2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float2 sigmoid2(float2 z) {
  return make_float2(sigmoid(z.x), sigmoid(z.y));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// S = X @ W (TRANS false) or X @ W^T (TRANS true) for the edge tile X
// [TC_TE][LDB] and a weight W [H][LDB] ([in][out]); S f32 [TC_TE][LDF].  Warp
// w computes the 16 x 16 output tiles (w / 2, 2 (w % 2) + u), u = 0, 1, with
// one A fragment per k step for both.
template <bool TRANS>
__device__ __forceinline__ void tile_product(const bf16* X, const bf16* W, float* S,
                                             int warp) {
  const int fi = warp >> 1, fk = 2 * (warp & 1);
  FragC c[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) wmma::fill_fragment(c[u], 0.f);
#pragma unroll
  for (int kk = 0; kk < H / 16; ++kk) {
    FragA a;
    wmma::load_matrix_sync(a, X + 16 * fi * LDB + 16 * kk, LDB);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if constexpr (TRANS) {
        FragBT b;  // (W^T)[o][i] = W[i][o]: W read column-major
        wmma::load_matrix_sync(b, W + 16 * (fk + u) * LDB + 16 * kk, LDB);
        wmma::mma_sync(c[u], a, b, c[u]);
      } else {
        FragB b;
        wmma::load_matrix_sync(b, W + 16 * kk * LDB + 16 * (fk + u), LDB);
        wmma::mma_sync(c[u], a, b, c[u]);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < 2; ++u)
    wmma::store_matrix_sync(S + 16 * fi * LDF + 16 * (fk + u), c[u], LDF, wmma::mem_row_major);
}

// acc += X^T @ Y over the tile's TC_TE edges (X, Y [TC_TE][LDB]), for this
// warp's two 16 x 16 tiles (w / 2, 2 (w % 2) + u) of the [H][H] weight gradient.
__device__ __forceinline__ void grad_product(const bf16* X, const bf16* Y, FragC* acc,
                                             int warp) {
  const int fj = warp >> 1, fk = 2 * (warp & 1);
#pragma unroll
  for (int kk = 0; kk < TC_TE / 16; ++kk) {
    FragAT a;  // (X^T)[j][e] = X[e][j]: X read column-major
    wmma::load_matrix_sync(a, X + 16 * kk * LDB + 16 * fj, LDB);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      FragB b;
      wmma::load_matrix_sync(b, Y + 16 * kk * LDB + 16 * (fk + u), LDB);
      wmma::mma_sync(acc[u], a, b, acc[u]);
    }
  }
}

// acc += PQ[16 fi : 16 fi + 16][E] @ Y[E] for the output tile (fi, fk), E the
// tile's edges 16 kk0 .. 16 (kk0 + NK): per-edge rows of PQ [rows][LDB] (one-hot
// dst rows and the like) summed over an edge tile Y [TC_TE][LDB].
template <int NK>
__device__ __forceinline__ void rows_product(const bf16* PQ, const bf16* Y, FragC& acc,
                                             int fi, int fk, int kk0) {
#pragma unroll
  for (int i = 0; i < NK; ++i) {
    const int kk = kk0 + i;
    FragA a;
    wmma::load_matrix_sync(a, PQ + 16 * fi * LDB + 16 * kk, LDB);
    FragB b;
    wmma::load_matrix_sync(b, Y + 16 * kk * LDB + 16 * fk, LDB);
    wmma::mma_sync(acc, a, b, acc);
  }
}

// zg = t + bg1 (t: this lane's two columns of m Wg1), sg = sigmoid(zg) and
// g1 = zg sg, each rounded to bf16; returns the edge's gate g1 . wg2, summed
// over the warp.
__device__ __forceinline__ float gate_of(float2 t, float2 bg1, float2 wg2, float2& zg,
                                         float2& sg, float2& g1) {
  zg = rnd2(make_float2(t.x + bg1.x, t.y + bg1.y));
  sg = rnd2(sigmoid2(zg));
  g1 = rnd2(make_float2(zg.x * sg.x, zg.y * sg.y));
  return warp_sum(g1.x * wg2.x + g1.y * wg2.y);
}

// One block's walk over the edge tiles of its TC_ROWS dst rows r0 .. r0 + nr:
// the shared tiles and per-edge scalars both tensor-core kernels stage, and
// the stages they share.  Lanes 0..TC_EPW-1 of warp w own edge
// t0 + TC_EPW w + lane of each tile: its src id and edge attributes arrive a
// tile ahead; its x row and the Us row (by cp.async into sUS, rows of this
// warp only) are fetched halfway through the tile before.
struct TileWalk {
  bf16 *sW2, *sWg1;   // [H][LDB] weights
  bf16 *sA1, *sM;     // [TC_TE][LDB] a1 = silu(z1), m = silu(z2)
  bf16* sUS;          // [TC_TE][LDB] Us rows of the tile's src nodes
  bf16* sPQ;          // [PQ_RAD or PQ_ROWS][LDB]
  float* sS;          // [TC_TE][LDF] product results
  float* sLW;         // [LW_ROWS][H] per-feature weights
  float* sXD;         // [TC_ROWS][4] x of the block's rows
  float* sDIFF;       // [TC_TE][4] x_d - x_s, radial
  float* sEA;         // [TC_TE][4] edge attrs (rounded)
  int* sSRC;          // [TC_TE] src
  int* sROW;          // [TC_TE] dst row - r0; -1 past the last edge
  int* sRP;           // [TC_ROWS + 1] rowptr[r0 ..]
  const bf16 *ud, *us;
  const float *x, *ea;
  const int* src;
  int fe, r0, nr, e1, warp, lane, k0, te_own;
  int s_nx;                       // the lane's edge of the next tile: src,
  float ea_nx[FE_MAX], xs_nx[3];  // edge attrs, x of the src

  // The weights as bf16 (lossless: the pack holds bf16 values in this mode),
  // the per-feature weights, the block's x rows and rowptr, and the first
  // tile's src ids and edge attributes.
  __device__ __forceinline__ void setup(const float* wpack, const int* rowptr, int e0) {
    const int tid = threadIdx.x;
    for (int i = tid; i < H * H; i += THREADS) {
      const int j = i / H, k = i % H;
      sW2[j * LDB + k] = __float2bfloat16_rn(wpack[ROW_W2 * H + i]);
      sWg1[j * LDB + k] = __float2bfloat16_rn(wpack[ROW_WG1 * H + i]);
    }
    for (int i = tid; i < LW_ROWS * H; i += THREADS) {
      const int row = i / H, k = i % H;
      const int src_row = row == LW_W1R ? ROW_W1R : row == LW_WG2 ? ROW_WG2
                          : row == LW_B2 ? ROW_B2 : row == LW_BG1 ? ROW_BG1
                          : ROW_W1E + row - LW_W1E;
      sLW[i] = row < LW_W1E || row - LW_W1E < fe ? wpack[src_row * H + k] : 0.f;
    }
    if (tid < TC_ROWS * 4) {
      const int r = tid >> 2, c = tid & 3;
      sXD[tid] = r < nr && c < 3 ? x[3 * (r0 + r) + c] : 0.f;
    }
    if (tid <= nr) sRP[tid] = rowptr[r0 + tid];
    te_own = warp * TC_EPW + (lane & (TC_EPW - 1));
    s_nx = 0;
#pragma unroll
    for (int f = 0; f < FE_MAX; ++f) ea_nx[f] = 0.f;
#pragma unroll
    for (int c = 0; c < 3; ++c) xs_nx[c] = 0.f;
    if (lane < TC_EPW && e0 + te_own < e1) {
      s_nx = src[e0 + te_own];
#pragma unroll
      for (int f = 0; f < FE_MAX; ++f)
        if (f < fe) ea_nx[f] = ea[(long)(e0 + te_own) * fe + f];
    }
  }

  // the src rows of the tile at tn for this warp's edges: x into xs_nx, Us into sUS
  __device__ __forceinline__ void fetch_rows(int tn) {
    const int i = lane >> 2, q = lane & 3;  // edge of the warp, quarter of its Us row
    const int s = __shfl_sync(0xffffffffu, s_nx, i);
    if (tn + warp * TC_EPW + i < e1) {
      const bf16* g = us + (long)s * H + 16 * q;
      bf16* d = sUS + (warp * TC_EPW + i) * LDB + 16 * q;
      cp_async16(d, g);
      cp_async16(d + 8, g + 8);
    }
    cp_async_commit();
    if (lane < TC_EPW && tn + te_own < e1) {
#pragma unroll
      for (int c = 0; c < 3; ++c) xs_nx[c] = x[3 * s_nx + c];
    }
  }

  // per-edge scalars of the tile at t0: src, dst row, diff, radial, edge
  // attrs; then the next tile's src ids and edge attributes
  __device__ __forceinline__ void stage_scalars(int t0) {
    if (lane < TC_EPW) {
      const int te = te_own, e = t0 + te;
      if (e < e1) {
        int r = 0;
        while (r + 1 < nr && sRP[r + 1] <= e) ++r;
        float rad = 0.f;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float dc = sXD[4 * r + c] - xs_nx[c];
          sDIFF[4 * te + c] = dc;
          rad += dc * dc;
        }
        sDIFF[4 * te + 3] = rad;
#pragma unroll
        for (int f = 0; f < FE_MAX; ++f) sEA[4 * te + f] = rnd(ea_nx[f]);
        sSRC[te] = s_nx;
        sROW[te] = r;
        const int en = e + TC_TE;
        if (en < e1) {
          s_nx = src[en];
#pragma unroll
          for (int f = 0; f < FE_MAX; ++f)
            if (f < fe) ea_nx[f] = ea[(long)en * fe + f];
        }
      } else {
        sROW[te] = -1;
      }
    }
  }

  // this warp's columns of PQ, rows 0..ROWS-1: the one-hot dst rows, then
  // (ROWS > PQ_RAD) the rounded radial and edge attributes
  template <int ROWS>
  __device__ __forceinline__ void stage_pq() {
    for (int j = lane; j < TC_EPW * ROWS; j += 32) {
      const int te = warp * TC_EPW + j / ROWS, row = j % ROWS, r = sROW[te];
      float v;
      if (row < PQ_RAD) v = row == r ? 1.f : 0.f;
      else if (r < 0) v = 0.f;
      else if (row == PQ_RAD) v = sDIFF[4 * te + 3];
      else v = sEA[4 * te + row - PQ_EA];
      sPQ[row * LDB + te] = __float2bfloat16_rn(v);  // radial rounded here
    }
  }

  // z1 and a1 = silu(z1) of the warp's edges into sA1 (and z1 into sZ1 with
  // KEEP_Z1); zeros past the last edge
  template <bool KEEP_Z1>
  __device__ __forceinline__ void z1_pass(bf16* sZ1) {
    const float2 w1r = load_f2(sLW + LW_W1R * H + k0);
    float2 w1e[FE_MAX];
#pragma unroll
    for (int f = 0; f < FE_MAX; ++f) w1e[f] = load_f2(sLW + (LW_W1E + f) * H + k0);
#pragma unroll
    for (int i = 0; i < TC_EPW; ++i) {
      const int te = warp * TC_EPW + i, r = sROW[te];
      float2 z1 = make_float2(0.f, 0.f), a1 = z1;
      if (r >= 0) {
        const float2 u = load_bf2(sUS + te * LDB + k0);
        const float2 udr = load2(ud, (long)(r0 + r) * H + k0);
        const float radial = sDIFF[4 * te + 3];
        float2 eterm = make_float2(0.f, 0.f);
#pragma unroll
        for (int f = 0; f < FE_MAX; ++f) {
          eterm.x += sEA[4 * te + f] * w1e[f].x;
          eterm.y += sEA[4 * te + f] * w1e[f].y;
        }
        z1 = rnd2(make_float2((udr.x + u.x) + radial * w1r.x + eterm.x,
                              (udr.y + u.y) + radial * w1r.y + eterm.y));
        const float2 s1 = rnd2(sigmoid2(z1));
        a1 = rnd2(make_float2(z1.x * s1.x, z1.y * s1.y));
      }
      if constexpr (KEEP_Z1) store_bf2(sZ1 + te * LDB + k0, z1);
      store_bf2(sA1 + te * LDB + k0, a1);
    }
  }

  // from sS = a1 W2: z2 = sS + b2 and m = silu(z2) of the warp's edges into
  // sM (and z2 into sZ2 with KEEP_Z2); zeros past the last edge
  template <bool KEEP_Z2>
  __device__ __forceinline__ void z2_pass(bf16* sZ2) {
    const float2 b2 = load_f2(sLW + LW_B2 * H + k0);
#pragma unroll
    for (int i = 0; i < TC_EPW; ++i) {
      const int te = warp * TC_EPW + i;
      float2 z2 = make_float2(0.f, 0.f), m = z2;
      if (sROW[te] >= 0) {
        const float2 t = load_f2(sS + te * LDF + k0);
        z2 = rnd2(make_float2(t.x + b2.x, t.y + b2.y));
        const float2 s2 = rnd2(sigmoid2(z2));
        m = rnd2(make_float2(z2.x * s2.x, z2.y * s2.y));
      }
      if constexpr (KEEP_Z2) store_bf2(sZ2 + te * LDB + k0, z2);
      store_bf2(sM + te * LDB + k0, m);
    }
  }

  // One tile's chain up to m: scalars, P(Q) columns, z1 / a1, z2 = a1 W2 and
  // m, with the next tile's src rows fetched; on return sM holds m and every
  // warp may read it.
  template <int PQ_N, bool KEEP>
  __device__ __forceinline__ void chain_to_m(int t0, bf16* sZ1, bf16* sZ2) {
    stage_scalars(t0);
    __syncwarp();
    stage_pq<PQ_N>();
    cp_async_wait_all();
    __syncwarp();
    z1_pass<KEEP>(sZ1);
    __syncthreads();
    tile_product<false>(sA1, sW2, sS, warp);
    __syncthreads();
    z2_pass<KEEP>(sZ2);
    if (t0 + TC_TE < e1) fetch_rows(t0 + TC_TE);
    __syncthreads();
  }
};

// Point a TileWalk at its inputs and the block's rows.
__device__ __forceinline__ void walk_inputs(TileWalk& w, const bf16* ud, const bf16* us,
                                            const float* x, const int* src, const float* ea,
                                            int fe, int r0, int nr, int e1) {
  w.ud = ud;
  w.us = us;
  w.x = x;
  w.src = src;
  w.ea = ea;
  w.fe = fe;
  w.r0 = r0;
  w.nr = nr;
  w.e1 = e1;
  w.lane = threadIdx.x & 31;
  w.warp = threadIdx.x >> 5;
  w.k0 = 2 * w.lane;
}

__global__ void __launch_bounds__(THREADS, FWD_BLOCKS)
edge_fwd_tc_kernel(const bf16* __restrict__ ud, const bf16* __restrict__ us,
                   const float* __restrict__ x, const int* __restrict__ rowptr,
                   const int* __restrict__ src, const float* __restrict__ ea, int fe,
                   const float* __restrict__ wpack, float* __restrict__ msum,
                   float* __restrict__ tsum, int n) {
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * TC_ROWS;
  const int nr = min(n - r0, TC_ROWS);
  const int e0 = rowptr[r0], e1 = rowptr[r0 + nr];
  if (e0 >= e1) {  // block-uniform: no edges, so the block's sums are zeros
    for (int i = tid; i < nr * H; i += THREADS) msum[(long)r0 * H + i] = 0.f;
    if (tid < nr * 3) tsum[3 * r0 + tid] = 0.f;
    return;
  }
  TileWalk w;
  w.sW2 = reinterpret_cast<bf16*>(tc_smem);
  w.sWg1 = w.sW2 + TC_TILE;
  w.sA1 = w.sWg1 + TC_TILE;
  w.sM = w.sA1 + TC_TILE;
  w.sUS = w.sM + TC_TILE;
  w.sPQ = w.sUS + TC_TILE;   // P: [PQ_RAD][LDB] one-hot dst rows
  w.sS = reinterpret_cast<float*>(w.sPQ + PQ_RAD * LDB);
  w.sLW = w.sS + TC_TE * LDF;
  w.sXD = w.sLW + LW_ROWS * H;
  w.sDIFF = w.sXD + TC_ROWS * 4;
  w.sEA = w.sDIFF + TC_TE * 4;
  float* sTS = w.sEA + TC_TE * 4;   // [WARPS][TC_ROWS][4] per-warp t_sum rows
  w.sSRC = reinterpret_cast<int*>(sTS + WARPS * TC_ROWS * 4);
  w.sROW = w.sSRC + TC_TE;
  w.sRP = w.sROW + TC_TE;
  walk_inputs(w, ud, us, x, src, ea, fe, r0, nr, e1);
  const int warp = w.warp, lane = w.lane, k0 = w.k0;

  w.setup(wpack, rowptr, e0);
  for (int i = tid; i < WARPS * TC_ROWS * 4; i += THREADS) sTS[i] = 0.f;
  // m_sum rows: this warp's 16 x 16 tile (0, warp % 4) of P @ m, over edges
  // 32 (warp / 4) .. + 32 of each tile; the two halves are added at the end
  FragC gM;
  wmma::fill_fragment(gM, 0.f);
  w.fetch_rows(e0);
  __syncthreads();

  for (int t0 = e0; t0 < e1; t0 += TC_TE) {
    w.chain_to_m<PQ_RAD, false>(t0, nullptr, nullptr);

    // ---- zg = m Wg1 + bg1 and the gate; (x_d - x_s) gate into this warp's
    // t_sum rows; m_sum rows += P @ m ----
    tile_product<false>(w.sM, w.sWg1, w.sS, warp);
    __syncthreads();
    {
      const float2 bg1 = load_f2(w.sLW + LW_BG1 * H + k0);
      const float2 wg2 = load_f2(w.sLW + LW_WG2 * H + k0);
#pragma unroll
      for (int i = 0; i < TC_EPW; ++i) {
        const int te = warp * TC_EPW + i, r = w.sROW[te];
        if (r >= 0) {
          float2 zg, sg, g1;
          const float gate = gate_of(load_f2(w.sS + te * LDF + k0), bg1, wg2, zg, sg, g1);
          if (lane < 3) sTS[(warp * TC_ROWS + r) * 4 + lane] += w.sDIFF[4 * te + lane] * gate;
        }
      }
    }
    rows_product<TC_TE / 32>(w.sPQ, w.sM, gM, 0, warp & 3, (TC_TE / 32) * (warp >> 2));
    __syncthreads();
  }

  // ---- the block's m_sum and t_sum rows, each stored once ----
  float* sOut = w.sS;  // [2][PQ_RAD][LDF]: P @ m over the two halves of the edges
  wmma::store_matrix_sync(sOut + (warp >> 2) * PQ_RAD * LDF + 16 * (warp & 3), gM, LDF,
                          wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < nr * H; i += THREADS) {
    const int r = i / H, k = i % H;
    msum[(long)r0 * H + i] = sOut[r * LDF + k] + sOut[(PQ_RAD + r) * LDF + k];
  }
  if (tid < nr * 3) {
    const int r = tid / 3, c = tid % 3;
    float acc = 0.f;
    for (int v = 0; v < WARPS; ++v) acc += sTS[(v * TC_ROWS + r) * 4 + c];
    tsum[3 * r0 + tid] = acc;
  }
}

__global__ void __launch_bounds__(THREADS, 2)
edge_bwd_tc_kernel(const bf16* __restrict__ ud, const bf16* __restrict__ us,
                   const float* __restrict__ x, const int* __restrict__ rowptr,
                   const int* __restrict__ src, const float* __restrict__ ea, int fe,
                   const float* __restrict__ wpack, const float* __restrict__ dms,
                   const float* __restrict__ dts, float* __restrict__ dud,
                   float* __restrict__ dus, float* __restrict__ dxd,
                   float* __restrict__ dxs, float* __restrict__ dw, int n) {
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * TC_ROWS;
  const int nr = min(n - r0, TC_ROWS);
  const int e0 = rowptr[r0], e1 = rowptr[r0 + nr];
  if (e0 >= e1) return;  // block-uniform: rows without edges keep their zeros

  TileWalk w;
  w.sW2 = reinterpret_cast<bf16*>(tc_smem);
  w.sWg1 = w.sW2 + TC_TILE;
  bf16* sZ1 = w.sWg1 + TC_TILE;   // z1 per edge, then d_z1 (rounded)
  w.sA1 = sZ1 + TC_TILE;
  bf16* sZ2 = w.sA1 + TC_TILE;    // z2
  w.sM = sZ2 + TC_TILE;
  bf16* sDZG = w.sM + TC_TILE;    // d_zg (rounded)
  bf16* sDZ2 = sDZG + TC_TILE;    // d_z2 (rounded)
  w.sUS = sDZ2 + TC_TILE;
  w.sPQ = w.sUS + TC_TILE;        // [PQ_ROWS][LDB]
  w.sS = reinterpret_cast<float*>(w.sPQ + PQ_ROWS * LDB);
  w.sLW = w.sS + TC_TE * LDF;
  w.sXD = w.sLW + LW_ROWS * H;
  float* sDT = w.sXD + TC_ROWS * 4;       // [TC_ROWS][4] d t_sum
  w.sDIFF = sDT + TC_ROWS * 4;
  w.sEA = w.sDIFF + TC_TE * 4;
  float* sDD = w.sEA + TC_TE * 4;         // [TC_TE][4] d(x_d - x_s)
  float* sDXD = sDD + TC_TE * 4;          // [WARPS][TC_ROWS][4] dx_dst sums
  w.sSRC = reinterpret_cast<int*>(sDXD + WARPS * TC_ROWS * 4);
  w.sROW = w.sSRC + TC_TE;
  w.sRP = w.sROW + TC_TE;
  walk_inputs(w, ud, us, x, src, ea, fe, r0, nr, e1);
  const int warp = w.warp, lane = w.lane, k0 = w.k0;

  w.setup(wpack, rowptr, e0);
  for (int i = tid; i < PQ_ROWS * LDB; i += THREADS) w.sPQ[i] = __float2bfloat16_rn(0.f);
  if (tid < TC_ROWS * 4) {
    const int r = tid >> 2, c = tid & 3;
    sDT[tid] = r < nr && c < 3 ? dts[3 * (r0 + r) + c] : 0.f;
  }
  for (int i = tid; i < WARPS * TC_ROWS * 4; i += THREADS) sDXD[i] = 0.f;

  float2 g_b2 = make_float2(0.f, 0.f), g_bg1 = g_b2, g_wg2 = g_b2;
  FragC gW2[2], gWg1[2], gPQ;  // dW2, dWg1, PQ @ d_z1 tiles of this warp, across tiles
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    wmma::fill_fragment(gW2[u], 0.f);
    wmma::fill_fragment(gWg1[u], 0.f);
  }
  wmma::fill_fragment(gPQ, 0.f);
  w.fetch_rows(e0);
  __syncthreads();

  for (int t0 = e0; t0 < e1; t0 += TC_TE) {
    w.chain_to_m<PQ_EA + 3, true>(t0, sZ1, sZ2);

    // ---- zg = m Wg1 + bg1, gate, and d_zg ----
    tile_product<false>(w.sM, w.sWg1, w.sS, warp);
    __syncthreads();
    {
      const float2 bg1 = load_f2(w.sLW + LW_BG1 * H + k0);
      const float2 wg2 = load_f2(w.sLW + LW_WG2 * H + k0);
#pragma unroll
      for (int i = 0; i < TC_EPW; ++i) {
        const int te = warp * TC_EPW + i, r = w.sROW[te];
        float2 dzgc = make_float2(0.f, 0.f);
        if (r >= 0) {
          float2 zg, sg, g1;
          const float gate = gate_of(load_f2(w.sS + te * LDF + k0), bg1, wg2, zg, sg, g1);
          const float* dt = sDT + 4 * r;
          const float* df = w.sDIFF + 4 * te;
          const float d_gate = df[0] * dt[0] + df[1] * dt[1] + df[2] * dt[2];
          const float2 dzg = make_float2(d_gate * wg2.x * dsilu(zg.x, sg.x),
                                         d_gate * wg2.y * dsilu(zg.y, sg.y));
          dzgc = rnd2(dzg);
          if (lane < 3) sDD[4 * te + lane] = dt[lane] * gate;
          g_bg1.x += dzg.x;
          g_bg1.y += dzg.y;
          g_wg2.x += g1.x * d_gate;
          g_wg2.y += g1.y * d_gate;
        }
        store_bf2(sDZG + te * LDB + k0, dzgc);
      }
    }
    __syncthreads();

    // ---- d_z2 = (dm + d_zg Wg1^T) dsilu(z2) ----
    tile_product<true>(sDZG, w.sWg1, w.sS, warp);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < TC_EPW; ++i) {
      const int te = warp * TC_EPW + i, r = w.sROW[te];
      float2 dz2c = make_float2(0.f, 0.f);
      if (r >= 0) {
        const float2 t = load_f2(w.sS + te * LDF + k0);
        const float2 dm = load_f2(dms + (long)(r0 + r) * H + k0);
        const float2 z2 = load_bf2(sZ2 + te * LDB + k0);
        const float2 s2 = rnd2(sigmoid2(z2));
        const float2 dz2 = make_float2((dm.x + t.x) * dsilu(z2.x, s2.x),
                                       (dm.y + t.y) * dsilu(z2.y, s2.y));
        dz2c = rnd2(dz2);
        g_b2.x += dz2.x;
        g_b2.y += dz2.y;
      }
      store_bf2(sDZ2 + te * LDB + k0, dz2c);
    }
    __syncthreads();

    // ---- d_a1 = d_z2 W2^T, d_z1 ----
    tile_product<true>(sDZ2, w.sW2, w.sS, warp);
    __syncthreads();
    {
      const float2 w1r = load_f2(w.sLW + LW_W1R * H + k0);
#pragma unroll
      for (int i = 0; i < TC_EPW; ++i) {
        const int te = warp * TC_EPW + i, r = w.sROW[te];
        float2 dz1c = make_float2(0.f, 0.f);
        if (r >= 0) {
          const float2 t = load_f2(w.sS + te * LDF + k0);
          const float2 z1 = load_bf2(sZ1 + te * LDB + k0);
          const float2 s1 = rnd2(sigmoid2(z1));
          const float2 dz1 = make_float2(t.x * dsilu(z1.x, s1.x), t.y * dsilu(z1.y, s1.y));
          dz1c = rnd2(dz1);
          const float d_radial = warp_sum(dz1.x * w1r.x + dz1.y * w1r.y);
          const int s = w.sSRC[te];
          // src role: atomics; dst role: this warp's own per-row sums
          atomicAdd(reinterpret_cast<float2*>(dus + (long)s * H + k0), dz1c);
          if (lane < 3) {
            const float dd = sDD[4 * te + lane] + 2.f * w.sDIFF[4 * te + lane] * d_radial;
            atomicAdd(dxs + 3 * s + lane, dd);
            sDXD[(warp * TC_ROWS + r) * 4 + lane] += dd;
          }
        }
        store_bf2(sZ1 + te * LDB + k0, dz1c);  // d_z1 over z1, read by this lane only
      }
    }
    __syncthreads();

    // ---- over the whole tile: dW2 += a1^T d_z2, dWg1 += m^T d_zg, and the
    // dUd rows and dW1 radial / edge-attr rows += PQ @ d_z1 ----
    grad_product(w.sA1, sDZ2, gW2, warp);
    grad_product(w.sM, sDZG, gWg1, warp);
    rows_product<TC_TE / 16>(w.sPQ, sZ1, gPQ, warp >> 2, warp & 3, 0);
    __syncthreads();
  }

  // ---- the block's sums: dUd and dx_dst rows stored once; weight grads
  // added to dw; all through sOut, over the edge tiles ----
  float* sOut = reinterpret_cast<float*>(sZ1);  // [H][LDF]
  wmma::store_matrix_sync(sOut + 16 * (warp >> 2) * LDF + 16 * (warp & 3), gPQ, LDF,
                          wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < nr * H; i += THREADS)
    dud[(long)r0 * H + i] = sOut[(i / H) * LDF + i % H];
  if (tid < nr * 3) {
    const int r = tid / 3, c = tid % 3;
    float acc = 0.f;
    for (int v = 0; v < WARPS; ++v) acc += sDXD[(v * TC_ROWS + r) * 4 + c];
    dxd[3 * r0 + tid] = acc;
  }
  if (tid < H) {
    atomicAdd(dw + ROW_W1R * H + tid, sOut[PQ_RAD * LDF + tid]);
    for (int f = 0; f < fe; ++f)
      atomicAdd(dw + (ROW_W1E + f) * H + tid, sOut[(PQ_EA + f) * LDF + tid]);
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int f = 2 * warp + u, fj = f >> 2, fk = f & 3;
      wmma::store_matrix_sync(sOut + 16 * fj * LDF + 16 * fk, m ? gWg1[u] : gW2[u], LDF,
                              wmma::mem_row_major);
    }
    __syncthreads();
    float* out = dw + (m ? ROW_WG1 : ROW_W2) * H;
    for (int i = tid; i < H * H; i += THREADS) atomicAdd(out + i, sOut[(i / H) * LDF + i % H]);
    __syncthreads();
  }
  atomicAdd(reinterpret_cast<float2*>(dw + ROW_B2 * H + k0), g_b2);
  atomicAdd(reinterpret_cast<float2*>(dw + ROW_BG1 * H + k0), g_bg1);
  atomicAdd(reinterpret_cast<float2*>(dw + ROW_WG2 * H + k0), g_wg2);
}

}  // namespace

// C interface, loaded with ctypes.  Each entry point launches on the given
// stream, does not synchronise, and returns cudaGetLastError() (0 = success).

extern "C" int fastegnn_edge_fwd(int bf16, const void* ud, const void* us,
                                 const float* x, const int* rowptr, const int* src,
                                 const float* ea, int fe, const float* wpack,
                                 float* msum, float* tsum, int n, void* stream) {
  if (fe < 0 || fe > FE_MAX || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {  // tensor cores
    cudaError_t err = cudaFuncSetAttribute(
        edge_fwd_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)FWD_SMEM);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(edge_fwd_tc_kernel,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    edge_fwd_tc_kernel<<<dim3((n + TC_ROWS - 1) / TC_ROWS), THREADS, FWD_SMEM, st>>>(
        static_cast<const __nv_bfloat16*>(ud), static_cast<const __nv_bfloat16*>(us), x,
        rowptr, src, ea, fe, wpack, msum, tsum, n);
  } else {
    edge_fwd_kernel<<<dim3((n + WARPS - 1) / WARPS), THREADS, 0, st>>>(
        static_cast<const float*>(ud), static_cast<const float*>(us), x, rowptr, src, ea,
        fe, wpack, msum, tsum, n);
  }
  return (int)cudaGetLastError();
}

extern "C" int fastegnn_edge_bwd(int bf16, const void* ud, const void* us,
                                 const float* x, const int* rowptr, const int* src,
                                 const int* dst, const float* ea, int fe,
                                 const float* wpack, const float* dms, const float* dts,
                                 float* dud, float* dus, float* dxd, float* dxs, float* dw,
                                 int n, void* stream) {
  if (fe < 0 || fe > FE_MAX || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16) {  // tensor cores; dst rows come from rowptr
    err = cudaFuncSetAttribute(edge_bwd_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)TC_SMEM);
    if (err != cudaSuccess) return (int)err;
    edge_bwd_tc_kernel<<<dim3((n + TC_ROWS - 1) / TC_ROWS), THREADS, TC_SMEM, st>>>(
        static_cast<const __nv_bfloat16*>(ud), static_cast<const __nv_bfloat16*>(us), x,
        rowptr, src, ea, fe, wpack, dms, dts, dud, dus, dxd, dxs, dw, n);
  } else {
    // BWD_BLOCKS blocks per SM walk the ranges of BWD_ROWS rows
    int blocks = (n + BWD_ROWS - 1) / BWD_ROWS, dev = 0, sms = 0;
    err = cudaFuncSetAttribute(edge_bwd_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)BWD_SMEM);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(edge_bwd_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess && BWD_PERSIST) err = cudaGetDevice(&dev);
    if (err == cudaSuccess && BWD_PERSIST)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if (BWD_PERSIST) {
      blocks = blocks < BWD_BLOCKS * sms ? blocks : BWD_BLOCKS * sms;
      void* next = nullptr;
      err = cudaGetSymbolAddress(&next, bwd_next_range);
      if (err == cudaSuccess) err = cudaMemsetAsync(next, 0, sizeof(int), st);
      if (err != cudaSuccess) return (int)err;
    }
    edge_bwd_kernel<<<dim3(blocks), BWD_THREADS, BWD_SMEM, st>>>(
        static_cast<const float*>(ud), static_cast<const float*>(us), x, rowptr, src, dst,
        ea, fe, wpack, dms, dts, dud, dus, dxd, dxs, dw, n);
  }
  return (int)cudaGetLastError();
}
