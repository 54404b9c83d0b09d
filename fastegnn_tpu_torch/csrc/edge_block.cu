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
// This first version runs the products as FP32 FMAs on the CUDA cores, one
// edge per warp at a time, and measures 100x and more above that bound
// (PERF.md); moving them to mma / wgmma over tiles of edges is later work.
// Its design keeps every per-edge intermediate out of device memory:
//
// - forward: one warp per dst row walks rowptr[row]..rowptr[row+1]; each lane
//   owns two of the 64 features; W2 and Wg1 sit in shared memory; the row's
//   sums stay in registers and are written once (no atomics, deterministic).
// - backward: one block per range of BWD_ROWS dst rows, in tiles of TE edges
//   (TE / WARPS per warp).  Phase 1 recomputes the chain and its backward
//   per edge and stages a1, m, d_zg, d_z2, d_z1 in shared memory; src-role
//   sums (dUs, dx_src) go out with f32 atomicAdd.  Phase 2 accumulates the
//   dW2 / dWg1 outer products into 4x4 register tiles per thread and the
//   dst-role sums (dUd, dx_dst) per row, written once by the block that owns
//   the row.  Each block adds its weight-gradient tiles to dw with one atomic
//   per entry.  The atomics make dUs, dx and dw vary in the last bits from
//   run to run; dUd and the forward are deterministic.
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

namespace {

constexpr int H = 64;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int FE_MAX = 3;
constexpr int ROW_W2 = 0, ROW_WG1 = 64, ROW_W1E = 128, ROW_W1R = 131,
              ROW_WG2 = 132, ROW_B2 = 133, ROW_BG1 = 134;
constexpr int TE = 32;         // edges per backward tile
constexpr int BWD_ROWS = 16;   // dst rows per backward block
constexpr size_t BWD_SMEM =
    (4 * H * H + 5 * TE * H + 4 * TE) * sizeof(float) + TE * sizeof(int);

template <bool BF>
__device__ __forceinline__ float rnd(float v) {
  if constexpr (BF) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return v;
  }
}

template <bool BF>
__device__ __forceinline__ float2 rnd2(float2 v) {
  return make_float2(rnd<BF>(v.x), rnd<BF>(v.y));
}

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

// Recompute the chain of edge (d, s).  bufA / bufM are this warp's 64-float
// shared buffers for a1 and m (the operands of the two chain products); the
// caller synchronises the warp before a buffer is reused.
template <typename T, bool BF>
__device__ __forceinline__ void chain_fwd(Chain& c, float2 ud, const T* __restrict__ us,
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
    c.ea[f] = f < fe ? rnd<BF>(ea_row[f]) : 0.f;
    eterm.x += c.ea[f] * w.w1e[f].x;
    eterm.y += c.ea[f] * w.w1e[f].y;
  }
  c.z1 = rnd2<BF>(make_float2((ud.x + u.x) + c.radial * w.w1r.x + eterm.x,
                              (ud.y + u.y) + c.radial * w.w1r.y + eterm.y));
  c.s1 = rnd2<BF>(make_float2(sigmoid(c.z1.x), sigmoid(c.z1.y)));
  c.a1 = rnd2<BF>(make_float2(c.z1.x * c.s1.x, c.z1.y * c.s1.y));
  bufA[k0] = c.a1.x;
  bufA[k0 + 1] = c.a1.y;
  __syncwarp();
  float2 t = matvec(bufA, sW2, k0);
  c.z2 = rnd2<BF>(make_float2(t.x + w.b2.x, t.y + w.b2.y));
  c.s2 = rnd2<BF>(make_float2(sigmoid(c.z2.x), sigmoid(c.z2.y)));
  c.m = rnd2<BF>(make_float2(c.z2.x * c.s2.x, c.z2.y * c.s2.y));
  bufM[k0] = c.m.x;
  bufM[k0 + 1] = c.m.y;
  __syncwarp();
  t = matvec(bufM, sWg1, k0);
  c.zg = rnd2<BF>(make_float2(t.x + w.bg1.x, t.y + w.bg1.y));
  c.sg = rnd2<BF>(make_float2(sigmoid(c.zg.x), sigmoid(c.zg.y)));
  c.g1 = rnd2<BF>(make_float2(c.zg.x * c.sg.x, c.zg.y * c.sg.y));
  c.gate = warp_sum(c.g1.x * w.wg2.x + c.g1.y * w.wg2.y);
}

template <typename T, bool BF>
__global__ void __launch_bounds__(THREADS)
edge_fwd_kernel(const T* __restrict__ ud, const T* __restrict__ us,
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
      chain_fwd<T, BF>(c, udr, us, src[e], x, xd, ea + (long)e * fe, fe, w, sW2, sWg1,
                       bufA, bufM, k0);
      accm.x += c.m.x;
      accm.y += c.m.y;
#pragma unroll
      for (int k = 0; k < 3; ++k) acct[k] += c.diff[k] * c.gate;
    }
    *reinterpret_cast<float2*>(msum + (long)row * H + k0) = accm;
    if (lane < 3) tsum[3 * row + lane] = pick3(acct, lane);
  }
}

template <typename T, bool BF>
__global__ void __launch_bounds__(THREADS)
edge_bwd_kernel(const T* __restrict__ ud, const T* __restrict__ us,
                const float* __restrict__ x, const int* __restrict__ rowptr,
                const int* __restrict__ src, const int* __restrict__ dst,
                const float* __restrict__ ea, int fe, const float* __restrict__ wpack,
                const float* __restrict__ dms, const float* __restrict__ dts,
                float* __restrict__ dud, float* __restrict__ dus,
                float* __restrict__ dxd, float* __restrict__ dxs,
                float* __restrict__ dw, int n) {
  extern __shared__ __align__(16) float smem[];
  float* sW2 = smem;
  float* sW2T = sW2 + H * H;
  float* sWg1 = sW2T + H * H;
  float* sWg1T = sWg1 + H * H;
  float* A1 = sWg1T + H * H;      // [TE][H] a1 per staged edge
  float* M = A1 + TE * H;         // [TE][H] m
  float* DZG = M + TE * H;        // [TE][H] d_zg (rounded)
  float* DZ2 = DZG + TE * H;      // [TE][H] d_z2 (rounded)
  float* DZ1 = DZ2 + TE * H;      // [TE][H] d_z1 (rounded)
  float* DDIFF = DZ1 + TE * H;    // [TE][4] d(x_d - x_s)
  int* DSTI = reinterpret_cast<int*>(DDIFF + 4 * TE);  // [TE] dst row, -1 = empty

  const int tid = threadIdx.x;
  for (int i = tid; i < H * H; i += THREADS) {
    const int j = i / H, k = i % H;
    const float a = wpack[ROW_W2 * H + i], b = wpack[ROW_WG1 * H + i];
    sW2[i] = a;
    sW2T[k * H + j] = a;
    sWg1[i] = b;
    sWg1T[k * H + j] = b;
  }
  __syncthreads();

  const int r0 = blockIdx.x * BWD_ROWS;
  const int r1 = min(n, r0 + BWD_ROWS);
  const int e0 = rowptr[r0], e1 = rowptr[r1];
  if (e0 >= e1) return;  // block-uniform: rows without edges keep their zeros

  const int lane = tid & 31, warp = tid >> 5, k0 = 2 * lane;
  const LaneW w = load_lane_weights(wpack, k0, fe);
  float2 g_b2 = make_float2(0.f, 0.f), g_bg1 = g_b2, g_wg2 = g_b2, g_w1r = g_b2;
  float2 g_w1e[FE_MAX];
#pragma unroll
  for (int f = 0; f < FE_MAX; ++f) g_w1e[f] = make_float2(0.f, 0.f);

  const int kg = tid & 15, jg = tid >> 4;  // this thread's 4x4 weight-grad tile
  float tW2[4][4], tWg1[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) tW2[a][b] = tWg1[a][b] = 0.f;

  int cur_row = -1;  // dst-role running sum (threads 0..H+2)
  float cur_acc = 0.f;

  for (int t0 = e0; t0 < e1; t0 += TE) {
    // ---- phase 1: chain forward + backward, one edge at a time per warp ----
    for (int i = 0; i < TE / WARPS; ++i) {
      const int te = warp * (TE / WARPS) + i;
      const int e = t0 + te;
      float* a1r = A1 + te * H;
      float* mr = M + te * H;
      float* dzgr = DZG + te * H;
      float* dz2r = DZ2 + te * H;
      float* dz1r = DZ1 + te * H;
      if (e >= e1) {  // warp-uniform tail of the last tile
        a1r[k0] = a1r[k0 + 1] = mr[k0] = mr[k0 + 1] = 0.f;
        dzgr[k0] = dzgr[k0 + 1] = dz2r[k0] = dz2r[k0 + 1] = 0.f;
        dz1r[k0] = dz1r[k0 + 1] = 0.f;
        if (lane == 0) DSTI[te] = -1;
        if (lane < 4) DDIFF[4 * te + lane] = 0.f;
        continue;
      }
      const int d = dst[e], s = src[e];
      const float2 udr = load2(ud, (long)d * H + k0);
      const float xd[3] = {x[3 * d], x[3 * d + 1], x[3 * d + 2]};
      Chain c;
      chain_fwd<T, BF>(c, udr, us, s, x, xd, ea + (long)e * fe, fe, w, sW2, sWg1, a1r,
                       mr, k0);

      const float dt[3] = {dts[3 * d], dts[3 * d + 1], dts[3 * d + 2]};
      const float2 dm = load2(dms, (long)d * H + k0);
      const float d_gate = c.diff[0] * dt[0] + c.diff[1] * dt[1] + c.diff[2] * dt[2];
      float d_diff[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) d_diff[k] = dt[k] * c.gate;
      const float2 dzg = make_float2(d_gate * w.wg2.x * dsilu(c.zg.x, c.sg.x),
                                     d_gate * w.wg2.y * dsilu(c.zg.y, c.sg.y));
      const float2 dzgc = rnd2<BF>(dzg);
      dzgr[k0] = dzgc.x;
      dzgr[k0 + 1] = dzgc.y;
      __syncwarp();
      float2 t = matvec(dzgr, sWg1T, k0);  // d_m = dm + Wg1 d_zg
      const float2 dz2 = make_float2((dm.x + t.x) * dsilu(c.z2.x, c.s2.x),
                                     (dm.y + t.y) * dsilu(c.z2.y, c.s2.y));
      const float2 dz2c = rnd2<BF>(dz2);
      dz2r[k0] = dz2c.x;
      dz2r[k0 + 1] = dz2c.y;
      __syncwarp();
      t = matvec(dz2r, sW2T, k0);  // d_a1 = W2 d_z2
      const float2 dz1 = make_float2(t.x * dsilu(c.z1.x, c.s1.x), t.y * dsilu(c.z1.y, c.s1.y));
      const float2 dz1c = rnd2<BF>(dz1);
      const float d_radial = warp_sum(dz1.x * w.w1r.x + dz1.y * w.w1r.y);
#pragma unroll
      for (int k = 0; k < 3; ++k) d_diff[k] += 2.f * c.diff[k] * d_radial;

      // src role: atomics
      atomicAdd(dus + (long)s * H + k0, dz1c.x);
      atomicAdd(dus + (long)s * H + k0 + 1, dz1c.y);
      if (lane < 3) atomicAdd(dxs + 3 * s + lane, pick3(d_diff, lane));
      // dst role: staged for the per-row sums of phase 2
      dz1r[k0] = dz1c.x;
      dz1r[k0 + 1] = dz1c.y;
      if (lane == 0) DSTI[te] = d;
      if (lane < 3) DDIFF[4 * te + lane] = pick3(d_diff, lane);
      // per-feature weight grads
      g_b2.x += dz2.x;  g_b2.y += dz2.y;
      g_bg1.x += dzg.x; g_bg1.y += dzg.y;
      g_wg2.x += c.g1.x * d_gate;
      g_wg2.y += c.g1.y * d_gate;
      const float rr = rnd<BF>(c.radial);
      g_w1r.x += rr * dz1c.x;
      g_w1r.y += rr * dz1c.y;
#pragma unroll
      for (int f = 0; f < FE_MAX; ++f) {
        g_w1e[f].x += c.ea[f] * dz1c.x;
        g_w1e[f].y += c.ea[f] * dz1c.y;
      }
      __syncwarp();
    }
    __syncthreads();

    // ---- phase 2: dW2 += a1^T d_z2, dWg1 += m^T d_zg over the tile ----
#pragma unroll 4
    for (int te = 0; te < TE; ++te) {
      const float4 a = *reinterpret_cast<const float4*>(A1 + te * H + 4 * jg);
      const float4 b = *reinterpret_cast<const float4*>(DZ2 + te * H + 4 * kg);
      const float4 p = *reinterpret_cast<const float4*>(M + te * H + 4 * jg);
      const float4 q = *reinterpret_cast<const float4*>(DZG + te * H + 4 * kg);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
      const float pv[4] = {p.x, p.y, p.z, p.w}, qv[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          tW2[r][cc] += av[r] * bv[cc];
          tWg1[r][cc] += pv[r] * qv[cc];
        }
    }
    // dst-role sums: edges are dst-sorted, so each row's edges are contiguous
    // and lie in this block; a row's sum is stored once, when the row ends
    if (tid < H + 3) {
      for (int te = 0; te < TE; ++te) {
        const int d = DSTI[te];
        if (d < 0) break;
        if (d != cur_row) {
          if (cur_row >= 0) {
            if (tid < H) dud[(long)cur_row * H + tid] = cur_acc;
            else dxd[3 * cur_row + tid - H] = cur_acc;
          }
          cur_row = d;
          cur_acc = 0.f;
        }
        cur_acc += tid < H ? DZ1[te * H + tid] : DDIFF[4 * te + tid - H];
      }
    }
    __syncthreads();
  }
  if (tid < H + 3 && cur_row >= 0) {
    if (tid < H) dud[(long)cur_row * H + tid] = cur_acc;
    else dxd[3 * cur_row + tid - H] = cur_acc;
  }

  // ---- this block's weight grads into dw ----
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      atomicAdd(dw + (ROW_W2 + 4 * jg + r) * H + 4 * kg + cc, tW2[r][cc]);
      atomicAdd(dw + (ROW_WG1 + 4 * jg + r) * H + 4 * kg + cc, tWg1[r][cc]);
    }
  atomicAdd(dw + ROW_B2 * H + k0, g_b2.x);
  atomicAdd(dw + ROW_B2 * H + k0 + 1, g_b2.y);
  atomicAdd(dw + ROW_BG1 * H + k0, g_bg1.x);
  atomicAdd(dw + ROW_BG1 * H + k0 + 1, g_bg1.y);
  atomicAdd(dw + ROW_WG2 * H + k0, g_wg2.x);
  atomicAdd(dw + ROW_WG2 * H + k0 + 1, g_wg2.y);
  atomicAdd(dw + ROW_W1R * H + k0, g_w1r.x);
  atomicAdd(dw + ROW_W1R * H + k0 + 1, g_w1r.y);
  for (int f = 0; f < fe; ++f) {
    atomicAdd(dw + (ROW_W1E + f) * H + k0, g_w1e[f].x);
    atomicAdd(dw + (ROW_W1E + f) * H + k0 + 1, g_w1e[f].y);
  }
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
  const dim3 grid((n + WARPS - 1) / WARPS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    edge_fwd_kernel<__nv_bfloat16, true><<<grid, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(ud), static_cast<const __nv_bfloat16*>(us), x,
        rowptr, src, ea, fe, wpack, msum, tsum, n);
  } else {
    edge_fwd_kernel<float, false><<<grid, THREADS, 0, st>>>(
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
  const dim3 grid((n + BWD_ROWS - 1) / BWD_ROWS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16) {
    err = cudaFuncSetAttribute(edge_bwd_kernel<__nv_bfloat16, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)BWD_SMEM);
    if (err != cudaSuccess) return (int)err;
    edge_bwd_kernel<__nv_bfloat16, true><<<grid, THREADS, BWD_SMEM, st>>>(
        static_cast<const __nv_bfloat16*>(ud), static_cast<const __nv_bfloat16*>(us), x,
        rowptr, src, dst, ea, fe, wpack, dms, dts, dud, dus, dxd, dxs, dw, n);
  } else {
    err = cudaFuncSetAttribute(edge_bwd_kernel<float, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)BWD_SMEM);
    if (err != cudaSuccess) return (int)err;
    edge_bwd_kernel<float, false><<<grid, THREADS, BWD_SMEM, st>>>(
        static_cast<const float*>(ud), static_cast<const float*>(us), x, rowptr, src, dst,
        ea, fe, wpack, dms, dts, dud, dus, dxd, dxs, dw, n);
  }
  return (int)cudaGetLastError();
}
