// Fused masked L-TAE eval forward for NVIDIA Hopper (sm_90a), nq <= 8
// learnable queries per head.
//
// Replaces crop2seg_tpu/ops/ltae_pallas.py::ltae_fused_forward (its Pallas
// body `_kernel`, pallas_call at ltae_pallas.py:421). Wrapper, offline folds
// and the plain PyTorch version: crop2seg_tpu_torch/ops/ltae_fused.py.
//
// Per pixel row n of batch item b, over T <= 64 steps and C <= 128 channels:
//   x      = [max(x * tsc + tsh, 0)]            deferred conv-tail affine
//   xn     = GroupNorm_G(x) over (T, C/G)       two-pass fp32, no affine
// then for each query q < nq (one column of U per (head, query), g*nq + q):
//   scores = xn @ Ws[:, g*nq+q] + pes[b]        Ws = (s*W_in) U, pes holds
//                                               (b_in + pe) U + cs, -1e6 at pads
//   a      = softmax_T(scores)                  (G, T)
//   P      = a @ xn                             (G, C): pooled in C-space
//   o[d]   = P[g(d)] . W_in[:, d] + b_in[d] + sum_t a[g(d), t] pe[t, d]
//   m_q    = relu(o @ W_m + b_m)                eval BatchNorm folded
// and last
//   out    = GroupNorm_G(m) * osc + obi         group g pools its d_out/G
//                                               channels over all nq queries
// The TPU kernel widens the weighted sum to all queries at once (a 0/1
// broadcast matmul and a block-diagonal W_m); here a row loops over the
// queries. Pooling in C-space is exact algebra (sum_t a = 1), so the
// projected sequence h (T x D per row, 4x the input) never exists, in
// registers or in memory: the kernel reads x once and writes out (and attn
// on request).
//
// Bound on an H100 SXM (3.35 TB/s; 67 TFLOP/s fp32 on the CUDA cores) at the
// TimeUNet main-path shape B=10, T=61, N=16384, C=64, D=256, G=16, d_out=64:
//   bytes:      x 1.28 GB in bf16 (2.56 GB fp32) read once, out 21 MB (42 MB)
//               written -> 0.39 ms (bf16), 0.78 ms (fp32).
//   operations: ~0.39 MFLOP per row with the tail affine, ~63 GFLOP per
//               launch. In fp32 on the CUDA cores that is >= 0.95 ms, so
//               both kernels below are bound by their operations, not by the
//               bf16 byte bound; reaching that needs the products (scores,
//               P, the MLP) on the tensor cores (mma), which is later work.
// chip_smoke.py measures each launch beside this bound.
//
// Three kernels share the arithmetic above, every product and statistic in
// fp32 (bf16 only in device memory):
//
// ltae_fused_group_kernel<Tin>: C <= 64 and one query (TimeUNet's whole-
// tile path, ten launches a tile). What held the one-warp-per-row kernel
// below at 10.7 / 11.6 ms (bf16 / fp32) there was latency with nothing to
// hide it: one 256-thread block of 8 rows per SM (203 KiB of shared memory),
// the block's x loaded before any compute and no compute while it loaded,
// every step a dependent chain of shared-memory or L2 loads (clock64 stamps
// per step, PERF.md: no step above 24 %). This kernel:
// - persistent 512-thread blocks, S = SMs / B per batch item
//   (ops/ltae_fused.py::launch_shape), each walking its contiguous range of
//   rows (ltae_pool.py::row_ranges) in groups of R = 8 rows, two warps a row;
// - Ws, pes[b], b_in, b_m and the out affine in shared memory once per
//   block; the next group's x (16-byte cp.async) comes in while the group's
//   projection, MLP and out GroupNorm run, into the x tile, free since P;
//   in tail mode tsc[b], tsh[b] come in the same way after the MLP;
// - GroupNorm: thread (row, channel quad, quarter of T) holds its 64 values
//   in registers; scores: warp (row, half of the heads), lanes t and t + 32,
//   so the softmax stays in the warp; P: 4 x 4 (head, channel) register
//   tiles; projection + PE term: thread (d, half of the sum) over the
//   group's 8 rows; MLP: thread (j, eighth of D) over the 8 rows, the
//   eighths added in order. So each W_in, pe[b] and W_m element read from
//   L2 serves 8 rows from a register, and no weight is read once per row.
// - the x tile's channel quads are swizzled by t (xs_quad), so that every
//   16-byte shared load of it is free of bank conflicts.
// Limits: D <= 256 (a thread per (d, half)), d_out <= 256 (the group's m in
// shared memory): 221.75 KiB at the TimeUNet shape, at most 224 KiB of the
// 227 (T = C = 64, D = d_out = 256). On an NVIDIA H100 80GB HBM3 at 700 W:
// 4.97 ms bf16, 5.31 ms fp32 per B = 10 launch (PERF.md, section 6), 46 %
// of the one-warp-per-row kernel's time, 12.8x / 5.6x the bound; 128
// registers with ~140 bytes of spills. scripts/split_ltae_fused_steps.py
// splits its time by step.
//
// ltae_fused_wide_kernel<Tin>: 64 < C <= 128 and one query (U-TAE's
// bottleneck, C = d_out = 128, attention out: ten launches a tile, one per
// entry forward). The one-warp-per-row kernel below served it at 0.85 /
// 0.93 ms (bf16 / fp32) per B = 10 launch, 56x / 33x its bound: four warps
// on an SM (4-row blocks of 185 KiB), x loaded before any compute, every
// step a serial loop of one warp per row, W_m read from L2 once per row.
// This kernel is the row-group kernel above at twice the width:
// - the same persistent 512-thread blocks and row ranges, in groups of R =
//   4 rows, four warps a row: the fp32 x tile (4, 64, 128) is 128 KiB;
//   206.5 KiB in all at the U-TAE shape, at most 208 KiB (T = 64, D = d_out
//   = 256);
// - GroupNorm: warp (row, quarter of T), lane = channel quad, 64 values in
//   registers, the quarters' sums added through shared memory; scores:
//   warp (row, quarter of the heads), lanes t and t + 32; P: warp (row,
//   quarter of the heads), lane = channel quad, 4 x 4 register tiles;
//   projection + PE term: thread (d, half of C and half of T) over the
//   group's 4 rows; MLP: thread (j, quarter of D) over the 4 rows, the
//   quarters added in order;
// - the attention is stored from the softmax, coalesced over t; the next
//   group's x comes in by cp.async behind the projection, MLP and out
//   GroupNorm; in tail mode tsc[b], tsh[b] are read from L2 (no room).
// Limits as above: D <= 256, d_out <= 256; a wider one-query L-TAE at this
// C takes the kernel below. PERF.md, section 6, has its time.
//
// ltae_fused_fwd_kernel<Tin, KC>: nq = 2 .. 8 queries (the LTAE module with
// num_queries > 1), and one query at 64 < C with D or d_out past 256 (the
// row-group kernels' limit), C <= 128. One block = R <= 8 rows (one warp per row for
// the per-row steps), all T. Shared memory per row: xs (T, C+1) | a (T,
// G+1) | P (G, C+1) | o (D) | v (max(C, nq*d_out)); the +1 pads avoid bank
// conflicts; Ws (C, G*nq) once per block. At U-TAE's width with nq = 3 a row
// takes 47 KiB and 4 rows with 24 KiB of Ws 212 KiB. The launch picks the
// most rows that fit. One block runs per SM. A lane owns channels c + 32k, k
// < KC: the kernel is instantiated for KC = 2 (C <= 64) and KC = 4 (C <=
// 128), so the per-lane channel arrays stay in registers. The row reuses its
// a, P and o regions across queries; only the MLP outputs of all queries
// (the out GroupNorm pools them) and Ws grow with nq. The scores, P, o and
// the MLP run nq times; the input GroupNorm and the read of x do not.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kMaxT = 64;      // lanes own t and t + 32
constexpr int kMaxC = 128;     // lanes own c + 32k, k < KC <= 4
constexpr int kMaxG = 16;      // per-head accumulators held in registers
constexpr int kMaxQ = 8;       // queries per head (MAX_QUERIES in ltae_fused.py)
constexpr int kMaxRows = 8;    // rows (= warps) per block
constexpr size_t kSmemLimit = 232448;  // 227 KB, the most a block may use
// C <= 64, one query (ltae_fused_group_kernel)
constexpr int kGroupMaxC = 64;
constexpr int kGroupRows = 8;       // rows per group
constexpr int kJChunk = 64;         // MLP / out-GroupNorm outputs per pass
constexpr int kGroupThreads = kGroupRows * kJChunk;  // 16 warps: 2 per row
constexpr int kMlpSplit = kGroupThreads / kJChunk;   // MLP: D split in eighths
constexpr int kGroupMaxD = kGroupThreads / 2;        // projection: a thread per (d, half)
constexpr int kGroupMaxDout = 256;  // m of the group's rows in shared memory
// 64 < C <= 128, one query (ltae_fused_wide_kernel)
constexpr int kWideRows = 4;        // rows per group
constexpr int kWideJChunk = 128;    // MLP / out-GroupNorm outputs per pass
constexpr int kWideSplit = kGroupThreads / kWideJChunk;  // MLP: D split in quarters
constexpr int kWideParts = kGroupThreads / 32 / kWideRows;  // GroupNorm: a warp per quarter of T

struct Args {
  const void* x;
  const float* pe;    // (B, T, D)
  const float* win;   // (C, D), in-GroupNorm affine folded
  const float* bin;   // (D,)
  const float* ws;    // (C, G*nq), column g*nq + q
  const float* pes;   // (B, G*nq, T)
  const float* wm;    // (D, d_out), BatchNorm folded
  const float* bm;    // (d_out,)
  const float* osc;   // (d_out,)
  const float* obi;   // (d_out,)
  const float* tsc;   // (B, T, C) or null
  const float* tsh;   // (B, T, C) or null
  void* out;          // (B, N, nq, d_out), x's type
  float* attn;        // (B, N, G, nq, T) or null
  int B, T, N, C, D, G, DOUT, NQ;
  float eps;
};

__host__ __device__ inline int row_floats(int T, int C, int D, int G, int DOUT,
                                          int NQ) {
  return T * (C + 1) + T * (G + 1) + G * (C + 1) + D + (C > NQ * DOUT ? C : NQ * DOUT);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// 16-byte vector of the input type, widened to fp32.
template <typename Tin> struct Vec;

template <> struct Vec<float> {
  static constexpr int kN = 4;
  __device__ static void unpack(const uint4& r, float* v) {
    v[0] = __uint_as_float(r.x);
    v[1] = __uint_as_float(r.y);
    v[2] = __uint_as_float(r.z);
    v[3] = __uint_as_float(r.w);
  }
  __device__ static void store(float* p, float v) { *p = v; }
};

template <> struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void unpack(const uint4& r, float* v) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // element 2i sits in the low half
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
};

template <typename Tin, int KC>
__global__ void __launch_bounds__(32 * kMaxRows)
ltae_fused_fwd_kernel(const Args a) {
  extern __shared__ float smem[];
  const int T = a.T, C = a.C, D = a.D, G = a.G, DOUT = a.DOUT, N = a.N;
  const int NQ = a.NQ;
  const int CP = C + 1, GP = G + 1;
  const int R = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int n0 = blockIdx.x * R;
  const int cg = C / G, dv = D / G, og = DOUT / G;
  const int rf = row_floats(T, C, D, G, DOUT, NQ);
  const int off_a = T * CP, off_p = off_a + T * GP, off_o = off_p + G * CP,
            off_v = off_o + D;

  const int GQ = G * NQ;
  float* ws_s = smem;            // (C, G*nq)
  float* rows = smem + C * GQ;   // R regions of rf floats

  // ---- stage Ws and the x tile (tail affine applied on load) -------------
  for (int i = threadIdx.x; i < C * GQ; i += blockDim.x) ws_s[i] = a.ws[i];
  constexpr int V = Vec<Tin>::kN;
  const Tin* x = static_cast<const Tin*>(a.x);
  const int RC = R * C;
  const int nvec = T * RC / V;   // C % V == 0: a vector never straddles rows
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    const int e = i * V;
    const int t = e / RC, rem = e - t * RC;
    const int r = rem / C, c = rem - r * C;
    const int n = n0 + r;
    float v[V];
    if (n < N) {
      const size_t off = ((size_t)(b * T + t) * N + n) * C + c;
      Vec<Tin>::unpack(__ldg(reinterpret_cast<const uint4*>(x + off)), v);
      if (a.tsc != nullptr) {
        const size_t k = (size_t)(b * T + t) * C + c;
#pragma unroll
        for (int j = 0; j < V; ++j) v[j] = fmaxf(fmaf(v[j], a.tsc[k + j], a.tsh[k + j]), 0.f);
      }
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = 0.f;
    }
    float* dst = rows + r * rf + t * CP + c;
#pragma unroll
    for (int j = 0; j < V; ++j) dst[j] = v[j];
  }
  __syncthreads();

  // ---- per-row steps: warp `warp` owns row n ------------------------------
  const int n = n0 + warp;
  const bool row_ok = n < N;     // rows past N compute on zeros, write nothing
  float* xr = rows + warp * rf;
  float* ar = xr + off_a;
  float* pr = xr + off_p;
  float* vr = xr + off_v;

  // 1. GroupNorm over (T, C/G): per-channel sums, group mean, then centered
  //    squares (two passes), then normalize in place. Lanes own c + 32k.
  const float cnt = (float)(T * cg);
  float mean_c[KC], inv_c[KC];
#pragma unroll
  for (int k = 0; k < KC; ++k) mean_c[k] = inv_c[k] = 0.f;
  for (int c = lane; c < C; c += 32) {
    float s = 0.f;
    for (int t = 0; t < T; ++t) s += xr[t * CP + c];
    vr[c] = s;
  }
  __syncwarp();
#pragma unroll
  for (int k = 0; k < KC; ++k) {
    const int c = lane + 32 * k;
    if (c < C) {
      const int g0 = (c / cg) * cg;
      float s = 0.f;
      for (int j = 0; j < cg; ++j) s += vr[g0 + j];
      mean_c[k] = s / cnt;
    }
  }
  __syncwarp();
#pragma unroll
  for (int k = 0; k < KC; ++k) {
    const int c = lane + 32 * k;
    if (c < C) {
      float q = 0.f;
      for (int t = 0; t < T; ++t) {
        const float dl = xr[t * CP + c] - mean_c[k];
        q = fmaf(dl, dl, q);
      }
      vr[c] = q;
    }
  }
  __syncwarp();
#pragma unroll
  for (int k = 0; k < KC; ++k) {
    const int c = lane + 32 * k;
    if (c < C) {
      const int g0 = (c / cg) * cg;
      float q = 0.f;
      for (int j = 0; j < cg; ++j) q += vr[g0 + j];
      inv_c[k] = rsqrtf(q / cnt + a.eps);
      for (int t = 0; t < T; ++t)
        xr[t * CP + c] = (xr[t * CP + c] - mean_c[k]) * inv_c[k];
    }
  }
  __syncwarp();

  // Steps 2-5 run once per query; a, P and o are reused, m_q goes to
  // v[q * d_out + j]. The block-wide steps 4 and 5 sit between barriers that
  // every thread reaches (NQ is uniform).
  const bool v0 = lane < T, v1 = lane + 32 < T;
  for (int q = 0; q < NQ; ++q) {
  // 2. scores (lanes own t, t + 32) and the masked softmax over T.
  {
    float s0[kMaxG], s1[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) s0[g] = s1[g] = 0.f;
    const float* x0p = xr + (v0 ? lane : 0) * CP;   // lanes past T read row 0
    const float* x1p = xr + (v1 ? lane + 32 : 0) * CP;
    for (int c = 0; c < C; ++c) {
      const float x0 = x0p[c], x1 = x1p[c];
      const float* w = ws_s + c * GQ + q;
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          const float wv = w[g * NQ];
          s0[g] = fmaf(x0, wv, s0[g]);
          s1[g] = fmaf(x1, wv, s1[g]);
        }
      }
    }
    // (head, query) column g*nq + q of pes and of the row's attention
    const float* pes = a.pes + ((size_t)b * GQ + q) * T;
    float* attn = (a.attn != nullptr && row_ok)
                      ? a.attn + (((size_t)b * N + n) * GQ + q) * T : nullptr;
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) {   // G is uniform: the whole warp takes the shuffles
        const float z0 = v0 ? s0[g] + pes[g * NQ * T + lane] : -CUDART_INF_F;
        const float z1 = v1 ? s1[g] + pes[g * NQ * T + lane + 32] : -CUDART_INF_F;
        const float m = warp_max(fmaxf(z0, z1));
        float e0 = v0 ? expf(z0 - m) : 0.f;
        float e1 = v1 ? expf(z1 - m) : 0.f;
        const float inv = 1.f / warp_sum(e0 + e1);
        e0 *= inv;
        e1 *= inv;
        if (v0) ar[lane * GP + g] = e0;
        if (v1) ar[(lane + 32) * GP + g] = e1;
        if (attn != nullptr) {
          if (v0) attn[g * NQ * T + lane] = e0;
          if (v1) attn[g * NQ * T + lane + 32] = e1;
        }
      }
    }
  }
  __syncwarp();

  // 3. P = a @ xn, (G, C): lanes own c + 32k.
  {
    float p[KC][kMaxG];
#pragma unroll
    for (int k = 0; k < KC; ++k)
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) p[k][g] = 0.f;
    for (int t = 0; t < T; ++t) {
      const float* xt = xr + t * CP;
      float xv[KC];
#pragma unroll
      for (int k = 0; k < KC; ++k) xv[k] = lane + 32 * k < C ? xt[lane + 32 * k] : 0.f;
      const float* at = ar + t * GP;
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          const float av = at[g];
#pragma unroll
          for (int k = 0; k < KC; ++k) p[k][g] = fmaf(av, xv[k], p[k][g]);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) {
#pragma unroll
        for (int k = 0; k < KC; ++k)
          if (lane + 32 * k < C) pr[g * CP + lane + 32 * k] = p[k][g];
      }
    }
  }
  __syncthreads();

  // 4. o = P[g(d)] . W_in[:, d] + b_in[d] + sum_t a[g(d), t] pe[t, d], block-
  //    wide: a thread owns d for all R rows, so each W_in / pe element read
  //    from L2 serves R rows.
  const float* pe_b = a.pe + (size_t)b * T * D;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    const int g = d / dv;
    float acc[kMaxRows];
    const float b0 = a.bin[d];
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) acc[r] = b0;
    for (int c = 0; c < C; ++c) {
      const float w = __ldg(a.win + c * D + d);
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r)
        if (r < R) acc[r] = fmaf(rows[r * rf + off_p + g * CP + c], w, acc[r]);
    }
    for (int t = 0; t < T; ++t) {
      const float pv = __ldg(pe_b + t * D + d);
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r)
        if (r < R) acc[r] = fmaf(rows[r * rf + off_a + t * GP + g], pv, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r)
      if (r < R) rows[r * rf + off_o + d] = acc[r];
  }
  __syncthreads();

  // 5. m_q = relu(o @ W_m + b_m), block-wide over (row, j). The next
  //    query's step 4 writes o only after the barrier that ends its step 3.
  for (int i = threadIdx.x; i < R * DOUT; i += blockDim.x) {
    const int r = i / DOUT, j = i - r * DOUT;
    const float* orow = rows + r * rf + off_o;
    float acc = a.bm[j];
    for (int d = 0; d < D; ++d) acc = fmaf(orow[d], __ldg(a.wm + d * DOUT + j), acc);
    rows[r * rf + off_v + q * DOUT + j] = fmaxf(acc, 0.f);
  }
  }  // queries
  __syncthreads();

  // 6. out GroupNorm over G groups of d_out/G channels, each pooled over
  //    the nq queries (og * nq values), two-pass, + the shared affine.
  if (row_ok) {
    Tin* out = static_cast<Tin*>(a.out) + ((size_t)b * N + n) * NQ * DOUT;
    const float cnt_o = (float)(og * NQ);
    for (int e = lane; e < NQ * DOUT; e += 32) {
      const int j = e % DOUT;
      const int g0 = (j / og) * og;
      float s = 0.f;
      for (int qq = 0; qq < NQ; ++qq)
        for (int i = 0; i < og; ++i) s += vr[qq * DOUT + g0 + i];
      const float mu = s / cnt_o;
      float ss = 0.f;
      for (int qq = 0; qq < NQ; ++qq)
        for (int i = 0; i < og; ++i) {
          const float dl = vr[qq * DOUT + g0 + i] - mu;
          ss = fmaf(dl, dl, ss);
        }
      const float y = (vr[e] - mu) * rsqrtf(ss / cnt_o + a.eps);
      Vec<Tin>::store(out + e, fmaf(y, a.osc[j], a.obi[j]));
    }
  }
}

// ---- C <= 64, one query: persistent row groups (module note) --------------

// Shared memory of a group kernel block, in floats. Regions start on 16
// bytes. The x tile holds (R, TP, C) fp32 with its channel quads swizzled
// by t (xs_quad), and from the end of P to the next GroupNorm the next
// group's raw x in x's type, (T, R, C) as in device memory. The a region
// holds a (R, G, TP) until the projection, then the MLP's partial sums
// (8, R, 64), then in tail mode tsc[b] and tsh[b] (T, C) each, for the next
// GroupNorm; the P region holds P (R, G, C) until the projection, then m
// (R, d_out).
struct GroupLayout {
  int tp, dp, sw;      // T and D rounded up to 4; the swizzle mask of quads
  int xs, a, p, o, ot, bin, bm, osc, obi, ws, pes, chs;
  int floats;
};

// R rows a group, MLP outputs in passes of J by K threads each, the
// GroupNorm's per-channel sums from P threads a channel; tsc[b] and tsh[b]
// staged in the a region with `tail`.
__host__ __device__ constexpr GroupLayout group_layout(int T, int C, int D, int G, int DOUT,
                                                    int R, int J, int K, int P, bool tail) {
  GroupLayout L{};
  int o = 0;
  auto take = [&](int n) { const int at = o; o += (n + 3) & ~3; return at; };
  auto mx = [](int u, int v) { return u > v ? u : v; };
  L.tp = (T + 3) & ~3;
  L.dp = (D + 3) & ~3;
  const int quads = C / 4, low = quads & -quads;   // C % 8 == 0: quads even
  L.sw = (low < 8 ? low : 8) - 1;
  L.xs = take(R * L.tp * C);
  L.a = take(mx(mx(R * G * L.tp, K * R * J), tail ? 2 * T * C : 0));
  L.p = take(mx(R * G * C, R * DOUT));
  L.o = take(R * L.dp);
  L.ot = take(R * L.dp);
  L.bin = take(D);
  L.bm = take(DOUT);
  L.osc = take(DOUT);
  L.obi = take(DOUT);
  L.ws = take(C * kMaxG);
  L.pes = take(kMaxG * L.tp);
  L.chs = take(P * R * C);
  L.floats = o;
  return L;
}

__host__ __device__ constexpr GroupLayout narrow_layout(int T, int C, int D, int G, int DOUT) {
  return group_layout(T, C, D, G, DOUT, kGroupRows, kJChunk, kMlpSplit, 2, true);
}

__host__ __device__ constexpr GroupLayout wide_layout(int T, int C, int D, int G, int DOUT) {
  return group_layout(T, C, D, G, DOUT, kWideRows, kWideJChunk, kWideSplit, kWideParts, false);
}

// Every layout grows with T, C, D, G and d_out, so every shape the row-group
// kernels take fits when the one at their limits does.
static_assert(narrow_layout(kMaxT, kGroupMaxC, kGroupMaxD, kMaxG, kGroupMaxDout).floats *
                  sizeof(float) <= kSmemLimit,
              "the C <= 64 row group at its limits fits in shared memory");
static_assert(wide_layout(kMaxT, kMaxC, kGroupMaxD, kMaxG, kGroupMaxDout).floats *
                  sizeof(float) <= kSmemLimit,
              "the C <= 128 row group at its limits fits in shared memory");

// Offset of channel quad q (channels 4q .. 4q + 4) of step t in a row's x
// tile: stored at quad q ^ (t & sw), so that lanes reading one quad of 8
// consecutive t, or the quads of one t, hit distinct banks.
__device__ __forceinline__ int xs_quad(int t, int q, int C, int sw) {
  return t * C + ((q ^ (t & sw)) << 2);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float at4(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Start copying the raw x of rows [m0, m0 + rows) of batch item b, all T,
// into raw as (T, R, C) in x's type (R rows per group): for each t the rows are contiguous in
// device memory, so the copy is 16-byte vectors throughout.
template <typename Tin, int R>
__device__ void fetch_group(const Args& a, Tin* raw, int b, int m0, int rows) {
  constexpr int V = 16 / sizeof(Tin);
  const Tin* x = static_cast<const Tin*>(a.x);
  const int C = a.C, per_t = rows * C / V;   // C % 8 == 0: whole vectors
#pragma unroll 1
  for (int i = threadIdx.x; i < a.T * per_t; i += kGroupThreads) {
    const int t = i / per_t, e = (i - t * per_t) * V;
    cp_async16(raw + t * R * C + e,
               x + ((size_t)(b * a.T + t) * a.N + m0) * C + e);
  }
  cp_async_commit();
}

// Start copying batch item b's tail affine, tsc[b] and tsh[b] (T, C) fp32,
// into ts (2, T, C).
__device__ void fetch_tail(const Args& a, float* ts, int b) {
  const int n = a.T * a.C;   // C % 8 == 0: whole vectors
  const float* sc = a.tsc + (size_t)b * n;
  const float* sh = a.tsh + (size_t)b * n;
#pragma unroll 1
  for (int i = 4 * threadIdx.x; i < n; i += 4 * kGroupThreads) {
    cp_async16(ts + i, sc + i);
    cp_async16(ts + n + i, sh + i);
  }
  cp_async_commit();
}

// Four consecutive values of x's type from shared memory, widened to fp32.
__device__ __forceinline__ float4 load4(const float* p) { return ld4(p); }
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);   // element 2i in the low half
  return make_float4(__uint_as_float(r.x << 16), __uint_as_float(r.x & 0xffff0000u),
                     __uint_as_float(r.y << 16), __uint_as_float(r.y & 0xffff0000u));
}

// The GroupNorm's per-group statistic for the thread's 4 channels: part[j]
// holds the thread's sum over its 16 steps of channel 4 gq + j of row gr;
// the two quarters in the warp are added by a shuffle, the row's two warps
// through chs (2, R, C) and a barrier, then the group's cg channels; out[j]
// = that / cnt, or rsqrt(that / cnt + eps) with `rs`. Every thread of
// the block calls it (two barriers).
__device__ __forceinline__ void group_stat(float* part, float* out, float* chs, int gr,
                                           int gh, int gq, int lane, int C, int cg,
                                           float cnt, float eps, bool rs) {
#pragma unroll
  for (int j = 0; j < 4; ++j) part[j] += __shfl_xor_sync(0xffffffffu, part[j], 16);
  if (lane < 16 && 4 * gq < C)
#pragma unroll
    for (int j = 0; j < 4; ++j) chs[(gh * kGroupRows + gr) * C + 4 * gq + j] = part[j];
  __syncthreads();
  if (4 * gq < C) {
    const float* c0 = chs + gr * C;
    const float* c1 = chs + (kGroupRows + gr) * C;
    int prev = -1;
    float val = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int g0 = ((4 * gq + j) / cg) * cg;
      if (g0 != prev) {   // channels of one group share the value
        float s = 0.f;
#pragma unroll 1
        for (int k = 0; k < cg; ++k) s += c0[g0 + k] + c1[g0 + k];
        val = rs ? rsqrtf(s / cnt + eps) : s / cnt;
        prev = g0;
      }
      out[j] = val;
    }
  }
  __syncthreads();
}

// Batch item b's constants in shared memory, once per block: Ws for 16
// heads (0 past G), pes[b], b_in, b_m and the out affine.
__device__ __forceinline__ void stage_constants(const Args& a, float* smem,
                                                const GroupLayout& L, int b) {
  const int C = a.C, G = a.G, T = a.T, TP = L.tp, tid = threadIdx.x;
  for (int i = tid; i < C * kMaxG; i += kGroupThreads) {
    const int c = i / kMaxG, g = i - c * kMaxG;
    smem[L.ws + i] = g < G ? a.ws[c * G + g] : 0.f;
  }
  for (int i = tid; i < G * T; i += kGroupThreads) {
    const int g = i / T, t = i - g * T;
    smem[L.pes + g * TP + t] = a.pes[(size_t)b * G * T + i];
  }
  for (int i = tid; i < a.D; i += kGroupThreads) smem[L.bin + i] = a.bin[i];
  for (int i = tid; i < a.DOUT; i += kGroupThreads) {
    smem[L.bm + i] = a.bm[i];
    smem[L.osc + i] = a.osc[i];
    smem[L.obi + i] = a.obi[i];
  }
}

// m = relu(o @ W_m + b_m) of a group's R rows into ps (R, d_out), in passes
// of J outputs: thread (j, k) sums d in the k-th of K = threads / J parts of
// D for all R rows, so each W_m element read from L2 serves R rows; the
// parts' sums meet in `part` (K, R, J) and are added in order. Every thread
// of the block calls it (two barriers a pass).
template <int R, int J>
__device__ __forceinline__ void group_mlp(const Args& a, const float* smem,
                                          const GroupLayout& L, float* part, float* ps) {
  constexpr int K = kGroupThreads / J;
  const int D = a.D, DOUT = a.DOUT, DP = L.dp, tid = threadIdx.x;
  for (int j0 = 0; j0 < DOUT; j0 += J) {
    const int jj = tid & (J - 1), k = tid / J, j = j0 + jj;
    const int d0 = k * D / K, d1 = (k + 1) * D / K;
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
    if (j < DOUT) {
      if ((D & (4 * K - 1)) == 0) {   // every part holds whole quads
#pragma unroll 4
        for (int d = d0; d < d1; d += 4) {
          float w[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) w[i] = __ldg(a.wm + (d + i) * DOUT + j);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float4 ov = ld4(smem + L.o + r * DP + d);
            acc[r] = fmaf(ov.x, w[0], acc[r]);
            acc[r] = fmaf(ov.y, w[1], acc[r]);
            acc[r] = fmaf(ov.z, w[2], acc[r]);
            acc[r] = fmaf(ov.w, w[3], acc[r]);
          }
        }
      } else {
#pragma unroll 1
        for (int d = d0; d < d1; ++d) {
          const float w = __ldg(a.wm + d * DOUT + j);
#pragma unroll
          for (int r = 0; r < R; ++r)
            acc[r] = fmaf(smem[L.o + r * DP + d], w, acc[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) part[(k * R + r) * J + jj] = acc[r];
    __syncthreads();
    {
      const int r = tid / J;   // kGroupThreads = R * J
      if (j < DOUT) {
        float s = smem[L.bm + j];
        for (int kk = 0; kk < K; ++kk) s += part[(kk * R + r) * J + jj];
        ps[r * DOUT + j] = fmaxf(s, 0.f);
      }
    }
    __syncthreads();
  }
}

// The out GroupNorm of a group's first `rows` rows of m (ps, (R, d_out)):
// G groups of d_out / G channels, two-pass, then the affine, stored to out
// row m0 + r of batch item b; thread (r, j), in passes of J outputs.
template <typename Tin, int R, int J>
__device__ __forceinline__ void group_out_norm(const Args& a, const float* smem,
                                               const GroupLayout& L, const float* ps,
                                               int b, int m0, int rows) {
  static_assert(R * J == kGroupThreads, "a thread per (row, output) of a pass");
  const int DOUT = a.DOUT, og = DOUT / a.G, tid = threadIdx.x;
  for (int j0 = 0; j0 < DOUT; j0 += J) {
    const int r = tid / J, j = j0 + (tid & (J - 1));
    if (j < DOUT && r < rows) {
      const float* mr = ps + r * DOUT;
      const int g0 = (j / og) * og;
      float s = 0.f;
      for (int i = 0; i < og; ++i) s += mr[g0 + i];
      const float mu = s / og;
      float ss = 0.f;
      for (int i = 0; i < og; ++i) {
        const float dl = mr[g0 + i] - mu;
        ss = fmaf(dl, dl, ss);
      }
      const float y = (mr[j] - mu) * rsqrtf(ss / og + a.eps);
      Vec<Tin>::store(static_cast<Tin*>(a.out) + ((size_t)b * a.N + m0 + r) * DOUT + j,
                      fmaf(y, smem[L.osc + j], smem[L.obi + j]));
    }
  }
}

template <typename Tin>
__global__ void __launch_bounds__(kGroupThreads, 1)
ltae_fused_group_kernel(const Args a) {
  extern __shared__ __align__(16) float smem_group[];
  float* const smem = smem_group;
  const int T = a.T, C = a.C, D = a.D, G = a.G, DOUT = a.DOUT, N = a.N;
  const GroupLayout L = narrow_layout(T, C, D, G, DOUT);
  const int TP = L.tp, DP = L.dp, SW = L.sw;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y, S = gridDim.x;
  const int cg = C / G, dv = D / G;
  // this block's rows: a contiguous range of batch item b (row_ranges)
  const int n0 = (int)((long long)blockIdx.x * N / S);
  const int n1 = (int)((long long)(blockIdx.x + 1) * N / S);
  if (n0 >= n1) return;   // the whole block: no barrier is reached

  float* xs = smem + L.xs;
  float* as = smem + L.a;
  float* ps = smem + L.p;
  Tin* raw = reinterpret_cast<Tin*>(xs);
  const bool tail = a.tsc != nullptr;
  fetch_group<Tin, kGroupRows>(a, raw, b, n0, min(kGroupRows, n1 - n0));
  if (tail) fetch_tail(a, as, b);

  stage_constants(a, smem, L, b);
  const float* tsc = as;   // tsc[b], tsh[b] as fetch_tail lays them out
  const float* tsh = as + T * C;
  const float* pe_b = a.pe + (size_t)b * T * D;
  const float cnt = (float)(T * cg);

#pragma unroll 1
  for (int m0 = n0; m0 < n1; m0 += kGroupRows) {
    const int rows = min(kGroupRows, n1 - m0);
    cp_async_wait_all();
    __syncthreads();

    // 1. tail affine and GroupNorm over (T, C/G): thread (r, quad, quarter)
    //    holds channels 4 quad .. + 4 of row r at 16 steps in registers;
    //    per-channel sums (the quarters added by a shuffle and across the
    //    row's two warps), the group mean, centered squares (two passes),
    //    normalized into the x tile. Rows past the range compute on zeros
    //    and store nothing.
    const int gr = warp >> 1, gq = lane & 15, gh = warp & 1;
    const int gt0 = 16 * (2 * gh + (lane >> 4));
    const bool gn_on = 4 * gq < C;
    float4 v[16];
    float mean[4] = {0.f, 0.f, 0.f, 0.f}, inv[4] = {0.f, 0.f, 0.f, 0.f};
    {
      float s[4] = {0.f, 0.f, 0.f, 0.f};
      const int nt = min(16, max(0, T - gt0));   // the thread's steps below T
      if (gn_on) {
        const int nx = gr < rows ? nt : 0;         // ... that hold a row's data
        const Tin* rp = raw + (gt0 * kGroupRows + gr) * C + 4 * gq;
        const float* scp = tsc + gt0 * C + 4 * gq;
        const float* shp = tsh + gt0 * C + 4 * gq;
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
          if (i < nx) {
            x = load4(rp + i * kGroupRows * C);
            if (tail) {
              const float4 sc = ld4(scp + i * C), sh = ld4(shp + i * C);
              x = make_float4(fmaxf(fmaf(x.x, sc.x, sh.x), 0.f), fmaxf(fmaf(x.y, sc.y, sh.y), 0.f),
                              fmaxf(fmaf(x.z, sc.z, sh.z), 0.f), fmaxf(fmaf(x.w, sc.w, sh.w), 0.f));
            }
          }
          v[i] = x;
          s[0] += x.x;
          s[1] += x.y;
          s[2] += x.z;
          s[3] += x.w;
        }
      }
      group_stat(s, mean, smem + L.chs, gr, gh, gq, lane, C, cg, cnt, 0.f, false);
      float q[4] = {0.f, 0.f, 0.f, 0.f};
      if (gn_on) {
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          if (i < nt) {
            const float d0 = v[i].x - mean[0], d1 = v[i].y - mean[1];
            const float d2 = v[i].z - mean[2], d3 = v[i].w - mean[3];
            q[0] = fmaf(d0, d0, q[0]);
            q[1] = fmaf(d1, d1, q[1]);
            q[2] = fmaf(d2, d2, q[2]);
            q[3] = fmaf(d3, d3, q[3]);
          }
        }
      }
      group_stat(q, inv, smem + L.chs, gr, gh, gq, lane, C, cg, cnt, a.eps, true);
      if (gn_on) {
        float* xr = xs + gr * TP * C;
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int t = gt0 + i;
          float4 y = make_float4(0.f, 0.f, 0.f, 0.f);   // the pad steps T .. TP
          if (i < nt)
            y = make_float4((v[i].x - mean[0]) * inv[0], (v[i].y - mean[1]) * inv[1],
                            (v[i].z - mean[2]) * inv[2], (v[i].w - mean[3]) * inv[3]);
          if (t < TP) *reinterpret_cast<float4*>(xr + xs_quad(t, gq, C, SW)) = y;
        }
      }
    }
    __syncthreads();

    // 2. scores and the masked softmax over T: warp (r, half) owns row r's
    //    heads 8 * half .. + 8, lanes t and t + 32; c in order, as the
    //    one-warp-per-row kernel sums them.
    {
      const int r = warp >> 1, g0 = (warp & 1) * 8;
      if (g0 < G) {   // warp-uniform
        // lanes past the padded steps read a step they do not own
        const int t0 = lane < TP ? lane : 0, t1 = lane + 32 < TP ? lane + 32 : lane;
        const bool v0 = lane < T, v1 = lane + 32 < T;
        const float* xr = xs + r * TP * C;
        const float* wsg = smem + L.ws + g0;
        float s0[8], s1[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) s0[k] = s1[k] = 0.f;
#pragma unroll 2
        for (int q = 0; q < C / 4; ++q) {
          const float4 xa = ld4(xr + xs_quad(t0, q, C, SW));
          const float4 xb = ld4(xr + xs_quad(t1, q, C, SW));
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float* w = wsg + (4 * q + i) * kMaxG;
            const float4 wl = ld4(w), wh = ld4(w + 4);
            const float wv[8] = {wl.x, wl.y, wl.z, wl.w, wh.x, wh.y, wh.z, wh.w};
            const float xv0 = at4(xa, i), xv1 = at4(xb, i);
#pragma unroll
            for (int k = 0; k < 8; ++k) {
              s0[k] = fmaf(xv0, wv[k], s0[k]);
              s1[k] = fmaf(xv1, wv[k], s1[k]);
            }
          }
        }
        const int n = m0 + r;
        float* attn = (a.attn != nullptr && r < rows)
                          ? a.attn + ((size_t)b * N + n) * G * T : nullptr;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int g = g0 + k;
          if (g < G) {   // uniform: the whole warp takes the shuffles
            const float* pes = smem + L.pes + g * TP;
            const float z0 = v0 ? s0[k] + pes[t0] : -CUDART_INF_F;
            const float z1 = v1 ? s1[k] + pes[lane + 32] : -CUDART_INF_F;
            const float mx = warp_max(fmaxf(z0, z1));
            float e0 = v0 ? expf(z0 - mx) : 0.f;
            float e1 = v1 ? expf(z1 - mx) : 0.f;
            const float rs = 1.f / warp_sum(e0 + e1);
            e0 *= rs;
            e1 *= rs;
            float* ar = as + (r * G + g) * TP;
            if (lane < TP) ar[lane] = e0;        // 0 on the pad steps T .. TP
            if (lane + 32 < TP) ar[lane + 32] = e1;
            if (attn != nullptr) {
              if (v0) attn[g * T + t0] = e0;
              if (v1) attn[g * T + lane + 32] = e1;
            }
          }
        }
      }
    }
    __syncthreads();

    // 3. P = a @ xn, (G, C) per row: warp (r, half), lane (c quad, g quad);
    //    a 4 x 4 tile of (g, c) in registers, t in order (the pad steps add
    //    0 * 0). Written once the x tile is free, which also lets the next
    //    group's x start coming in.
    {
      const int r = warp >> 1;
      const int cq = lane & 15, gq = (lane >> 4) + 2 * (warp & 1);
      const bool on = 4 * cq < C && 4 * gq < G;
      float p[4][4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int j = 0; j < 4; ++j) p[k][j] = 0.f;
      if (on) {
        const float* xr = xs + r * TP * C;
        const float* ar[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) ar[k] = as + (r * G + min(4 * gq + k, G - 1)) * TP;
#pragma unroll 1
        for (int t = 0; t < TP; t += 4) {
          float4 xv[4], av[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) xv[i] = ld4(xr + xs_quad(t + i, cq, C, SW));
#pragma unroll
          for (int k = 0; k < 4; ++k) av[k] = ld4(ar[k] + t);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const float w = at4(av[k], i);
              p[k][0] = fmaf(w, xv[i].x, p[k][0]);
              p[k][1] = fmaf(w, xv[i].y, p[k][1]);
              p[k][2] = fmaf(w, xv[i].z, p[k][2]);
              p[k][3] = fmaf(w, xv[i].w, p[k][3]);
            }
        }
      }
      __syncthreads();   // the x tile is free from here
      if (m0 + kGroupRows < n1)
        fetch_group<Tin, kGroupRows>(a, raw, b, m0 + kGroupRows, min(kGroupRows, n1 - m0 - kGroupRows));
      if (on) {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (4 * gq + k < G)
            *reinterpret_cast<float4*>(ps + (r * G + 4 * gq + k) * C + 4 * cq) =
                make_float4(p[k][0], p[k][1], p[k][2], p[k][3]);
      }
    }
    __syncthreads();

    // 4. o[d] = b_in[d] + P[g(d)] . W_in[:, d] + a[g(d)] . pe[:, d]: thread d
    //    of the first 256 sums over c, of the last 256 over t, for all the
    //    group's rows, so each W_in / pe element read from L2 serves R rows.
    {
      const int d = tid & 255, half = tid >> 8;
      const bool on = d < D;
      const int g = on ? d / dv : 0;
      float acc[kGroupRows];
      const float b0 = half == 0 && on ? smem[L.bin + d] : 0.f;
#pragma unroll
      for (int r = 0; r < kGroupRows; ++r) acc[r] = b0;
      if (on && half == 0) {
#pragma unroll 4
        for (int c = 0; c < C; c += 4) {
          float w[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) w[i] = __ldg(a.win + (c + i) * D + d);
#pragma unroll
          for (int r = 0; r < kGroupRows; ++r) {
            const float4 pv = ld4(ps + (r * G + g) * C + c);
            acc[r] = fmaf(pv.x, w[0], acc[r]);
            acc[r] = fmaf(pv.y, w[1], acc[r]);
            acc[r] = fmaf(pv.z, w[2], acc[r]);
            acc[r] = fmaf(pv.w, w[3], acc[r]);
          }
        }
      } else if (on) {
#pragma unroll 4
        for (int t = 0; t < TP; t += 4) {
          float w[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) w[i] = t + i < T ? __ldg(pe_b + (t + i) * D + d) : 0.f;
#pragma unroll
          for (int r = 0; r < kGroupRows; ++r) {
            const float4 av = ld4(as + (r * G + g) * TP + t);
            acc[r] = fmaf(av.x, w[0], acc[r]);
            acc[r] = fmaf(av.y, w[1], acc[r]);
            acc[r] = fmaf(av.z, w[2], acc[r]);
            acc[r] = fmaf(av.w, w[3], acc[r]);
          }
        }
      }
      if (on && half == 1)
#pragma unroll
        for (int r = 0; r < kGroupRows; ++r) smem[L.ot + r * DP + d] = acc[r];
      __syncthreads();
      if (on && half == 0)
#pragma unroll
        for (int r = 0; r < kGroupRows; ++r)
          smem[L.o + r * DP + d] = acc[r] + smem[L.ot + r * DP + d];
    }
    __syncthreads();

    // 5. m = relu(o @ W_m + b_m): thread (j, eighth of D) over the group's
    //    rows (group_mlp).
    group_mlp<kGroupRows, kJChunk>(a, smem, L, as, ps);
    if (tail && m0 + kGroupRows < n1) fetch_tail(a, as, b);   // the a region is free

    // 6. out GroupNorm over G groups of d_out / G channels, two-pass, then
    //    the affine: thread (r, j) (group_out_norm).
    group_out_norm<Tin, kGroupRows, kJChunk>(a, smem, L, ps, b, m0, rows);
  }
}

template <typename Tin>
cudaError_t launch_group(const Args& a, int S, cudaStream_t stream) {
  const size_t bytes =
      (size_t)narrow_layout(a.T, a.C, a.D, a.G, a.DOUT).floats * sizeof(float);
  if (bytes > kSmemLimit || S < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(ltae_fused_group_kernel<Tin>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return err;
  ltae_fused_group_kernel<Tin><<<dim3(S, a.B), kGroupThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

// ---- 64 < C <= 128, one query: persistent row groups of 4 (module note) ----

// The wide kernel's per-group statistic for the thread's 4 channels:
// part[j] holds the thread's sum over its quarter of T of channel 4 gq + j
// of row gr; the row's four warps add theirs through chs (4, R, C) and a
// barrier, in quarter order, then the group's cg channels; out[j] = that /
// cnt, or rsqrt(that / cnt + eps) with `rs`. Every thread of the block calls
// it (two barriers).
__device__ __forceinline__ void wide_stat(const float* part, float* out, float* chs, int gr,
                                          int gh, int gq, int C, int cg, float cnt,
                                          float eps, bool rs) {
  if (4 * gq < C)
    *reinterpret_cast<float4*>(chs + (gh * kWideRows + gr) * C + 4 * gq) =
        make_float4(part[0], part[1], part[2], part[3]);
  __syncthreads();
  if (4 * gq < C) {
    int prev = -1;
    float val = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int g0 = ((4 * gq + j) / cg) * cg;
      if (g0 != prev) {   // channels of one group share the value
        float s = 0.f;
#pragma unroll 1
        for (int k = 0; k < cg; ++k)
#pragma unroll
          for (int h = 0; h < kWideParts; ++h) s += chs[(h * kWideRows + gr) * C + g0 + k];
        val = rs ? rsqrtf(s / cnt + eps) : s / cnt;
        prev = g0;
      }
      out[j] = val;
    }
  }
  __syncthreads();
}

template <typename Tin>
__global__ void __launch_bounds__(kGroupThreads, 1)
ltae_fused_wide_kernel(const Args a) {
  extern __shared__ __align__(16) float smem_wide[];
  float* const smem = smem_wide;
  const int T = a.T, C = a.C, D = a.D, G = a.G, DOUT = a.DOUT, N = a.N;
  const GroupLayout L = wide_layout(T, C, D, G, DOUT);
  const int TP = L.tp, DP = L.dp, SW = L.sw;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y, S = gridDim.x;
  const int cg = C / G, dv = D / G;
  // this block's rows: a contiguous range of batch item b (row_ranges)
  const int n0 = (int)((long long)blockIdx.x * N / S);
  const int n1 = (int)((long long)(blockIdx.x + 1) * N / S);
  if (n0 >= n1) return;   // the whole block: no barrier is reached

  float* xs = smem + L.xs;
  float* as = smem + L.a;
  float* ps = smem + L.p;
  Tin* raw = reinterpret_cast<Tin*>(xs);
  fetch_group<Tin, kWideRows>(a, raw, b, n0, min(kWideRows, n1 - n0));

  stage_constants(a, smem, L, b);
  // tsc[b], tsh[b] stay in L2: no room beside the x tile
  const bool tail = a.tsc != nullptr;
  const float* tsc = tail ? a.tsc + (size_t)b * T * C : nullptr;
  const float* tsh = tail ? a.tsh + (size_t)b * T * C : nullptr;
  const float* pe_b = a.pe + (size_t)b * T * D;
  const float cnt = (float)(T * cg);

#pragma unroll 1
  for (int m0 = n0; m0 < n1; m0 += kWideRows) {
    const int rows = min(kWideRows, n1 - m0);
    cp_async_wait_all();
    __syncthreads();

    // 1. tail affine and GroupNorm over (T, C/G): warp (r, quarter of T),
    //    lane = channel quad; the thread holds channels 4 quad .. + 4 of row
    //    r at 16 steps in registers; per-channel sums (the quarters added
    //    through shared memory), the group mean, centered squares (two
    //    passes), normalized into the x tile. Rows past the range compute
    //    on zeros and store nothing.
    const int gr = warp / kWideParts, gh = warp % kWideParts, gq = lane;
    const int gt0 = 16 * gh;
    const bool gn_on = 4 * gq < C;
    float4 v[16];
    float mean[4] = {0.f, 0.f, 0.f, 0.f}, inv[4] = {0.f, 0.f, 0.f, 0.f};
    {
      float s[4] = {0.f, 0.f, 0.f, 0.f};
      const int nt = min(16, max(0, T - gt0));   // the thread's steps below T
      if (gn_on) {
        const int nx = gr < rows ? nt : 0;         // ... that hold a row's data
        const Tin* rp = raw + (gt0 * kWideRows + gr) * C + 4 * gq;
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
          if (i < nx) {
            x = load4(rp + i * kWideRows * C);
            if (tail) {
              const size_t k = (size_t)(gt0 + i) * C + 4 * gq;
              const float4 sc = __ldg(reinterpret_cast<const float4*>(tsc + k));
              const float4 sh = __ldg(reinterpret_cast<const float4*>(tsh + k));
              x = make_float4(fmaxf(fmaf(x.x, sc.x, sh.x), 0.f), fmaxf(fmaf(x.y, sc.y, sh.y), 0.f),
                              fmaxf(fmaf(x.z, sc.z, sh.z), 0.f), fmaxf(fmaf(x.w, sc.w, sh.w), 0.f));
            }
          }
          v[i] = x;
          s[0] += x.x;
          s[1] += x.y;
          s[2] += x.z;
          s[3] += x.w;
        }
      }
      wide_stat(s, mean, smem + L.chs, gr, gh, gq, C, cg, cnt, 0.f, false);
      float q[4] = {0.f, 0.f, 0.f, 0.f};
      if (gn_on) {
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          if (i < nt) {
            const float d0 = v[i].x - mean[0], d1 = v[i].y - mean[1];
            const float d2 = v[i].z - mean[2], d3 = v[i].w - mean[3];
            q[0] = fmaf(d0, d0, q[0]);
            q[1] = fmaf(d1, d1, q[1]);
            q[2] = fmaf(d2, d2, q[2]);
            q[3] = fmaf(d3, d3, q[3]);
          }
        }
      }
      wide_stat(q, inv, smem + L.chs, gr, gh, gq, C, cg, cnt, a.eps, true);
      if (gn_on) {
        float* xr = xs + gr * TP * C;
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int t = gt0 + i;
          float4 y = make_float4(0.f, 0.f, 0.f, 0.f);   // the pad steps T .. TP
          if (i < nt)
            y = make_float4((v[i].x - mean[0]) * inv[0], (v[i].y - mean[1]) * inv[1],
                            (v[i].z - mean[2]) * inv[2], (v[i].w - mean[3]) * inv[3]);
          if (t < TP) *reinterpret_cast<float4*>(xr + xs_quad(t, gq, C, SW)) = y;
        }
      }
    }
    __syncthreads();

    // 2. scores and the masked softmax over T: warp (r, quarter) owns row
    //    r's heads 4 * quarter .. + 4, lanes t and t + 32, c in order; the
    //    attention is stored from here, coalesced over t.
    {
      const int r = warp / kWideParts, g0 = (warp % kWideParts) * 4;
      if (g0 < G) {   // warp-uniform
        // lanes past the padded steps read a step they do not own
        const int t0 = lane < TP ? lane : 0, t1 = lane + 32 < TP ? lane + 32 : lane;
        const bool v0 = lane < T, v1 = lane + 32 < T;
        const float* xr = xs + r * TP * C;
        const float* wsg = smem + L.ws + g0;
        float s0[4] = {0.f, 0.f, 0.f, 0.f}, s1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
        for (int q = 0; q < C / 4; ++q) {
          const float4 xa = ld4(xr + xs_quad(t0, q, C, SW));
          const float4 xb = ld4(xr + xs_quad(t1, q, C, SW));
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float4 w = ld4(wsg + (4 * q + i) * kMaxG);
            const float xv0 = at4(xa, i), xv1 = at4(xb, i);
            s0[0] = fmaf(xv0, w.x, s0[0]);
            s0[1] = fmaf(xv0, w.y, s0[1]);
            s0[2] = fmaf(xv0, w.z, s0[2]);
            s0[3] = fmaf(xv0, w.w, s0[3]);
            s1[0] = fmaf(xv1, w.x, s1[0]);
            s1[1] = fmaf(xv1, w.y, s1[1]);
            s1[2] = fmaf(xv1, w.z, s1[2]);
            s1[3] = fmaf(xv1, w.w, s1[3]);
          }
        }
        const int n = m0 + r;
        float* attn = (a.attn != nullptr && r < rows)
                          ? a.attn + ((size_t)b * N + n) * G * T : nullptr;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int g = g0 + k;
          if (g < G) {   // uniform: the whole warp takes the shuffles
            const float* pes = smem + L.pes + g * TP;
            const float z0 = v0 ? s0[k] + pes[t0] : -CUDART_INF_F;
            const float z1 = v1 ? s1[k] + pes[lane + 32] : -CUDART_INF_F;
            const float mx = warp_max(fmaxf(z0, z1));
            float e0 = v0 ? expf(z0 - mx) : 0.f;
            float e1 = v1 ? expf(z1 - mx) : 0.f;
            const float rs = 1.f / warp_sum(e0 + e1);
            e0 *= rs;
            e1 *= rs;
            float* ar = as + (r * G + g) * TP;
            if (lane < TP) ar[lane] = e0;        // 0 on the pad steps T .. TP
            if (lane + 32 < TP) ar[lane + 32] = e1;
            if (attn != nullptr) {
              if (v0) attn[g * T + t0] = e0;
              if (v1) attn[g * T + lane + 32] = e1;
            }
          }
        }
      }
    }
    __syncthreads();

    // 3. P = a @ xn, (G, C) per row: warp (r, quarter of the heads), lane =
    //    channel quad; a 4 x 4 tile of (g, c) in registers, t in order (the
    //    pad steps add 0 * 0). Written once the x tile is free, which also
    //    lets the next group's x start coming in.
    {
      const int r = warp / kWideParts;
      const int cq = lane, gq = warp % kWideParts;
      const bool on = 4 * cq < C && 4 * gq < G;
      float p[4][4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int j = 0; j < 4; ++j) p[k][j] = 0.f;
      if (on) {
        const float* xr = xs + r * TP * C;
        const float* ar[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) ar[k] = as + (r * G + min(4 * gq + k, G - 1)) * TP;
#pragma unroll 1
        for (int t = 0; t < TP; t += 4) {
          float4 xv[4], av[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) xv[i] = ld4(xr + xs_quad(t + i, cq, C, SW));
#pragma unroll
          for (int k = 0; k < 4; ++k) av[k] = ld4(ar[k] + t);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const float w = at4(av[k], i);
              p[k][0] = fmaf(w, xv[i].x, p[k][0]);
              p[k][1] = fmaf(w, xv[i].y, p[k][1]);
              p[k][2] = fmaf(w, xv[i].z, p[k][2]);
              p[k][3] = fmaf(w, xv[i].w, p[k][3]);
            }
        }
      }
      __syncthreads();   // the x tile is free from here
      if (m0 + kWideRows < n1)
        fetch_group<Tin, kWideRows>(a, raw, b, m0 + kWideRows,
                                    min(kWideRows, n1 - m0 - kWideRows));
      if (on) {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (4 * gq + k < G)
            *reinterpret_cast<float4*>(ps + (r * G + 4 * gq + k) * C + 4 * cq) =
                make_float4(p[k][0], p[k][1], p[k][2], p[k][3]);
      }
    }
    __syncthreads();

    // 4. o[d] = b_in[d] + P[g(d)] . W_in[:, d] + a[g(d)] . pe[:, d]: thread
    //    (d, half) sums its half of c, then its half of the steps, for all
    //    the group's rows, so each W_in / pe element read from L2 serves R
    //    rows; the halves are added in order.
    {
      const int d = tid & 255, half = tid >> 8;
      const bool on = d < D;
      const int g = on ? d / dv : 0;
      const int c0 = half * (C / 2), c1 = c0 + C / 2;   // C % 8 == 0: whole quads
      const int th = TP / 8 * 4;                        // half 0's steps, whole quads
      const int t0 = half ? th : 0, t1 = half ? TP : th;
      float acc[kWideRows];
      const float b0 = half == 0 && on ? smem[L.bin + d] : 0.f;
#pragma unroll
      for (int r = 0; r < kWideRows; ++r) acc[r] = b0;
      if (on) {
#pragma unroll 4
        for (int c = c0; c < c1; c += 4) {
          float w[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) w[i] = __ldg(a.win + (c + i) * D + d);
#pragma unroll
          for (int r = 0; r < kWideRows; ++r) {
            const float4 pv = ld4(ps + (r * G + g) * C + c);
            acc[r] = fmaf(pv.x, w[0], acc[r]);
            acc[r] = fmaf(pv.y, w[1], acc[r]);
            acc[r] = fmaf(pv.z, w[2], acc[r]);
            acc[r] = fmaf(pv.w, w[3], acc[r]);
          }
        }
#pragma unroll 4
        for (int t = t0; t < t1; t += 4) {
          float w[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) w[i] = t + i < T ? __ldg(pe_b + (t + i) * D + d) : 0.f;
#pragma unroll
          for (int r = 0; r < kWideRows; ++r) {
            const float4 av = ld4(as + (r * G + g) * TP + t);
            acc[r] = fmaf(av.x, w[0], acc[r]);
            acc[r] = fmaf(av.y, w[1], acc[r]);
            acc[r] = fmaf(av.z, w[2], acc[r]);
            acc[r] = fmaf(av.w, w[3], acc[r]);
          }
        }
      }
      if (on && half == 1)
#pragma unroll
        for (int r = 0; r < kWideRows; ++r) smem[L.ot + r * DP + d] = acc[r];
      __syncthreads();
      if (on && half == 0)
#pragma unroll
        for (int r = 0; r < kWideRows; ++r)
          smem[L.o + r * DP + d] = acc[r] + smem[L.ot + r * DP + d];
    }
    __syncthreads();

    // 5. m = relu(o @ W_m + b_m): thread (j, quarter of D) over the group's
    //    rows (group_mlp).
    group_mlp<kWideRows, kWideJChunk>(a, smem, L, as, ps);

    // 6. out GroupNorm over G groups of d_out / G channels, two-pass, then
    //    the affine: thread (r, j) (group_out_norm).
    group_out_norm<Tin, kWideRows, kWideJChunk>(a, smem, L, ps, b, m0, rows);
  }
}

template <typename Tin>
cudaError_t launch_wide(const Args& a, int S, cudaStream_t stream) {
  const size_t bytes =
      (size_t)wide_layout(a.T, a.C, a.D, a.G, a.DOUT).floats * sizeof(float);
  if (bytes > kSmemLimit || S < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(ltae_fused_wide_kernel<Tin>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return err;
  ltae_fused_wide_kernel<Tin><<<dim3(S, a.B), kGroupThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename Tin, int KC>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int rf = row_floats(a.T, a.C, a.D, a.G, a.DOUT, a.NQ);
  int rows = kMaxRows;
  auto bytes = [&](int r) { return (size_t)(a.C * a.G * a.NQ + r * rf) * sizeof(float); };
  while (rows > 1 && bytes(rows) > kSmemLimit) --rows;
  if (bytes(rows) > kSmemLimit) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ltae_fused_fwd_kernel<Tin, KC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes(rows));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + rows - 1) / rows, a.B);
  ltae_fused_fwd_kernel<Tin, KC><<<grid, 32 * rows, bytes(rows), stream>>>(a);
  return cudaGetLastError();
}

// The row-group kernels serve one query up to D, d_out = 256; the nq kernel
// the rest (at C <= 64 the C entry refuses one query past those widths).
template <typename Tin>
cudaError_t launch_c(const Args& a, int S, cudaStream_t stream) {
  const bool wide = a.C > kGroupMaxC;
  const bool group = a.NQ == 1 && a.D <= kGroupMaxD && a.DOUT <= kGroupMaxDout;
  if (!group) return wide ? launch<Tin, 4>(a, stream) : launch<Tin, 2>(a, stream);
  return wide ? launch_wide<Tin>(a, S, stream) : launch_group<Tin>(a, S, stream);
}

}  // namespace

// C entry for ctypes. Pointers are device pointers; tsc/tsh and attn may be
// null. S is the row-group kernels' blocks per batch item (ignored by the
// nq kernel). Returns the cudaError_t of the launch (0 on success).
extern "C" int ltae_fused_fwd(
    const void* x, int x_is_bf16, const void* pe, const void* win,
    const void* bin, const void* ws, const void* pes, const void* wm,
    const void* bm, const void* osc, const void* obi, const void* tsc,
    const void* tsh, void* out, void* attn, int B, int T, int N, int C, int D,
    int G, int DOUT, int NQ, int S, float eps, void* stream) {
  if (B < 1 || N < 1 || T < 1 || T > kMaxT || C < 8 || C > kMaxC || C % 8 ||
      G < 1 || G > kMaxG || C % G || D % G || DOUT % G || NQ < 1 || NQ > kMaxQ ||
      (tsc == nullptr) != (tsh == nullptr) ||
      (NQ == 1 && (S < 1 || (C <= kGroupMaxC && (D > kGroupMaxD || DOUT > kGroupMaxDout)))))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = x;
  a.pe = static_cast<const float*>(pe);
  a.win = static_cast<const float*>(win);
  a.bin = static_cast<const float*>(bin);
  a.ws = static_cast<const float*>(ws);
  a.pes = static_cast<const float*>(pes);
  a.wm = static_cast<const float*>(wm);
  a.bm = static_cast<const float*>(bm);
  a.osc = static_cast<const float*>(osc);
  a.obi = static_cast<const float*>(obi);
  a.tsc = static_cast<const float*>(tsc);
  a.tsh = static_cast<const float*>(tsh);
  a.out = out;
  a.attn = static_cast<float*>(attn);
  a.B = B; a.T = T; a.N = N; a.C = C; a.D = D; a.G = G; a.DOUT = DOUT; a.NQ = NQ;
  a.eps = eps;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(x_is_bf16 ? launch_c<__nv_bfloat16>(a, S, s) : launch_c<float>(a, S, s));
}
