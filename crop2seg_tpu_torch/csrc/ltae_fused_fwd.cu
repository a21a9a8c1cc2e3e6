// Fused masked L-TAE eval forward for NVIDIA Hopper (sm_90a), nq learnable
// queries per head.
//
// Replaces crop2seg_tpu/ops/ltae_pallas.py::ltae_fused_forward (its Pallas
// body `_kernel`, pallas_call at ltae_pallas.py:421). Wrapper, offline folds
// and the plain PyTorch version: crop2seg_tpu_torch/ops/ltae_fused.py.
//
// Per pixel row n of batch item b, over T steps and C channels:
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
// Four kernels share the arithmetic above, every product and statistic in
// fp32 (bf16 only in device memory). The wrapper picks one per shape
// (ops/ltae_fused.py::kernel_route): the three row-group kernels take T <=
// 64, C <= 128 with C % 8 == 0, G <= 16, D and d_out <= 256 (one query at C
// <= 64, one at 64 < C <= 128, nq = 2 .. 8 at either); the general kernel
// takes every other shape at which the L-TAE is defined (G dividing C, D and
// d_out).
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
// Limits as above: D <= 256, d_out <= 256. PERF.md, section 6, has its time.
//
// ltae_fused_queries_kernel<Tin, R>: nq = 2 .. 8 queries (the LTAE module
// with num_queries > 1), C <= 128. It replaces a kernel of one warp per row
// in blocks of <= 8 rows (35.8 ms bf16 at TimeUNet's width with nq = 3, 2.3
// ms at U-TAE's): the block's x loaded before any compute, Ws and W_m read
// from L2 for every row, every step a chain of dependent loads. This kernel
// is the row-group kernels' design with a loop over the queries:
// - the same persistent 512-thread blocks and row ranges, in groups of R =
//   4 rows at C <= 64 and R = 2 at 64 < C <= 128, so that Ws and pes[b] of
//   all queries (C x nq x 16 and nq x 16 x T), the MLP outputs m of every
//   query of the group's rows (nq x d_out a row, for the out GroupNorm,
//   which pools each head's channels over all queries) and the x tile fit
//   at nq = 8, T = 64, D = d_out = 256: 204 / 208 KiB;
// - GroupNorm once per row: thread (row, channel quad, eighth of T), the
//   eighths' sums added through shared memory; then for each query q: scores
//   by warp (row, 4 or 2 heads) with the softmax in the warp and the
//   attention stored from it, P in 2 x 4 (head, channel) register tiles,
//   projection + PE term by thread (d, half of C and of T) over the group's
//   rows, the MLP (group_mlp) into m[q]; last the out GroupNorm over the
//   queries;
// - the next group's x comes in by cp.async once the last query's P has
//   read the x tile, behind that query's projection, its MLP and the out
//   GroupNorm; tsc[b] and tsh[b] are read from L2.
//
// ltae_fused_general_kernel<Tin>: every other shape (T > 64 above all: a
// year of Sentinel-2 dates at the 5-day revisit is 73), written to be right
// at any size rather than fast. One block of 256 threads takes one row at a
// time, S blocks per batch item; x is read from device memory in three
// passes over T (the GroupNorm's sums, its centred squares, then chunks of
// 32 steps for the scores), with an online softmax: a running max and sum
// per (head, query) column, P and the PE term rescaled as chunks arrive (the
// JAX package's chunked path, crop2seg_tpu/nn/ltae.py:354-458, has the same
// math). The attention is written as raw scores and normalized in a last
// pass. Its per-row workspace lives in shared memory where it fits, else in
// a scratch buffer in device memory (ltae_fused_general_scratch_floats).
// Scalar loads, so any C. Latency bounds it, not bytes or operations: each
// row's steps are chains of dependent loads between block barriers, and x
// is read three times; four resident blocks an SM (kGenBlocksPerSm) and
// unrolled inner loops hide part of it. PERF.md, section 6, has its time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kMaxT = 64;      // row-group kernels: lanes own t and t + 32
constexpr int kMaxC = 128;     // the wide row group's x tile
constexpr int kMaxG = 16;      // per-head accumulators held in registers
constexpr int kMaxQ = 8;       // queries kernel: m of all queries in shared memory
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
// nq = 2 .. 8, C <= 128 (ltae_fused_queries_kernel)
constexpr int kQueriesNarrowRows = 4;   // rows per group at C <= 64
constexpr int kQueriesWideRows = 2;     // rows per group at 64 < C <= 128
constexpr int kQueriesParts = 8;        // GroupNorm: parts of T, 8 steps each
// every other shape (ltae_fused_general_kernel)
constexpr int kGenThreads = 256;
constexpr int kGenBlocksPerSm = 4;     // resident blocks an SM (latency)
constexpr int kGenChunk = 32;           // steps of normalized x on chip at a time

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

// ---- nq = 2 .. 8 queries, C <= 128: persistent row groups, a query loop ----

// Shared memory of a queries kernel block, in floats: the group kernels'
// regions (group_layout) with Ws (C, nq, 16) and pes[b] (nq, 16, TP) of all
// queries, zero past G, and m, the MLP outputs (nq, R, d_out) of every
// query. The a region holds the GroupNorm's partial sums (8, R, C), then one
// query's a (R, G, TP) until its projection, then the MLP's partial sums;
// the P region holds P (R, G, C).
struct QueriesLayout : GroupLayout {
  int m;
};

template <int R>
__host__ __device__ constexpr QueriesLayout queries_layout(int T, int C, int D, int G,
                                                         int DOUT, int NQ) {
  constexpr int J = kGroupThreads / R;   // group_mlp's outputs per pass
  QueriesLayout L{};
  int o = 0;
  auto take = [&](int n) { const int at = o; o += (n + 3) & ~3; return at; };
  auto mx = [](int u, int v) { return u > v ? u : v; };
  L.tp = (T + 3) & ~3;
  L.dp = (D + 3) & ~3;
  const int quads = C / 4, low = quads & -quads;   // C % 8 == 0: quads even
  L.sw = (low < 8 ? low : 8) - 1;
  L.xs = take(R * L.tp * C);
  L.a = take(mx(mx(R * G * L.tp, kGroupThreads / J * R * J), kQueriesParts * R * C));
  L.chs = L.a;
  L.p = take(R * G * C);
  L.m = take(NQ * R * DOUT);
  L.o = take(R * L.dp);
  L.ot = take(R * L.dp);
  L.bin = take(D);
  L.bm = take(DOUT);
  L.osc = take(DOUT);
  L.obi = take(DOUT);
  L.ws = take(C * NQ * kMaxG);
  L.pes = take(NQ * kMaxG * L.tp);
  L.floats = o;
  return L;
}

static_assert(queries_layout<kQueriesNarrowRows>(kMaxT, kGroupMaxC, kGroupMaxD, kMaxG,
                                                 kGroupMaxDout, kMaxQ).floats *
                      sizeof(float) <= kSmemLimit,
              "the C <= 64 queries row group at its limits fits in shared memory");
static_assert(queries_layout<kQueriesWideRows>(kMaxT, kMaxC, kGroupMaxD, kMaxG,
                                               kGroupMaxDout, kMaxQ).floats *
                      sizeof(float) <= kSmemLimit,
              "the C <= 128 queries row group at its limits fits in shared memory");

template <typename Tin, int R>
__global__ void __launch_bounds__(kGroupThreads, 1)
ltae_fused_queries_kernel(const Args a) {
  extern __shared__ __align__(16) float smem_queries[];
  float* const smem = smem_queries;
  constexpr int TPR = kGroupThreads / R;   // threads a row: 128 or 256
  constexpr int WPR = TPR / 32;            // warps a row: 4 or 8
  constexpr int HPW = kMaxG / WPR;         // scores: heads a warp, 4 or 2
  constexpr int LQ = TPR / kQueriesParts;  // GroupNorm, P: channel quads a row, 16 or 32
  constexpr int SP = kMaxT / kQueriesParts;  // GroupNorm: steps a thread
  constexpr int J = kGroupThreads / R;     // MLP and out GroupNorm: outputs a pass
  static_assert(HPW == 4 || HPW == 2, "a warp's heads are one float4 or float2 of Ws");
  const int T = a.T, C = a.C, D = a.D, G = a.G, DOUT = a.DOUT, N = a.N, NQ = a.NQ;
  const QueriesLayout L = queries_layout<R>(T, C, D, G, DOUT, NQ);
  const int TP = L.tp, DP = L.dp, SW = L.sw;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y, S = gridDim.x;
  const int cg = C / G, dv = D / G, og = DOUT / G;
  // this block's rows: a contiguous range of batch item b (row_ranges)
  const int n0 = (int)((long long)blockIdx.x * N / S);
  const int n1 = (int)((long long)(blockIdx.x + 1) * N / S);
  if (n0 >= n1) return;   // the whole block: no barrier is reached

  float* xs = smem + L.xs;
  float* as = smem + L.a;
  float* ps = smem + L.p;
  float* ms = smem + L.m;
  Tin* raw = reinterpret_cast<Tin*>(xs);
  fetch_group<Tin, R>(a, raw, b, n0, min(R, n1 - n0));

  // batch item b's constants, once per block: Ws and pes[b] of every query
  // (column g*nq + q in device memory), zero past G; b_in, b_m, out affine
  for (int i = tid; i < C * NQ * kMaxG; i += kGroupThreads) {
    const int g = i % kMaxG, cq = i / kMaxG, q = cq % NQ, c = cq / NQ;
    smem[L.ws + i] = g < G ? a.ws[(c * G + g) * NQ + q] : 0.f;
  }
  for (int i = tid; i < NQ * kMaxG * TP; i += kGroupThreads) {
    const int t = i % TP, qg = i / TP, g = qg % kMaxG, q = qg / kMaxG;
    smem[L.pes + i] = g < G && t < T ? a.pes[((size_t)b * G * NQ + g * NQ + q) * T + t] : 0.f;
  }
  for (int i = tid; i < D; i += kGroupThreads) smem[L.bin + i] = a.bin[i];
  for (int i = tid; i < DOUT; i += kGroupThreads) {
    smem[L.bm + i] = a.bm[i];
    smem[L.osc + i] = a.osc[i];
    smem[L.obi + i] = a.obi[i];
  }
  // tsc[b], tsh[b] stay in L2
  const bool tail = a.tsc != nullptr;
  const float* tsc = tail ? a.tsc + (size_t)b * T * C : nullptr;
  const float* tsh = tail ? a.tsh + (size_t)b * T * C : nullptr;
  const float* pe_b = a.pe + (size_t)b * T * D;
  const float cnt = (float)(T * cg);
  const int r_me = tid / TPR, i_me = tid % TPR;   // this thread's row and place in it

#pragma unroll 1
  for (int m0 = n0; m0 < n1; m0 += R) {
    const int rows = min(R, n1 - m0);
    cp_async_wait_all();
    __syncthreads();

    // 1. tail affine and GroupNorm over (T, C/G), once per row: thread (r,
    //    quad, eighth of T) holds channels 4 quad .. + 4 of row r at 8 steps
    //    in registers; per-channel sums (the eighths added in order through
    //    shared memory), the group mean, centered squares (two passes),
    //    normalized into the x tile. Rows past the range compute on zeros
    //    and store nothing.
    {
      const int gr = r_me, gq = i_me % LQ, part = i_me / LQ;
      const int gt0 = SP * part;
      const bool gn_on = 4 * gq < C;
      const int nt = min(SP, max(0, T - gt0));   // the thread's steps below T
      float* chs = smem + L.chs;                  // (8, R, C)
      float4 v[SP];
      float s[4] = {0.f, 0.f, 0.f, 0.f};
      if (gn_on) {
        const int nx = gr < rows ? nt : 0;       // ... that hold a row's data
        const Tin* rp = raw + (gt0 * R + gr) * C + 4 * gq;
#pragma unroll
        for (int i = 0; i < SP; ++i) {
          float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
          if (i < nx) {
            x = load4(rp + i * R * C);
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
      // the group's statistic for the thread's 4 channels from every part's
      // sums in chs: / cnt, or rsqrt(that / cnt + eps) with `rs`
      auto stat = [&](const float* part_sum, float* out, float eps, bool rs) {
        if (gn_on)
          *reinterpret_cast<float4*>(chs + (part * R + gr) * C + 4 * gq) =
              make_float4(part_sum[0], part_sum[1], part_sum[2], part_sum[3]);
        __syncthreads();
        if (gn_on) {
          int prev = -1;
          float val = 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int g0 = ((4 * gq + j) / cg) * cg;
            if (g0 != prev) {   // channels of one group share the value
              float t = 0.f;
#pragma unroll 1
              for (int k = 0; k < cg; ++k)
#pragma unroll
                for (int h = 0; h < kQueriesParts; ++h) t += chs[(h * R + gr) * C + g0 + k];
              val = rs ? rsqrtf(t / cnt + eps) : t / cnt;
              prev = g0;
            }
            out[j] = val;
          }
        }
        __syncthreads();
      };
      float mean[4] = {0.f, 0.f, 0.f, 0.f}, inv[4] = {0.f, 0.f, 0.f, 0.f};
      stat(s, mean, 0.f, false);
      float q[4] = {0.f, 0.f, 0.f, 0.f};
      if (gn_on) {
#pragma unroll
        for (int i = 0; i < SP; ++i) {
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
      stat(q, inv, a.eps, true);
      if (gn_on) {
        float* xr = xs + gr * TP * C;
#pragma unroll
        for (int i = 0; i < SP; ++i) {
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

#pragma unroll 1
    for (int q = 0; q < NQ; ++q) {
      // 2. scores and the masked softmax over T for query q: warp (r, w) owns
      //    row r's heads HPW * w .. + HPW, lanes t and t + 32, c in order; the
      //    attention is stored from here, coalesced over t.
      {
        const int r = warp / WPR, g0 = (warp % WPR) * HPW;
        if (g0 < G) {   // warp-uniform
          // lanes past the padded steps read a step they do not own
          const int t0 = lane < TP ? lane : 0, t1 = lane + 32 < TP ? lane + 32 : lane;
          const bool v0 = lane < T, v1 = lane + 32 < T;
          const float* xr = xs + r * TP * C;
          const float* wsq = smem + L.ws + q * kMaxG + g0;
          float s0[HPW], s1[HPW];
#pragma unroll
          for (int k = 0; k < HPW; ++k) s0[k] = s1[k] = 0.f;
#pragma unroll 2
          for (int c4 = 0; c4 < C / 4; ++c4) {
            const float4 xa = ld4(xr + xs_quad(t0, c4, C, SW));
            const float4 xb = ld4(xr + xs_quad(t1, c4, C, SW));
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float* w = wsq + (4 * c4 + i) * NQ * kMaxG;
              float wv[HPW];
              if constexpr (HPW == 4) {
                const float4 w4 = ld4(w);
                wv[0] = w4.x;
                wv[1] = w4.y;
                wv[2] = w4.z;
                wv[3] = w4.w;
              } else {
                const float2 w2 = *reinterpret_cast<const float2*>(w);
                wv[0] = w2.x;
                wv[1] = w2.y;
              }
              const float xv0 = at4(xa, i), xv1 = at4(xb, i);
#pragma unroll
              for (int k = 0; k < HPW; ++k) {
                s0[k] = fmaf(xv0, wv[k], s0[k]);
                s1[k] = fmaf(xv1, wv[k], s1[k]);
              }
            }
          }
          const int n = m0 + r;
          float* attn = (a.attn != nullptr && r < rows)
                            ? a.attn + ((size_t)b * N + n) * G * NQ * T : nullptr;
#pragma unroll
          for (int k = 0; k < HPW; ++k) {
            const int g = g0 + k;
            if (g < G) {   // uniform: the whole warp takes the shuffles
              const float* pes = smem + L.pes + (q * kMaxG + g) * TP;
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
                float* at = attn + (g * NQ + q) * T;
                if (v0) at[t0] = e0;
                if (v1) at[lane + 32] = e1;
              }
            }
          }
        }
      }
      __syncthreads();

      // 3. P = a @ xn, (G, C) per row: thread (r, channel quad, head pair) of
      //    a 2 x 4 tile of (g, c) in registers, t in order (the pad steps add
      //    0 * 0). After the last query the x tile is free, and the next
      //    group's x starts coming in.
      {
        const int r = r_me, cq = i_me % LQ, gp = i_me / LQ;
        const bool on = 4 * cq < C && 2 * gp < G;
        float p[2][4];
#pragma unroll
        for (int k = 0; k < 2; ++k)
#pragma unroll
          for (int j = 0; j < 4; ++j) p[k][j] = 0.f;
        if (on) {
          const float* xr = xs + r * TP * C;
          const float* ar[2];
#pragma unroll
          for (int k = 0; k < 2; ++k) ar[k] = as + (r * G + min(2 * gp + k, G - 1)) * TP;
#pragma unroll 1
          for (int t = 0; t < TP; t += 4) {
            float4 xv[4], av[2];
#pragma unroll
            for (int i = 0; i < 4; ++i) xv[i] = ld4(xr + xs_quad(t + i, cq, C, SW));
#pragma unroll
            for (int k = 0; k < 2; ++k) av[k] = ld4(ar[k] + t);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int k = 0; k < 2; ++k) {
                const float w = at4(av[k], i);
                p[k][0] = fmaf(w, xv[i].x, p[k][0]);
                p[k][1] = fmaf(w, xv[i].y, p[k][1]);
                p[k][2] = fmaf(w, xv[i].z, p[k][2]);
                p[k][3] = fmaf(w, xv[i].w, p[k][3]);
              }
          }
        }
        __syncthreads();   // after the last query the x tile is free from here
        if (q == NQ - 1 && m0 + R < n1)
          fetch_group<Tin, R>(a, raw, b, m0 + R, min(R, n1 - m0 - R));
        if (on) {
#pragma unroll
          for (int k = 0; k < 2; ++k)
            if (2 * gp + k < G)
              *reinterpret_cast<float4*>(ps + (r * G + 2 * gp + k) * C + 4 * cq) =
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
        float acc[R];
        const float b0 = half == 0 && on ? smem[L.bin + d] : 0.f;
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = b0;
        if (on) {
#pragma unroll 4
          for (int c = c0; c < c1; c += 4) {
            float w[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) w[i] = __ldg(a.win + (c + i) * D + d);
#pragma unroll
            for (int r = 0; r < R; ++r) {
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
            for (int r = 0; r < R; ++r) {
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
          for (int r = 0; r < R; ++r) smem[L.ot + r * DP + d] = acc[r];
        __syncthreads();
        if (on && half == 0)
#pragma unroll
          for (int r = 0; r < R; ++r) smem[L.o + r * DP + d] = acc[r] + smem[L.ot + r * DP + d];
      }
      __syncthreads();

      // 5. m[q] = relu(o @ W_m + b_m): thread (j, part of D) over the group's
      //    rows (group_mlp), into query q's (R, d_out) block of m.
      group_mlp<R, J>(a, smem, L, as, ms + q * R * DOUT);
    }  // queries

    // 6. out GroupNorm over G groups of d_out / G channels, each pooled over
    //    the nq queries (nq * d_out / G values), two-pass, then the affine:
    //    thread (r, j) for every query, in passes of J outputs.
    for (int j0 = 0; j0 < DOUT; j0 += J) {
      const int r = tid / J, j = j0 + tid % J;
      if (j < DOUT && r < rows) {
        const int g0 = (j / og) * og;
        const float cnt_o = (float)(og * NQ);
        float s = 0.f;
        for (int qq = 0; qq < NQ; ++qq)
          for (int i = 0; i < og; ++i) s += ms[(qq * R + r) * DOUT + g0 + i];
        const float mu = s / cnt_o;
        float ss = 0.f;
        for (int qq = 0; qq < NQ; ++qq)
          for (int i = 0; i < og; ++i) {
            const float dl = ms[(qq * R + r) * DOUT + g0 + i] - mu;
            ss = fmaf(dl, dl, ss);
          }
        const float rs = rsqrtf(ss / cnt_o + a.eps);
        Tin* out = static_cast<Tin*>(a.out) + ((size_t)b * N + m0 + r) * NQ * DOUT + j;
        const float sc = smem[L.osc + j], sh = smem[L.obi + j];
        for (int qq = 0; qq < NQ; ++qq)
          Vec<Tin>::store(out + qq * DOUT, fmaf((ms[(qq * R + r) * DOUT + j] - mu) * rs, sc, sh));
      }
    }
  }
}

template <typename Tin, int R>
cudaError_t launch_queries(const Args& a, int S, cudaStream_t stream) {
  const size_t bytes =
      (size_t)queries_layout<R>(a.T, a.C, a.D, a.G, a.DOUT, a.NQ).floats * sizeof(float);
  if (bytes > kSmemLimit || S < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(ltae_fused_queries_kernel<Tin, R>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return err;
  ltae_fused_queries_kernel<Tin, R><<<dim3(S, a.B), kGroupThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

// ---- every other shape: one row at a time, x streamed over T --------------

// The general kernel's workspace per block, in floats: in shared memory
// where it fits, else the block's slice of a scratch buffer in device
// memory. Per channel the GroupNorm's mean and 1/std and the partial sums of
// channel_sums; a chunk of normalized x (TC, C) and its scores (TC, G*nq);
// per (head, query) column the running max, sum and this chunk's rescale,
// P (G*nq, C); per (query, d) the PE term and o; m (nq, d_out); the out
// GroupNorm's mean and 1/std per head.
struct GenLayout {
  int tc;
  int mean, inv, red, xc, e, mx, sum, scl, p, epe, o, m, gst;
  int floats;
};

__host__ __device__ inline GenLayout gen_layout(int T, int C, int D, int G, int DOUT,
                                                int NQ) {
  GenLayout L{};
  int o = 0;
  auto take = [&](int n) { const int at = o; o += (n + 3) & ~3; return at; };
  const int GQ = G * NQ;
  L.tc = T < kGenChunk ? T : kGenChunk;
  L.mean = take(C);
  L.inv = take(C);
  L.red = take(C > kGenThreads ? C : kGenThreads);
  L.xc = take(L.tc * C);
  L.e = take(L.tc * GQ);
  L.mx = take(GQ);
  L.sum = take(GQ);
  L.scl = take(GQ);
  L.p = take(GQ * C);
  L.epe = take(NQ * D);
  L.o = take(NQ * D);
  L.m = take(NQ * DOUT);
  L.gst = take(2 * G);
  L.floats = o;
  return L;
}

__device__ __forceinline__ float ld_elem(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld_elem(const __nv_bfloat16* p) {
  return __uint_as_float((uint32_t)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
}

// x[b, t, n, c] in fp32, with the tail affine max(x * tsc + tsh, 0) applied.
template <typename Tin>
__device__ __forceinline__ float load_x(const Args& a, int b, int t, int n, int c) {
  const size_t bt = (size_t)b * a.T + t;
  float v = ld_elem(static_cast<const Tin*>(a.x) + (bt * a.N + n) * a.C + c);
  if (a.tsc != nullptr) v = fmaxf(fmaf(v, a.tsc[bt * a.C + c], a.tsh[bt * a.C + c]), 0.f);
  return v;
}

// The sums over t < T of f(t, c) for every channel c < C, into red[c]:
// thread (c, part) sums steps part, part + parts, ..., and the parts are
// added in order. Every thread of the block calls it; red must be free (a
// barrier after its last reads). Two barriers.
template <typename F>
__device__ void channel_sums(int T, int C, float* red, F f) {
  const int tid = threadIdx.x;
  if (C < kGenThreads) {
    const int parts = kGenThreads / C, c = tid % C, part = tid / C;
    if (part < parts) {
      float s = 0.f;
#pragma unroll 4
      for (int t = part; t < T; t += parts) s += f(t, c);
      red[part * C + c] = s;
    }
    __syncthreads();
    if (tid < C) {   // thread c alone reads slots (k, c) and writes (0, c)
      float s = 0.f;
      for (int k = 0; k < parts; ++k) s += red[k * C + tid];
      red[tid] = s;
    }
  } else {
    for (int c = tid; c < C; c += kGenThreads) {
      float s = 0.f;
#pragma unroll 4
      for (int t = 0; t < T; ++t) s += f(t, c);
      red[c] = s;
    }
  }
  __syncthreads();
}

// The total of channel c's GroupNorm group (its cg channels) in red.
__device__ __forceinline__ float group_total(const float* red, int c, int cg) {
  const int g0 = c / cg * cg;
  float s = 0.f;
  for (int k = 0; k < cg; ++k) s += red[g0 + k];
  return s;
}

template <typename Tin>
__global__ void __launch_bounds__(kGenThreads, kGenBlocksPerSm)
ltae_fused_general_kernel(const Args a, float* const scratch) {
  extern __shared__ __align__(16) float smem_general[];
  const int T = a.T, C = a.C, D = a.D, G = a.G, DOUT = a.DOUT, N = a.N, NQ = a.NQ;
  const int GQ = G * NQ, cg = C / G, dv = D / G, og = DOUT / G;
  const GenLayout L = gen_layout(T, C, D, G, DOUT, NQ);
  const int tid = threadIdx.x, b = blockIdx.y, S = gridDim.x;
  float* const w = scratch != nullptr
                       ? scratch + (size_t)(b * S + blockIdx.x) * L.floats : smem_general;
  float* __restrict__ const mean = w + L.mean;
  float* __restrict__ const inv = w + L.inv;
  float* __restrict__ const red = w + L.red;
  float* __restrict__ const xc = w + L.xc;
  float* __restrict__ const e = w + L.e;
  float* __restrict__ const mx = w + L.mx;
  float* __restrict__ const sum = w + L.sum;
  float* __restrict__ const scl = w + L.scl;
  float* __restrict__ const p = w + L.p;
  float* __restrict__ const epe = w + L.epe;
  float* __restrict__ const o = w + L.o;
  float* __restrict__ const m = w + L.m;
  float* __restrict__ const gst = w + L.gst;
  // this block's rows: a contiguous range of batch item b (row_ranges)
  const int n0 = (int)((long long)blockIdx.x * N / S);
  const int n1 = (int)((long long)(blockIdx.x + 1) * N / S);
  const float cnt = (float)T * cg;
  const float* pe_b = a.pe + (size_t)b * T * D;
  const float* pes_b = a.pes + (size_t)b * GQ * T;

  for (int n = n0; n < n1; ++n) {
    // 1. GroupNorm statistics over (T, C/G), two passes over x
    channel_sums(T, C, red, [&](int t, int c) { return load_x<Tin>(a, b, t, n, c); });
    for (int c = tid; c < C; c += kGenThreads) mean[c] = group_total(red, c, cg) / cnt;
    __syncthreads();
    channel_sums(T, C, red, [&](int t, int c) {
      const float dl = load_x<Tin>(a, b, t, n, c) - mean[c];
      return dl * dl;
    });
    for (int c = tid; c < C; c += kGenThreads)
      inv[c] = rsqrtf(group_total(red, c, cg) / cnt + a.eps);
    for (int i = tid; i < GQ; i += kGenThreads) {
      mx[i] = -CUDART_INF_F;
      sum[i] = 0.f;
    }
    for (int i = tid; i < GQ * C; i += kGenThreads) p[i] = 0.f;
    for (int i = tid; i < NQ * D; i += kGenThreads) epe[i] = 0.f;
    __syncthreads();

    // 2. chunks of TC steps: normalized x, scores, an online softmax
    float* attn = a.attn != nullptr ? a.attn + ((size_t)b * N + n) * GQ * T : nullptr;
    for (int t0 = 0; t0 < T; t0 += L.tc) {
      const int tc = min(L.tc, T - t0);
#pragma unroll 4
      for (int i = tid; i < tc * C; i += kGenThreads) {
        const int t = i / C, c = i - t * C;
        xc[i] = (load_x<Tin>(a, b, t0 + t, n, c) - mean[c]) * inv[c];
      }
      __syncthreads();
      // scores of every (step, column); column g*nq + q is head g's query q
      for (int i = tid; i < tc * GQ; i += kGenThreads) {
        const int t = i / GQ, col = i - t * GQ;
        const float* xt = xc + t * C;
        float s = 0.f;
#pragma unroll 4
        for (int c = 0; c < C; ++c) s = fmaf(xt[c], __ldg(a.ws + c * GQ + col), s);
        s += pes_b[col * T + t0 + t];
        e[i] = s;
        if (attn != nullptr) attn[col * T + t0 + t] = s;   // raw: normalized in step 5
      }
      __syncthreads();
      // the running max and sum per column; e becomes exp(s - max)
      for (int col = tid; col < GQ; col += kGenThreads) {
        float mc = mx[col];
        for (int t = 0; t < tc; ++t) mc = fmaxf(mc, e[t * GQ + col]);
        const float sc = expf(mx[col] - mc);   // 0 at the first chunk
        float sm = sum[col] * sc;
        for (int t = 0; t < tc; ++t) {
          const float v = expf(e[t * GQ + col] - mc);
          e[t * GQ + col] = v;
          sm += v;
        }
        mx[col] = mc;
        sum[col] = sm;
        scl[col] = sc;
      }
      __syncthreads();
      // P[col] and the PE term per (query, d), rescaled to the new max
      for (int i = tid; i < GQ * C; i += kGenThreads) {
        const int col = i / C, c = i - col * C;
        float acc = p[i] * scl[col];
#pragma unroll 4
        for (int t = 0; t < tc; ++t) acc = fmaf(e[t * GQ + col], xc[t * C + c], acc);
        p[i] = acc;
      }
      for (int i = tid; i < NQ * D; i += kGenThreads) {
        const int q = i / D, d = i - q * D, col = d / dv * NQ + q;
        float acc = epe[i] * scl[col];
#pragma unroll 4
        for (int t = 0; t < tc; ++t)
          acc = fmaf(e[t * GQ + col], __ldg(pe_b + (size_t)(t0 + t) * D + d), acc);
        epe[i] = acc;
      }
      __syncthreads();
    }

    // 3. o[q][d] = (P[col] . W_in[:, d] + PE term) / sum[col] + b_in[d], then
    //    m[q] = relu(o[q] @ W_m + b_m)
    for (int i = tid; i < NQ * D; i += kGenThreads) {
      const int q = i / D, d = i - q * D, col = d / dv * NQ + q;
      const float* pc = p + col * C;
      float acc = 0.f;
#pragma unroll 4
      for (int c = 0; c < C; ++c) acc = fmaf(pc[c], __ldg(a.win + (size_t)c * D + d), acc);
      o[i] = (acc + epe[i]) / sum[col] + a.bin[d];
    }
    __syncthreads();
    for (int i = tid; i < NQ * DOUT; i += kGenThreads) {
      const int q = i / DOUT, j = i - q * DOUT;
      const float* oq = o + q * D;
      float acc = a.bm[j];
#pragma unroll 4
      for (int d = 0; d < D; ++d) acc = fmaf(oq[d], __ldg(a.wm + (size_t)d * DOUT + j), acc);
      m[i] = fmaxf(acc, 0.f);
    }
    __syncthreads();

    // 4. out GroupNorm: head g pools its d_out/G channels over all queries
    for (int g = tid; g < G; g += kGenThreads) {
      const float cnt_o = (float)(NQ * og);
      float s = 0.f;
      for (int q = 0; q < NQ; ++q)
        for (int k = 0; k < og; ++k) s += m[q * DOUT + g * og + k];
      const float mu = s / cnt_o;
      float ss = 0.f;
      for (int q = 0; q < NQ; ++q)
        for (int k = 0; k < og; ++k) {
          const float dl = m[q * DOUT + g * og + k] - mu;
          ss = fmaf(dl, dl, ss);
        }
      gst[g] = mu;
      gst[G + g] = rsqrtf(ss / cnt_o + a.eps);
    }
    __syncthreads();
    Tin* out = static_cast<Tin*>(a.out) + ((size_t)b * N + n) * NQ * DOUT;
    for (int i = tid; i < NQ * DOUT; i += kGenThreads) {
      const int j = i % DOUT, g = j / og;
      Vec<Tin>::store(out + i, fmaf((m[i] - gst[g]) * gst[G + g], a.osc[j], a.obi[j]));
    }

    // 5. the attention, normalized in place: exp(s - max) / sum
    if (attn != nullptr)
      for (int i = tid; i < GQ * T; i += kGenThreads) {
        const int col = i / T;
        attn[i] = expf(attn[i] - mx[col]) / sum[col];
      }
    __syncthreads();
  }
}

template <typename Tin>
cudaError_t launch_general(const Args& a, int S, float* scratch, cudaStream_t stream) {
  const size_t bytes =
      (size_t)gen_layout(a.T, a.C, a.D, a.G, a.DOUT, a.NQ).floats * sizeof(float);
  const bool in_smem = bytes <= kSmemLimit;
  if (S < 1 || in_smem == (scratch != nullptr)) return cudaErrorInvalidValue;
  const size_t dyn = in_smem ? bytes : 0;
  cudaError_t err = cudaFuncSetAttribute(ltae_fused_general_kernel<Tin>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)dyn);
  if (err != cudaSuccess) return err;
  ltae_fused_general_kernel<Tin><<<dim3(S, a.B), kGenThreads, dyn, stream>>>(a, scratch);
  return cudaGetLastError();
}

// The routes of ops/ltae_fused.py::kernel_route, in ROUTES' order.
enum Route { kRouteGroup = 0, kRouteWide = 1, kRouteQueries = 2, kRouteGeneral = 3 };

// Whether the row-group kernels take the shape (ops/ltae_fused.py::kernel_takes).
bool row_groups_take(int T, int C, int D, int G, int DOUT, int NQ) {
  return T <= kMaxT && C <= kMaxC && C % 8 == 0 && G <= kMaxG && D <= kGroupMaxD &&
         DOUT <= kGroupMaxDout && NQ <= kMaxQ;
}

template <typename Tin>
cudaError_t launch_c(const Args& a, int route, int S, float* scratch, cudaStream_t stream) {
  const bool wide = a.C > kGroupMaxC;
  switch (route) {
    case kRouteGroup:
      return launch_group<Tin>(a, S, stream);
    case kRouteWide:
      return launch_wide<Tin>(a, S, stream);
    case kRouteQueries:
      return wide ? launch_queries<Tin, kQueriesWideRows>(a, S, stream)
                  : launch_queries<Tin, kQueriesNarrowRows>(a, S, stream);
    default:
      return launch_general<Tin>(a, S, scratch, stream);
  }
}

}  // namespace

// The general kernel's scratch floats per block: 0 where its workspace fits
// in shared memory, else the size of each block's slice of `scratch`.
extern "C" int ltae_fused_general_scratch_floats(int T, int C, int D, int G, int DOUT,
                                                 int NQ) {
  const int f = gen_layout(T, C, D, G, DOUT, NQ).floats;
  return (size_t)f * sizeof(float) <= kSmemLimit ? 0 : f;
}

// C entry for ctypes. Pointers are device pointers; tsc/tsh and attn may be
// null. `route` is ops/ltae_fused.py::kernel_route's choice (Route), and the
// entry refuses a route that does not take the shape. S is the blocks per
// batch item; `scratch`, of B * S * ltae_fused_general_scratch_floats(...)
// floats, is the general kernel's workspace where that is not 0, else null.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int ltae_fused_fwd(
    const void* x, int x_is_bf16, const void* pe, const void* win,
    const void* bin, const void* ws, const void* pes, const void* wm,
    const void* bm, const void* osc, const void* obi, const void* tsc,
    const void* tsh, void* out, void* attn, int B, int T, int N, int C, int D,
    int G, int DOUT, int NQ, int route, int S, void* scratch, float eps, void* stream) {
  if (B < 1 || N < 1 || T < 1 || C < 1 || G < 1 || NQ < 1 || S < 1 || C % G || D % G ||
      DOUT % G || D < G || DOUT < G || (tsc == nullptr) != (tsh == nullptr))
    return (int)cudaErrorInvalidValue;
  const bool rows = row_groups_take(T, C, D, G, DOUT, NQ);
  const bool wide = C > kGroupMaxC;
  const bool ok = route == kRouteGroup     ? rows && NQ == 1 && !wide
                  : route == kRouteWide    ? rows && NQ == 1 && wide
                  : route == kRouteQueries ? rows && NQ > 1
                  : route == kRouteGeneral;
  if (!ok || (route != kRouteGeneral && scratch != nullptr)) return (int)cudaErrorInvalidValue;
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
  float* sc = static_cast<float*>(scratch);
  return (int)(x_is_bf16 ? launch_c<__nv_bfloat16>(a, route, S, sc, s)
                         : launch_c<float>(a, route, S, sc, s));
}
