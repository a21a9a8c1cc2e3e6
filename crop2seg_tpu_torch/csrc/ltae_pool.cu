// Masked L-TAE attention pooling, training path, for NVIDIA Hopper (sm_90a):
// a forward kernel and a backward kernel, each in four variants (input fp32
// or bf16, untailed or tail mode), all from this one source.
//
// Replaces crop2seg_tpu/ops/ltae_pallas_train.py::ltae_pool and
// ::ltae_pool_tail: the forward `_run_fwd` / `_fwd_kernel` (pallas_call at
// ltae_pallas_train.py:457) and the backward `_run_bwd` / `_bwd_kernel`
// (pallas_call at :536), in their fp32 (`exact`) and bf16 modes and with or
// without the deferred conv tail. Wrapper, folds, the autograd Function and
// the plain PyTorch versions: crop2seg_tpu_torch/ops/ltae_pool.py.
//
// Per pixel row n of batch item b, over T steps, C channels, G heads of dv
// = D/G channels:
//   xf   = x, or in tail mode max(z * tsc[b, t] + tsh[b, t], 0)   (deferred
//          GroupNorm + ReLU of the producing conv; pads arrive with
//          tsc = tsh = 0, so their rows are exactly 0)
//   xhat = GroupNorm_G(xf) over (T, C/G), no affine (folded into W = win_f)
//   h    = xhat W + bpe[b]            bpe = bin_f + pe          (T, D), never built
//   s    = xhat Ws + pes[b]           Ws = W u, pes = bpe u + cs, -1e6 at pads
//   a    = softmax_T(s);  a_d = a * keep(seed, b, t, n, g) / (1 - p)
//   o[d] = sum_t a_d[t, g(d)] h[t, d] = P[g] . W[:, d] + sum_t a_d[t, g] bpe[t, d]
//          with P[g] = sum_t a_d[t, g] xhat[t]   (C-space pooling: h never exists)
// Backward, per row, with go = dL/do and Z[g, c] = sum_{d in g} W[c, d] go[d]:
//   p1[t, g] = xhat[t] . Z[g] + sum_{d in g} go[d] bpe[t, d]    (= dL/da_d)
//   ds       = a_d p1 - a sum_t (a_d p1)                      (softmax jacobian)
//   dxhat[t] = sum_g ds[t, g] Ws[:, g] + a_d[t, g] Z[g]
//   dxf      = inv (dxhat - mean_grp(dxhat) - xhat mean_grp(dxhat xhat))
//   dx       = dxf, or in tail mode, with live = dxf 1[z tsc + tsh > 0]:
//              dz = live tsc, and dtsc[b, t, c] += sum_rows live z,
//              dtsh[b, t, c] += sum_rows live
// and four sums over rows:
//   A[c, g] += sum_t xhat[t, c] ds[t, g]     F[c, d] += P[g(d), c] go[d]
//   Dsum[b, t, g] += ds[t, g]                E[b, t, d] += a_d[t, g(d)] go[d]
// from which the wrapper forms dW_f, db_f, du, dcs and dpe in small products.
// The TPU grid carries these sums (and dtsc, dtsh) in VMEM across its
// sequential steps. Here each persistent backward block sums its own range of
// rows on chip and writes one partial; ltae_pool_bwd_reduce then adds the
// partials block by block, in a fixed order, so every gradient is the same
// from run to run. No atomics.
//
// bf16: x (z), go, o and dx are bf16 in device memory (x and z read with
// 16-byte loads of 8 values); every sum, the GroupNorm statistics and the
// softmax are fp32, and xhat, a and the per-row scratch are fp32 in shared
// memory, so a bf16 variant differs from the fp32 one only by the roundings
// of its input and outputs. The backward's tail mode reads each element's raw
// z for its mask and dtsc back from the row's staging buffer.
//
// Dropout: keep(seed, b, t, n, g) = mix32(mix32(i) ^ mix32(seed)) >= thresh,
// i = ((b*T + t)*N + n)*G + g mod 2^32. The mask is a function of the element
// alone, so the forward and the backward (whatever their row blocks), every
// variant and the plain version (ops/ltae_pool.py::keep_mask) draw the same one.
//
// Bound on an H100 SXM (3.35 TB/s; 67 TFLOP/s fp32 on the CUDA cores, 989
// TFLOP/s bf16) at the train step's shape B=4, T=61, N=16384, C=64, D=256,
// G=16, each input read once and each output written once:
//   forward fp32:  x 1.02 GB read, o 67 MB written: 0.33 ms by bytes; ~0.34
//                  MFLOP per row (0.35 in tail mode), 22.4 GFLOP: 0.33 ms
//                  (0.35) by operations -> about even.
//   forward bf16:  x 0.51 GB, o 34 MB: 0.16 ms by bytes.
//   backward fp32: x, go read, dx written: 2.11 GB, 0.63 ms by bytes; ~0.94
//                  MFLOP per row (0.96 in tail mode), ~62 GFLOP: 0.92 ms
//                  (0.94) -> bound by operations.
//   backward bf16: 1.06 GB, 0.32 ms by bytes.
// (chip_smoke.py::pool_flops and ::pool_bytes count them.) Every variant
// computes in fp32 on the CUDA cores, so the fp32 operation bound (0.33-0.94
// ms) is the real floor of this design in bf16 too; the products on the
// tensor cores are later work.
//
// Forward, ltae_pool_fwd_group_kernel<Tin, Tail>. What held the earlier
// design (one 256-thread block of 8 rows, one warp per row, ~195 KiB of
// shared memory, so one block of 8 warps per SM; the block's whole x loaded
// before any compute; each row's GroupNorm, scores and pooling a chain of
// dependent shared-memory loads on one warp; W and bpe read from L2 by every
// block) at 4.3-5.0 ms a launch was latency with nothing to hide it, as for
// kernel 1's old design (csrc/ltae_fused_fwd.cu). This design follows
// ltae_fused_fwd.cu::ltae_fused_group_kernel without its MLP and out
// GroupNorm:
// - persistent blocks of 512 threads, S = SMs / B per batch item (one wave:
//   33 x 4 = 132 at B = 4; ops/ltae_pool.py::fwd_launch_shape), each
//   walking its contiguous range of rows (row_ranges) in groups of R = 8
//   rows, two warps a row;
// - Ws and pes[b] in shared memory once per block; bpe[b] (T, D) does not
//   fit beside the x tile and stays in L2;
// - the next group's raw x (16-byte cp.async, (T, R, C) as in device
//   memory) comes into the x tile as soon as P has read it, so it overlaps
//   the projection and the store of o; in tail mode tsc[b] and tsh[b] come
//   in the same way into the a region once the projection has read a_d;
// - GroupNorm: thread (row, channel quad, quarter of T) holds its values in
//   registers (16-byte loads), two-pass fp32, each channel's running sum
//   handed from quarter to quarter; scores: warp (row, half of the heads),
//   lanes t and t + 32, so the softmax (and the dropout) stays in the warp;
//   P: 4 x 4 (head, channel) register tiles; projection + PE term: thread
//   (d, half of the rows) over 4 rows, so each W and bpe element read from
//   L2 serves 4 rows from a register;
// - every sum runs in the earlier kernel's order (GroupNorm over t
//   then over the group's channels, scores over c, P over t, o over c then
//   t), so o is that kernel's bit for bit. Partial sums added at the end
//   (per quarter of T, or the projection's c and t halves) gave o as close
//   to fp64 but other roundings, and the whole-model gradient check in
//   chip_smoke.py, which a change of o by a few ulp moves, then failed
//   (PERF.md, section 6);
// - the x tile's channel quads are swizzled by t (xs_quad), so that the
//   16-byte shared loads of the scores and P are free of bank conflicts.
// Shared memory at T = C = 64, G = 16: the x tile 128 KiB, a_d 32 KiB, P 32
// KiB, Ws, pes and the GroupNorm's channel sums 12 KiB: 204 KiB of the 227.
// Limit D <= 256. Measured in PERF.md, section 6;
// scripts/split_ltae_fused_steps.py --kernel pool_fwd splits its time by
// step.
//
// Routes (ops/ltae_pool.py::kernel_takes): the two kernels below,
// ltae_pool_fwd_group_kernel and ltae_pool_bwd_kernel, take T <= 64, C <= 64
// with C % 8 == 0, G <= 16 and D <= 256 (TimeUNet's training path); every
// other shape at which the L-TAE is defined (G dividing C and D; T > 64
// above all) takes the general pair at the end of this file, with the same
// hash dropout on the same (b, t, n, g) index, so the same mask. The
// general forward, written to be right at any size rather than fast, runs
// one block of 256 threads per row at a time, S blocks per batch item (four
// an SM), x read from device memory in passes over T with an online softmax
// (a running max and sum per head, P and the bpe term rescaled as chunks of
// 32 steps arrive); it saves each row's GroupNorm statistics and softmax
// max and sum, which its backward takes. Its workspace lives in shared
// memory where it fits, else in a scratch buffer in device memory
// (ltae_pool_general_scratch_floats).
//
// The general backward, ltae_pool_bwd_general_kernel<Tin, Tail>. What held
// its first design (one row per 256-thread block at a time, x read from
// device memory three times, every row's E and F added into the block's
// partial sums in device memory, ~50 ms at T = 128, B = 4, TimeUNet's
// width) was latency: every pass alike slow (PERF.md, section 6). This
// design follows the row-group kernels:
// - persistent blocks of 512 threads, one an SM (S = SMs / B per batch
//   item), each walking its rows in groups of R <= 4, R from the plan
//   (gb_plan: the group's x resident in shared memory where that fits at
//   some R, else streamed; then the most rows), Ws once per block, Z and the
//   PE term of p1 once per group from W and bpe in L2, each element serving
//   the group's rows;
// - x arrives in chunks of 32 steps by 16-byte cp.async behind the compute;
//   with the group's x resident, the GroupNorm-backward sums and dx read it
//   from shared memory (x leaves device memory once), else the chunks
//   stream again, through two slots;
// - F sums on chip for the block's life (registers of the 512 threads
//   where C * D <= 16384, as kernel 3 keeps its sums), E and Dsum once a
//   group, A once a chunk, dtsc and dtsh once a chunk over the group's rows:
//   into the block's partial sums, which ltae_pool_bwd_reduce adds in a
//   fixed order, so gradients are the same from run to run;
// - the hot steps are register tiles: a thread takes four heads of a (row,
//   step) for the scores and p1 (Ws and Z rows as float4), four heads of a
//   (row, channel) for P and A, and a channel's Ws and Z of 16 heads in
//   registers for dxhat, over 4 steps of each row of the chunk.
// Where even R = 1 does not fit (T = 2000 at G = 16), the workspace is a
// scratch buffer in device memory, read and written through the same code.
// PERF.md, section 6, has the times of both.
//
// Backward: persistent blocks of 512 threads (16 warps), S = SMs / B per batch
// item (one wave: 33 x 4 = 132 at B = 4), each walking a contiguous range of
// rows (ops/ltae_pool.py::row_ranges). What bounded the earlier design (one
// warp per row, 4 rows per block, 4 warps per SM, W and bpe fetched from L2
// by every block, sums added with 0.56-0.68 G atomics a launch) was latency
// with nothing to hide it: 28.5-31.6 ms. The atomics alone cost nothing
// measurable (PERF.md, section 6). This design:
// - W (C, D+1), bpe[b] (T, D+1), Ws, pes[b] and in tail mode tsc[b], tsh[b]
//   are loaded into shared memory once per block (D <= 256: <= 225 KiB in
//   all at T = C = 64);
// - cp.async brings row n + 1's x (T, C) while row n computes;
// - warp g owns head g: GroupNorm group g, Z[g, :] and q[:, g], the scores
//   and p1 of head g in one pass over xhat (float4 reads), its softmax and
//   jacobian inside the warp, then P[g, :] and xhat^T ds[:, g]; the element
//   steps (dxhat = ds Ws^T + a_d Z, the GroupNorm backward, dx) give thread
//   (tg, c) channel c at t = tg, tg + 512 / C, ...;
// - the sums stay on chip until the block's rows are done: F[:, d in g] and
//   E[:, d in g] in warp g's registers (2 x 16 + 2 x 16 a lane: the rank-1
//   updates are local to the warp), A and Dsum in warp g's, dtsc and dtsh in
//   the registers of the thread that owns the element.
//   Heads of dv > 16 channels take ceil(dv / 16) passes over the rows, the
//   first of which also computes dx and the other sums.
// 128 registers a thread (the tail variants spill a little); the hot loops
// stay rolled (`#pragma unroll 1` / `2`): the smaller code ran ~4 % faster.
// A row takes 14-18 us of a block (6.6-9.0 ms a launch at B = 4): 7-10x the
// fp32 operation bound (0.92-0.95 ms), with six block barriers a row;
// measured in PERF.md, section 6.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kMaxT = 64;      // fast pair: lanes own t and t + 32
constexpr int kMaxC = 64;      // lanes own c and c + 32
constexpr int kMaxG = 16;      // per-head accumulators held in registers
constexpr int kMaxD = 256;     // backward: W and bpe[b] held in shared memory
constexpr int kFwdRows = 8;    // forward: rows per group
constexpr int kFwdThreads = 512;  // forward: 16 warps, two per row of a group
constexpr int kFwdMaxD = kFwdThreads / 2;  // forward: a thread per (d, half)
constexpr int kBwdThreads = 512;  // backward: 16 warps, warp g owns head g
constexpr int kJ = 16;         // backward: a head's d channels per pass in registers
constexpr int kMaxTPer = kMaxT / (kBwdThreads / kMaxC);  // t per thread, C-parallel steps
constexpr size_t kSmemLimit = 232448;  // 227 KB, the most a block may use
constexpr int kGenThreads = 256;  // the general forward: threads a block
constexpr int kGenBlocksPerSm = 4;  // the general forward: resident blocks an SM (latency)
constexpr int kGenChunk = 32;     // the general pair: steps of x on chip at a time
constexpr int kGbThreads = 512;   // the general backward: 16 warps, one block an SM
constexpr int kGbMaxRows = 4;     // the general backward: rows a group at most
constexpr int kGbHeadRegs = 16;   // the general backward: heads of Ws and Z in registers
constexpr int kGbFRegs = 32;      // the general backward: F in registers, C * D <= 16384
constexpr int kGbParts = 8;       // the general backward: a chunk's steps split in 8 parts
constexpr int kLoads = 8;         // the general backward: device-memory loads in flight a thread

struct Args {
  const void* x;      // (B, T, N, C) x's type: the input, in tail mode the raw z
  const void* go;     // (B, N, D) x's type, backward only
  const float* tsc;   // (B, T, C), tail mode only
  const float* tsh;   // (B, T, C), tail mode only
  const float* win;   // (C, D)
  const float* ws;    // (C, G)
  const float* pes;   // (B, G, T)
  const float* bpe;   // (B, T, D)
  void* o;            // (B, N, D) x's type, forward
  void* dx;           // (B, T, N, C) x's type, backward
  float* acc_a;       // (C, G)
  float* acc_f;       // (C, D)
  float* dsum;        // (B, T, G)
  float* acc_e;       // (B, T, D)
  float* dtsc;        // (B, T, C), tail-mode backward
  float* dtsh;        // (B, T, C), tail-mode backward
  int B, T, N, C, D, G;
  uint32_t seed_mix, thresh;
  float scale, eps;
};

// Loads and stores of the input type, widened to / narrowed from fp32.
template <typename Tin> struct Io;

template <> struct Io<float> {
  __device__ static float load(const float* p) { return __ldg(p); }
  // four consecutive values from shared memory
  __device__ static float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
  __device__ static void store(float* p, float v) { *p = v; }
};

template <> struct Io<__nv_bfloat16> {
  __device__ static float load(const __nv_bfloat16* p) {
    return __uint_as_float(
        (uint32_t)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
  }
  __device__ static float4 load4(const __nv_bfloat16* p) {
    const uint2 r = *reinterpret_cast<const uint2*>(p);   // element 2i in the low half
    return make_float4(__uint_as_float(r.x << 16), __uint_as_float(r.x & 0xffff0000u),
                       __uint_as_float(r.y << 16), __uint_as_float(r.y & 0xffff0000u));
  }
  __device__ static void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
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

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x21f0aaadu;
  x ^= x >> 15;
  x *= 0x735a2d97u;
  x ^= x >> 15;
  return x;
}

// Dropout factor of element (b, t, n, g): scale if kept, else 0.
__device__ __forceinline__ float keep_scale(const Args& a, int b, int t, int n, int g) {
  if (a.thresh == 0u) return 1.f;   // drop_p == 0
  const uint32_t i = (((uint32_t)(b * a.T + t)) * (uint32_t)a.N + (uint32_t)n) *
                         (uint32_t)a.G + (uint32_t)g;
  return mix32(mix32(i) ^ a.seed_mix) >= a.thresh ? a.scale : 0.f;
}

// The tail's pre-activation z * tsc + tsh: one expression for the forward's
// max(., 0) and the backward's mask, rounded after the product and after the
// sum (no fused multiply-add), as PyTorch's separate multiply and add round
// it in the plain version, so the ReLU masks of the kernels and of the plain
// version agree bit for bit and no element's gradient flips between them.
__device__ __forceinline__ float tail_pre(float z, float sc, float sh) {
  return __fadd_rn(__fmul_rn(z, sc), sh);
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

// ---- forward: persistent row groups -----------------------------------------

// Shared memory of the forward block, in floats. Regions start on 16 bytes.
// The x tile holds (R, TP, C) fp32 with its channel quads swizzled by t
// (xs_quad), and from the end of P to the next GroupNorm the next group's raw
// x in x's type, (T, R, C) as in device memory. The a region holds a_d (R, G,
// TP) until the projection, then in tail mode tsc[b] and tsh[b] (T, C) each,
// for the next GroupNorm.
struct FwdLayout {
  int tp, sw;          // T rounded up to 4; the swizzle mask of quads
  int xs, a, p, ws, pes, chs;
  int floats;
};

__host__ __device__ inline FwdLayout fwd_layout(int T, int C, int G) {
  FwdLayout L;
  int o = 0;
  auto take = [&](int n) { const int at = o; o += (n + 3) & ~3; return at; };
  L.tp = (T + 3) & ~3;
  const int quads = C / 4, low = quads & -quads;   // C % 8 == 0: quads even
  L.sw = (low < 8 ? low : 8) - 1;
  L.xs = take(kFwdRows * L.tp * C);
  L.a = take(kFwdRows * G * L.tp > 2 * T * C ? kFwdRows * G * L.tp : 2 * T * C);
  L.p = take(kFwdRows * G * C);           // P (R, G, C)
  L.ws = take(C * kMaxG);                 // Ws (C, G), zero pad heads up to 16
  L.pes = take(kMaxG * L.tp);             // pes[b] (G, TP)
  L.chs = take(2 * kFwdRows * C);         // GroupNorm: the relay, the channel sums
  L.floats = o;
  return L;
}

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

// Start copying the raw x of rows [m0, m0 + rows) of batch item b, all T,
// into raw as (T, R, C) in x's type: for each t the rows are contiguous in
// device memory, so the copy is 16-byte vectors throughout.
template <typename Tin>
__device__ void fetch_group(const Args& a, Tin* raw, int b, int m0, int rows) {
  constexpr int V = 16 / sizeof(Tin);
  const Tin* x = static_cast<const Tin*>(a.x);
  const int C = a.C, per_t = rows * C / V;   // C % 8 == 0: whole vectors
#pragma unroll 1
  for (int i = threadIdx.x; i < a.T * per_t; i += kFwdThreads) {
    const int t = i / per_t, e = (i - t * per_t) * V;
    cp_async16(raw + t * kFwdRows * C + e, x + ((size_t)(b * a.T + t) * a.N + m0) * C + e);
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
  for (int i = 4 * threadIdx.x; i < n; i += 4 * kFwdThreads) {
    cp_async16(ts + i, sc + i);
    cp_async16(ts + n + i, sh + i);
  }
  cp_async_commit();
}

template <typename Tin, bool Tail>
__global__ void __launch_bounds__(kFwdThreads, 1)
ltae_pool_fwd_group_kernel(const Args a) {
  extern __shared__ __align__(16) float smem_fwd[];
  float* const smem = smem_fwd;
  const int T = a.T, C = a.C, D = a.D, G = a.G, N = a.N;
  const FwdLayout L = fwd_layout(T, C, G);
  const int TP = L.tp, SW = L.sw;
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
  fetch_group<Tin>(a, raw, b, n0, min(kFwdRows, n1 - n0));
  if constexpr (Tail) fetch_tail(a, as, b);

  // ---- batch item b's constants, once per block ----------------------------
  for (int i = tid; i < C * kMaxG; i += kFwdThreads) {
    const int c = i / kMaxG, g = i - c * kMaxG;
    smem[L.ws + i] = g < G ? a.ws[c * G + g] : 0.f;
  }
  for (int i = tid; i < G * T; i += kFwdThreads) {
    const int g = i / T, t = i - g * T;
    smem[L.pes + g * TP + t] = a.pes[(size_t)b * G * T + i];
  }
  const float* tsc = as;   // tsc[b], tsh[b] as fetch_tail lays them out
  const float* tsh = as + T * C;
  const float* bpe = a.bpe + (size_t)b * T * D;
  const float cnt = (float)(T * cg);

#pragma unroll 1
  for (int m0 = n0; m0 < n1; m0 += kFwdRows) {
    const int rows = min(kFwdRows, n1 - m0);
    cp_async_wait_all();
    __syncthreads();

    // 1. tail affine and GroupNorm over (T, C/G), two-pass fp32: thread (r,
    //    quad, quarter) holds channels 4 quad .. + 4 of row r at 16 steps in
    //    registers. Each channel's sum runs over t in order, as the earlier
    //    one-warp-per-row kernel summed it (so o is that kernel's bit for
    //    bit): quarter 0 starts it, and each quarter hands its running sums
    //    to the next (a shuffle within the row's first warp, shared memory to
    //    its second); then the group's channels in order. Normalized into the
    //    x tile. Rows past the range compute on zeros and store nothing.
    {
      const int gr = warp >> 1, gq = lane & 15, gh = warp & 1, hi = lane >> 4;
      const int gt0 = 16 * (2 * gh + hi);
      const bool gn_on = 4 * gq < C;
      const int nt = min(16, max(0, T - gt0));   // the thread's steps below T
      float* relay = smem + L.chs;                // (R, C): quarter 1's running sums
      float* sums = relay + kFwdRows * C;         // (R, C): the channel sums
      float4 v[16];
      if (gn_on) {
        const int nx = gr < rows ? nt : 0;        // ... that hold a row's data
        const Tin* rp = raw + (gt0 * kFwdRows + gr) * C + 4 * gq;
        const float* scp = tsc + gt0 * C + 4 * gq;
        const float* shp = tsh + gt0 * C + 4 * gq;
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
          if (i < nx) {
            x = Io<Tin>::load4(rp + i * kFwdRows * C);
            if constexpr (Tail) {
              const float4 sc = ld4(scp + i * C), sh = ld4(shp + i * C);
              x = make_float4(fmaxf(tail_pre(x.x, sc.x, sh.x), 0.f),
                              fmaxf(tail_pre(x.y, sc.y, sh.y), 0.f),
                              fmaxf(tail_pre(x.z, sc.z, sh.z), 0.f),
                              fmaxf(tail_pre(x.w, sc.w, sh.w), 0.f));
            }
          }
          v[i] = x;
        }
      }
      // One pass of the relay: acc[j] continues channel 4 gq + j's running
      // value over this thread's steps with step(acc, x); the result of the
      // last quarter lands in sums. Every thread of the block calls it.
      auto relay_pass = [&](float* acc, auto&& step) {
        auto run = [&]() {
#pragma unroll
          for (int i = 0; i < 16; ++i)
            if (i < nt) step(acc, v[i]);
        };
        const int at = gr * C + 4 * gq;
        if (gh == 1 && hi == 0 && gn_on)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[j] = relay[at + j];
        if (hi == 0) run();
#pragma unroll
        for (int j = 0; j < 4; ++j) {   // the warp's low half to its high half
          const float o = __shfl_xor_sync(0xffffffffu, acc[j], 16);
          if (hi == 1) acc[j] = o;
        }
        if (hi == 1) run();
        if (hi == 1 && gn_on)
#pragma unroll
          for (int j = 0; j < 4; ++j) (gh == 0 ? relay : sums)[at + j] = acc[j];
      };
      // quarters 0-1 in the row's first warp, then 2-3 in its second
      auto relayed = [&](float* acc, auto&& step) {
        if (gh == 0) relay_pass(acc, step);
        __syncthreads();
        if (gh == 1) relay_pass(acc, step);
        __syncthreads();
      };
      // the group's cg channel values from sums, in order from 0
      auto group_total = [&](int j) {
        const int g0 = ((4 * gq + j) / cg) * cg;
        float t = 0.f;
#pragma unroll 1
        for (int k = 0; k < cg; ++k) t += sums[gr * C + g0 + k];
        return t;
      };
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      relayed(acc, [](float* a, const float4& x) {
        a[0] += x.x;
        a[1] += x.y;
        a[2] += x.z;
        a[3] += x.w;
      });
      float mean[4] = {0.f, 0.f, 0.f, 0.f};
      if (gn_on)
#pragma unroll
        for (int j = 0; j < 4; ++j) mean[j] = group_total(j) / cnt;
      float q[4] = {0.f, 0.f, 0.f, 0.f};
      relayed(q, [&](float* a, const float4& x) {
        const float d0 = x.x - mean[0], d1 = x.y - mean[1];
        const float d2 = x.z - mean[2], d3 = x.w - mean[3];
        a[0] = fmaf(d0, d0, a[0]);
        a[1] = fmaf(d1, d1, a[1]);
        a[2] = fmaf(d2, d2, a[2]);
        a[3] = fmaf(d3, d3, a[3]);
      });
      if (gn_on) {
        float inv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) inv[j] = rsqrtf(group_total(j) / cnt + a.eps);
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

    // 2. scores and the masked softmax over T, then dropout: warp (r, half)
    //    owns row r's heads 8 * half .. + 8, lanes t and t + 32; c in order.
    //    a_d = a * keep(seed, b, t, n, g) / (1 - p), 0 on the pad steps.
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
            if (lane < TP) ar[lane] = v0 ? e0 * keep_scale(a, b, lane, n, g) : 0.f;
            if (lane + 32 < TP) ar[lane + 32] = v1 ? e1 * keep_scale(a, b, lane + 32, n, g) : 0.f;
          }
        }
      }
    }
    __syncthreads();

    // 3. P = a_d @ xhat, (G, C) per row: warp (r, half), lane (c quad, g
    //    quad); a 4 x 4 tile of (g, c) in registers, t in order (the pad
    //    steps add 0 * 0). Written once the x tile is free, which also lets
    //    the next group's x start coming in.
    {
      const int r = warp >> 1;
      const int cq = lane & 15, gq4 = (lane >> 4) + 2 * (warp & 1);
      const bool on = 4 * cq < C && 4 * gq4 < G;
      float p[4][4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int j = 0; j < 4; ++j) p[k][j] = 0.f;
      if (on) {
        const float* xr = xs + r * TP * C;
        const float* ar[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) ar[k] = as + (r * G + min(4 * gq4 + k, G - 1)) * TP;
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
      if (m0 + kFwdRows < n1)
        fetch_group<Tin>(a, raw, b, m0 + kFwdRows, min(kFwdRows, n1 - m0 - kFwdRows));
      if (on) {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (4 * gq4 + k < G)
            *reinterpret_cast<float4*>(ps + (r * G + 4 * gq4 + k) * C + 4 * cq) =
                make_float4(p[k][0], p[k][1], p[k][2], p[k][3]);
      }
    }
    __syncthreads();

    // 4. o[d] = P[g(d)] . W[:, d] + sum_t a_d[t, g(d)] bpe[t, d], one chain
    //    per (row, d), c then t, as the earlier kernel summed it:
    //    thread (d, half of the rows) over the half's 4 rows, so each W / bpe
    //    element read from L2 serves 4 rows; o is stored in x's type.
    {
      constexpr int kHalf = kFwdRows / 2;
      const int d = tid & (kFwdMaxD - 1), r0 = (tid / kFwdMaxD) * kHalf;
      const bool on = d < D;
      const int g = on ? d / dv : 0;
      float acc[kHalf];
#pragma unroll
      for (int r = 0; r < kHalf; ++r) acc[r] = 0.f;
      if (on) {
#pragma unroll 4
        for (int c = 0; c < C; c += 4) {
          float w[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) w[i] = __ldg(a.win + (c + i) * D + d);
#pragma unroll
          for (int r = 0; r < kHalf; ++r) {
            const float4 pv = ld4(ps + ((r0 + r) * G + g) * C + c);
            acc[r] = fmaf(pv.x, w[0], acc[r]);
            acc[r] = fmaf(pv.y, w[1], acc[r]);
            acc[r] = fmaf(pv.z, w[2], acc[r]);
            acc[r] = fmaf(pv.w, w[3], acc[r]);
          }
        }
#pragma unroll 4
        for (int t = 0; t < TP; t += 4) {   // the pad steps add 0 * 0
          float w[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) w[i] = t + i < T ? __ldg(bpe + (t + i) * D + d) : 0.f;
#pragma unroll
          for (int r = 0; r < kHalf; ++r) {
            const float4 av = ld4(as + ((r0 + r) * G + g) * TP + t);
            acc[r] = fmaf(av.x, w[0], acc[r]);
            acc[r] = fmaf(av.y, w[1], acc[r]);
            acc[r] = fmaf(av.z, w[2], acc[r]);
            acc[r] = fmaf(av.w, w[3], acc[r]);
          }
        }
      }
      __syncthreads();   // a_d is read: the a region is free
      if (Tail && m0 + kFwdRows < n1) fetch_tail(a, as, b);
      if (on) {
        Tin* orow = static_cast<Tin*>(a.o) + ((size_t)b * N + m0 + r0) * D + d;
#pragma unroll
        for (int r = 0; r < kHalf; ++r)
          if (r0 + r < rows) Io<Tin>::store(orow + (size_t)r * D, acc[r]);
      }
    }
  }
}

// ---- backward --------------------------------------------------------------

// Shared memory of the backward block, in floats: one batch item's weights,
// loaded once, and one row's working set (module note). Regions start on 16
// bytes; xhat and Z rows have a stride of C + 4 for float4 reads.
struct BwdLayout {
  int wp, xp;                  // row strides of W / bpe (D + 1: banks) and of xhat, Z
  int raw, w, bpe, wst, wscg, pes, tsc, tsh, xh, z, dsad, go, inv, gs, red;
  int floats;
};

__host__ __device__ inline BwdLayout bwd_layout(int T, int C, int D, int G, bool tail,
                                                int elem_bytes) {
  BwdLayout L;
  int o = 0;
  auto take = [&](int n) { const int at = o; o += (n + 3) & ~3; return at; };
  L.wp = D + 1;
  L.xp = C + 4;
  L.raw = take(T * C * elem_bytes / 4);   // row n + 1's x, filled by cp.async
  L.w = take(C * L.wp);                   // W (C, D)
  L.bpe = take(T * L.wp);                 // bpe[b] (T, D)
  L.wst = take(G * C);                    // Ws^T (G, C)
  const int ge = (G + 1) & ~1;            // heads rounded up to pairs
  L.wscg = take(C * (ge + 2));            // Ws (C, G), a zero pad head (+2: banks)
  L.pes = take(G * T);                    // pes[b] (G, T)
  L.tsc = take(tail ? T * C : 0);         // tsc[b], tsh[b] (T, C)
  L.tsh = take(tail ? T * C : 0);
  L.xh = take(T * L.xp);                  // xhat (T, C)
  L.z = take(ge * L.xp);                  // Z (G, C), a zero pad head
  L.dsad = take(2 * T * (ge + 2));        // (ds, a_d) pairs (T, G), a zero pad head
  L.go = take(D);
  L.inv = take(G);                        // the GroupNorm's 1/std per group
  L.gs = take(2 * G);                     // GroupNorm backward group means
  L.red = take(2 * kBwdThreads);          // their partial sums
  L.floats = o;
  return L;
}

// Floats of one block's partial sums: A (C, G), F (C, D), then those of its
// batch item, Dsum (T, G), E (T, D) and in tail mode dtsc, dtsh (T, C).
__host__ __device__ inline int bwd_shared_floats(int C, int D, int G) {
  return C * G + C * D;
}

__host__ __device__ inline int bwd_item_floats(int T, int C, int D, int G, bool tail) {
  return T * G + T * D + (tail ? 2 * T * C : 0);
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// Start copying row n of batch item b, (T, C) in x's type, into raw.
template <typename Tin>
__device__ void fetch_row(const Args& a, float* raw, int b, int n) {
  constexpr int V = 16 / sizeof(Tin);
  const Tin* x = static_cast<const Tin*>(a.x);
  Tin* dst = reinterpret_cast<Tin*>(raw);
  const int C = a.C, nvec = a.T * C / V;   // C % 8 == 0: no vector straddles t
#pragma unroll 1
  for (int i = threadIdx.x; i < nvec; i += kBwdThreads) {
    const int e = i * V, t = e / C;
    cp_async16(dst + e, x + ((size_t)(b * a.T + t) * a.N + n) * C + (e - t * C));
  }
  cp_async_commit();
}

template <typename Tin>
__device__ __forceinline__ float load_go(const Args& a, int b, int n) {
  return (int)threadIdx.x < a.D
             ? Io<Tin>::load(static_cast<const Tin*>(a.go) + ((size_t)b * a.N + n) * a.D +
                             threadIdx.x)
             : 0.f;
}

template <typename Tin, bool Tail>
__global__ void __launch_bounds__(kBwdThreads, 1)
ltae_pool_bwd_kernel(const Args a, float* const part) {
  extern __shared__ __align__(16) float smem[];
  const int T = a.T, C = a.C, D = a.D, G = a.G, N = a.N;
  const int dv = D / G, cg = C / G;
  const int tid = threadIdx.x, lane = tid & 31, g = tid >> 5;
  const int b = blockIdx.y, S = gridDim.x;
  // this block's rows: a contiguous range of batch item b
  const int n0 = (int)((long long)blockIdx.x * N / S);
  const int n1 = (int)((long long)(blockIdx.x + 1) * N / S);
  const BwdLayout L = bwd_layout(T, C, D, G, Tail, sizeof(Tin));
  float* raw = smem + L.raw;
  float* w_s = smem + L.w;
  float* bpe_s = smem + L.bpe;
  float* wst = smem + L.wst;
  float* wscg = smem + L.wscg;
  float* pes_s = smem + L.pes;
  float* tsc_s = smem + L.tsc;
  float* tsh_s = smem + L.tsh;
  float* xh = smem + L.xh;
  float* z_s = smem + L.z;
  float2* dsad = reinterpret_cast<float2*>(smem + L.dsad);
  float* go_s = smem + L.go;
  float* inv_s = smem + L.inv;
  float* gs = smem + L.gs;
  float* red = smem + L.red;
  const int wp = L.wp, xp = L.xp, GE = (G + 1) & ~1, WS = GE + 2;
  const int DS = GE + 2;   // dsad's row stride in pairs (+2: banks)

  // ---- the weights, once per block -----------------------------------------
  for (int i = tid; i < C * D; i += kBwdThreads) {
    const int c = i / D;
    w_s[c * wp + i - c * D] = a.win[i];
  }
  for (int i = tid; i < T * D; i += kBwdThreads) {
    const int t = i / D;
    bpe_s[t * wp + i - t * D] = a.bpe[(size_t)b * T * D + i];
  }
  for (int i = tid; i < C * G; i += kBwdThreads) {
    const int c = i / G, h = i - c * G;
    wst[h * C + c] = wscg[c * WS + h] = a.ws[i];
  }
  if (G < GE) {   // the pad head adds zeros in the element steps
    for (int i = tid; i < C; i += kBwdThreads) wscg[i * WS + G] = z_s[G * xp + i] = 0.f;
    for (int t = tid; t < T; t += kBwdThreads) dsad[t * DS + G] = make_float2(0.f, 0.f);
  }
  for (int i = tid; i < G * T; i += kBwdThreads) pes_s[i] = a.pes[(size_t)b * G * T + i];
  if constexpr (Tail) {
    for (int i = tid; i < T * C; i += kBwdThreads) {
      tsc_s[i] = a.tsc[(size_t)b * T * C + i];
      tsh_s[i] = a.tsh[(size_t)b * T * C + i];
    }
  }

  // Head steps: warp g owns head g (and GroupNorm group g); lanes own t0, t1
  // or c0, c1. Element steps: thread (tg, cc) owns channel cc at t = tg,
  // tg + ntg, ... (at most kMaxTPer of them; C <= 64 so ntg >= 8).
  const bool head = g < G;
  const int t0 = lane, t1 = lane + 32, c0 = lane, c1 = lane + 32;
  const bool v0 = t0 < T, v1 = t1 < T, cv0 = c0 < C, cv1 = c1 < C;
  const int ntg = kBwdThreads / C, cc = tid % C, tg = tid / C;
  const bool cthread = tg < ntg;
  const float cnt = (float)(T * cg);
  const int gn_t = lane / cg, gn_j = lane % cg, gn_dt = 32 / cg, gn_dj = 32 % cg;
  const int cq = 2 * lane;   // P, A and F: lanes own channels cq, cq + 1
  const bool cqv = cq < C;

  // per-block sums, kept in registers until the block's rows are done
  float dsum0 = 0.f, dsum1 = 0.f, acca0 = 0.f, acca1 = 0.f;
  float dtsc_r[Tail ? kMaxTPer : 1], dtsh_r[Tail ? kMaxTPer : 1];
#pragma unroll
  for (int k = 0; k < (Tail ? kMaxTPer : 1); ++k) dtsc_r[k] = dtsh_r[k] = 0.f;
  float* const part_blk = part + (size_t)(b * S + blockIdx.x) *
                                     (bwd_shared_floats(C, D, G) + bwd_item_floats(T, C, D, G, Tail));

  // F and E hold kJ of a head's dv channels; wider heads take more passes over
  // the rows, and only the first pass computes dx and the other sums.
  for (int j0 = 0; j0 < dv; j0 += kJ) {
    const bool first = j0 == 0;
    const int nj = min(kJ, dv - j0);
    float f0[kJ], f1[kJ], e0[kJ], e1[kJ];
#pragma unroll
    for (int j = 0; j < kJ; ++j) f0[j] = f1[j] = e0[j] = e1[j] = 0.f;
    float go_next = 0.f;
    if (n0 < n1) {
      fetch_row<Tin>(a, raw, b, n0);
      go_next = load_go<Tin>(a, b, n0);
    }
    for (int n = n0; n < n1; ++n) {
      cp_async_wait_all();
      if (tid < D) go_s[tid] = go_next;
      __syncthreads();   // row n's x and go (and the weights) are in

      // ---- xf = x, or the tail's max(z tsc + tsh, 0), into xhat's buffer ----
      const Tin* rin = reinterpret_cast<const Tin*>(raw);
      if (cthread) {
#pragma unroll
        for (int k = 0; k < kMaxTPer; ++k) {
          const int t = tg + k * ntg;
          if (t < T) {
            float v = to_f(rin[t * C + cc]);
            if constexpr (Tail) v = fmaxf(tail_pre(v, tsc_s[t * C + cc], tsh_s[t * C + cc]), 0.f);
            xh[t * xp + cc] = v;
          }
        }
      }
      __syncthreads();
      // Fetch the next row while this one computes: now, or in tail mode's
      // first pass once the element steps have read z back from raw.
      const bool late = Tail && first;
      if (n + 1 < n1) {
        if (!late) fetch_row<Tin>(a, raw, b, n + 1);
        go_next = load_go<Tin>(a, b, n + 1);
      }

      float q0 = 0.f, q1 = 0.f;
      if (head) {
        // GroupNorm of group g over (T, C/G), two-pass, no affine; the lane
        // walks elements i = lane, lane + 32, ... as (t, j) = divmod(i, cg)
        auto each = [&](auto&& f) {
          int t = gn_t, j = gn_j;
#pragma unroll 1
          for (int i = lane; i < T * cg; i += 32) {
            f(xh + t * xp + g * cg + j);
            t += gn_dt;
            j += gn_dj;
            if (j >= cg) {
              j -= cg;
              ++t;
            }
          }
        };
        float sm = 0.f;
        each([&](float* p) { sm += *p; });
        const float mean = warp_sum(sm) / cnt;
        float sq = 0.f;
        each([&](float* p) {
          const float dl = *p - mean;
          sq = fmaf(dl, dl, sq);
        });
        const float inv = rsqrtf(warp_sum(sq) / cnt + a.eps);
        each([&](float* p) { *p = (*p - mean) * inv; });
        if (lane == 0) inv_s[g] = inv;
        // Z[g, c] = sum_{d in g} W[c, d] go[d];  q[t] = sum_{d in g} go[d] bpe[t, d]
        const float* gg = go_s + g * dv;
        const float* wa = w_s + (cv0 ? c0 : 0) * wp + g * dv;
        const float* wb = w_s + (cv1 ? c1 : 0) * wp + g * dv;
        const float* ba = bpe_s + (v0 ? t0 : 0) * wp + g * dv;
        const float* bb = bpe_s + (v1 ? t1 : 0) * wp + g * dv;
        float za = 0.f, zb = 0.f;
#pragma unroll 2
        for (int j = 0; j < dv; ++j) {
          const float gv = gg[j];
          za = fmaf(wa[j], gv, za);
          zb = fmaf(wb[j], gv, zb);
          q0 = fmaf(ba[j], gv, q0);
          q1 = fmaf(bb[j], gv, q1);
        }
        if (cv0) z_s[g * xp + c0] = za;
        if (cv1) z_s[g * xp + c1] = zb;
      }
      __syncthreads();   // xhat normalized

      if (head) {
        // scores s = xhat Ws + pes and p1 = q + xhat Z^T for head g, one pass
        // over xhat in float4s (C % 8 == 0, rows of C + 4 floats)
        const float4* x0p = reinterpret_cast<const float4*>(xh + (v0 ? t0 : 0) * xp);
        const float4* x1p = reinterpret_cast<const float4*>(xh + (v1 ? t1 : 0) * xp);
        const float4* wg = reinterpret_cast<const float4*>(wst + g * C);
        const float4* zg = reinterpret_cast<const float4*>(z_s + g * xp);
        float s0 = 0.f, s1 = 0.f, p0 = q0, p1 = q1;
#pragma unroll 1
        for (int c = 0; c < C / 4; ++c) {
          const float4 xa = x0p[c], xb = x1p[c], wv = wg[c], zv = zg[c];
          s0 = fmaf(xa.x, wv.x, fmaf(xa.y, wv.y, fmaf(xa.z, wv.z, fmaf(xa.w, wv.w, s0))));
          s1 = fmaf(xb.x, wv.x, fmaf(xb.y, wv.y, fmaf(xb.z, wv.z, fmaf(xb.w, wv.w, s1))));
          p0 = fmaf(xa.x, zv.x, fmaf(xa.y, zv.y, fmaf(xa.z, zv.z, fmaf(xa.w, zv.w, p0))));
          p1 = fmaf(xb.x, zv.x, fmaf(xb.y, zv.y, fmaf(xb.z, zv.z, fmaf(xb.w, zv.w, p1))));
        }
        // masked softmax over T, dropout, and its jacobian: ds
        const float* pg = pes_s + g * T;
        const float y0 = v0 ? s0 + pg[t0] : -CUDART_INF_F;
        const float y1 = v1 ? s1 + pg[t1] : -CUDART_INF_F;
        const float m = warp_max(fmaxf(y0, y1));
        float a0 = v0 ? expf(y0 - m) : 0.f;
        float a1 = v1 ? expf(y1 - m) : 0.f;
        const float rs = 1.f / warp_sum(a0 + a1);
        a0 *= rs;
        a1 *= rs;
        const float ad0 = v0 ? a0 * keep_scale(a, b, t0, n, g) : 0.f;
        const float ad1 = v1 ? a1 * keep_scale(a, b, t1, n, g) : 0.f;
        const float tot = warp_sum(ad0 * p0 + ad1 * p1);
        const float ds0 = ad0 * p0 - a0 * tot, ds1 = ad1 * p1 - a1 * tot;
        if (v0) dsad[t0 * DS + g] = make_float2(ds0, ad0);
        if (v1) dsad[t1 * DS + g] = make_float2(ds1, ad1);
        if (first) {
          dsum0 += ds0;
          dsum1 += ds1;
        }
        // E[t, d] += a_d[t, g] go[d] over this pass's d of head g
        const float* gj = go_s + g * dv + j0;
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          if (j < nj) {
            const float gv = gj[j];
            e0[j] = fmaf(ad0, gv, e0[j]);
            e1[j] = fmaf(ad1, gv, e1[j]);
          }
        }
        __syncwarp();
        // P[g, c] = sum_t a_d[t, g] xhat[t, c] and sum_t xhat[t, c] ds[t, g]
        // (lanes own c = cq, cq + 1), then F[c, d] += P[g, c] go[d]
        const float2* xq = reinterpret_cast<const float2*>(xh + (cqv ? cq : 0));
        float pa = 0.f, pb = 0.f, sa = 0.f, sb = 0.f;
#pragma unroll 2
        for (int t = 0; t < T; ++t) {
          const float2 v = dsad[t * DS + g], xv = xq[t * (xp / 2)];
          pa = fmaf(v.y, xv.x, pa);
          pb = fmaf(v.y, xv.y, pb);
          sa = fmaf(v.x, xv.x, sa);
          sb = fmaf(v.x, xv.y, sb);
        }
        if (first) {
          acca0 += sa;
          acca1 += sb;
        }
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          if (j < nj) {
            const float gv = gj[j];
            f0[j] = fmaf(pa, gv, f0[j]);
            f1[j] = fmaf(pb, gv, f1[j]);
          }
        }
      }
      __syncthreads();   // every head's ds, a_d and Z are in

      if (first) {
        // dxhat = ds Ws^T + a_d Z (thread (tg, cc)), and its sums for the
        // GroupNorm backward: sum dxhat and sum dxhat xhat per group
        float acc[kMaxTPer], zk[Tail ? kMaxTPer : 1];   // zk: tail mode's raw z
#pragma unroll
        for (int k = 0; k < kMaxTPer; ++k) acc[k] = 0.f;
        if (cthread) {
          const float4* dsad4 = reinterpret_cast<const float4*>(dsad);
#pragma unroll
          for (int k0 = 0; k0 < kMaxTPer; k0 += 4) {   // 4 t at a time: registers
            if (tg + k0 * ntg < T) {
#pragma unroll 1
              for (int h = 0; h < GE; h += 2) {
                const float2 wv = *reinterpret_cast<const float2*>(wscg + cc * WS + h);
                const float za = z_s[h * xp + cc], zb = z_s[(h + 1) * xp + cc];
#pragma unroll
                for (int k = k0; k < k0 + 4; ++k) {
                  const int t = tg + k * ntg;
                  if (t < T) {   // (ds, a_d) of heads h and h + 1
                    const float4 v = dsad4[(t * DS + h) >> 1];
                    acc[k] = fmaf(v.x, wv.x, fmaf(v.y, za, fmaf(v.z, wv.y, fmaf(v.w, zb, acc[k]))));
                  }
                }
              }
            }
          }
          float m1 = 0.f, m2 = 0.f;
#pragma unroll
          for (int k = 0; k < kMaxTPer; ++k) {
            const int t = tg + k * ntg;
            if (t < T) {
              m1 += acc[k];
              m2 = fmaf(acc[k], xh[t * xp + cc], m2);
              if constexpr (Tail) zk[k] = to_f(rin[t * C + cc]);
            }
          }
          red[tid] = m1;
          red[kBwdThreads + tid] = m2;
        }
        __syncthreads();   // raw is free in tail mode too
        if (late && n + 1 < n1) fetch_row<Tin>(a, raw, b, n + 1);
        if (head) {   // warp g sums group g's partials
          float s1 = 0.f, s2 = 0.f;
          for (int i = lane; i < ntg * cg; i += 32) {
            const int k = i / cg, at = k * C + g * cg + i - k * cg;
            s1 += red[at];
            s2 += red[kBwdThreads + at];
          }
          s1 = warp_sum(s1);
          s2 = warp_sum(s2);
          if (lane == 0) {
            gs[g] = s1 / cnt;
            gs[G + g] = s2 / cnt;
          }
        }
        __syncthreads();
        // GroupNorm backward into dx; in tail mode through the ReLU mask and
        // tsc, summing dtsc and dtsh per owned element
        if (cthread) {
          const int gc = cc / cg;
          const float inv = inv_s[gc], s1 = gs[gc], s2 = gs[G + gc];
          Tin* dx = static_cast<Tin*>(a.dx);
#pragma unroll
          for (int k = 0; k < kMaxTPer; ++k) {
            const int t = tg + k * ntg;
            if (t < T) {
              const size_t at = ((size_t)(b * T + t) * N + n) * C + cc;
              const float dxf = inv * (acc[k] - s1 - xh[t * xp + cc] * s2);
              if constexpr (Tail) {
                const float sc = tsc_s[t * C + cc];
                const float live = tail_pre(zk[k], sc, tsh_s[t * C + cc]) > 0.f ? dxf : 0.f;
                Io<Tin>::store(dx + at, live * sc);
                dtsc_r[k] = fmaf(live, zk[k], dtsc_r[k]);
                dtsh_r[k] += live;
              } else {
                Io<Tin>::store(dx + at, dxf);
              }
            }
          }
        }
      }
    }

    // this pass's F and E into the block's partial sums
    float* part_f = part_blk + C * G;
    float* part_e = part_f + C * D + T * G;
    if (head) {
      const int d0 = g * dv + j0;
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        if (j < nj) {
          if (cqv) {
            part_f[cq * D + d0 + j] = f0[j];
            part_f[(cq + 1) * D + d0 + j] = f1[j];
          }
          if (v0) part_e[t0 * D + d0 + j] = e0[j];
          if (v1) part_e[t1 * D + d0 + j] = e1[j];
        }
      }
    }
  }
  float* part_item = part_blk + bwd_shared_floats(C, D, G);
  if (head) {
    if (cqv) {
      part_blk[cq * G + g] = acca0;
      part_blk[(cq + 1) * G + g] = acca1;
    }
    if (v0) part_item[t0 * G + g] = dsum0;
    if (v1) part_item[t1 * G + g] = dsum1;
  }
  if constexpr (Tail) {
    if (cthread) {
      float* part_sc = part_item + T * G + T * D;
#pragma unroll
      for (int k = 0; k < kMaxTPer; ++k) {
        const int t = tg + k * ntg;
        if (t < T) {
          part_sc[t * C + cc] = dtsc_r[k];
          part_sc[T * C + t * C + cc] = dtsh_r[k];
        }
      }
    }
  }
}

// The blocks' partial sums, added in a fixed order (block by block), so the
// grid-wide sums are the same from run to run: A and F over all B * S blocks,
// the per-item sums (Dsum, E, dtsc, dtsh) over the S blocks of their item.
__global__ void ltae_pool_bwd_reduce(const Args a, const float* part, int S, bool tail) {
  const int B = a.B, T = a.T, C = a.C, D = a.D, G = a.G;
  const int shared = bwd_shared_floats(C, D, G), item = bwd_item_floats(T, C, D, G, tail);
  const size_t pf = (size_t)shared + item;
  const int total = shared + B * item;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += gridDim.x * blockDim.x) {
    float s = 0.f;
    if (i < shared) {
      for (int k = 0; k < B * S; ++k) s += part[k * pf + i];
      if (i < C * G) a.acc_a[i] = s;
      else a.acc_f[i - C * G] = s;
    } else {
      const int bb = (i - shared) / item, r = i - shared - bb * item;
      for (int k = 0; k < S; ++k) s += part[(size_t)(bb * S + k) * pf + shared + r];
      if (r < T * G) a.dsum[(size_t)bb * T * G + r] = s;
      else if (r < T * G + T * D) a.acc_e[(size_t)bb * T * D + r - T * G] = s;
      else if (r < T * G + T * D + T * C) a.dtsc[(size_t)bb * T * C + r - T * G - T * D] = s;
      else a.dtsh[(size_t)bb * T * C + r - T * G - T * D - T * C] = s;
    }
  }
}

using Kernel = void (*)(const Args);

template <typename Tin>
Kernel fwd_kernel(bool tail) {
  return tail ? &ltae_pool_fwd_group_kernel<Tin, true>
              : &ltae_pool_fwd_group_kernel<Tin, false>;
}

// The forward: S persistent blocks per batch item.
cudaError_t launch_fwd(Kernel kernel, const Args& a, int S, cudaStream_t stream) {
  const size_t bytes = (size_t)fwd_layout(a.T, a.C, a.G).floats * sizeof(float);
  if (bytes > kSmemLimit) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(S, a.B), kFwdThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

using BwdKernel = void (*)(const Args, float*);

template <typename Tin>
BwdKernel bwd_kernel(bool tail) {
  return tail ? &ltae_pool_bwd_kernel<Tin, true> : &ltae_pool_bwd_kernel<Tin, false>;
}

// The backward: S persistent blocks per batch item, then the fixed-order
// reduce of their partial sums `part` into the outputs.
cudaError_t launch_bwd(BwdKernel kernel, const Args& a, float* part, int S, bool tail,
                       int elem_bytes, cudaStream_t stream) {
  const size_t bytes =
      (size_t)bwd_layout(a.T, a.C, a.D, a.G, tail, elem_bytes).floats * sizeof(float);
  if (bytes > kSmemLimit) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(S, a.B), kBwdThreads, bytes, stream>>>(a, part);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int total = bwd_shared_floats(a.C, a.D, a.G) +
                    a.B * bwd_item_floats(a.T, a.C, a.D, a.G, tail);
  ltae_pool_bwd_reduce<<<(total + 255) / 256, 256, 0, stream>>>(a, part, S, tail);
  return cudaGetLastError();
}

bool bad_shape(int B, int T, int N, int C, int D, int G) {
  return B < 1 || N < 1 || T < 1 || T > kMaxT || C < 8 || C > kMaxC || C % 8 ||
         G < 1 || G > kMaxG || C % G || D < G || D % G;
}

Args make_args(int B, int T, int N, int C, int D, int G, unsigned seed_mix,
               unsigned thresh, float scale, float eps) {
  Args a = {};
  a.B = B; a.T = T; a.N = N; a.C = C; a.D = D; a.G = G;
  a.seed_mix = seed_mix;
  a.thresh = thresh;
  a.scale = scale;
  a.eps = eps;
  return a;
}

// ---- every other shape: one row at a time, x streamed over T ---------------

// The general forward's workspace per block, in floats: in shared memory
// where it fits, else the block's slice of a scratch buffer in device memory.
// Per channel the GroupNorm's mean and 1/std and channel_sums' partial sums,
// a chunk of xhat (TC, C) and its scores (TC, G), per head the running max
// and sum and this chunk's rescale, P (G, C) and the bpe term (D).
struct GenLayout {
  int tc;
  int mean, inv, red, xc, e, mx, sum, scl, p, eb;
  int floats;
};

__host__ __device__ inline GenLayout gen_layout(int T, int C, int D, int G) {
  GenLayout L{};
  int o = 0;
  auto take = [&](int n) { const int at = o; o += (n + 3) & ~3; return at; };
  L.tc = T < kGenChunk ? T : kGenChunk;
  L.mean = take(C);
  L.inv = take(C);
  L.red = take(C > kGenThreads ? C : kGenThreads);
  L.xc = take(L.tc * C);
  L.p = take(G * C);
  L.e = take(L.tc * G);
  L.mx = take(G);
  L.sum = take(G);
  L.scl = take(G);
  L.eb = take(D);
  L.floats = o;
  return L;
}

// x[b, t, n, c] in fp32 (in tail mode the raw z).
template <typename Tin>
__device__ __forceinline__ float load_raw(const Args& a, int b, int t, int n, int c) {
  return Io<Tin>::load(static_cast<const Tin*>(a.x) +
                       (((size_t)b * a.T + t) * a.N + n) * a.C + c);
}

// xf[b, t, n, c]: x, or in tail mode max(z * tsc + tsh, 0).
template <typename Tin, bool Tail>
__device__ __forceinline__ float load_xf(const Args& a, int b, int t, int n, int c) {
  const float v = load_raw<Tin>(a, b, t, n, c);
  if constexpr (Tail) {
    const size_t k = ((size_t)b * a.T + t) * a.C + c;
    return fmaxf(tail_pre(v, a.tsc[k], a.tsh[k]), 0.f);
  }
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

// Forward of any shape. Per row it also saves, in st (B, N, 4, G), each
// group's GroupNorm mean and 1/std and each head's softmax max and sum, which
// the general backward takes instead of two more passes over x.
template <typename Tin, bool Tail>
__global__ void __launch_bounds__(kGenThreads, kGenBlocksPerSm)
ltae_pool_fwd_general_kernel(const Args a, float* const st, float* const scratch) {
  extern __shared__ __align__(16) float smem_gen_fwd[];
  const int T = a.T, C = a.C, D = a.D, G = a.G, N = a.N;
  const int cg = C / G, dv = D / G;
  const GenLayout L = gen_layout(T, C, D, G);
  const int tid = threadIdx.x, b = blockIdx.y, S = gridDim.x;
  float* const w = scratch != nullptr
                       ? scratch + (size_t)(b * S + blockIdx.x) * L.floats : smem_gen_fwd;
  float* __restrict__ const mean = w + L.mean;
  float* __restrict__ const inv = w + L.inv;
  float* __restrict__ const red = w + L.red;
  float* __restrict__ const xc = w + L.xc;
  float* __restrict__ const e = w + L.e;
  float* __restrict__ const mx = w + L.mx;
  float* __restrict__ const sum = w + L.sum;
  float* __restrict__ const scl = w + L.scl;
  float* __restrict__ const p = w + L.p;
  float* __restrict__ const eb = w + L.eb;
  // this block's rows: a contiguous range of batch item b (row_ranges)
  const int n0 = (int)((long long)blockIdx.x * N / S);
  const int n1 = (int)((long long)(blockIdx.x + 1) * N / S);
  const float cnt = (float)T * cg;
  const float* bpe_b = a.bpe + (size_t)b * T * D;
  const float* pes_b = a.pes + (size_t)b * G * T;

  for (int n = n0; n < n1; ++n) {
    float* st_row = st + ((size_t)b * N + n) * 4 * G;
    // 1. GroupNorm statistics over (T, C/G), two passes over x
    channel_sums(T, C, red, [&](int t, int c) { return load_xf<Tin, Tail>(a, b, t, n, c); });
    for (int c = tid; c < C; c += kGenThreads) mean[c] = group_total(red, c, cg) / cnt;
    __syncthreads();
    channel_sums(T, C, red, [&](int t, int c) {
      const float dl = load_xf<Tin, Tail>(a, b, t, n, c) - mean[c];
      return dl * dl;
    });
    for (int c = tid; c < C; c += kGenThreads)
      inv[c] = rsqrtf(group_total(red, c, cg) / cnt + a.eps);
    for (int g = tid; g < G; g += kGenThreads) {
      mx[g] = -CUDART_INF_F;
      sum[g] = 0.f;
    }
    for (int i = tid; i < G * C; i += kGenThreads) p[i] = 0.f;
    for (int i = tid; i < D; i += kGenThreads) eb[i] = 0.f;
    __syncthreads();
    for (int g = tid; g < G; g += kGenThreads) {
      st_row[g] = mean[g * cg];
      st_row[G + g] = inv[g * cg];
    }

    // 2. chunks of TC steps: xhat, scores, an online softmax; P and the bpe
    //    term take the dropped weights e * keep / (1 - p), the sum takes e
    for (int t0 = 0; t0 < T; t0 += L.tc) {
      const int tc = min(L.tc, T - t0);
#pragma unroll 4
      for (int i = tid; i < tc * C; i += kGenThreads) {
        const int t = i / C, c = i - t * C;
        xc[i] = (load_xf<Tin, Tail>(a, b, t0 + t, n, c) - mean[c]) * inv[c];
      }
      __syncthreads();
      for (int i = tid; i < tc * G; i += kGenThreads) {
        const int t = i / G, g = i - t * G;
        const float* xt = xc + t * C;
        float s = 0.f;
#pragma unroll 4
        for (int c = 0; c < C; ++c) s = fmaf(xt[c], __ldg(a.ws + c * G + g), s);
        e[i] = s + pes_b[g * T + t0 + t];
      }
      __syncthreads();
      for (int g = tid; g < G; g += kGenThreads) {
        float mc = mx[g];
        for (int t = 0; t < tc; ++t) mc = fmaxf(mc, e[t * G + g]);
        const float sc = expf(mx[g] - mc);   // 0 at the first chunk
        float sm = sum[g] * sc;
        for (int t = 0; t < tc; ++t) {
          const float v = expf(e[t * G + g] - mc);
          sm += v;
          e[t * G + g] = v * keep_scale(a, b, t0 + t, n, g);
        }
        mx[g] = mc;
        sum[g] = sm;
        scl[g] = sc;
      }
      __syncthreads();
      for (int i = tid; i < G * C; i += kGenThreads) {
        const int g = i / C, c = i - g * C;
        float acc = p[i] * scl[g];
#pragma unroll 4
        for (int t = 0; t < tc; ++t) acc = fmaf(e[t * G + g], xc[t * C + c], acc);
        p[i] = acc;
      }
      for (int d = tid; d < D; d += kGenThreads) {
        const int g = d / dv;
        float acc = eb[d] * scl[g];
#pragma unroll 4
        for (int t = 0; t < tc; ++t)
          acc = fmaf(e[t * G + g], __ldg(bpe_b + (size_t)(t0 + t) * D + d), acc);
        eb[d] = acc;
      }
      __syncthreads();
    }

    // 3. o[d] = (P[g(d)] . W[:, d] + bpe term) / sum[g(d)]
    Tin* orow = static_cast<Tin*>(a.o) + ((size_t)b * N + n) * D;
    for (int d = tid; d < D; d += kGenThreads) {
      const int g = d / dv;
      const float* pg = p + g * C;
      float acc = 0.f;
#pragma unroll 4
      for (int c = 0; c < C; ++c) acc = fmaf(pg[c], __ldg(a.win + (size_t)c * D + d), acc);
      Io<Tin>::store(orow + d, (acc + eb[d]) / sum[g]);
    }
    for (int g = tid; g < G; g += kGenThreads) {
      st_row[2 * G + g] = mx[g];
      st_row[3 * G + g] = sum[g];
    }
    __syncthreads();
  }
}

// ---- the general backward: persistent row groups, x streamed over T --------

// Shared memory of the general backward block, in floats; regions start on
// 16 bytes. R rows a group; the raw x of a chunk of TC steps, (TC, R, C) in
// x's type as in device memory, fills one slot (all chunks of the group stay
// with `resident`, else two slots take turns); xh holds a chunk's xhat (R,
// TC, C | 1: an odd row stride, so lanes on consecutive steps hit distinct
// banks); per row and step, ds and ad (R, T, GP: heads rounded up to 4,
// zero past G) hold a_d p1 and the sign-coded a until the jacobian, then ds
// and a_d; Z (R, C, ZP) and Ws (C, ZP) have a row stride of GP + 4 (float4
// rows free of bank conflicts); the p region holds P (R, G, C) until F is
// summed, then each row's A (R, C, GP);
// go (R, G, dv + 1: a pad float a head, so lanes on consecutive heads hit
// distinct banks); per row its saved statistics (4, G), tot (GP), sum_t ds
// and sum_t a_d (2, GP) and the group means gm (2, G).
struct GbLayout {
  int rows, tc, nch, slots, slot, gp, zp, cp, resident;
  int raw, xh, ds, ad, z, ws, p, go, st, tot, sg, gm;
  int floats;
};

__host__ __device__ inline GbLayout gb_layout(int T, int C, int D, int G, int elem_bytes,
                                              int R, bool resident) {
  GbLayout L{};
  int o = 0;
  auto take = [&](int n) { const int at = o; o += (n + 3) & ~3; return at; };
  L.rows = R;
  L.resident = resident;
  L.tc = T < kGenChunk ? T : kGenChunk;
  L.nch = (T + L.tc - 1) / L.tc;
  L.slots = resident ? L.nch : 2;
  L.slot = (L.tc * R * C * elem_bytes + 15) / 16 * 4;
  L.gp = (G + 3) & ~3;
  L.zp = L.gp + 4;
  L.cp = C | 1;
  L.raw = take(L.slots * L.slot);
  L.xh = take(R * L.tc * L.cp);
  L.ds = take(R * T * L.gp);
  L.ad = take(R * T * L.gp);
  L.z = take(R * C * L.zp);
  L.ws = take(C * L.zp);
  L.p = take(R * C * L.gp);
  L.go = take(R * G * (D / G + 1));
  L.st = take(R * 4 * G);
  L.tot = take(R * L.gp);
  L.sg = take(R * 2 * L.gp);
  L.gm = take(R * 2 * G);
  L.floats = o;
  return L;
}

// The general backward's plan: the group's x resident if that fits at some
// R, else streamed; then the most rows a group, R = 4 .. 1. Where nothing
// fits in shared memory, R = 1 streamed in a scratch buffer in device memory.
// ops/ltae_pool.py::general_bwd_plan mirrors it.
__host__ __device__ inline GbLayout gb_plan(int T, int C, int D, int G, int elem_bytes) {
  for (int res = 1; res >= 0; --res)
    for (int R = kGbMaxRows; R >= 1; --R) {
      const GbLayout L = gb_layout(T, C, D, G, elem_bytes, R, res != 0);
      if ((size_t)L.floats * sizeof(float) <= kSmemLimit) return L;
    }
  return gb_layout(T, C, D, G, elem_bytes, 1, false);
}

// d / dv for 0 <= d < 2^21: (d + 0.5) / dv is at least 0.5 / dv from an
// integer, and the float product's error stays below that there.
__device__ __forceinline__ int head_of(int d, float inv_dv) {
  return __float2int_rz((d + 0.5f) * inv_dv);
}

// a_d and a from the sign-coded value the first pass stores: a * scale where
// the element is kept, -a where it is dropped (a >= 0, so the sign tells
// them apart; scale = 1 / (1 - p), inv_scale = 1 - p).
__device__ __forceinline__ float coded_ad(float v) { return fmaxf(v, 0.f); }
__device__ __forceinline__ float coded_a(float v, float inv_scale) {
  return v >= 0.f ? v * inv_scale : -v;
}

// Backward of any shape, with the forward's saved statistics st (B, N, 4,
// G). Each persistent block takes its rows (row_ranges) in groups of R, and
// each group in three passes over T in chunks of TC steps:
//   1. per step and head a, a_d and p1, then P = sum_t a_d xhat;
//   2. A += xhat^T ds and per channel the sums of dxhat and dxhat xhat;
//   3. dx (in tail mode through the ReLU mask and tsc, with dtsc and dtsh).
// Between them, the jacobian ds = a_d p1 - a sum_t a_d p1 and the group's
// share of F (in registers for the block's life where C * D <= 16384, else
// added into the block's partial sums once a group), E and Dsum (added once a
// group). Chunks arrive by cp.async behind the compute: all of a group's with
// `resident` (passes 2 and 3 read x from shared memory; the next group's
// chunk j comes in once pass 3 is past it), else the next visit's chunk into
// the other of two slots.
template <typename Tin, bool Tail, bool Smem>
__global__ void __launch_bounds__(kGbThreads, 1)
ltae_pool_bwd_general_kernel(const Args a, const GbLayout L, const float* const st,
                             float* const part, float* const scratch) {
  extern __shared__ __align__(16) float smem_gen_bwd[];
  const int T = a.T, C = a.C, D = a.D, G = a.G, N = a.N;
  const int R = L.rows, TC = L.tc, GP = L.gp, ZP = L.zp, CP = L.cp, G4 = L.gp / 4;
  const int cg = C / G, dv = D / G, G2 = 2 * G, G4S = 4 * G, DV1 = dv + 1, GOP = G * DV1;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y, S = gridDim.x;
  // Smem: the workspace in shared memory (so the compiler addresses it as
  // such), else this block's slice of the scratch buffer
  float* const w = Smem ? smem_gen_bwd : scratch + (size_t)(b * S + blockIdx.x) * L.floats;
  Tin* const raw = reinterpret_cast<Tin*>(w + L.raw);
  const int slot_elems = L.slot * 4 / (int)sizeof(Tin);
  float* __restrict__ const xh = w + L.xh;
  float* __restrict__ const dsv = w + L.ds;
  float* __restrict__ const adv = w + L.ad;
  float* __restrict__ const zs = w + L.z;
  float* __restrict__ const wss = w + L.ws;
  float* __restrict__ const ps = w + L.p;
  float* __restrict__ const ars = w + L.p;   // after F: each row's A (R, C, GP)
  float* __restrict__ const gos = w + L.go;
  float* __restrict__ const sts = w + L.st;
  float* __restrict__ const tot = w + L.tot;
  float* __restrict__ const sg = w + L.sg;
  float* __restrict__ const gm = w + L.gm;
  const int n0 = (int)((long long)blockIdx.x * N / S);
  const int n1 = (int)((long long)(blockIdx.x + 1) * N / S);
  const float cnt = (float)T * cg;
  const float inv_scale = 1.f / a.scale;
  const float inv_dv = 1.f / dv;
  const float* bpe_b = a.bpe + (size_t)b * T * D;
  const float* pes_b = a.pes + (size_t)b * G * T;
  const Tin* const x = static_cast<const Tin*>(a.x);

  // this block's partial sums: A (C, G), F (C, D), then its item's Dsum (T,
  // G), E (T, D) and in tail mode dtsc, dtsh (T, C)
  const int per_block = bwd_shared_floats(C, D, G) + bwd_item_floats(T, C, D, G, Tail);
  float* __restrict__ const pa = part + (size_t)(b * S + blockIdx.x) * per_block;
  float* __restrict__ const pf = pa + C * G;
  float* __restrict__ const pds = pf + C * D;
  float* __restrict__ const pe = pds + T * G;
  float* __restrict__ const psc = pe + T * D;
  float* __restrict__ const psh = psc + T * C;
  for (int i = tid; i < per_block; i += kGbThreads) pa[i] = 0.f;
  for (int i = tid; i < C * ZP; i += kGbThreads) {
    const int c = i / ZP, g = i - c * ZP;
    wss[i] = g < G ? a.ws[c * G + g] : 0.f;
  }
  const bool f_regs = C * D <= kGbFRegs * kGbThreads;
  float freg[kGbFRegs];
#pragma unroll
  for (int k = 0; k < kGbFRegs; ++k) freg[k] = 0.f;

  // chunk j of rows [m0, m0 + rows) into slot s: 16-byte cp.async where the
  // workspace is in shared memory and a row's C values fill whole vectors,
  // else plain copies
  const bool async = Smem && (C * (int)sizeof(Tin)) % 16 == 0;
  auto load_chunk = [&](int m0, int j, int s) {
    const int rows = min(R, n1 - m0), t0 = j * TC, tc = min(TC, T - t0), per_t = rows * C;
    Tin* dst = raw + s * slot_elems;
    const Tin* src = x + ((size_t)(b * T + t0) * N + m0) * C;
    if (async) {
      constexpr int V = 16 / sizeof(Tin);
      const int nv = per_t / V;
#pragma unroll 1
      for (int i = tid; i < tc * nv; i += kGbThreads) {
        const int t = i / nv, e = (i - t * nv) * V;
        cp_async16(dst + t * R * C + e, src + (size_t)t * N * C + e);
      }
      cp_async_commit();
    } else {
#pragma unroll 1
      for (int i = tid; i < tc * per_t; i += kGbThreads) {
        const int t = i / per_t, e = i - t * per_t;
        dst[t * R * C + e] = src[(size_t)t * N * C + e];
      }
    }
  };
  // The start of a visit (pass, chunk j) of the group at m0: its chunk is in
  // and every thread is past the last visit; the next chunk to load starts.
  // Returns the chunk's slot.
  int visits = 0;
  auto begin_visit = [&](int m0, int pass, int j) -> int {
    cp_async_wait_all();
    __syncthreads();
    if (L.resident) {
      if (pass == 3 && j > 0 && m0 + R < n1) load_chunk(m0 + R, j - 1, j - 1);
      return j;
    }
    int nm = m0, np = pass, nj = j + 1;
    if (nj == L.nch) {
      nj = 0;
      if (++np == 4) {
        np = 1;
        nm += R;
      }
    }
    if (nm < n1) load_chunk(nm, nj, (visits + 1) & 1);
    return (visits++) & 1;
  };
  // xhat of the chunk (from slot s) into xh: thread (part, c) over steps
  // part, part + np, .. and the group's rows, so that each tail affine value
  // is read once for all of them
  auto normalize = [&](int rows, int s, int t0, int tc) {
    const Tin* rs = raw + s * slot_elems;
    const int np = max(1, min(tc, kGbThreads / C));
    for (int it = tid; it < np * C; it += kGbThreads) {
      const int c = it % C, pt = it / C, gc = c / cg;
      float mean[kGbMaxRows], inv[kGbMaxRows];
#pragma unroll
      for (int r = 0; r < kGbMaxRows; ++r) {
        mean[r] = r < rows ? sts[r * G4S + gc] : 0.f;
        inv[r] = r < rows ? sts[r * G4S + G + gc] : 0.f;
      }
#pragma unroll 4
      for (int t = pt; t < tc; t += np) {
        float sc = 1.f, sh = 0.f;
        if constexpr (Tail) {
          const size_t at = ((size_t)b * T + t0 + t) * C + c;
          sc = __ldg(a.tsc + at);
          sh = __ldg(a.tsh + at);
        }
#pragma unroll
        for (int r = 0; r < kGbMaxRows; ++r) {
          if (r < rows) {
            float v = to_f(rs[t * R * C + r * C + c]);
            if constexpr (Tail) v = fmaxf(tail_pre(v, sc, sh), 0.f);
            xh[(r * TC + t) * CP + c] = (v - mean[r]) * inv[r];
          }
        }
      }
    }
  };
  // dxhat[t, c] = sum_g ds[t, g] Ws[c, g] + a_d[t, g] Z[g, c] of row r, with
  // the first 16 heads' Ws and Z from registers
  auto dxhat = [&](const float* wr, const float* zr, int r, int tt, int c) {
    const float* dr = dsv + (r * T + tt) * GP;
    const float* ar = adv + (r * T + tt) * GP;
    float acc = 0.f;
#pragma unroll
    for (int q = 0; q < kGbHeadRegs / 4; ++q) {
      if (4 * q < GP) {
        const float4 d4 = ld4(dr + 4 * q), a4 = ld4(ar + 4 * q);
        acc = fmaf(d4.x, wr[4 * q], fmaf(a4.x, zr[4 * q], acc));
        acc = fmaf(d4.y, wr[4 * q + 1], fmaf(a4.y, zr[4 * q + 1], acc));
        acc = fmaf(d4.z, wr[4 * q + 2], fmaf(a4.z, zr[4 * q + 2], acc));
        acc = fmaf(d4.w, wr[4 * q + 3], fmaf(a4.w, zr[4 * q + 3], acc));
      }
    }
    for (int g = kGbHeadRegs; g < G; ++g)   // G > 16 only
      acc = fmaf(dr[g], wss[c * ZP + g], fmaf(ar[g], zs[(r * C + c) * ZP + g], acc));
    return acc;
  };
  auto head_regs = [&](float* reg, const float* row) {
#pragma unroll
    for (int q = 0; q < kGbHeadRegs / 4; ++q) {
      const float4 v = 4 * q < GP ? ld4(row + 4 * q) : make_float4(0.f, 0.f, 0.f, 0.f);
      reg[4 * q] = v.x;
      reg[4 * q + 1] = v.y;
      reg[4 * q + 2] = v.z;
      reg[4 * q + 3] = v.w;
    }
  };

  if (n0 < n1) {
    if (L.resident)
      for (int j = 0; j < L.nch; ++j) load_chunk(n0, j, j);
    else
      load_chunk(n0, 0, 0);
  }

#pragma unroll 1
  for (int m0 = n0; m0 < n1; m0 += R) {
    const int rows = min(R, n1 - m0);
    // ---- the group's statistics, go, Z and the PE term of p1 ---------------
    for (int i = tid; i < rows * G4S; i += kGbThreads)
      sts[i] = st[((size_t)b * N + m0) * G4S + i];
    for (int i = tid; i < rows * D; i += kGbThreads) {   // go[r][g, j], a pad a head
      const int r = i / D, d = i - r * D, g = d / dv;
      gos[r * GOP + g * DV1 + d - g * dv] =
          Io<Tin>::load(static_cast<const Tin*>(a.go) + ((size_t)b * N + m0) * D + i);
    }
    for (int i = tid; i < rows * G * C; i += kGbThreads) ps[i] = 0.f;
    __syncthreads();
    // Z[r][c, g] = sum_{d in g} W[c, d] go_r[d]: each W element from L2
    // serves the group's rows; kLoads loads in flight a thread
    for (int i = tid; i < C * GP; i += kGbThreads) {
      const int c = i / GP, g = i - c * GP;
      float acc[kGbMaxRows] = {};
      if (g < G) {
        const float* wr = a.win + (size_t)c * D + g * dv;
        const float* gr = gos + g * DV1;
        for (int j0 = 0; j0 < dv; j0 += kLoads) {
          float wv[kLoads];
#pragma unroll
          for (int k = 0; k < kLoads; ++k) wv[k] = j0 + k < dv ? __ldg(wr + j0 + k) : 0.f;
#pragma unroll
          for (int k = 0; k < kLoads; ++k)
#pragma unroll
            for (int r = 0; r < kGbMaxRows; ++r)
              if (r < rows && j0 + k < dv) acc[r] = fmaf(wv[k], gr[r * GOP + j0 + k], acc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < kGbMaxRows; ++r)
        if (r < rows) zs[(r * C + c) * ZP + g] = acc[r];
    }
    // ds[r][t, g] = sum_{d in g} go_r[d] bpe[t, d], p1's PE term
    for (int i = tid; i < T * GP; i += kGbThreads) {
      const int t = i / GP, g = i - t * GP;
      float acc[kGbMaxRows] = {};
      if (g < G) {
        const float* bt = bpe_b + (size_t)t * D + g * dv;
        const float* gr = gos + g * DV1;
        for (int j0 = 0; j0 < dv; j0 += kLoads) {
          float bv[kLoads];
#pragma unroll
          for (int k = 0; k < kLoads; ++k) bv[k] = j0 + k < dv ? __ldg(bt + j0 + k) : 0.f;
#pragma unroll
          for (int k = 0; k < kLoads; ++k)
#pragma unroll
            for (int r = 0; r < kGbMaxRows; ++r)
              if (r < rows && j0 + k < dv) acc[r] = fmaf(gr[r * GOP + j0 + k], bv[k], acc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < kGbMaxRows; ++r)
        if (r < rows) dsv[(r * T + t) * GP + g] = acc[r];
    }

    // 1. a, a_d and p1 of every step, and P = sum_t a_d xhat
#pragma unroll 1
    for (int j = 0; j < L.nch; ++j) {
      const int t0 = j * TC, tc = min(TC, T - t0);
      const int s = begin_visit(m0, 1, j);
      normalize(rows, s, t0, tc);
      __syncthreads();
      // thread (r, t, four heads): s = xhat Ws + pes, p1 += xhat Z[g]
      for (int i = tid; i < rows * tc * G4; i += kGbThreads) {
        const int gq = i % G4, k = i / G4, t = k % tc, r = k / tc, tt = t0 + t;
        const float* xr = xh + (r * TC + t) * CP;
        const float* wq = wss + 4 * gq;
        const float* zq = zs + r * C * ZP + 4 * gq;
        float4 sv = make_float4(0.f, 0.f, 0.f, 0.f), pv = sv;
#pragma unroll 4
        for (int c = 0; c < C; ++c) {
          const float xv = xr[c];
          const float4 wv = ld4(wq + c * ZP), zv = ld4(zq + c * ZP);
          sv.x = fmaf(xv, wv.x, sv.x);
          sv.y = fmaf(xv, wv.y, sv.y);
          sv.z = fmaf(xv, wv.z, sv.z);
          sv.w = fmaf(xv, wv.w, sv.w);
          pv.x = fmaf(xv, zv.x, pv.x);
          pv.y = fmaf(xv, zv.y, pv.y);
          pv.z = fmaf(xv, zv.z, pv.z);
          pv.w = fmaf(xv, zv.w, pv.w);
        }
        float* dr = dsv + (r * T + tt) * GP + 4 * gq;
        float* ar = adv + (r * T + tt) * GP + 4 * gq;
        const float* sr = sts + r * G4S;
#pragma unroll
        for (int k2 = 0; k2 < 4; ++k2) {
          const int g = 4 * gq + k2;
          if (g < G) {
            const float aa = expf(at4(sv, k2) + __ldg(pes_b + g * T + tt) - sr[G2 + g]) /
                             sr[3 * G + g];
            const float ks = keep_scale(a, b, tt, m0 + r, g);
            const float ad = aa * ks;
            dr[k2] = ad * (dr[k2] + at4(pv, k2));
            ar[k2] = ks != 0.f ? ad : -aa;
          } else {
            dr[k2] = 0.f;
            ar[k2] = 0.f;
          }
        }
      }
      __syncthreads();
      // thread (r, four heads, c): P[r][g, c] += sum_t a_d[t, g] xhat[t, c]
      for (int i = tid; i < rows * G4 * C; i += kGbThreads) {
        const int c = i % C, k = i / C, gq = k % G4, r = k / G4;
        const float* xc = xh + r * TC * CP + c;
        const float* ar = adv + (r * T + t0) * GP + 4 * gq;
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
        for (int t = 0; t < tc; ++t) {
          const float xv = xc[t * CP];
          const float4 av = ld4(ar + t * GP);
          acc.x = fmaf(coded_ad(av.x), xv, acc.x);
          acc.y = fmaf(coded_ad(av.y), xv, acc.y);
          acc.z = fmaf(coded_ad(av.z), xv, acc.z);
          acc.w = fmaf(coded_ad(av.w), xv, acc.w);
        }
#pragma unroll
        for (int k2 = 0; k2 < 4; ++k2)
          if (4 * gq + k2 < G) ps[(r * G + 4 * gq + k2) * C + c] += at4(acc, k2);
      }
    }

    // 2. ds = a_d p1 - a sum_t a_d p1 (the softmax jacobian); ad becomes a_d
    __syncthreads();
    for (int k = warp; k < rows * GP; k += kGbThreads / 32) {   // pad heads: 0
      const int r = k / GP, g = k - r * GP;
      float sm = 0.f;
      for (int t = lane; t < T; t += 32) sm += dsv[(r * T + t) * GP + g];
      sm = warp_sum(sm);
      if (lane == 0) tot[r * GP + g] = sm;
    }
    __syncthreads();
    for (int it = tid; it < rows * T; it += kGbThreads) {   // thread per (r, t)
      float* dr = dsv + it * GP;
      float* ar = adv + it * GP;
      const float* tr = tot + it / T * GP;
      for (int q = 0; q < G4; ++q) {
        float4 dv4 = ld4(dr + 4 * q), av = ld4(ar + 4 * q);
        const float4 tv = ld4(tr + 4 * q);
        dv4.x -= coded_a(av.x, inv_scale) * tv.x;
        dv4.y -= coded_a(av.y, inv_scale) * tv.y;
        dv4.z -= coded_a(av.z, inv_scale) * tv.z;
        dv4.w -= coded_a(av.w, inv_scale) * tv.w;
        av = make_float4(coded_ad(av.x), coded_ad(av.y), coded_ad(av.z), coded_ad(av.w));
        *reinterpret_cast<float4*>(dr + 4 * q) = dv4;
        *reinterpret_cast<float4*>(ar + 4 * q) = av;
      }
    }
    __syncthreads();

    // per row sum_t ds and sum_t a_d (warp (r, head), lanes over t), and the
    // P part of the GroupNorm backward's second sum (see step 4)
    for (int k = warp; k < rows * GP; k += kGbThreads / 32) {
      const int r = k / GP, g = k - r * GP;
      float s1 = 0.f, s2 = 0.f;
      for (int t = lane; t < T; t += 32) {
        s1 += dsv[(r * T + t) * GP + g];
        s2 += adv[(r * T + t) * GP + g];
      }
      s1 = warp_sum(s1);
      s2 = warp_sum(s2);
      if (lane == 0) {
        sg[r * 2 * GP + g] = s1;
        sg[r * 2 * GP + GP + g] = s2;
      }
    }
    for (int i = tid; i < rows * G; i += kGbThreads) {
      const int r = i / G, gc = i - r * G;
      float sm = 0.f;
      for (int c = gc * cg; c < (gc + 1) * cg; ++c)
        for (int g = 0; g < G; ++g)
          sm = fmaf(zs[(r * C + c) * ZP + g], ps[(r * G + g) * C + c], sm);
      gm[r * G2 + G + gc] = sm;
    }

    // 3. the group's share of F, E and Dsum
    if (f_regs && kGbThreads % D == 0) {   // element tid + k * kGbThreads is (c + k cs, d)
      const int d = tid % D, cs = kGbThreads / D, g = d / dv, gd = g * DV1 + d - g * dv;
      float gv[kGbMaxRows];
#pragma unroll
      for (int r = 0; r < kGbMaxRows; ++r) gv[r] = r < rows ? gos[r * GOP + gd] : 0.f;
      int c = tid / D;
#pragma unroll
      for (int k = 0; k < kGbFRegs; ++k) {
        if (c < C) {
          float sm = 0.f;
#pragma unroll
          for (int r = 0; r < kGbMaxRows; ++r)
            if (r < rows) sm = fmaf(ps[(r * G + g) * C + c], gv[r], sm);
          freg[k] += sm;
        }
        c += cs;
      }
    } else if (f_regs) {   // element tid + k * kGbThreads is (c, d), stepped
      int c = tid / D, d = tid - c * D;
      const int cs = kGbThreads / D, dsp = kGbThreads - cs * D;
#pragma unroll
      for (int k = 0; k < kGbFRegs; ++k) {
        if (c < C) {
          const int g = head_of(d, inv_dv), gd = g * DV1 + d - g * dv;
          float sm = 0.f;
#pragma unroll
          for (int r = 0; r < kGbMaxRows; ++r)
            if (r < rows) sm = fmaf(ps[(r * G + g) * C + c], gos[r * GOP + gd], sm);
          freg[k] += sm;
        }
        c += cs;
        d += dsp;
        if (d >= D) {
          d -= D;
          ++c;
        }
      }
    } else {
      for (int i = tid; i < C * D; i += kGbThreads) {
        const int c = i / D, d = i - c * D, g = d / dv, gd = g * DV1 + d - g * dv;
        float sm = 0.f;
        for (int r = 0; r < rows; ++r) sm = fmaf(ps[(r * G + g) * C + c], gos[r * GOP + gd], sm);
        pf[i] += sm;
      }
    }
    const int npe = max(1, kGbThreads / D);   // E: thread (part, d) over steps
    for (int it = tid; it < npe * D; it += kGbThreads) {
      const int d = it % D, pt = it / D, g = d / dv, gd = g * DV1 + d - g * dv;
      float gv[kGbMaxRows];
#pragma unroll
      for (int r = 0; r < kGbMaxRows; ++r) gv[r] = r < rows ? gos[r * GOP + gd] : 0.f;
      for (int t0 = pt; t0 < T; t0 += kLoads * npe) {   // kLoads partial sums in flight
        float old[kLoads];
#pragma unroll
        for (int k = 0; k < kLoads; ++k) {
          const int t = t0 + k * npe;
          old[k] = t < T ? pe[t * D + d] : 0.f;
        }
#pragma unroll
        for (int k = 0; k < kLoads; ++k) {
          const int t = t0 + k * npe;
          if (t < T) {
            const float* ar = adv + t * GP + g;
            float sm = 0.f;
#pragma unroll
            for (int r = 0; r < kGbMaxRows; ++r)
              if (r < rows) sm = fmaf(ar[r * T * GP], gv[r], sm);
            pe[t * D + d] = old[k] + sm;
          }
        }
      }
    }
    // Dsum[t, g] += sum_r ds_r[t, g]
    for (int i = tid; i < T * G; i += kGbThreads) {
      const int t = i / G, g = i - t * G;
      float sm = 0.f;
#pragma unroll
      for (int r = 0; r < kGbMaxRows; ++r)
        if (r < rows) sm += dsv[(r * T + t) * GP + g];
      pds[i] += sm;
    }

    // 4. each row's A_r = xhat^T ds (thread (r, four heads, c) over the
    //    chunk's steps), added into the block's A once a group. The GroupNorm
    //    backward's sums follow without dxhat: over t and the channels c of
    //    group gc, sum dxhat = sum_c sum_g Ws[c, g] sum_t ds[t, g] + Z[g, c]
    //    sum_t a_d[t, g], and sum dxhat xhat = sum_c sum_g Ws[c, g] A_r[c, g]
    //    + Z[g, c] P_r[g, c]
#pragma unroll 1
    for (int j = 0; j < L.nch; ++j) {
      const int t0 = j * TC, tc = min(TC, T - t0);
      const int s = begin_visit(m0, 2, j);
      normalize(rows, s, t0, tc);
      __syncthreads();
      for (int i = tid; i < rows * G4 * C; i += kGbThreads) {
        const int c = i % C, k = i / C, gq = k % G4, r = k / G4;
        const float* xc = xh + r * TC * CP + c;
        const float* dr = dsv + (r * T + t0) * GP + 4 * gq;
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
        for (int t = 0; t < tc; ++t) {
          const float xv = xc[t * CP];
          const float4 dv4 = ld4(dr + t * GP);
          acc.x = fmaf(xv, dv4.x, acc.x);
          acc.y = fmaf(xv, dv4.y, acc.y);
          acc.z = fmaf(xv, dv4.z, acc.z);
          acc.w = fmaf(xv, dv4.w, acc.w);
        }
        float4* ar = reinterpret_cast<float4*>(ars + (r * C + c) * GP + 4 * gq);
        if (j > 0) {
          const float4 old = *ar;
          acc = make_float4(old.x + acc.x, old.y + acc.y, old.z + acc.z, old.w + acc.w);
        }
        *ar = acc;
      }
    }
    __syncthreads();
    for (int i = tid; i < rows * G; i += kGbThreads) {   // the group means
      const int r = i / G, gc = i - r * G;
      const float* sd = sg + r * 2 * GP;
      float s1 = 0.f, s2 = gm[r * G2 + G + gc];
      for (int c = gc * cg; c < (gc + 1) * cg; ++c)
        for (int g = 0; g < G; ++g) {
          const float wv = wss[c * ZP + g], zv = zs[(r * C + c) * ZP + g];
          s1 = fmaf(sd[g], wv, fmaf(sd[GP + g], zv, s1));
          s2 = fmaf(wv, ars[(r * C + c) * GP + g], s2);
        }
      gm[r * G2 + gc] = s1 / cnt;
      gm[r * G2 + G + gc] = s2 / cnt;
    }
    for (int i = tid; i < C * G; i += kGbThreads) {   // A += sum_r A_r
      const int c = i / G, g = i - c * G;
      float sm = 0.f;
#pragma unroll
      for (int r = 0; r < kGbMaxRows; ++r)
        if (r < rows) sm += ars[(r * C + c) * GP + g];
      pa[i] += sm;
    }

    // 5. dx = inv (dxhat - mean dxhat - xhat mean dxhat xhat); in tail mode
    //    through the ReLU mask and tsc, with the group's share of dtsc, dtsh
#pragma unroll 1
    for (int j = 0; j < L.nch; ++j) {
      const int t0 = j * TC, tc = min(TC, T - t0);
      const Tin* rs = raw + begin_visit(m0, 3, j) * slot_elems;
      Tin* dx = static_cast<Tin*>(a.dx);
      for (int it = tid; it < kGbParts * C; it += kGbThreads) {
        const int c = it % C, pt = it / C, gc = c / cg;
        float wr[kGbHeadRegs], zr[kGbHeadRegs];
        head_regs(wr, wss + c * ZP);
        float dsc[kGenChunk / kGbParts], dsh[kGenChunk / kGbParts];
        float tsc_k[Tail ? kGenChunk / kGbParts : 1], tsh_k[Tail ? kGenChunk / kGbParts : 1];
#pragma unroll
        for (int k = 0; k < kGenChunk / kGbParts; ++k) {
          dsc[k] = dsh[k] = 0.f;
          if constexpr (Tail) {   // the tail affine of the thread's steps, for every row
            const int t = pt + k * kGbParts;
            const size_t k3 = ((size_t)b * T + t0 + t) * C + c;
            tsc_k[k] = t < tc ? __ldg(a.tsc + k3) : 0.f;
            tsh_k[k] = t < tc ? __ldg(a.tsh + k3) : 0.f;
          }
        }
        for (int r = 0; r < rows; ++r) {
          head_regs(zr, zs + (r * C + c) * ZP);
          const float mean = sts[r * G4S + gc], inv = sts[r * G4S + G + gc];
          const float m1 = gm[r * G2 + gc], m2 = gm[r * G2 + G + gc];
#pragma unroll
          for (int k = 0; k < kGenChunk / kGbParts; ++k) {
            const int t = pt + k * kGbParts;
            if (t < tc) {
              const float dh = dxhat(wr, zr, r, t0 + t, c);
              // xhat from the slot: z, and in tail mode the pre-activation
              const float zv = to_f(rs[t * R * C + r * C + c]);
              float xf = zv, sc = 0.f, pre = 0.f;
              if constexpr (Tail) {
                sc = tsc_k[k];
                pre = tail_pre(zv, sc, tsh_k[k]);
                xf = fmaxf(pre, 0.f);
              }
              const float dxf = inv * (dh - m1 - (xf - mean) * inv * m2);
              const size_t at = (((size_t)b * T + t0 + t) * N + m0 + r) * C + c;
              if constexpr (Tail) {
                const float live = pre > 0.f ? dxf : 0.f;
                Io<Tin>::store(dx + at, live * sc);
                dsc[k] = fmaf(live, zv, dsc[k]);
                dsh[k] += live;
              } else {
                Io<Tin>::store(dx + at, dxf);
              }
            }
          }
        }
        if constexpr (Tail) {   // the loads first, all in flight
          float osc[kGenChunk / kGbParts], osh[kGenChunk / kGbParts];
#pragma unroll
          for (int k = 0; k < kGenChunk / kGbParts; ++k) {
            const int t = pt + k * kGbParts;
            osc[k] = t < tc ? psc[(t0 + t) * C + c] : 0.f;
            osh[k] = t < tc ? psh[(t0 + t) * C + c] : 0.f;
          }
#pragma unroll
          for (int k = 0; k < kGenChunk / kGbParts; ++k) {
            const int t = pt + k * kGbParts;
            if (t < tc) {
              psc[(t0 + t) * C + c] = osc[k] + dsc[k];
              psh[(t0 + t) * C + c] = osh[k] + dsh[k];
            }
          }
        }
      }
    }
    __syncthreads();   // the group's buffers are free
    if (L.resident && m0 + R < n1) load_chunk(m0 + R, L.nch - 1, L.nch - 1);
  }
  if (f_regs) {
#pragma unroll
    for (int k = 0; k < kGbFRegs; ++k) {
      const int i = tid + k * kGbThreads;
      if (i < C * D) pf[i] = freg[k];
    }
  }
}

template <bool Tail, typename Tin>
cudaError_t launch_general_fwd(const Args& a, float* st, float* scratch, int S,
                               cudaStream_t stream) {
  const size_t bytes = (size_t)gen_layout(a.T, a.C, a.D, a.G).floats * sizeof(float);
  const bool in_smem = bytes <= kSmemLimit;
  if (S < 1 || in_smem == (scratch != nullptr)) return cudaErrorInvalidValue;
  const size_t dyn = in_smem ? bytes : 0;
  cudaError_t err = cudaFuncSetAttribute(ltae_pool_fwd_general_kernel<Tin, Tail>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  if (err != cudaSuccess) return err;
  ltae_pool_fwd_general_kernel<Tin, Tail><<<dim3(S, a.B), kGenThreads, dyn, stream>>>(
      a, st, scratch);
  return cudaGetLastError();
}

template <bool Tail, typename Tin>
cudaError_t launch_general_bwd(const Args& a, const float* st, float* part, float* scratch,
                               int S, cudaStream_t stream) {
  const GbLayout L = gb_plan(a.T, a.C, a.D, a.G, sizeof(Tin));
  const size_t bytes = (size_t)L.floats * sizeof(float);
  const bool in_smem = bytes <= kSmemLimit;
  if (S < 1 || in_smem == (scratch != nullptr)) return cudaErrorInvalidValue;
  const size_t dyn = in_smem ? bytes : 0;
  const auto kernel = in_smem ? ltae_pool_bwd_general_kernel<Tin, Tail, true>
                              : ltae_pool_bwd_general_kernel<Tin, Tail, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(S, a.B), kGbThreads, dyn, stream>>>(a, L, st, part, scratch);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int total = bwd_shared_floats(a.C, a.D, a.G) +
                    a.B * bwd_item_floats(a.T, a.C, a.D, a.G, Tail);
  ltae_pool_bwd_reduce<<<(total + 255) / 256, 256, 0, stream>>>(a, part, S, Tail);
  return cudaGetLastError();
}

// Every shape at which the L-TAE is defined (G dividing C and D).
bool bad_general_shape(int B, int T, int N, int C, int D, int G) {
  return B < 1 || N < 1 || T < 1 || C < 1 || G < 1 || C % G || D < G || D % G;
}

}  // namespace

// C entries for ctypes. Pointers are device pointers to contiguous tensors:
// x, go, o and dx of x's type (fp32, or bf16 when x_is_bf16), every other one
// fp32; x, and in tail mode tsc and tsh, start on 16 bytes (the forward
// copies them in 16-byte vectors). tsc and tsh are null for the untailed
// mode; in tail mode the backward also needs dtsc and dtsh. Each kernel runs
// S persistent blocks per batch item (ops/ltae_pool.py::blocks_per_item).
// The forward takes D <= 256 (a thread per (d, half of a row group) in its
// projection).
// The backward writes every element of its sums (acc_a, acc_f, dsum, acc_e,
// dtsc, dtsh) and needs a scratch buffer `part` of S * B *
// ltae_pool_bwd_part_floats(...) floats. Each returns the cudaError_t of its
// launches (0 on success).
extern "C" int ltae_pool_fwd(const void* x, int x_is_bf16, const void* tsc,
                             const void* tsh, const void* bpe, const void* win,
                             const void* ws, const void* pes, void* o, int S, int B,
                             int T, int N, int C, int D, int G, unsigned seed_mix,
                             unsigned thresh, float scale, float eps, void* stream) {
  if (bad_shape(B, T, N, C, D, G) || D > kFwdMaxD || S < 1 ||
      (tsc == nullptr) != (tsh == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a = make_args(B, T, N, C, D, G, seed_mix, thresh, scale, eps);
  a.x = x;
  a.tsc = static_cast<const float*>(tsc);
  a.tsh = static_cast<const float*>(tsh);
  a.bpe = static_cast<const float*>(bpe);
  a.win = static_cast<const float*>(win);
  a.ws = static_cast<const float*>(ws);
  a.pes = static_cast<const float*>(pes);
  a.o = o;
  const bool tail = tsc != nullptr;
  return (int)launch_fwd(x_is_bf16 ? fwd_kernel<__nv_bfloat16>(tail) : fwd_kernel<float>(tail),
                         a, S, static_cast<cudaStream_t>(stream));
}

extern "C" int ltae_pool_bwd_part_floats(int T, int C, int D, int G, int tail) {
  return bwd_shared_floats(C, D, G) + bwd_item_floats(T, C, D, G, tail != 0);
}

extern "C" int ltae_pool_bwd(const void* x, int x_is_bf16, const void* tsc,
                             const void* tsh, const void* go, const void* win,
                             const void* ws, const void* pes, const void* bpe,
                             void* dx, void* acc_a, void* acc_f, void* dsum,
                             void* acc_e, void* dtsc, void* dtsh, void* part, int S,
                             int B, int T, int N, int C, int D, int G,
                             unsigned seed_mix, unsigned thresh, float scale,
                             float eps, void* stream) {
  const bool tail = tsc != nullptr;
  if (bad_shape(B, T, N, C, D, G) || D > kMaxD || S < 1 || part == nullptr ||
      (tsh != nullptr) != tail || (dtsc != nullptr) != tail || (dtsh != nullptr) != tail)
    return (int)cudaErrorInvalidValue;
  Args a = make_args(B, T, N, C, D, G, seed_mix, thresh, scale, eps);
  a.x = x;
  a.go = go;
  a.tsc = static_cast<const float*>(tsc);
  a.tsh = static_cast<const float*>(tsh);
  a.win = static_cast<const float*>(win);
  a.ws = static_cast<const float*>(ws);
  a.pes = static_cast<const float*>(pes);
  a.bpe = static_cast<const float*>(bpe);
  a.dx = dx;
  a.acc_a = static_cast<float*>(acc_a);
  a.acc_f = static_cast<float*>(acc_f);
  a.dsum = static_cast<float*>(dsum);
  a.acc_e = static_cast<float*>(acc_e);
  a.dtsc = static_cast<float*>(dtsc);
  a.dtsh = static_cast<float*>(dtsh);
  return (int)launch_bwd(x_is_bf16 ? bwd_kernel<__nv_bfloat16>(tail) : bwd_kernel<float>(tail),
                         a, static_cast<float*>(part), S, tail, x_is_bf16 ? 2 : 4,
                         static_cast<cudaStream_t>(stream));
}

// The general pair's scratch floats per block: 0 where the workspace of the
// forward (backward = 0) or the backward (for x of fp32, or bf16 with
// x_is_bf16) fits in shared memory, else the size of each block's slice of
// `scratch`.
extern "C" int ltae_pool_general_scratch_floats(int T, int C, int D, int G, int backward,
                                                int x_is_bf16) {
  const int f = backward ? gb_plan(T, C, D, G, x_is_bf16 ? 2 : 4).floats
                         : gen_layout(T, C, D, G).floats;
  return (size_t)f * sizeof(float) <= kSmemLimit ? 0 : f;
}

// The general backward's plan for a shape (gb_plan), into out[4]: rows a
// group, whether the group's x stays resident, steps a chunk, and the
// workspace's floats per block (past 227 KB: in the scratch buffer).
extern "C" int ltae_pool_bwd_general_plan(int T, int C, int D, int G, int x_is_bf16,
                                          int* out) {
  if (T < 1 || C < 1 || G < 1 || D < 1) return (int)cudaErrorInvalidValue;
  const GbLayout L = gb_plan(T, C, D, G, x_is_bf16 ? 2 : 4);
  out[0] = L.rows;
  out[1] = L.resident;
  out[2] = L.tc;
  out[3] = L.floats;
  return 0;
}

// The general pair (any shape with G dividing C and D), with the arguments
// of ltae_pool_fwd / ltae_pool_bwd and: st (B, N, 4, G) fp32, which the
// forward writes and the backward reads; scratch, of B * S *
// ltae_pool_general_scratch_floats(...) floats where that is not 0, else
// null. The backward's `part` holds B * S * ltae_pool_bwd_part_floats(...).
extern "C" int ltae_pool_fwd_general(const void* x, int x_is_bf16, const void* tsc,
                                     const void* tsh, const void* bpe, const void* win,
                                     const void* ws, const void* pes, void* o, void* st,
                                     void* scratch, int S, int B, int T, int N, int C, int D,
                                     int G, unsigned seed_mix, unsigned thresh, float scale,
                                     float eps, void* stream) {
  if (bad_general_shape(B, T, N, C, D, G) || st == nullptr ||
      (tsc == nullptr) != (tsh == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a = make_args(B, T, N, C, D, G, seed_mix, thresh, scale, eps);
  a.x = x;
  a.tsc = static_cast<const float*>(tsc);
  a.tsh = static_cast<const float*>(tsh);
  a.bpe = static_cast<const float*>(bpe);
  a.win = static_cast<const float*>(win);
  a.ws = static_cast<const float*>(ws);
  a.pes = static_cast<const float*>(pes);
  a.o = o;
  float* stf = static_cast<float*>(st);
  float* sc = static_cast<float*>(scratch);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool tail = tsc != nullptr;
  if (x_is_bf16)
    return (int)(tail ? launch_general_fwd<true, __nv_bfloat16>(a, stf, sc, S, s)
                      : launch_general_fwd<false, __nv_bfloat16>(a, stf, sc, S, s));
  return (int)(tail ? launch_general_fwd<true, float>(a, stf, sc, S, s)
                    : launch_general_fwd<false, float>(a, stf, sc, S, s));
}

extern "C" int ltae_pool_bwd_general(const void* x, int x_is_bf16, const void* tsc,
                                     const void* tsh, const void* go, const void* win,
                                     const void* ws, const void* pes, const void* bpe,
                                     const void* st, void* dx, void* acc_a, void* acc_f,
                                     void* dsum, void* acc_e, void* dtsc, void* dtsh,
                                     void* part, void* scratch, int S, int B, int T, int N,
                                     int C, int D, int G, unsigned seed_mix, unsigned thresh,
                                     float scale, float eps, void* stream) {
  const bool tail = tsc != nullptr;
  if (bad_general_shape(B, T, N, C, D, G) || st == nullptr || part == nullptr ||
      (tsh != nullptr) != tail || (dtsc != nullptr) != tail || (dtsh != nullptr) != tail)
    return (int)cudaErrorInvalidValue;
  Args a = make_args(B, T, N, C, D, G, seed_mix, thresh, scale, eps);
  a.x = x;
  a.go = go;
  a.tsc = static_cast<const float*>(tsc);
  a.tsh = static_cast<const float*>(tsh);
  a.win = static_cast<const float*>(win);
  a.ws = static_cast<const float*>(ws);
  a.pes = static_cast<const float*>(pes);
  a.bpe = static_cast<const float*>(bpe);
  a.dx = dx;
  a.acc_a = static_cast<float*>(acc_a);
  a.acc_f = static_cast<float*>(acc_f);
  a.dsum = static_cast<float*>(dsum);
  a.acc_e = static_cast<float*>(acc_e);
  a.dtsc = static_cast<float*>(dtsc);
  a.dtsh = static_cast<float*>(dtsh);
  const float* stf = static_cast<const float*>(st);
  float* pt = static_cast<float*>(part);
  float* sc = static_cast<float*>(scratch);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16)
    return (int)(tail ? launch_general_bwd<true, __nv_bfloat16>(a, stf, pt, sc, S, s)
                      : launch_general_bwd<false, __nv_bfloat16>(a, stf, pt, sc, S, s));
  return (int)(tail ? launch_general_bwd<true, float>(a, stf, pt, sc, S, s)
                    : launch_general_bwd<false, float>(a, stf, pt, sc, S, s));
}
