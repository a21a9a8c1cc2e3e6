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
// Per pixel row n of batch item b, over T <= 64 steps, C <= 64 channels,
// G <= 16 heads of dv = D/G channels:
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
// Forward: one block = R rows of one batch item, one warp per row for the
// per-row steps; x is read once with 16-byte loads into shared memory (the
// tail affine applied on the way), and the per-d projection runs block-wide,
// so each W / bpe element fetched from L2 serves all the block's rows. Shared
// memory per row (fp32, +1 pads against bank conflicts): xhat (T, C+1) | a_d
// (T, G+1) | P (G, C+1) | scratch (C); R = 8 at the main-path shape (195 KiB).
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

constexpr int kMaxT = 64;      // lanes own t and t + 32
constexpr int kMaxC = 64;      // lanes own c and c + 32
constexpr int kMaxG = 16;      // per-head accumulators held in registers
constexpr int kMaxD = 256;     // backward: W and bpe[b] held in shared memory
constexpr int kMaxRows = 8;    // forward: rows (= warps) per block
constexpr int kBwdThreads = 512;  // backward: 16 warps, warp g owns head g
constexpr int kJ = 16;         // backward: a head's d channels per pass in registers
constexpr int kMaxTPer = kMaxT / (kBwdThreads / kMaxC);  // t per thread, C-parallel steps
constexpr size_t kSmemLimit = 232448;  // 227 KB, the most a block may use

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
  static constexpr int kVec = 4;   // values per 16-byte load
  __device__ static void unpack(const uint4& r, float* v) {
    v[0] = __uint_as_float(r.x);
    v[1] = __uint_as_float(r.y);
    v[2] = __uint_as_float(r.z);
    v[3] = __uint_as_float(r.w);
  }
  __device__ static float load(const float* p) { return __ldg(p); }
  __device__ static void store(float* p, float v) { *p = v; }
};

template <> struct Io<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ static void unpack(const uint4& r, float* v) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // element 2i sits in the low half
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static float load(const __nv_bfloat16* p) {
    return __uint_as_float(
        (uint32_t)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
  }
  __device__ static void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
};

__host__ __device__ inline int fwd_row_floats(int T, int C, int G) {
  return T * (C + 1) + T * (G + 1) + G * (C + 1) + C;
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

// Stage Ws and the rows n0 .. n0+R-1 of batch item b as fp32 (zeros past N),
// in tail mode with max(z * tsc + tsh, 0) applied on the way.
template <typename Tin, bool Tail>
__device__ void stage(const Args& a, float* ws_s, float* rows, int rf, int R,
                      int b, int n0) {
  const int T = a.T, C = a.C, CP = C + 1, RC = R * C;
  for (int i = threadIdx.x; i < C * a.G; i += blockDim.x) ws_s[i] = a.ws[i];
  constexpr int V = Io<Tin>::kVec;
  const Tin* x = static_cast<const Tin*>(a.x);
  const int nvec = T * RC / V;   // C % 8 == 0: a vector never straddles rows
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    const int e = i * V;
    const int t = e / RC, rem = e - t * RC;
    const int r = rem / C, c = rem - r * C;
    const int n = n0 + r;
    float v[V];
    if (n < a.N) {
      Io<Tin>::unpack(__ldg(reinterpret_cast<const uint4*>(
                          x + ((size_t)(b * T + t) * a.N + n) * C + c)), v);
      if constexpr (Tail) {
        const size_t k = (size_t)(b * T + t) * C + c;
#pragma unroll
        for (int j = 0; j < V; ++j)
          v[j] = fmaxf(tail_pre(v[j], __ldg(a.tsc + k + j), __ldg(a.tsh + k + j)), 0.f);
      }
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = 0.f;
    }
    float* dst = rows + r * rf + t * CP + c;
#pragma unroll
    for (int j = 0; j < V; ++j) dst[j] = v[j];
  }
}

// GroupNorm of one row (T, C) in place over (T, C/G), two-pass fp32, no
// affine; the warp's lanes own channels lane and lane + 32. vr: C floats of
// scratch.
__device__ void group_norm_row(float* xr, float* vr, int T, int C, int G, float eps) {
  const int lane = threadIdx.x & 31, CP = C + 1, cg = C / G;
  const float cnt = (float)(T * cg);
  float mean_c[2] = {0.f, 0.f};
  for (int c = lane; c < C; c += 32) {
    float s = 0.f;
    for (int t = 0; t < T; ++t) s += xr[t * CP + c];
    vr[c] = s;
  }
  __syncwarp();
#pragma unroll
  for (int k = 0; k < 2; ++k) {
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
  for (int k = 0; k < 2; ++k) {
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
  for (int k = 0; k < 2; ++k) {
    const int c = lane + 32 * k;
    if (c < C) {
      const int g0 = (c / cg) * cg;
      float q = 0.f;
      for (int j = 0; j < cg; ++j) q += vr[g0 + j];
      const float inv = rsqrtf(q / cnt + eps);
      for (int t = 0; t < T; ++t) xr[t * CP + c] = (xr[t * CP + c] - mean_c[k]) * inv;
    }
  }
  __syncwarp();
}

// Scores xhat Ws + pes and the masked softmax over T for one row (lanes own
// t and t + 32); writes a_d (T, G+1).
__device__ void attention_row(const Args& a, const float* xr, const float* ws_s,
                              float* adr, int b, int n) {
  const int lane = threadIdx.x & 31, T = a.T, C = a.C, G = a.G;
  const int CP = C + 1, GP = G + 1;
  const bool v0 = lane < T, v1 = lane + 32 < T;
  float s0[kMaxG], s1[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) s0[g] = s1[g] = 0.f;
  const float* x0p = xr + (v0 ? lane : 0) * CP;   // lanes past T read row 0
  const float* x1p = xr + (v1 ? lane + 32 : 0) * CP;
  for (int c = 0; c < C; ++c) {
    const float x0 = x0p[c], x1 = x1p[c];
    const float* w = ws_s + c * G;
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) {
        const float wv = w[g];
        s0[g] = fmaf(x0, wv, s0[g]);
        s1[g] = fmaf(x1, wv, s1[g]);
      }
    }
  }
  const float* pes = a.pes + (size_t)b * G * T;
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g < G) {   // G is uniform: the whole warp takes the shuffles
      const float z0 = v0 ? s0[g] + pes[g * T + lane] : -CUDART_INF_F;
      const float z1 = v1 ? s1[g] + pes[g * T + lane + 32] : -CUDART_INF_F;
      const float m = warp_max(fmaxf(z0, z1));
      float e0 = v0 ? expf(z0 - m) : 0.f;
      float e1 = v1 ? expf(z1 - m) : 0.f;
      const float inv = 1.f / warp_sum(e0 + e1);
      e0 *= inv;
      e1 *= inv;
      if (v0) adr[lane * GP + g] = e0 * keep_scale(a, b, lane, n, g);
      if (v1) adr[(lane + 32) * GP + g] = e1 * keep_scale(a, b, lane + 32, n, g);
    }
  }
  __syncwarp();
}

// P[g, c] = sum_t a_d[t, g] xhat[t, c] for one row (lanes own c, c + 32).
__device__ void pool_row(const float* xr, const float* adr, float* pr, int T,
                         int C, int G) {
  const int lane = threadIdx.x & 31, CP = C + 1, GP = G + 1;
  const bool c0 = lane < C, c1 = lane + 32 < C;
  float p0[kMaxG], p1[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) p0[g] = p1[g] = 0.f;
  for (int t = 0; t < T; ++t) {
    const float* xt = xr + t * CP;
    const float x0 = c0 ? xt[lane] : 0.f;
    const float x1 = c1 ? xt[lane + 32] : 0.f;
    const float* at = adr + t * GP;
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) {
        const float av = at[g];
        p0[g] = fmaf(av, x0, p0[g]);
        p1[g] = fmaf(av, x1, p1[g]);
      }
    }
  }
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g < G) {
      if (c0) pr[g * CP + lane] = p0[g];
      if (c1) pr[g * CP + lane + 32] = p1[g];
    }
  }
  __syncwarp();
}

template <typename Tin, bool Tail>
__global__ void __launch_bounds__(32 * kMaxRows)
ltae_pool_fwd_kernel(const Args a) {
  extern __shared__ float smem[];
  const int T = a.T, C = a.C, D = a.D, G = a.G, N = a.N;
  const int CP = C + 1, GP = G + 1, dv = D / G;
  const int R = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int b = blockIdx.y, n0 = blockIdx.x * R;
  const int rf = fwd_row_floats(T, C, G);
  const int off_a = T * CP, off_p = off_a + T * GP, off_v = off_p + G * CP;
  float* ws_s = smem;            // (C, G)
  float* rows = smem + C * G;    // R regions of rf floats

  stage<Tin, Tail>(a, ws_s, rows, rf, R, b, n0);
  __syncthreads();

  float* xr = rows + warp * rf;
  group_norm_row(xr, xr + off_v, T, C, G, a.eps);
  attention_row(a, xr, ws_s, xr + off_a, b, n0 + warp);
  pool_row(xr, xr + off_a, xr + off_p, T, C, G);
  __syncthreads();

  // o[d] = P[g(d)] . W[:, d] + sum_t a_d[t, g(d)] bpe[t, d], block-wide: a
  // thread owns d for all R rows, so each W / bpe element read serves R rows.
  const float* bpe = a.bpe + (size_t)b * T * D;
  Tin* o = static_cast<Tin*>(a.o);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    const int g = d / dv;
    float acc[kMaxRows];
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) acc[r] = 0.f;
    for (int c = 0; c < C; ++c) {
      const float w = __ldg(a.win + c * D + d);
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r)
        if (r < R) acc[r] = fmaf(rows[r * rf + off_p + g * CP + c], w, acc[r]);
    }
    for (int t = 0; t < T; ++t) {
      const float pv = __ldg(bpe + t * D + d);
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r)
        if (r < R) acc[r] = fmaf(rows[r * rf + off_a + t * GP + g], pv, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r)
      if (r < R && n0 + r < N) Io<Tin>::store(o + ((size_t)b * N + n0 + r) * D + d, acc[r]);
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
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
  asm volatile("cp.async.commit_group;\n" ::);
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

cudaError_t launch(Kernel kernel, int rf, const Args& a, cudaStream_t stream) {
  int rows = kMaxRows;
  auto bytes = [&](int r) { return (size_t)(a.C * a.G + r * rf) * sizeof(float); };
  while (rows > 1 && bytes(rows) > kSmemLimit) --rows;
  if (bytes(rows) > kSmemLimit) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes(rows));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + rows - 1) / rows, a.B);
  kernel<<<grid, 32 * rows, bytes(rows), stream>>>(a);
  return cudaGetLastError();
}

template <typename Tin>
Kernel fwd_kernel(bool tail) {
  return tail ? &ltae_pool_fwd_kernel<Tin, true> : &ltae_pool_fwd_kernel<Tin, false>;
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

}  // namespace

// C entries for ctypes. Pointers are device pointers to contiguous tensors:
// x, go, o and dx of x's type (fp32, or bf16 when x_is_bf16), every other one
// fp32. tsc and tsh are null for the untailed mode; in tail mode the backward
// also needs dtsc and dtsh. The backward writes every element of its sums
// (acc_a, acc_f, dsum, acc_e, dtsc, dtsh) and needs a scratch buffer `part`
// of S * B * ltae_pool_bwd_part_floats(...) floats, S blocks per batch item.
// Each returns the cudaError_t of its launches (0 on success).
extern "C" int ltae_pool_fwd(const void* x, int x_is_bf16, const void* tsc,
                             const void* tsh, const void* bpe, const void* win,
                             const void* ws, const void* pes, void* o, int B,
                             int T, int N, int C, int D, int G, unsigned seed_mix,
                             unsigned thresh, float scale, float eps, void* stream) {
  if (bad_shape(B, T, N, C, D, G) || (tsc == nullptr) != (tsh == nullptr))
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
  return (int)launch(x_is_bf16 ? fwd_kernel<__nv_bfloat16>(tail) : fwd_kernel<float>(tail),
                     fwd_row_floats(T, C, G), a, static_cast<cudaStream_t>(stream));
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
