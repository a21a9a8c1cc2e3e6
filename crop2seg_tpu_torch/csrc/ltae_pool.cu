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
// and four sums over rows, added into device memory with fp32 atomics:
//   A[c, g] += sum_t xhat[t, c] ds[t, g]     F[c, d] += P[g(d), c] go[d]
//   Dsum[b, t, g] += ds[t, g]                E[b, t, d] += a_d[t, g(d)] go[d]
// from which the wrapper forms dW_f, db_f, du, dcs and dpe in small products.
// Hopper's blocks run in no order, unlike the TPU grid that carries these sums
// (and dtsc, dtsh) in VMEM across sequential steps, so each block first sums
// its R rows and then adds one value per entry: (C*G + C*D + T*G + T*D)
// atomics per block, plus 2*T*C in tail mode. The order of those adds changes
// from run to run, so the gradients of W_f, b_f, u, cs, pe, tsc and tsh vary
// in their last bits between runs; dx and o do not (no atomics).
//
// bf16: x (z), go, o and dx are bf16 in device memory (x and z read with
// 16-byte loads of 8 values); every sum, the GroupNorm statistics and the
// softmax are fp32, and xhat, a and the per-row scratch are fp32 in shared
// memory, so a bf16 variant differs from the fp32 one only by the roundings
// of its input and outputs. The tail mode's mask and dtsc need the raw z in
// the backward: it is read again from device memory (just read, so mostly
// from L2) rather than kept in shared memory, which stays as below.
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
// What the design does about it: x is read once per kernel with 16-byte
// loads into shared memory (the tail affine applied on the way), and every
// product of a row runs out of shared memory and registers. The per-d
// projection (forward) and the per-block sums (backward) run block-wide, so
// each W / bpe element fetched from L2 serves all the block's rows.
// chip_smoke.py measures every variant beside its bound.
//
// Layout: one block = R rows of one batch item, one warp per row for the
// per-row steps. Shared memory per row (fp32 in every variant), +1 pads
// against bank conflicts:
//   forward:  xhat (T, C+1) | a_d (T, G+1) | P (G, C+1) | scratch (C)
//   backward: xhat, dxhat (T, C+1) | a, a_d, p1->ds (T, G+1) | Z, P (G, C+1)
//             | go (D) | scratch (2C)
// The tail mode adds none: after the GroupNorm backward a row's dxhat buffer
// holds live, and the block-wide dtsc sum reads z once more from device
// memory (L2 as a rule). At the main-path shape the forward takes R = 8
// (195 KiB), the backward R = 4 (215 KiB), in every variant: one block per SM
// either way.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kMaxT = 64;      // lanes own t and t + 32
constexpr int kMaxC = 64;      // lanes own c and c + 32
constexpr int kMaxG = 16;      // per-head accumulators held in registers
constexpr int kMaxRows = 8;    // rows (= warps) per block
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

__host__ __device__ inline int bwd_row_floats(int T, int C, int D, int G) {
  return 2 * T * (C + 1) + 3 * T * (G + 1) + 2 * G * (C + 1) + D + 2 * C;
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
// affine; the warp's lanes own channels lane and lane + 32 and keep their
// rsqrt(var + eps) in inv_c. vr: C floats of scratch.
__device__ void group_norm_row(float* xr, float* vr, int T, int C, int G,
                               float eps, float inv_c[2]) {
  const int lane = threadIdx.x & 31, CP = C + 1, cg = C / G;
  const float cnt = (float)(T * cg);
  float mean_c[2] = {0.f, 0.f};
  inv_c[0] = inv_c[1] = 0.f;
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
      inv_c[k] = rsqrtf(q / cnt + eps);
      for (int t = 0; t < T; ++t) xr[t * CP + c] = (xr[t * CP + c] - mean_c[k]) * inv_c[k];
    }
  }
  __syncwarp();
}

// Scores xhat Ws + pes and the masked softmax over T for one row (lanes own
// t and t + 32); writes a (if ar) and a_d, each (T, G+1).
__device__ void attention_row(const Args& a, const float* xr, const float* ws_s,
                              float* ar, float* adr, int b, int n) {
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
      if (v0) {
        if (ar != nullptr) ar[lane * GP + g] = e0;
        adr[lane * GP + g] = e0 * keep_scale(a, b, lane, n, g);
      }
      if (v1) {
        if (ar != nullptr) ar[(lane + 32) * GP + g] = e1;
        adr[(lane + 32) * GP + g] = e1 * keep_scale(a, b, lane + 32, n, g);
      }
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
  float inv_c[2];
  group_norm_row(xr, xr + off_v, T, C, G, a.eps, inv_c);
  attention_row(a, xr, ws_s, nullptr, xr + off_a, b, n0 + warp);
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

template <typename Tin, bool Tail>
__global__ void __launch_bounds__(32 * kMaxRows)
ltae_pool_bwd_kernel(const Args a) {
  extern __shared__ float smem[];
  const int T = a.T, C = a.C, D = a.D, G = a.G, N = a.N;
  const int CP = C + 1, GP = G + 1, dv = D / G, cg = C / G;
  const int R = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.y, n0 = blockIdx.x * R;
  const int rf = bwd_row_floats(T, C, D, G);
  const int off_dx = T * CP, off_a = 2 * T * CP, off_ad = off_a + T * GP,
            off_ds = off_ad + T * GP, off_z = off_ds + T * GP,
            off_p = off_z + G * CP, off_go = off_p + G * CP, off_v = off_go + D;
  float* ws_s = smem;
  float* rows = smem + C * G;

  // ---- stage Ws, the x rows and the go rows (zeros past N) ----------------
  stage<Tin, Tail>(a, ws_s, rows, rf, R, b, n0);
  const Tin* gop = static_cast<const Tin*>(a.go);
  for (int i = threadIdx.x; i < R * D; i += blockDim.x) {
    const int r = i / D, d = i - r * D;
    const int n = n0 + r;
    rows[r * rf + off_go + d] = n < N ? Io<Tin>::load(gop + ((size_t)b * N + n) * D + d) : 0.f;
  }
  __syncthreads();

  // ---- block-wide: Z[g, c] = sum_{d in g} W[c, d] go[d] and
  //      q[t, g] = sum_{d in g} go[d] bpe[t, d] (into the ds slot) ---------
  for (int i = threadIdx.x; i < R * G * C; i += blockDim.x) {
    const int r = i / (G * C), rem = i - r * G * C;
    const int g = rem / C, c = rem - g * C;
    const float* gr = rows + r * rf + off_go + g * dv;
    const float* w = a.win + c * D + g * dv;
    float z = 0.f;
    for (int j = 0; j < dv; ++j) z = fmaf(__ldg(w + j), gr[j], z);
    rows[r * rf + off_z + g * CP + c] = z;
  }
  const float* bpe = a.bpe + (size_t)b * T * D;
  for (int i = threadIdx.x; i < R * T * G; i += blockDim.x) {
    const int r = i / (T * G), rem = i - r * T * G;
    const int t = rem / G, g = rem - t * G;
    const float* gr = rows + r * rf + off_go + g * dv;
    const float* pv = bpe + t * D + g * dv;
    float q = 0.f;
    for (int j = 0; j < dv; ++j) q = fmaf(__ldg(pv + j), gr[j], q);
    rows[r * rf + off_ds + t * GP + g] = q;
  }
  __syncthreads();

  // ---- per-row steps: warp `warp` owns row n -------------------------------
  const int n = n0 + warp;
  float* xr = rows + warp * rf;
  float* dxr = xr + off_dx;
  float* ar = xr + off_a;
  float* adr = xr + off_ad;
  float* dsr = xr + off_ds;
  float* zr = xr + off_z;
  float* vr = xr + off_v;
  float inv_c[2];
  group_norm_row(xr, vr, T, C, G, a.eps, inv_c);
  attention_row(a, xr, ws_s, ar, adr, b, n);

  // p1 = q + xhat Z^T, then ds = a_d p1 - a sum_t a_d p1 (lanes own t, t + 32)
  {
    const bool v0 = lane < T, v1 = lane + 32 < T;
    const int t0 = v0 ? lane : 0, t1 = v1 ? lane + 32 : 0;
    float p0[kMaxG], p1[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      p0[g] = g < G ? dsr[t0 * GP + g] : 0.f;
      p1[g] = g < G ? dsr[t1 * GP + g] : 0.f;
    }
    for (int c = 0; c < C; ++c) {
      const float x0 = xr[t0 * CP + c], x1 = xr[t1 * CP + c];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          const float zv = zr[g * CP + c];
          p0[g] = fmaf(x0, zv, p0[g]);
          p1[g] = fmaf(x1, zv, p1[g]);
        }
      }
    }
    __syncwarp();   // every lane has read its q before any ds overwrites it
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) {
        const float ad0 = v0 ? adr[t0 * GP + g] : 0.f, ad1 = v1 ? adr[t1 * GP + g] : 0.f;
        const float a0 = v0 ? ar[t0 * GP + g] : 0.f, a1 = v1 ? ar[t1 * GP + g] : 0.f;
        const float tot = warp_sum(ad0 * p0[g] + ad1 * p1[g]);
        if (v0) dsr[t0 * GP + g] = ad0 * p0[g] - a0 * tot;
        if (v1) dsr[t1 * GP + g] = ad1 * p1[g] - a1 * tot;
      }
    }
    __syncwarp();
  }

  pool_row(xr, adr, xr + off_p, T, C, G);

  // dxhat = ds Ws^T + a_d Z, and its per-channel sums for the GroupNorm
  // backward, sum_t dxhat and sum_t dxhat xhat, into vr (lanes own c, c + 32)
  {
    const bool c0 = lane < C, c1 = lane + 32 < C;
    const int ca = c0 ? lane : 0, cb = c1 ? lane + 32 : 0;
    float w0[kMaxG], w1[kMaxG], z0[kMaxG], z1[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      w0[g] = g < G ? ws_s[ca * G + g] : 0.f;
      w1[g] = g < G ? ws_s[cb * G + g] : 0.f;
      z0[g] = g < G ? zr[g * CP + ca] : 0.f;
      z1[g] = g < G ? zr[g * CP + cb] : 0.f;
    }
    float m1[2] = {0.f, 0.f}, m2[2] = {0.f, 0.f};
    for (int t = 0; t < T; ++t) {
      const float* dst = dsr + t * GP;
      const float* adt = adr + t * GP;
      float d0 = 0.f, d1 = 0.f;
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          const float sv = dst[g], av = adt[g];
          d0 = fmaf(sv, w0[g], fmaf(av, z0[g], d0));
          d1 = fmaf(sv, w1[g], fmaf(av, z1[g], d1));
        }
      }
      if (c0) {
        dxr[t * CP + lane] = d0;
        m1[0] += d0;
        m2[0] = fmaf(d0, xr[t * CP + lane], m2[0]);
      }
      if (c1) {
        dxr[t * CP + lane + 32] = d1;
        m1[1] += d1;
        m2[1] = fmaf(d1, xr[t * CP + lane + 32], m2[1]);
      }
    }
    if (c0) { vr[lane] = m1[0]; vr[C + lane] = m2[0]; }
    if (c1) { vr[lane + 32] = m1[1]; vr[C + lane + 32] = m2[1]; }
    __syncwarp();
  }

  // ---- GroupNorm backward into dx (lanes own c, c + 32); in tail mode
  //      through the ReLU mask and tsc, keeping live in the row's dxhat
  //      buffer for the dtsc and dtsh sums ------------------------------------
  {
    const float cnt = (float)(T * cg);
    const Tin* z = static_cast<const Tin*>(a.x);
    Tin* dx = static_cast<Tin*>(a.dx);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int c = lane + 32 * k;
      if (c < C && n < N) {
        const int g0 = (c / cg) * cg;
        float s1 = 0.f, s2 = 0.f;
        for (int j = 0; j < cg; ++j) {
          s1 += vr[g0 + j];
          s2 += vr[C + g0 + j];
        }
        s1 /= cnt;
        s2 /= cnt;
        for (int t = 0; t < T; ++t) {
          const size_t at = ((size_t)(b * T + t) * N + n) * C + c;
          const float dxf = inv_c[k] * (dxr[t * CP + c] - s1 - xr[t * CP + c] * s2);
          if constexpr (Tail) {
            const size_t k2 = (size_t)(b * T + t) * C + c;
            const float sc = __ldg(a.tsc + k2);
            const float live =
                tail_pre(Io<Tin>::load(z + at), sc, __ldg(a.tsh + k2)) > 0.f ? dxf : 0.f;
            Io<Tin>::store(dx + at, live * sc);
            dxr[t * CP + c] = live;
          } else {
            Io<Tin>::store(dx + at, dxf);
          }
        }
      }
    }
  }
  __syncthreads();

  // ---- block-wide sums of the R rows, one atomic add per entry -------------
  // Rows past N hold xhat = 0, ds = 0, go = 0 and dxhat = 0 (so live = 0),
  // so they add nothing.
  for (int i = threadIdx.x; i < C * G; i += blockDim.x) {
    const int c = i / G, g = i - c * G;
    float s = 0.f;
    for (int r = 0; r < R; ++r) {
      const float* xrr = rows + r * rf;
      const float* dsrr = xrr + off_ds;
      for (int t = 0; t < T; ++t) s = fmaf(xrr[t * CP + c], dsrr[t * GP + g], s);
    }
    atomicAdd(a.acc_a + i, s);
  }
  for (int i = threadIdx.x; i < T * G; i += blockDim.x) {
    const int t = i / G, g = i - t * G;
    float s = 0.f;
    for (int r = 0; r < R; ++r) s += rows[r * rf + off_ds + t * GP + g];
    atomicAdd(a.dsum + (size_t)b * T * G + i, s);
  }
  for (int i = threadIdx.x; i < C * D; i += blockDim.x) {
    const int c = i / D, d = i - c * D;
    const int g = d / dv;
    float s = 0.f;
    for (int r = 0; r < R; ++r)
      s = fmaf(rows[r * rf + off_p + g * CP + c], rows[r * rf + off_go + d], s);
    atomicAdd(a.acc_f + i, s);
  }
  for (int i = threadIdx.x; i < T * D; i += blockDim.x) {
    const int t = i / D, d = i - t * D;
    const int g = d / dv;
    float s = 0.f;
    for (int r = 0; r < R; ++r)
      s = fmaf(rows[r * rf + off_ad + t * GP + g], rows[r * rf + off_go + d], s);
    atomicAdd(a.acc_e + (size_t)b * T * D + i, s);
  }
  if constexpr (Tail) {
    // dtsc[b, t, c] += sum_rows live z (z read once more, from L2 as a rule),
    // dtsh[b, t, c] += sum_rows live
    const Tin* z = static_cast<const Tin*>(a.x);
    const int rv = min(R, N - n0);
    for (int i = threadIdx.x; i < T * C; i += blockDim.x) {
      const int t = i / C, c = i - t * C;
      float s_sc = 0.f, s_sh = 0.f;
      for (int r = 0; r < rv; ++r) {
        const float live = rows[r * rf + off_dx + t * CP + c];
        s_sc = fmaf(live, Io<Tin>::load(z + ((size_t)(b * T + t) * N + n0 + r) * C + c), s_sc);
        s_sh += live;
      }
      atomicAdd(a.dtsc + (size_t)b * T * C + i, s_sc);
      atomicAdd(a.dtsh + (size_t)b * T * C + i, s_sh);
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

template <typename Tin>
Kernel bwd_kernel(bool tail) {
  return tail ? &ltae_pool_bwd_kernel<Tin, true> : &ltae_pool_bwd_kernel<Tin, false>;
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
// also needs dtsc and dtsh. The accumulators of the backward (and dtsc,
// dtsh) must hold zeros. Each returns the cudaError_t of its launch (0 on
// success).
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

extern "C" int ltae_pool_bwd(const void* x, int x_is_bf16, const void* tsc,
                             const void* tsh, const void* go, const void* win,
                             const void* ws, const void* pes, const void* bpe,
                             void* dx, void* acc_a, void* acc_f, void* dsum,
                             void* acc_e, void* dtsc, void* dtsh, int B, int T,
                             int N, int C, int D, int G, unsigned seed_mix,
                             unsigned thresh, float scale, float eps, void* stream) {
  const bool tail = tsc != nullptr;
  if (bad_shape(B, T, N, C, D, G) || (tsh != nullptr) != tail ||
      (dtsc != nullptr) != tail || (dtsh != nullptr) != tail)
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
  return (int)launch(x_is_bf16 ? bwd_kernel<__nv_bfloat16>(tail) : bwd_kernel<float>(tail),
                     bwd_row_floats(T, C, D, G), a, static_cast<cudaStream_t>(stream));
}
