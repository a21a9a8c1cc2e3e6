// L-TAE stage dump for NVIDIA Hopper (sm_90a): the fused eval kernel's first
// stages, each written out, for checking a rebuilt kernel 1 stage by stage.
//
// Replaces scripts/debug_ltae_stages.py::_kernel (pallas_call at
// debug_ltae_stages.py:91). Wrapper and the plain PyTorch version:
// crop2seg_tpu_torch/ops/ltae_stages.py.
//
// Per pixel row n of batch item b, over T <= 64 steps, C <= 128 channels, D
// model channels in G heads (eps 1e-5), all in fp32:
//   xn     = GroupNorm_G(x) over (T, C/G), no affine, ONE-PASS variance:
//            mean = E[x], var = E[x^2] - mean^2 per group
//   h      = xn @ W_in + b_in + pe[b, t]           (T, D); h[t = 0] out
//   scores = h @ U + cs                            (T, G), out BEFORE the mask
//   attn   = softmax_T(scores, -1e6 where mask > 0.5)       (G, T) out
//   o[d]   = sum_t attn[g(d), t] h[t, d]           (D,) out, g(d) = d / (D/G)
// Unlike kernel 1 it builds h (T x D per row) and does not fold the query:
// what it checks is each stage as the unfused formulas compute it.
//
// Bound on an H100 SXM (3.35 TB/s; 67 TFLOP/s fp32 on the CUDA cores) at the
// script's shape B=1, T=61, N=256, C=64, D=256, G=16: ~2.5 MFLOP per row
// (2 T C D for h, 2 T D G for the scores), 0.65 GFLOP per launch, >= 0.010
// ms; bytes ~6.5 MB (x 4 MB in; scores and attn 1 MB each, h0 and o out),
// 0.002 ms. Operations bound it.
//
// What held its first design (two rows and 256 threads a block, so 128
// blocks of 8 warps, under one an SM at N = 256; each W_in element an L2
// load inside the channel loop, serving 16 products; each score a 256-long
// serial dot product per (row, step, head) thread with U read from L2; 0.176
// ms, 18x its bound) was latency with nothing to hide it. This design:
// - one row a block, 512 threads (16 warps), N x B blocks: 256 at the
//   script's shape, two waves of one block an SM (h, W_in and x take ~180
//   KiB, so a second block does not fit beside);
// - x (T, C), U (D, G) and W_in (C, D; in chunks of 64 channels where C =
//   128 does not fit beside h) come into shared memory by 16-byte cp.async,
//   once per block, W_in and U behind the GroupNorm;
// - the projection is a register tile: a thread takes 8 steps x 4 channels
//   d of h, x and four W_in rows as float4, 128 products per 12 shared
//   loads, summed over c in order;
// - the scores are a block-wide tile product over h with U from shared
//   memory: thread (step, four heads, half of D), h and four U rows as
//   float4, the halves added by a shuffle;
// - the softmax stays a warp per head (lanes own t and t + 32); o is a
//   thread per (d, half of T), the halves added by a shuffle.
// The products stay on the CUDA cores: what this kernel checks is fp32
// arithmetic. Measured in PERF.md, section 6 (the kernel's device time by
// torch.profiler: the wrapper's call is host-bound at this size).
//
// Shared memory (floats; row strides padded so that the float4 loads of a
// warp hit distinct banks): xs (T rounded up to 8, C rounded up to 4 | 4) |
// h (T, D rounded up to 4, then to 8 mod 32) | W_in chunk (64 or C rows, the
// same stride) | U (D rounded up to 4, G rounded up to 4 | 4) | attention (G,
// T) | the GroupNorm's partial sums (2 x 8 x C) and statistics (2 C): 178
// KiB at the script's shape, 187 KiB at T = 64, C = 128, D = 256, G = 16.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kMaxT = 64;      // lanes own t and t + 32 in the softmax
constexpr int kMaxC = 128;
constexpr int kThreads = 512;  // one row a block, 16 warps
constexpr int kTt = 8;         // projection: steps of a thread's tile
constexpr int kWc = 64;        // W_in rows in shared memory at a time
constexpr int kParts = 8;      // GroupNorm: parts of T summed apart, then in order
constexpr size_t kSmemLimit = 232448;  // 227 KB, the most a block may use

struct Args {
  const float* x;     // (B, T, N, C)
  const float* pe;    // (B, T, D)
  const float* mask;  // (B, 1, T), > 0.5 at pads
  const float* win;   // (C, D)
  const float* bin;   // (D,)
  const float* u;     // (D, G)
  const float* cs;    // (1, G)
  float* h0;          // (B, N, D)
  float* scores;      // (B, N, G, T)
  float* attn;        // (B, N, G, T)
  float* o;           // (B, N, D)
  int B, T, N, C, D, G;
  float eps;
};

// Shared memory of a block, in floats; regions start on 16 bytes.
struct StageLayout {
  int cp, dp, up, t8, kc;
  int xs, hs, ws, us, sa, red, st;
  int floats;
};

__host__ __device__ inline StageLayout stage_layout(int T, int C, int D, int G) {
  StageLayout L{};
  int o = 0;
  auto take = [&](int n) { const int at = o; o += (n + 3) & ~3; return at; };
  const int c4 = (C + 3) & ~3, d4 = (D + 3) & ~3, gp = (G + 3) & ~3;
  L.cp = c4 | 4;
  L.dp = d4;
  while (L.dp % 32 != 8) L.dp += 4;
  L.up = gp | 4;
  L.t8 = (T + kTt - 1) / kTt * kTt;
  L.kc = c4 < kWc ? c4 : kWc;
  L.xs = take(L.t8 * L.cp);
  L.hs = take(T * L.dp);
  L.ws = take(L.kc * L.dp);
  L.us = take(d4 * L.up);
  L.sa = take(G * T);
  L.red = take(2 * kParts * C);
  L.st = take(2 * C);
  L.floats = o;
  return L;
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

// Every group of copies but the newest one has landed.
__device__ __forceinline__ void cp_async_wait_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// rows x cols fp32 of a row-major source (row stride src_stride) into shared
// memory (row stride dst_stride) as 16-byte copies where the source rows
// allow them, else plain loads; the destination's pads up to dst_rows rows
// and dst_cols columns become 0.
__device__ void stage(float* dst, int dst_stride, int dst_rows, int dst_cols,
                      const float* src, int src_stride, int rows, int cols) {
  const bool async = cols % 4 == 0 && src_stride % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(src) % 16 == 0;
  const int nq = dst_cols / 4;
  for (int i = threadIdx.x; i < dst_rows * nq; i += kThreads) {
    const int r = i / nq, c = 4 * (i - r * nq);
    float* d = dst + r * dst_stride + c;
    const float* s = src + (size_t)r * src_stride + c;
    if (async && r < rows && c < cols) {
      cp_async16(d, s);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) d[k] = r < rows && c + k < cols ? __ldg(s + k) : 0.f;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
ltae_stages_kernel(const Args a, const StageLayout L) {
  extern __shared__ __align__(16) float smem[];
  const int T = a.T, N = a.N, C = a.C, D = a.D, G = a.G;
  const int CP = L.cp, DP = L.dp, UP = L.up, KC = L.kc;
  const int C4 = (C + 3) & ~3, D4 = (D + 3) & ~3, GP = (G + 3) & ~3;
  const int ND4 = D4 / 4, G4 = GP / 4, cg = C / G, dv = D / G;
  const int n = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* __restrict__ const xs = smem + L.xs;   // (T8, CP): x, then xn
  float* __restrict__ const hs = smem + L.hs;   // (T, DP)
  float* __restrict__ const ws = smem + L.ws;   // (KC, DP): a chunk of W_in
  float* __restrict__ const us = smem + L.us;   // (D4, UP)
  float* __restrict__ const sa = smem + L.sa;   // (G, T): scores, then attn
  float* __restrict__ const red = smem + L.red; // (kParts, 2, C)
  float* __restrict__ const st = smem + L.st;   // mean, 1/std: (2, C)
  const size_t row = (size_t)b * N + n;

  // ---- x of the row first, then U and W_in's first chunk behind it --------
  // x[b, t, n, :] is row t of a (T, C) matrix with row stride N * C
  stage(xs, CP, L.t8, C4, a.x + ((size_t)b * T * N + n) * C, N * C, T, C);
  cp_async_commit();
  stage(us, UP, D4, GP, a.u, G, D, G);
  stage(ws, DP, KC, D4, a.win, D, min(KC, C), D);
  cp_async_commit();
  cp_async_wait_but_newest();
  __syncthreads();

  // ---- 1. GroupNorm, one pass: thread (part, c) sums x and x^2 over steps
  //         part, part + 8, ..; the parts added in order, then per group
  //         E[x] and E[x^2] - E[x]^2; then normalize in place --------------
  for (int i = tid; i < kParts * C; i += kThreads) {
    const int c = i % C, pt = i / C;
    float s = 0.f, q = 0.f;
    for (int t = pt; t < T; t += kParts) {
      const float v = xs[t * CP + c];
      s += v;
      q = fmaf(v, v, q);
    }
    red[(2 * pt) * C + c] = s;
    red[(2 * pt + 1) * C + c] = q;
  }
  __syncthreads();
  for (int c = tid; c < C; c += kThreads) {
    float s = 0.f, q = 0.f;
    for (int pt = 0; pt < kParts; ++pt) {
      s += red[(2 * pt) * C + c];
      q += red[(2 * pt + 1) * C + c];
    }
    st[c] = s;
    st[C + c] = q;
  }
  __syncthreads();
  const float cnt = (float)(T * cg);
  float mean_c = 0.f, inv_c = 0.f;   // thread c's channel, for c < C
  if (tid < C) {
    const int g0 = tid / cg * cg;
    float s = 0.f, q = 0.f;
    for (int j = 0; j < cg; ++j) {
      s += st[g0 + j];
      q += st[C + g0 + j];
    }
    mean_c = s / cnt;
    inv_c = rsqrtf(q / cnt - mean_c * mean_c + a.eps);
  }
  __syncthreads();
  if (tid < C) {
    st[tid] = mean_c;
    st[C + tid] = inv_c;
  }
  __syncthreads();
  for (int i = tid; i < T * C; i += kThreads) {
    const int t = i / C, c = i - t * C;
    float* p = xs + t * CP + c;
    *p = (*p - st[c]) * st[C + c];
  }
  cp_async_wait_all();
  __syncthreads();

  // ---- 2. h = xn @ W_in + b_in + pe: thread (8 steps, 4 channels d), xn
  //         and four W_in rows as float4, over c in order; h[t = 0] out ---
  const float* pe_b = a.pe + (size_t)b * T * D;
  const int items = L.t8 / kTt * ND4;
  for (int r0 = 0; r0 < items; r0 += kThreads) {
    const int it = r0 + tid;
    const bool valid = it < items;
    const int d4 = valid ? it % ND4 : 0, t0 = valid ? it / ND4 * kTt : 0;
    float4 acc[kTt];
#pragma unroll
    for (int k = 0; k < kTt; ++k) acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c0 = 0; c0 < C4; c0 += KC) {
      if (c0 > 0 || (r0 > 0 && KC < C4)) {   // the next chunk of W_in
        __syncthreads();
        stage(ws, DP, KC, D4, a.win + (size_t)c0 * D, D, min(KC, C - c0), D);
        cp_async_commit();
        cp_async_wait_all();
        __syncthreads();
      }
      const int kc = min(KC, C4 - c0);
      if (valid) {
        const float* xr = xs + t0 * CP + c0;
        const float* wr = ws + 4 * d4;
#pragma unroll 1
        for (int q = 0; q < kc; q += 4) {
          const float4 w0 = ld4(wr + q * DP), w1 = ld4(wr + (q + 1) * DP),
                       w2 = ld4(wr + (q + 2) * DP), w3 = ld4(wr + (q + 3) * DP);
#pragma unroll
          for (int k = 0; k < kTt; ++k) {
            const float4 xv = ld4(xr + k * CP + q);
            acc[k].x = fmaf(xv.w, w3.x, fmaf(xv.z, w2.x, fmaf(xv.y, w1.x, fmaf(xv.x, w0.x, acc[k].x))));
            acc[k].y = fmaf(xv.w, w3.y, fmaf(xv.z, w2.y, fmaf(xv.y, w1.y, fmaf(xv.x, w0.y, acc[k].y))));
            acc[k].z = fmaf(xv.w, w3.z, fmaf(xv.z, w2.z, fmaf(xv.y, w1.z, fmaf(xv.x, w0.z, acc[k].z))));
            acc[k].w = fmaf(xv.w, w3.w, fmaf(xv.z, w2.w, fmaf(xv.y, w1.w, fmaf(xv.x, w0.w, acc[k].w))));
          }
        }
      }
    }
    if (valid) {
      const int d = 4 * d4;
      float bd[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) bd[j] = d + j < D ? __ldg(a.bin + d + j) : 0.f;
#pragma unroll
      for (int k = 0; k < kTt; ++k) {
        const int t = t0 + k;
        if (t < T) {
          float hv[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            hv[j] = d + j < D ? (at4(acc[k], j) + bd[j]) + __ldg(pe_b + (size_t)t * D + d + j)
                              : 0.f;
          *reinterpret_cast<float4*>(hs + t * DP + d) = make_float4(hv[0], hv[1], hv[2], hv[3]);
          if (t == 0)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (d + j < D) a.h0[row * D + d + j] = hv[j];
        }
      }
    }
  }
  __syncthreads();

  // ---- 3. scores = h @ U + cs: thread (t, four heads, half of D), h and
  //         four U rows as float4, the halves added by a shuffle; written
  //         before the mask ----------------------------------------------
  const int sitems = T * G4 * 2;
  for (int r0 = 0; r0 < sitems; r0 += kThreads) {
    const int i = r0 + tid;
    const bool valid = i < sitems;
    const int half = i & 1, k = i >> 1, gq = k % G4, t = valid ? k / G4 : 0;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    if (valid) {
      const float* hr = hs + t * DP;
      const float* ur = us + 4 * gq;
#pragma unroll 2
      for (int q = half; q < ND4; q += 2) {
        const float4 hv = ld4(hr + 4 * q);
        const float* uq = ur + 4 * q * UP;
        const float4 u0 = ld4(uq), u1 = ld4(uq + UP), u2 = ld4(uq + 2 * UP), u3 = ld4(uq + 3 * UP);
        acc.x = fmaf(hv.w, u3.x, fmaf(hv.z, u2.x, fmaf(hv.y, u1.x, fmaf(hv.x, u0.x, acc.x))));
        acc.y = fmaf(hv.w, u3.y, fmaf(hv.z, u2.y, fmaf(hv.y, u1.y, fmaf(hv.x, u0.y, acc.y))));
        acc.z = fmaf(hv.w, u3.z, fmaf(hv.z, u2.z, fmaf(hv.y, u1.z, fmaf(hv.x, u0.z, acc.z))));
        acc.w = fmaf(hv.w, u3.w, fmaf(hv.z, u2.w, fmaf(hv.y, u1.w, fmaf(hv.x, u0.w, acc.w))));
      }
    }
    acc.x += __shfl_xor_sync(0xffffffffu, acc.x, 1);
    acc.y += __shfl_xor_sync(0xffffffffu, acc.y, 1);
    acc.z += __shfl_xor_sync(0xffffffffu, acc.z, 1);
    acc.w += __shfl_xor_sync(0xffffffffu, acc.w, 1);
    if (valid && half == 0) {
#pragma unroll
      for (int k2 = 0; k2 < 4; ++k2) {
        const int g = 4 * gq + k2;
        if (g < G) {
          const float s = at4(acc, k2) + __ldg(a.cs + g);
          sa[g * T + t] = s;
          a.scores[(row * G + g) * T + t] = s;
        }
      }
    }
  }
  __syncthreads();

  // ---- 4. masked softmax over T: a warp per head, lanes own t, t + 32 -----
  const float* mask = a.mask + (size_t)b * T;
  for (int g = warp; g < G; g += kThreads / 32) {
    float* ar = sa + g * T;
    const bool v0 = lane < T, v1 = lane + 32 < T;
    float z0 = -CUDART_INF_F, z1 = -CUDART_INF_F;
    if (v0) z0 = __ldg(mask + lane) > 0.5f ? -1e6f : ar[lane];
    if (v1) z1 = __ldg(mask + lane + 32) > 0.5f ? -1e6f : ar[lane + 32];
    const float m = warp_max(fmaxf(z0, z1));
    float e0 = v0 ? expf(z0 - m) : 0.f;
    float e1 = v1 ? expf(z1 - m) : 0.f;
    const float sum = warp_sum(e0 + e1);
    e0 /= sum;
    e1 /= sum;
    float* out = a.attn + (row * G + g) * T;
    if (v0) ar[lane] = out[lane] = e0;
    if (v1) ar[lane + 32] = out[lane + 32] = e1;
  }
  __syncthreads();

  // ---- 5. o[d] = sum_t attn[g(d), t] h[t, d]: thread (d, half of T), the
  //         halves added by a shuffle -------------------------------------
  const int oitems = 2 * D;
  const int th = (T + 1) / 2;
  for (int r0 = 0; r0 < oitems; r0 += kThreads) {
    const int i = r0 + tid;
    const bool valid = i < oitems;
    const int half = i & 1, d = valid ? i >> 1 : 0, g = d / dv;
    float s = 0.f;
    if (valid) {
      const int t1 = half ? T : th;
      for (int t = half * th; t < t1; ++t) s = fmaf(sa[g * T + t], hs[t * DP + d], s);
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    if (valid && half == 0) a.o[row * D + d] = s;
  }
}

}  // namespace

// C entry for ctypes. Pointers are device pointers to contiguous fp32
// tensors. Takes T <= 64, C <= 128, G dividing C and D, and a D whose
// layout fits in shared memory (D <= 256 does at every T and C). Returns
// the cudaError_t of the launch (0 on success).
extern "C" int ltae_stages(
    const void* x, const void* pe, const void* mask, const void* win,
    const void* bin, const void* u, const void* cs, void* h0, void* scores,
    void* attn, void* o, int B, int T, int N, int C, int D, int G, float eps,
    void* stream) {
  if (B < 1 || N < 1 || T < 1 || T > kMaxT || C < 1 || C > kMaxC || G < 1 ||
      C % G || D < 1 || D % G)
    return (int)cudaErrorInvalidValue;
  const StageLayout L = stage_layout(T, C, D, G);
  const size_t bytes = (size_t)L.floats * sizeof(float);
  if (bytes > kSmemLimit) return (int)cudaErrorInvalidValue;
  Args a;
  a.x = static_cast<const float*>(x);
  a.pe = static_cast<const float*>(pe);
  a.mask = static_cast<const float*>(mask);
  a.win = static_cast<const float*>(win);
  a.bin = static_cast<const float*>(bin);
  a.u = static_cast<const float*>(u);
  a.cs = static_cast<const float*>(cs);
  a.h0 = static_cast<float*>(h0);
  a.scores = static_cast<float*>(scores);
  a.attn = static_cast<float*>(attn);
  a.o = static_cast<float*>(o);
  a.B = B; a.T = T; a.N = N; a.C = C; a.D = D; a.G = G;
  a.eps = eps;
  cudaError_t err = cudaFuncSetAttribute(
      ltae_stages_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  ltae_stages_kernel<<<dim3(N, B), kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(a, L);
  return (int)cudaGetLastError();
}
