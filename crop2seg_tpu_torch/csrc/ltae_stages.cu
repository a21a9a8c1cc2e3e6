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
// 0.002 ms. Operations bound it. What the design does about it: h stays in
// shared memory, never in device memory; the projection runs block-wide, a
// thread per d over all the block's rows and a chunk of 8 steps, so each
// W_in element read from L2 serves 16 products. A simple kernel: the
// products stay on the CUDA cores.
//
// Layout: one block = kRows = 2 rows, 256 threads. Shared memory: xs (R, T,
// C+1) | h (R, T, D) | a (R, T, G+1) | stats (4, R, C); 163 KiB at the
// script's shape, 205 KiB at T = 64, C = 128, D = 256, G = 16.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kMaxT = 64;      // lanes own t and t + 32 in the softmax
constexpr int kMaxC = 128;
constexpr int kRows = 2;       // rows per block
constexpr int kThreads = 256;
constexpr int kTc = 8;         // steps per chunk of the projection
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

__host__ __device__ inline size_t smem_floats(int T, int C, int D, int G) {
  return (size_t)kRows * (T * (C + 1) + T * D + T * (G + 1) + 4 * C);
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

__global__ void __launch_bounds__(kThreads)
ltae_stages_kernel(const Args a) {
  extern __shared__ float smem[];
  const int T = a.T, N = a.N, C = a.C, D = a.D, G = a.G;
  const int CP = C + 1, GP = G + 1;
  const int b = blockIdx.y, n0 = blockIdx.x * kRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nwarps = blockDim.x >> 5;
  const int cg = C / G, dv = D / G;
  float* xs = smem;                          // (R, T, C+1)
  float* hs = xs + kRows * T * CP;           // (R, T, D)
  float* as = hs + kRows * T * D;            // (R, T, G+1)
  float* st = as + kRows * T * GP;           // sum, sumsq, mean, inv: (4, R, C)
  const int RC = kRows * C;

  // ---- stage the x tile; rows past N are zeros ----------------------------
  for (int i = tid; i < kRows * T * C; i += blockDim.x) {
    const int r = i / (T * C), rem = i - r * T * C;
    const int t = rem / C, c = rem - t * C;
    const int n = n0 + r;
    xs[(r * T + t) * CP + c] =
        n < N ? __ldg(a.x + ((size_t)(b * T + t) * N + n) * C + c) : 0.f;
  }
  __syncthreads();

  // ---- 1. GroupNorm, one pass: per-channel sum and sum of squares over T,
  //         then per group E[x] and E[x^2] - E[x]^2, then normalize ----------
  for (int i = tid; i < RC; i += blockDim.x) {
    const int r = i / C, c = i - r * C;
    float s = 0.f, q = 0.f;
    for (int t = 0; t < T; ++t) {
      const float v = xs[(r * T + t) * CP + c];
      s += v;
      q = fmaf(v, v, q);
    }
    st[i] = s;
    st[RC + i] = q;
  }
  __syncthreads();
  const float cnt = (float)(T * cg);
  for (int i = tid; i < RC; i += blockDim.x) {
    const int r = i / C, c = i - r * C;
    const int g0 = r * C + (c / cg) * cg;
    float s = 0.f, q = 0.f;
    for (int j = 0; j < cg; ++j) {
      s += st[g0 + j];
      q += st[RC + g0 + j];
    }
    const float mean = s / cnt;
    const float var = q / cnt - mean * mean;
    st[2 * RC + i] = mean;
    st[3 * RC + i] = rsqrtf(var + a.eps);
  }
  __syncthreads();
  for (int i = tid; i < kRows * T * C; i += blockDim.x) {
    const int r = i / (T * C), rem = i - r * T * C;
    const int t = rem / C, c = rem - t * C;
    float* p = xs + (r * T + t) * CP + c;
    *p = (*p - st[2 * RC + r * C + c]) * st[3 * RC + r * C + c];
  }
  __syncthreads();

  // ---- 2. h = xn @ W_in + b_in + pe, block-wide: a thread owns d for all
  //         rows and kTc steps at a time; h[t = 0] goes out ----------------
  const float* pe_b = a.pe + (size_t)b * T * D;
  for (int d = tid; d < D; d += blockDim.x) {
    const float bd = __ldg(a.bin + d);
    for (int t0 = 0; t0 < T; t0 += kTc) {
      float acc[kRows][kTc];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int j = 0; j < kTc; ++j) acc[r][j] = 0.f;
      for (int c = 0; c < C; ++c) {
        const float w = __ldg(a.win + (size_t)c * D + d);
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int j = 0; j < kTc; ++j)
            if (t0 + j < T) acc[r][j] = fmaf(xs[(r * T + t0 + j) * CP + c], w, acc[r][j]);
      }
#pragma unroll
      for (int j = 0; j < kTc; ++j) {
        if (t0 + j < T) {
          const float pv = __ldg(pe_b + (size_t)(t0 + j) * D + d);
#pragma unroll
          for (int r = 0; r < kRows; ++r) hs[(r * T + t0 + j) * D + d] = (acc[r][j] + bd) + pv;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (n0 + r < N) a.h0[((size_t)b * N + n0 + r) * D + d] = hs[r * T * D + d];
  }
  __syncthreads();

  // ---- 3. scores = h @ U + cs, written before the mask --------------------
  for (int i = tid; i < kRows * T * G; i += blockDim.x) {
    const int r = i / (T * G), rem = i - r * T * G;
    const int t = rem / G, g = rem - t * G;
    const float* hr = hs + (r * T + t) * D;
    float s = 0.f;
    for (int d = 0; d < D; ++d) s = fmaf(hr[d], __ldg(a.u + d * G + g), s);
    s += __ldg(a.cs + g);
    as[(r * T + t) * GP + g] = s;
    if (n0 + r < N) a.scores[(((size_t)b * N + n0 + r) * G + g) * T + t] = s;
  }
  __syncthreads();

  // ---- 4. masked softmax over T: a warp per (row, head), lanes own t, t+32
  const float* mask = a.mask + (size_t)b * T;
  for (int p = warp; p < kRows * G; p += nwarps) {
    const int r = p / G, g = p - r * G;
    float* ar = as + r * T * GP + g;
    const bool v0 = lane < T, v1 = lane + 32 < T;
    float z0 = -CUDART_INF_F, z1 = -CUDART_INF_F;
    if (v0) z0 = __ldg(mask + lane) > 0.5f ? -1e6f : ar[lane * GP];
    if (v1) z1 = __ldg(mask + lane + 32) > 0.5f ? -1e6f : ar[(lane + 32) * GP];
    const float m = warp_max(fmaxf(z0, z1));
    float e0 = v0 ? expf(z0 - m) : 0.f;
    float e1 = v1 ? expf(z1 - m) : 0.f;
    const float sum = warp_sum(e0 + e1);
    e0 /= sum;
    e1 /= sum;
    if (v0) ar[lane * GP] = e0;
    if (v1) ar[(lane + 32) * GP] = e1;
    if (n0 + r < N) {
      float* out = a.attn + (((size_t)b * N + n0 + r) * G + g) * T;
      if (v0) out[lane] = e0;
      if (v1) out[lane + 32] = e1;
    }
  }
  __syncthreads();

  // ---- 5. o[d] = sum_t attn[g(d), t] h[t, d] ------------------------------
  for (int i = tid; i < kRows * D; i += blockDim.x) {
    const int r = i / D, d = i - r * D;
    if (n0 + r >= N) continue;
    const int g = d / dv;
    float s = 0.f;
    for (int t = 0; t < T; ++t)
      s = fmaf(as[(r * T + t) * GP + g], hs[(r * T + t) * D + d], s);
    a.o[((size_t)b * N + n0 + r) * D + d] = s;
  }
}

}  // namespace

// C entry for ctypes. Pointers are device pointers to contiguous fp32
// tensors. Returns the cudaError_t of the launch (0 on success).
extern "C" int ltae_stages(
    const void* x, const void* pe, const void* mask, const void* win,
    const void* bin, const void* u, const void* cs, void* h0, void* scores,
    void* attn, void* o, int B, int T, int N, int C, int D, int G, float eps,
    void* stream) {
  if (B < 1 || N < 1 || T < 1 || T > kMaxT || C < 1 || C > kMaxC || G < 1 ||
      C % G || D % G)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = smem_floats(T, C, D, G) * sizeof(float);
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
  const dim3 grid((N + kRows - 1) / kRows, B);
  ltae_stages_kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
