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
// broadcast matmul and a block-diagonal W_m); here the row loops over the
// queries and reuses the a, P and o regions, so registers and shared memory
// per query stay those of nq = 1; only the MLP outputs of all queries (the
// out GroupNorm pools them) and Ws grow with nq. The query count is a
// template parameter QN: 1 compiles the one-query kernel with every index
// constant (a runtime loop costs it ~28 % at C = 64, measured), 0 reads nq
// from the arguments.
// Pooling in C-space is exact algebra (sum_t a = 1), so the projected
// sequence h (T x D per row, 4x the input) never exists, in registers or in
// memory: the kernel reads x once and writes out (and attn on request).
//
// Bound on an H100 SXM (3.35 TB/s; 67 TFLOP/s fp32 on the CUDA cores) at the
// TimeUNet main-path shape B=10, T=61, N=16384, C=64, D=256, G=16, d_out=64:
//   bytes:      x 1.28 GB in bf16 (2.56 GB fp32) read once, out 21 MB (42 MB)
//               written -> 0.39 ms (bf16), 0.78 ms (fp32).
//   operations: ~0.39 MFLOP per row with the tail affine, ~63 GFLOP per
//               launch. In fp32 on the CUDA cores that is >= 0.95 ms, so
//               this design is bound by its operations, not by the bf16
//               byte bound; reaching the byte bound needs the three
//               products (scores, P, the MLP) on the tensor cores (wgmma),
//               which is later work.
// What the design does about it: x is read from device memory exactly once,
// with 16-byte loads, into shared memory; every product of the row runs out
// of shared memory and registers; the per-d projection and the MLP run
// block-wide so each W_in / pe / W_m element fetched from L2 serves all the
// block's rows. chip_smoke.py measures the kernel beside this bound.
//
// At the U-TAE bottleneck (B=10, T=61, N=256, C=128, d_out=128, attention
// out) the work is 0.70 MFLOP per row over 2,560 rows, ~0.03 ms at the fp32
// peak; there the launch is too small to fill the card for long. With nq
// queries the scores, P, o and the MLP run nq times; the input GroupNorm and
// the read of x do not.
//
// Layout: one block = R <= 8 rows (one warp per row for the per-row steps),
// all T. Shared memory per row: xs (T, C+1) | a (T, G+1) | P (G, C+1) |
// o (D) | v (max(C, nq*d_out)); the +1 pads avoid bank conflicts; Ws (C,
// G*nq) once per block. At the TimeUNet shape R = 8 uses 203 KiB of the
// 227 KiB a block may have; at the U-TAE shape (C = 128, d_out = 128) a row
// takes 45 KiB and R = 4 rows use 185 KiB (nq = 3: 47 KiB a row, 24 KiB of
// Ws, 212 KiB). The launch picks the most rows that fit. One block runs per
// SM. A lane owns channels c + 32k, k < KC: the kernel is instantiated for
// KC = 2 (C <= 64) and KC = 4 (C <= 128), so the per-lane channel arrays
// stay in registers, and for QN = 1 and QN = 0 (above).

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

template <typename Tin, int KC, int QN>
__global__ void __launch_bounds__(32 * kMaxRows)
ltae_fused_fwd_kernel(const Args a) {
  extern __shared__ float smem[];
  const int T = a.T, C = a.C, D = a.D, G = a.G, DOUT = a.DOUT, N = a.N;
  const int NQ = QN > 0 ? QN : a.NQ;
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
  //    the nq queries (og * nq values), two-pass, + the shared affine. One
  //    query keeps its own loop: compiled from the pooled loop below, the
  //    one-query kernel took 64 registers instead of 78 and ran 4-5 % slower
  //    at C = 64 (measured).
  if (QN == 1 && row_ok) {
    Tin* out = static_cast<Tin*>(a.out) + ((size_t)b * N + n) * DOUT;
    for (int j = lane; j < DOUT; j += 32) {
      const int g0 = (j / og) * og;
      float s = 0.f;
      for (int i = 0; i < og; ++i) s += vr[g0 + i];
      const float mu = s / og;
      float ss = 0.f;
      for (int i = 0; i < og; ++i) {
        const float dl = vr[g0 + i] - mu;
        ss = fmaf(dl, dl, ss);
      }
      const float y = (vr[j] - mu) * rsqrtf(ss / og + a.eps);
      Vec<Tin>::store(out + j, fmaf(y, a.osc[j], a.obi[j]));
    }
  } else if (row_ok) {
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

template <typename Tin, int KC, int QN>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int rf = row_floats(a.T, a.C, a.D, a.G, a.DOUT, a.NQ);
  int rows = kMaxRows;
  auto bytes = [&](int r) { return (size_t)(a.C * a.G * a.NQ + r * rf) * sizeof(float); };
  while (rows > 1 && bytes(rows) > kSmemLimit) --rows;
  if (bytes(rows) > kSmemLimit) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ltae_fused_fwd_kernel<Tin, KC, QN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes(rows));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + rows - 1) / rows, a.B);
  ltae_fused_fwd_kernel<Tin, KC, QN><<<grid, 32 * rows, bytes(rows), stream>>>(a);
  return cudaGetLastError();
}

template <typename Tin, int KC>
cudaError_t launch_q(const Args& a, cudaStream_t stream) {
  return a.NQ == 1 ? launch<Tin, KC, 1>(a, stream) : launch<Tin, KC, 0>(a, stream);
}

template <typename Tin>
cudaError_t launch_c(const Args& a, cudaStream_t stream) {
  return a.C <= 64 ? launch_q<Tin, 2>(a, stream) : launch_q<Tin, 4>(a, stream);
}

}  // namespace

// C entry for ctypes. Pointers are device pointers; tsc/tsh and attn may be
// null. Returns the cudaError_t of the launch (0 on success).
extern "C" int ltae_fused_fwd(
    const void* x, int x_is_bf16, const void* pe, const void* win,
    const void* bin, const void* ws, const void* pes, const void* wm,
    const void* bm, const void* osc, const void* obi, const void* tsc,
    const void* tsh, void* out, void* attn, int B, int T, int N, int C, int D,
    int G, int DOUT, int NQ, float eps, void* stream) {
  if (B < 1 || N < 1 || T < 1 || T > kMaxT || C < 8 || C > kMaxC || C % 8 ||
      G < 1 || G > kMaxG || C % G || D % G || DOUT % G || NQ < 1 || NQ > kMaxQ ||
      (tsc == nullptr) != (tsh == nullptr))
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
  return (int)(x_is_bf16 ? launch_c<__nv_bfloat16>(a, s) : launch_c<float>(a, s));
}
