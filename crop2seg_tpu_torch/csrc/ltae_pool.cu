// Masked L-TAE attention pooling, training path, fp32, for NVIDIA Hopper
// (sm_90a): a forward kernel and a backward kernel.
//
// Replaces crop2seg_tpu/ops/ltae_pallas_train.py::ltae_pool in its untailed
// mode: the forward `_run_fwd` / `_fwd_kernel` (pallas_call at
// ltae_pallas_train.py:457) and the backward `_run_bwd` / `_bwd_kernel`
// (pallas_call at :536). Wrapper, folds, the autograd Function and the plain
// PyTorch version: crop2seg_tpu_torch/ops/ltae_pool.py.
//
// Per pixel row n of batch item b, over T <= 64 steps, C <= 64 channels,
// G <= 16 heads of dv = D/G channels:
//   xhat = GroupNorm_G(x) over (T, C/G), no affine (folded into W = win_f)
//   h    = xhat W + bpe[b]            bpe = bin_f + pe          (T, D), never built
//   s    = xhat Ws + pes[b]           Ws = W u, pes = bpe u + cs, -1e6 at pads
//   a    = softmax_T(s);  a_d = a * keep(seed, b, t, n, g) / (1 - p)
//   o[d] = sum_t a_d[t, g(d)] h[t, d] = P[g] . W[:, d] + sum_t a_d[t, g] bpe[t, d]
//          with P[g] = sum_t a_d[t, g] xhat[t]   (C-space pooling: h never exists)
// Backward, per row, with go = dL/do and Z[g, c] = sum_{d in g} W[c, d] go[d]:
//   p1[t, g] = xhat[t] . Z[g] + sum_{d in g} go[d] bpe[t, d]    (= dL/da_d)
//   ds       = a_d p1 - a sum_t (a_d p1)                      (softmax jacobian)
//   dxhat[t] = sum_g ds[t, g] Ws[:, g] + a_d[t, g] Z[g]
//   dx       = inv (dxhat - mean_grp(dxhat) - xhat mean_grp(dxhat xhat))
// and four sums over rows, added into device memory with fp32 atomics:
//   A[c, g] += sum_t xhat[t, c] ds[t, g]     F[c, d] += P[g(d), c] go[d]
//   Dsum[b, t, g] += ds[t, g]                E[b, t, d] += a_d[t, g(d)] go[d]
// from which the wrapper forms dW_f, db_f, du, dcs and dpe in small products.
// Hopper's blocks run in no order, unlike the TPU grid that carries these sums
// in VMEM across sequential steps, so each block first sums its R rows in
// registers and then adds one value per entry: (C*G + C*D + T*G + T*D) atomics
// per block. The order of those adds changes from run to run, so the
// gradients of W_f, b_f, u, cs and pe vary in their last bits between runs;
// dx and o do not (no atomics).
//
// Dropout: keep(seed, b, t, n, g) = mix32(mix32(i) ^ mix32(seed)) >= thresh,
// i = ((b*T + t)*N + n)*G + g mod 2^32. The mask is a function of the element
// alone, so the forward and the backward (whatever their row blocks) and the
// plain version (ops/ltae_pool.py::keep_mask) draw the same one.
//
// Bound on an H100 SXM (3.35 TB/s; 67 TFLOP/s fp32 on the CUDA cores) at the
// train step's shape B=4, T=61, N=16384, C=64, D=256, G=16:
//   forward:  x 1.02 GB read, o 67 MB written: 0.33 ms by bytes; ~0.34 MFLOP
//             per row, 22.4 GFLOP: 0.33 ms by operations -> about even.
//   backward: x read, go read, dx written: 2.11 GB, 0.63 ms by bytes;
//             ~0.94 MFLOP per row, ~62 GFLOP: 0.92 ms -> bound by operations.
// (chip_smoke.py::pool_flops and ::pool_bytes count them.)
// What the design does about it: x is read once per kernel with 16-byte
// loads into shared memory, and every product of a row runs out of shared
// memory and registers. The per-d projection (forward) and the per-block
// sums (backward) run block-wide, so each W / bpe element fetched from L2
// serves all the block's rows. chip_smoke.py measures both kernels beside
// their bound.
//
// Layout: one block = R rows of one batch item, one warp per row for the
// per-row steps. Shared memory per row, +1 pads against bank conflicts:
//   forward:  xhat (T, C+1) | a_d (T, G+1) | P (G, C+1) | scratch (C)
//   backward: xhat, dxhat (T, C+1) | a, a_d, p1->ds (T, G+1) | Z, P (G, C+1)
//             | go (D) | scratch (2C)
// At the main-path shape the forward takes R = 8 (195 KiB), the backward
// R = 4 (215 KiB): one block per SM either way.

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
  const float* x;     // (B, T, N, C)
  const float* go;    // (B, N, D), backward only
  const float* win;   // (C, D)
  const float* ws;    // (C, G)
  const float* pes;   // (B, G, T)
  const float* bpe;   // (B, T, D)
  float* o;           // (B, N, D), forward
  float* dx;          // (B, T, N, C), backward
  float* acc_a;       // (C, G)
  float* acc_f;       // (C, D)
  float* dsum;        // (B, T, G)
  float* acc_e;       // (B, T, D)
  int B, T, N, C, D, G;
  uint32_t seed_mix, thresh;
  float scale, eps;
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

// Stage Ws and the x rows n0 .. n0+R-1 of batch item b (zeros past N).
__device__ void stage(const Args& a, float* ws_s, float* rows, int rf, int R,
                      int b, int n0) {
  const int T = a.T, C = a.C, CP = C + 1, RC = R * C;
  for (int i = threadIdx.x; i < C * a.G; i += blockDim.x) ws_s[i] = a.ws[i];
  const int nvec = T * RC / 4;   // C % 8 == 0: a vector never straddles rows
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    const int e = i * 4;
    const int t = e / RC, rem = e - t * RC;
    const int r = rem / C, c = rem - r * C;
    const int n = n0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (n < a.N)
      v = __ldg(reinterpret_cast<const float4*>(a.x + ((size_t)(b * T + t) * a.N + n) * C + c));
    float* dst = rows + r * rf + t * CP + c;
    dst[0] = v.x;
    dst[1] = v.y;
    dst[2] = v.z;
    dst[3] = v.w;
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

  stage(a, ws_s, rows, rf, R, b, n0);
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
      if (r < R && n0 + r < N) a.o[((size_t)b * N + n0 + r) * D + d] = acc[r];
  }
}

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
  stage(a, ws_s, rows, rf, R, b, n0);
  for (int i = threadIdx.x; i < R * D; i += blockDim.x) {
    const int r = i / D, d = i - r * D;
    const int n = n0 + r;
    rows[r * rf + off_go + d] = n < N ? __ldg(a.go + ((size_t)b * N + n) * D + d) : 0.f;
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

  // dxhat = ds Ws^T + a_d Z, then the GroupNorm backward into dx (lanes own
  // c, c + 32).
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
    const float cnt = (float)(T * cg);
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
          const float xh = xr[t * CP + c];
          a.dx[((size_t)(b * T + t) * N + n) * C + c] =
              inv_c[k] * (dxr[t * CP + c] - s1 - xh * s2);
        }
      }
    }
  }
  __syncthreads();

  // ---- block-wide sums of the R rows, one atomic add per entry -------------
  // Rows past N hold xhat = 0, ds = 0 and go = 0, so they add nothing.
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
}

cudaError_t launch(void (*kernel)(const Args), int rf, const Args& a,
                   cudaStream_t stream) {
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

// C entries for ctypes. Pointers are device pointers to contiguous fp32
// tensors; the accumulators of the backward must hold zeros. Each returns the
// cudaError_t of its launch (0 on success).
extern "C" int ltae_pool_fwd(const void* x, const void* bpe, const void* win,
                             const void* ws, const void* pes, void* o, int B,
                             int T, int N, int C, int D, int G, unsigned seed_mix,
                             unsigned thresh, float scale, float eps, void* stream) {
  if (bad_shape(B, T, N, C, D, G)) return (int)cudaErrorInvalidValue;
  Args a = make_args(B, T, N, C, D, G, seed_mix, thresh, scale, eps);
  a.x = static_cast<const float*>(x);
  a.bpe = static_cast<const float*>(bpe);
  a.win = static_cast<const float*>(win);
  a.ws = static_cast<const float*>(ws);
  a.pes = static_cast<const float*>(pes);
  a.o = static_cast<float*>(o);
  return (int)launch(ltae_pool_fwd_kernel, fwd_row_floats(T, C, G), a,
                     static_cast<cudaStream_t>(stream));
}

extern "C" int ltae_pool_bwd(const void* x, const void* go, const void* win,
                             const void* ws, const void* pes, const void* bpe,
                             void* dx, void* acc_a, void* acc_f, void* dsum,
                             void* acc_e, int B, int T, int N, int C, int D, int G,
                             unsigned seed_mix, unsigned thresh, float scale,
                             float eps, void* stream) {
  if (bad_shape(B, T, N, C, D, G)) return (int)cudaErrorInvalidValue;
  Args a = make_args(B, T, N, C, D, G, seed_mix, thresh, scale, eps);
  a.x = static_cast<const float*>(x);
  a.go = static_cast<const float*>(go);
  a.win = static_cast<const float*>(win);
  a.ws = static_cast<const float*>(ws);
  a.pes = static_cast<const float*>(pes);
  a.bpe = static_cast<const float*>(bpe);
  a.dx = static_cast<float*>(dx);
  a.acc_a = static_cast<float*>(acc_a);
  a.acc_f = static_cast<float*>(acc_f);
  a.dsum = static_cast<float*>(dsum);
  a.acc_e = static_cast<float*>(acc_e);
  return (int)launch(ltae_pool_bwd_kernel, bwd_row_floats(T, C, D, G), a,
                     static_cast<cudaStream_t>(stream));
}
