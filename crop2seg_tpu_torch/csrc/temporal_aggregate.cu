// The temporal aggregator's weighted sum over T and its backward, for NVIDIA
// Hopper (sm_90a): U-TAE's attention-guided skips (att_group, att_mean) and
// the masked temporal mean (mean), on the CUDA cores, every sum in fp32.
//
// Replaces no TPU kernel: the JAX package leaves this sum to XLA
// (crop2seg_tpu/nn/aggregator.py). It replaces the port's loop of per-date
// PyTorch ops (the plain version, crop2seg_tpu_torch/ops/aggregate.py::
// weighted_sum_reference), whose backward gave each date's read of x a
// zero-filled gradient the size of the whole skip and then added the T of
// them: O(T^2) bytes where the work needs O(T). Wrapper and autograd Function:
// crop2seg_tpu_torch/ops/aggregate.py.
//
// x (B, T, P, C) channels last (P = H * W pixels), contiguous; w (B, T, K, H,
// W) read by its strides (the resample's output as it comes, or the mean's
// 0/1 mask with stride 0 over K, H, W); k(c) = c / (C/K); pad (B, T) or none;
// den (B,) or none:
//   out[b, p, c]    = round( sum_{t live} w[b, t, k(c), p] * x[b, t, p, c] ) (/ den[b])
//   dx[b, t, p, c]  = round( w[b, t, k(c), p] * g[b, p, c] )            0 at pads
//   dw[b, t, k, p]  = round( sum_{c in head k} g[b, p, c] * x[b, t, p, c] ) 0 at pads
// with g = dout (/ den[b]), the dates in ascending order, and each product,
// sum and quotient rounded to fp32 on its own (__fmul_rn, __fadd_rn,
// __fdiv_rn): the loop's arithmetic, so out and dx equal the loop's bit for
// bit in bf16 and fp32 (a bf16 product is exact in fp32); dw sums a head's
// channels in a pairwise tree, the loop in torch's reduction order. A padded
// date is skipped: the loop adds its 0 * x, which differs only where x is
// not finite there. round() is to x's dtype; -0 leaves as +0, as the loop's
// sum of per-date gradients gives it.
//
// Bound: bytes. U-TAE's step (B = 16, T = 61, C = 64, K = 16 at 128^2, 64^2
// and 32^2, bf16): x 2.69 GB, w 0.67 GB. The forward reads each once (live
// dates only) and writes out (44 MB); the backward reads x, w and dout once
// and writes dx and dw once: 3.4 + 6.7 GB before the pads' savings, 1.0 and
// 2.0 ms at 3.35 TB/s. Nothing is reduced over t, so neither direction needs
// atomics and each gives the same bits from run to run.
//
// Design: a thread owns V channels of one pixel (one 16-byte vector: 8 bf16
// or 4 fp32), the channel vectors of a pixel on neighbouring threads, so a
// warp's loads of x and stores of dx are contiguous 512-byte runs. It walks
// the dates with its V sums (forward) or its V values of g (backward) in
// registers, so dout is read once. Its heads' weights are scalar loads that
// the block's other warps, on the same pixels, find in L1. A head spans L =
// min(C/K, V) channels of a thread (a template constant): in the backward a
// thread sums its L-channel segments in registers, and where a head spans G
// = (C/K)/V > 1 threads (a power of two, at most 32, aligned in the warp)
// those add by xor shuffles; a head's first thread writes dw. Every other
// shape (C/V or the heads not fitting a vector, or x not 16-byte aligned)
// takes the general pair: a thread per (pixel, channel) forward and per
// (pixel, head) backward, scalar loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

struct Geom {
  const void* x;             // (B, T, P, C), contiguous
  const void* w;             // (B, T, K, H, W) by the strides below, in elements
  const unsigned char* pad;  // (B, T), 1 at a padded date; or null
  const float* den;          // (B,); or null
  long long rows;            // B * P
  int T, P, W, C, K, cpk, G; // cpk = C / K; G = threads a head (vector route)
  long long sb, st, sk, sh, sw;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// A 16-byte vector of V values, to fp32 and back.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int V = 4;
  __device__ static void unpack(uint4 u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int V = 8;
  __device__ static void two(unsigned u, float* f) {   // element 2i is the low half
    f[0] = __uint_as_float(u << 16);
    f[1] = __uint_as_float(u & 0xffff0000u);
  }
  __device__ static unsigned word(float lo, float hi) {
    return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
           ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
  }
  __device__ static void unpack(uint4 u, float* f) {
    two(u.x, f);
    two(u.y, f + 2);
    two(u.z, f + 4);
    two(u.w, f + 6);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(word(f[0], f[1]), word(f[2], f[3]), word(f[4], f[5]), word(f[6], f[7]));
  }
};

template <typename T> __device__ __forceinline__ uint4 load16(const T* p) {
  return *reinterpret_cast<const uint4*>(p);
}
template <typename T> __device__ __forceinline__ void store16(T* p, uint4 u) {
  *reinterpret_cast<uint4*>(p) = u;
}

// Row n = b * P + p: its batch item, pixel and weight offset.
struct Pos {
  int b, p;
  long long woff;
};
__device__ __forceinline__ Pos locate(const Geom& g, long long n) {
  const int b = (int)(n / g.P);
  const int p = (int)(n - (long long)b * g.P);
  const int hh = p / g.W;
  return {b, p, b * g.sb + hh * g.sh + (p - hh * g.W) * g.sw};
}

// Forward, vector route: thread i = n * (C / V) + vector.
template <typename Tin, int L>
__global__ void __launch_bounds__(kThreads) agg_fwd_vec(Geom g, Tin* __restrict__ out) {
  constexpr int V = Vec<Tin>::V;
  constexpr int H = V / L;                      // heads a thread
  const int vecs = g.C / V;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= g.rows * vecs) return;
  const long long n = i / vecs;
  const int c0 = (int)(i - n * vecs) * V;
  const Pos q = locate(g, n);
  const Tin* x = static_cast<const Tin*>(g.x) + ((long long)q.b * g.T * g.P + q.p) * g.C + c0;
  const Tin* w = static_cast<const Tin*>(g.w) + q.woff + (long long)(c0 / g.cpk) * g.sk;
  const unsigned char* pad = g.pad ? g.pad + (long long)q.b * g.T : nullptr;
  const long long xt = (long long)g.P * g.C;
  float acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.f;
#pragma unroll 4
  for (int t = 0; t < g.T; ++t) {
    if (pad && pad[t]) continue;
    float xv[V], wv[H];
    Vec<Tin>::unpack(load16(x + t * xt), xv);
#pragma unroll
    for (int s = 0; s < H; ++s) wv[s] = to_f(w[t * g.st + s * g.sk]);
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = __fadd_rn(acc[j], __fmul_rn(wv[j / L], xv[j]));
  }
  if (g.den) {
    const float d = g.den[q.b];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = __fdiv_rn(acc[j], d);
  }
  store16(out + n * g.C + c0, Vec<Tin>::pack(acc));
}

// Backward, vector route. Every thread of the grid runs the whole date loop
// (a thread past the last row computes zeros and stores nothing), so each
// warp's shuffles see all 32 lanes.
template <typename Tin, int L>
__global__ void __launch_bounds__(kThreads)
    agg_bwd_vec(Geom g, const Tin* __restrict__ dout, Tin* __restrict__ dx, Tin* __restrict__ dw) {
  constexpr int V = Vec<Tin>::V;
  constexpr int H = V / L;
  const int vecs = g.C / V;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const bool mine = i < g.rows * vecs;
  const long long n = mine ? i / vecs : 0;
  const int c0 = mine ? (int)(i - n * vecs) * V : 0;
  const Pos q = locate(g, n);
  const Tin* x = static_cast<const Tin*>(g.x) + ((long long)q.b * g.T * g.P + q.p) * g.C + c0;
  const Tin* w = static_cast<const Tin*>(g.w) + q.woff + (long long)(c0 / g.cpk) * g.sk;
  Tin* dxp = dx + ((long long)q.b * g.T * g.P + q.p) * g.C + c0;
  Tin* dwp = dw ? dw + ((long long)q.b * g.T * g.K + c0 / g.cpk) * g.P + q.p : nullptr;
  const unsigned char* pad = g.pad ? g.pad + (long long)q.b * g.T : nullptr;
  const long long xt = (long long)g.P * g.C, wt = (long long)g.K * g.P;
  const bool writer = mine && (c0 / V) % g.G == 0;   // a head's first thread
  float d[V];
  if (mine) {
    Vec<Tin>::unpack(load16(dout + n * g.C + c0), d);
    if (g.den) {
      const float dn = g.den[q.b];
#pragma unroll
      for (int j = 0; j < V; ++j) d[j] = __fdiv_rn(d[j], dn);
    }
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) d[j] = 0.f;
  }
  for (int t = 0; t < g.T; ++t) {
    const bool on = mine && !(pad && pad[t]);
    float xv[V], wv[H], o[V];
    if (on) {
      Vec<Tin>::unpack(load16(x + t * xt), xv);
#pragma unroll
      for (int s = 0; s < H; ++s) wv[s] = to_f(w[t * g.st + s * g.sk]);
#pragma unroll
      for (int j = 0; j < V; ++j) o[j] = __fadd_rn(__fmul_rn(wv[j / L], d[j]), 0.f);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) o[j] = xv[j] = 0.f;
    }
    if (mine) store16(dxp + t * xt, Vec<Tin>::pack(o));
    if (dw) {
      float part[V];
#pragma unroll
      for (int j = 0; j < V; ++j) part[j] = on ? __fmul_rn(d[j], xv[j]) : 0.f;
#pragma unroll
      for (int s = 1; s < L; s *= 2)
#pragma unroll
        for (int j = 0; j < V; j += 2 * s) part[j] = __fadd_rn(part[j], part[j + s]);
      for (int off = 1; off < g.G; off *= 2)
        part[0] = __fadd_rn(part[0], __shfl_xor_sync(kFull, part[0], off));
      if (writer) {
#pragma unroll
        for (int s = 0; s < H; ++s) put(dwp + t * wt + s * g.P, __fadd_rn(part[s * L], 0.f));
      }
    }
  }
}

// Forward, general route: thread i = n * C + c.
template <typename Tin>
__global__ void __launch_bounds__(kThreads) agg_fwd_gen(Geom g, Tin* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= g.rows * g.C) return;
  const long long n = i / g.C;
  const int c = (int)(i - n * g.C);
  const Pos q = locate(g, n);
  const Tin* x = static_cast<const Tin*>(g.x) + ((long long)q.b * g.T * g.P + q.p) * g.C + c;
  const Tin* w = static_cast<const Tin*>(g.w) + q.woff + (long long)(c / g.cpk) * g.sk;
  const unsigned char* pad = g.pad ? g.pad + (long long)q.b * g.T : nullptr;
  const long long xt = (long long)g.P * g.C;
  float acc = 0.f;
  for (int t = 0; t < g.T; ++t) {
    if (pad && pad[t]) continue;
    acc = __fadd_rn(acc, __fmul_rn(to_f(w[t * g.st]), to_f(x[t * xt])));
  }
  if (g.den) acc = __fdiv_rn(acc, g.den[q.b]);
  put(out + i, acc);
}

// Backward, general route: thread i = n * K + k, the head's channels in turn.
template <typename Tin>
__global__ void __launch_bounds__(kThreads)
    agg_bwd_gen(Geom g, const Tin* __restrict__ dout, Tin* __restrict__ dx, Tin* __restrict__ dw) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= g.rows * g.K) return;
  const long long n = i / g.K;
  const int k = (int)(i - n * g.K), c0 = k * g.cpk;
  const Pos q = locate(g, n);
  const long long xbase = ((long long)q.b * g.T * g.P + q.p) * g.C + c0;
  const Tin* x = static_cast<const Tin*>(g.x) + xbase;
  const Tin* w = static_cast<const Tin*>(g.w) + q.woff + (long long)k * g.sk;
  const Tin* go = dout + n * g.C + c0;
  Tin* dxp = dx + xbase;
  Tin* dwp = dw ? dw + ((long long)q.b * g.T * g.K + k) * g.P + q.p : nullptr;
  const unsigned char* pad = g.pad ? g.pad + (long long)q.b * g.T : nullptr;
  const long long xt = (long long)g.P * g.C, wt = (long long)g.K * g.P;
  const float dn = g.den ? g.den[q.b] : 1.f;
  for (int t = 0; t < g.T; ++t) {
    const bool on = !(pad && pad[t]);
    const float wv = on ? to_f(w[t * g.st]) : 0.f;
    float s = 0.f;
    for (int c = 0; c < g.cpk; ++c) {
      float d = to_f(go[c]);
      if (g.den) d = __fdiv_rn(d, dn);
      put(dxp + t * xt + c, on ? __fadd_rn(__fmul_rn(wv, d), 0.f) : 0.f);
      if (dw && on) s = __fadd_rn(s, __fmul_rn(d, to_f(x[t * xt + c])));
    }
    if (dwp) put(dwp + t * wt, __fadd_rn(s, 0.f));
  }
}

bool aligned16(const void* p) { return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Checks the arguments; fills g. l: 0 for the general route, else L.
bool make_geom(Geom& g, const void* x, const void* w, const void* pad, const void* den,
               int elem, int l, int B, int T, int H, int W, int C, int K, long long sb,
               long long st, long long sk, long long sh, long long sw) {
  if (B < 1 || T < 1 || H < 1 || W < 1 || C < 1 || K < 1 || C % K || x == nullptr ||
      w == nullptr)
    return false;
  g = Geom{x, w, static_cast<const unsigned char*>(pad), static_cast<const float*>(den),
           (long long)B * H * W, T, H * W, W, C, K, C / K, 1, sb, st, sk, sh, sw};
  if (l == 0) return true;
  const int V = 16 / elem;
  if (C % V || !aligned16(x)) return false;
  if (g.cpk <= V) return V % g.cpk == 0 && l == g.cpk;
  g.G = g.cpk / V;
  return l == V && g.cpk % V == 0 && g.G <= 32 && (g.G & (g.G - 1)) == 0;
}

unsigned blocks_for(long long threads) { return (unsigned)((threads + kThreads - 1) / kThreads); }

template <typename Tin, int L>
cudaError_t fwd_vec(const Geom& g, void* out, cudaStream_t s) {
  if constexpr (L <= Vec<Tin>::V) {
    agg_fwd_vec<Tin, L><<<blocks_for(g.rows * (g.C / Vec<Tin>::V)), kThreads, 0, s>>>(g, static_cast<Tin*>(out));
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}

template <typename Tin, int L>
cudaError_t bwd_vec(const Geom& g, const void* dout, void* dx, void* dw, cudaStream_t s) {
  if constexpr (L <= Vec<Tin>::V) {
    agg_bwd_vec<Tin, L><<<blocks_for(g.rows * (g.C / Vec<Tin>::V)), kThreads, 0, s>>>(g, static_cast<const Tin*>(dout), static_cast<Tin*>(dx), static_cast<Tin*>(dw));
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}

template <typename Tin>
cudaError_t fwd(const Geom& g, void* out, int l, cudaStream_t s) {
  switch (l) {
    case 0:
      agg_fwd_gen<Tin><<<blocks_for(g.rows * g.C), kThreads, 0, s>>>(g, static_cast<Tin*>(out));
      return cudaGetLastError();
    case 1: return fwd_vec<Tin, 1>(g, out, s);
    case 2: return fwd_vec<Tin, 2>(g, out, s);
    case 4: return fwd_vec<Tin, 4>(g, out, s);
    case 8: return fwd_vec<Tin, 8>(g, out, s);
  }
  return cudaErrorInvalidValue;
}

template <typename Tin>
cudaError_t bwd(const Geom& g, const void* dout, void* dx, void* dw, int l, cudaStream_t s) {
  switch (l) {
    case 0:
      agg_bwd_gen<Tin><<<blocks_for(g.rows * g.K), kThreads, 0, s>>>(g, static_cast<const Tin*>(dout), static_cast<Tin*>(dx), static_cast<Tin*>(dw));
      return cudaGetLastError();
    case 1: return bwd_vec<Tin, 1>(g, dout, dx, dw, s);
    case 2: return bwd_vec<Tin, 2>(g, dout, dx, dw, s);
    case 4: return bwd_vec<Tin, 4>(g, dout, dx, dw, s);
    case 8: return bwd_vec<Tin, 8>(g, dout, dx, dw, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// out (B, H, W, C) in x's dtype, contiguous. route: 0 for the general pair,
// else the vector route's L (ops/aggregate.py::kernel_route), which the entry
// checks against the shape and x's and out's alignment. Each entry returns
// the cudaError_t of its launch (0 on success).
extern "C" int temporal_aggregate_fwd(const void* x, const void* w, const void* pad,
                                      const void* den, void* out, int x_is_bf16, int route,
                                      int B, int T, int H, int W, int C, int K, long long sb,
                                      long long st, long long sk, long long sh, long long sw,
                                      void* stream) {
  Geom g;
  if (!make_geom(g, x, w, pad, den, x_is_bf16 ? 2 : 4, route, B, T, H, W, C, K, sb, st, sk,
                 sh, sw) ||
      out == nullptr || (route && !aligned16(out)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(x_is_bf16 ? fwd<__nv_bfloat16>(g, out, route, s) : fwd<float>(g, out, route, s));
}

// dout (B, H, W, C) and dx (B, T, H, W, C) in x's dtype, contiguous; dw (B, T,
// K, H, W) contiguous in x's dtype, or null where the weights need no
// gradient. Every element of dx and dw is written.
extern "C" int temporal_aggregate_bwd(const void* x, const void* w, const void* pad,
                                      const void* den, const void* dout, void* dx, void* dw,
                                      int x_is_bf16, int route, int B, int T, int H, int W,
                                      int C, int K, long long sb, long long st, long long sk,
                                      long long sh, long long sw, void* stream) {
  Geom g;
  if (!make_geom(g, x, w, pad, den, x_is_bf16 ? 2 : 4, route, B, T, H, W, C, K, sb, st, sk,
                 sh, sw) ||
      dout == nullptr || dx == nullptr || (route && !(aligned16(dout) && aligned16(dx))))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(x_is_bf16 ? bwd<__nv_bfloat16>(g, dout, dx, dw, route, s)
                         : bwd<float>(g, dout, dx, dw, route, s));
}
