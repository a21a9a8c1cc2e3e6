// Native batch loader for S2TSCzCrop-style npy patch archives (a copy of
// crop2seg_tpu/native/loader.cpp; the code is the same, so the two libraries
// decode the same files to the same bits).
//
// Replaces the Python hot path of S2TSCZCropDataset.__getitem__ + collate
// (crop2seg_tpu_torch/data/s2tsczcrop.py, data/batcher.py) where no
// per-item Python work is needed: parse .npy (T, C_in, H, W) of
// float32/float16/uint16/int16/uint8, reorder channels to the PASTIS order,
// standardize per channel, and write each sample into its padded slot of the
// batch buffer, all off the GIL on a std::thread pool.
//
// Output layout/dtype are selectable per call:
// - interleaved (T, H, W, C) float32  -- the classic channels-last batch
// - planar (T, C, H, W)               -- skips the host transpose; the
//   device permutes to channels-last
// - bfloat16 output                   -- halves host write traffic and the
//   host->device transfer bytes
//
// Plane conversion is auto/explicitly vectorized (AVX-512 where the host has
// it): contiguous load -> widen -> (x - mean) * inv_std -> store, with
// VCVTPH2PS for f16 sources and VCVTNEPS2BF16 for bf16 output when available.
//
// Build: crop2seg_tpu_torch/native/__init__.py (g++ -O3 -march=native
// -shared, at first use, into crop2seg_tpu_torch/_build/)
#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#if defined(__x86_64__) || defined(_M_X64)
#include <immintrin.h>
#endif

#if defined(__unix__) || defined(__APPLE__)
#define C2S_HAVE_MMAP 1
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#endif

namespace {

enum NpyDtype { kF4, kF2, kU2, kI2, kU1 };

struct NpyInfo {
  int64_t shape[4] = {0, 0, 0, 0};
  int ndim = 0;
  NpyDtype dtype = kF4;
  size_t data_offset = 0;
};

inline size_t dtype_size(NpyDtype d) { return d == kF4 ? 4 : d == kU1 ? 1 : 2; }

// minimal .npy v1/v2 header parse; returns false on malformed files
bool parse_npy_header(FILE* f, NpyInfo* info) {
  unsigned char magic[8];
  if (fread(magic, 1, 8, f) != 8) return false;
  if (memcmp(magic, "\x93NUMPY", 6) != 0) return false;
  int major = magic[6];
  uint32_t hlen = 0;
  if (major == 1) {
    unsigned char b[2];
    if (fread(b, 1, 2, f) != 2) return false;
    hlen = b[0] | (b[1] << 8);
    info->data_offset = 10 + hlen;
  } else {
    unsigned char b[4];
    if (fread(b, 1, 4, f) != 4) return false;
    hlen = b[0] | (b[1] << 8) | (b[2] << 16) | (uint32_t(b[3]) << 24);
    info->data_offset = 12 + hlen;
  }
  std::string hdr(hlen, '\0');
  if (fread(&hdr[0], 1, hlen, f) != hlen) return false;
  if (hdr.find("'fortran_order': True") != std::string::npos) return false;
  // the reference dataset creator saves DATA_S2 patches as uint16
  // (sentinel2raster.py:396 profile dtype) and TARGETs can be uint8/int16;
  // its __getitem__ casts on load — we widen to float here instead.
  if (hdr.find("<f4") != std::string::npos) {
    info->dtype = kF4;
  } else if (hdr.find("<f2") != std::string::npos) {
    info->dtype = kF2;
  } else if (hdr.find("<u2") != std::string::npos) {
    info->dtype = kU2;
  } else if (hdr.find("<i2") != std::string::npos) {
    info->dtype = kI2;
  } else if (hdr.find("|u1") != std::string::npos) {
    info->dtype = kU1;
  } else {
    return false;
  }
  size_t sp = hdr.find("'shape':");
  if (sp == std::string::npos) return false;
  sp = hdr.find('(', sp);
  size_t ep = hdr.find(')', sp);
  if (sp == std::string::npos || ep == std::string::npos) return false;
  std::string dims = hdr.substr(sp + 1, ep - sp - 1);
  info->ndim = 0;
  const char* p = dims.c_str();
  while (*p && info->ndim < 4) {
    while (*p == ' ' || *p == ',') p++;
    if (!*p) break;
    info->shape[info->ndim++] = strtoll(p, const_cast<char**>(&p), 10);
  }
  return info->ndim >= 1;
}

inline float half_to_float(uint16_t h) {
  uint32_t sign = (h & 0x8000u) << 16;
  uint32_t exp = (h >> 10) & 0x1f;
  uint32_t frac = h & 0x3ffu;
  uint32_t bits;
  if (exp == 0) {
    if (frac == 0) {
      bits = sign;
    } else {  // subnormal
      exp = 127 - 15 + 1;
      while (!(frac & 0x400u)) { frac <<= 1; exp--; }
      frac &= 0x3ffu;
      bits = sign | (exp << 23) | (frac << 13);
    }
  } else if (exp == 0x1f) {
    bits = sign | 0x7f800000u | (frac << 13);
  } else {
    bits = sign | ((exp - 15 + 127) << 23) | (frac << 13);
  }
  float out;
  memcpy(&out, &bits, 4);
  return out;
}

inline uint16_t f32_to_bf16(float x) {  // round to nearest even
  uint32_t b;
  memcpy(&b, &x, 4);
  return uint16_t((b + 0x7FFFu + ((b >> 16) & 1u)) >> 16);
}

// ---- vectorizable plane kernels ------------------------------------------

template <typename SRC>
inline void convert_plane_t(const SRC* src, float m, float inv, int64_t n,
                            float* dst) {
  // contiguous widen+affine: g++ -O3 -march=native vectorizes this
  for (int64_t p = 0; p < n; p++) dst[p] = (float(src[p]) - m) * inv;
}

inline void convert_plane_f16(const uint16_t* src, float m, float inv,
                              int64_t n, float* dst) {
#if defined(__AVX512F__)
  const __m512 vm = _mm512_set1_ps(m), vi = _mm512_set1_ps(inv);
  int64_t p = 0;
  for (; p + 16 <= n; p += 16) {
    __m512 v = _mm512_cvtph_ps(_mm256_loadu_si256(
        reinterpret_cast<const __m256i*>(src + p)));
    _mm512_storeu_ps(dst + p, _mm512_mul_ps(_mm512_sub_ps(v, vm), vi));
  }
  for (; p < n; p++) dst[p] = (half_to_float(src[p]) - m) * inv;
#else
  for (int64_t p = 0; p < n; p++) dst[p] = (half_to_float(src[p]) - m) * inv;
#endif
}

inline void convert_plane(NpyDtype dt, const unsigned char* src, float m,
                          float inv, int64_t n, float* dst) {
  switch (dt) {
    case kF2:
      convert_plane_f16(reinterpret_cast<const uint16_t*>(src), m, inv, n,
                        dst);
      break;
    case kU2:
      convert_plane_t(reinterpret_cast<const uint16_t*>(src), m, inv, n, dst);
      break;
    case kI2:
      convert_plane_t(reinterpret_cast<const int16_t*>(src), m, inv, n, dst);
      break;
    case kU1:
      convert_plane_t(reinterpret_cast<const uint8_t*>(src), m, inv, n, dst);
      break;
    default:
      convert_plane_t(reinterpret_cast<const float*>(src), m, inv, n, dst);
  }
}

inline void narrow_bf16(const float* src, uint16_t* dst, int64_t n) {
#if defined(__AVX512BF16__)
  int64_t p = 0;
  for (; p + 16 <= n; p += 16) {
    __m512 v = _mm512_loadu_ps(src + p);
    __m256bh b = _mm512_cvtneps_pbh(v);
    _mm256_storeu_si256(reinterpret_cast<__m256i*>(dst + p), (__m256i)b);
  }
  for (; p < n; p++) dst[p] = f32_to_bf16(src[p]);
#else
  for (int64_t p = 0; p < n; p++) dst[p] = f32_to_bf16(src[p]);
#endif
}

// blocked planar (C, HW) -> interleaved (HW, C) transpose; the 256-pixel
// block keeps the output window L1-resident so the stride-C writes are cheap
constexpr int64_t kTransposeBlock = 256;

inline void interleave_f32(const float* planes, int c_out, int64_t hw,
                           float* out) {
  for (int64_t p0 = 0; p0 < hw; p0 += kTransposeBlock) {
    const int64_t pe = p0 + kTransposeBlock < hw ? p0 + kTransposeBlock : hw;
    for (int ci = 0; ci < c_out; ci++) {
      const float* src = planes + size_t(ci) * hw;
      for (int64_t p = p0; p < pe; p++) out[p * c_out + ci] = src[p];
    }
  }
}

inline void interleave_bf16(const float* planes, int c_out, int64_t hw,
                            uint16_t* out, float* blockbuf) {
  for (int64_t p0 = 0; p0 < hw; p0 += kTransposeBlock) {
    const int64_t pe = p0 + kTransposeBlock < hw ? p0 + kTransposeBlock : hw;
    const int64_t bn = (pe - p0) * c_out;
    for (int ci = 0; ci < c_out; ci++) {
      const float* src = planes + size_t(ci) * hw;
      for (int64_t p = p0; p < pe; p++)
        blockbuf[(p - p0) * c_out + ci] = src[p];
    }
    narrow_bf16(blockbuf, out + p0 * c_out, bn);
  }
}

// gather of an already-converted float plane through a pixel permutation
// (the augmentation's flip+rotate as an index map, transforms.py index_map);
// g < 0 fills 0 — the post-normalization rotate cval of the Python path
inline void gather_plane(const float* src, const int32_t* g, int64_t n,
                         float* dst) {
  for (int64_t p = 0; p < n; p++) dst[p] = g[p] < 0 ? 0.0f : src[g[p]];
}

// one sample: read (mmap when possible — skips one full-archive copy),
// reorder, normalize, augment (frame gather for temporal
// dropout + pixel gather for flip/rotate), (transpose,) pad
int load_one(const char* path, int t_bucket, float pad_value,
             const float* mean, const float* stdv, const int* reorder,
             int c_out, int h, int w, void* out, unsigned char* mask,
             int* length, bool planar, bool bf16, float* scratch,
             const int32_t* frame_map, const int32_t* gather) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  NpyInfo info;
  if (!parse_npy_header(f, &info) || info.ndim != 4) { fclose(f); return -2; }
  const int64_t T = info.shape[0], C_in = info.shape[1];
  if (info.shape[2] != h || info.shape[3] != w) { fclose(f); return -3; }
  const int64_t hw = int64_t(h) * w;
  int t_use = int(T < t_bucket ? T : t_bucket);
  if (frame_map) {  // explicit source-frame order; -1 = pad from there on
    t_use = 0;
    while (t_use < t_bucket && frame_map[t_use] >= 0) {
      if (frame_map[t_use] >= T) { fclose(f); return -7; }
      t_use++;
    }
  }
  *length = t_use;
  const size_t esz = dtype_size(info.dtype);
  const size_t frame_bytes = size_t(C_in) * hw * esz;
  const int64_t max_src_frame = frame_map && t_use
      ? *std::max_element(frame_map, frame_map + t_use) : int64_t(t_use) - 1;
  const size_t need = info.data_offset + size_t(max_src_frame + 1) * frame_bytes;

  const unsigned char* base = nullptr;  // mmap'd archive (preferred)
  size_t map_len = 0;
#if C2S_HAVE_MMAP
  {
    const int fd = fileno(f);
    struct stat st;
    if (fd >= 0 && fstat(fd, &st) == 0 && size_t(st.st_size) >= need) {
      void* m = mmap(nullptr, size_t(st.st_size), PROT_READ, MAP_SHARED, fd, 0);
      if (m != MAP_FAILED) {
        base = static_cast<const unsigned char*>(m);
        map_len = size_t(st.st_size);
        madvise(m, map_len, MADV_SEQUENTIAL);
      }
    }
  }
#endif
  std::vector<unsigned char> frame;
  if (base == nullptr) frame.resize(frame_bytes);

  // scratch layout: c_out planes | 1 temp plane (gather) | transpose block
  float* planes = scratch;
  float* tmp = scratch + size_t(c_out) * hw;
  float* blockbuf = tmp + hw;

  const size_t frame_elems = size_t(hw) * c_out;
  for (int t = 0; t < t_use; t++) {
    const int64_t fs = frame_map ? frame_map[t] : t;  // source frame
    const unsigned char* frame_p;
    if (base != nullptr) {
      frame_p = base + info.data_offset + size_t(fs) * frame_bytes;
    } else {
      if (fseek(f, long(info.data_offset + size_t(fs) * frame_bytes),
                SEEK_SET) != 0 ||
          fread(frame.data(), 1, frame_bytes, f) != frame_bytes) {
        fclose(f);
        return -5;
      }
      frame_p = frame.data();
    }
    for (int ci = 0; ci < c_out; ci++) {
      const int cs = reorder ? reorder[ci] : ci;
      if (cs < 0 || cs >= C_in) {
#if C2S_HAVE_MMAP
        if (base) munmap(const_cast<unsigned char*>(base), map_len);
#endif
        fclose(f);
        return -6;
      }
      const float m = mean ? mean[ci] : 0.0f;
      const float inv = stdv ? 1.0f / stdv[ci] : 1.0f;
      const unsigned char* srcp = frame_p + size_t(cs) * hw * esz;
      float* final_plane =
          planar && !bf16
              ? static_cast<float*>(out) + (size_t(t) * c_out + ci) * hw
              : (planar ? planes : planes + size_t(ci) * hw);
      if (gather) {  // vectorized convert, then permute (flip+rotate)
        convert_plane(info.dtype, srcp, m, inv, hw, tmp);
        gather_plane(tmp, gather, hw, final_plane);
      } else {
        convert_plane(info.dtype, srcp, m, inv, hw, final_plane);
      }
      if (planar && bf16) {
        narrow_bf16(planes, static_cast<uint16_t*>(out)
                                + (size_t(t) * c_out + ci) * hw, hw);
      }
    }
    if (!planar) {
      if (bf16) {
        interleave_bf16(planes, c_out, hw,
                        static_cast<uint16_t*>(out) + size_t(t) * frame_elems,
                        blockbuf);
      } else {
        interleave_f32(planes, c_out, hw,
                       static_cast<float*>(out) + size_t(t) * frame_elems);
      }
    }
    mask[t] = 0;
  }
#if C2S_HAVE_MMAP
  if (base) munmap(const_cast<unsigned char*>(base), map_len);
#endif
  fclose(f);
  // pad frames
  for (int t = t_use; t < t_bucket; t++) {
    if (bf16) {
      uint16_t* dst_t = static_cast<uint16_t*>(out) + size_t(t) * frame_elems;
      const uint16_t pv = f32_to_bf16(pad_value);
      for (size_t i = 0; i < frame_elems; i++) dst_t[i] = pv;
    } else {
      float* dst_t = static_cast<float*>(out) + size_t(t) * frame_elems;
      for (size_t i = 0; i < frame_elems; i++) dst_t[i] = pad_value;
    }
    mask[t] = 1;
  }
  return 0;
}

}  // namespace

extern "C" {

// Returns 0 on success; otherwise the first nonzero per-sample error code.
// out: (n, t_bucket, h, w, c_out) [or (n, t_bucket, c_out, h, w) if planar]
// of float32 [or bfloat16 if bf16]; mask: (n, t_bucket) uint8 (1=pad);
// lengths: (n,) int32. reorder maps output channel -> source channel.
// frame_maps: (n, t_bucket) int32 source-frame gather per sample (-1 = pad)
// implementing temporal dropout, or null for the identity first-T order.
// gathers: (n, h*w) int32 pixel permutation per sample (-1 = fill 0)
// implementing the flip+rotate augmentation (transforms.py index_map), or
// null. RNG draws stay in Python (one map per sample); the per-pixel work
// runs here off the GIL.
int c2s_load_batch_aug(const char** paths, int n, int t_bucket,
                       float pad_value, const float* mean, const float* stdv,
                       const int* reorder, int c_out, int h, int w, void* out,
                       unsigned char* mask, int* lengths, int n_threads,
                       int planar, int bf16, const int32_t* frame_maps,
                       const int32_t* gathers) {
  std::atomic<int> next(0), err(0);
  const int64_t hw = int64_t(h) * w;
  const size_t sample_elems = size_t(t_bucket) * hw * c_out;
  const size_t out_esz = bf16 ? 2 : 4;
  auto worker = [&]() {
    // c_out planes + one gather temp plane + one transpose block
    std::vector<float> scratch(size_t(c_out + 1) * hw +
                               kTransposeBlock * c_out);
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) return;
      const int rc = load_one(
          paths[i], t_bucket, pad_value, mean, stdv, reorder, c_out, h, w,
          static_cast<unsigned char*>(out) + size_t(i) * sample_elems * out_esz,
          mask + size_t(i) * t_bucket, lengths + i, planar != 0, bf16 != 0,
          scratch.data(),
          frame_maps ? frame_maps + size_t(i) * t_bucket : nullptr,
          gathers ? gathers + size_t(i) * hw : nullptr);
      if (rc != 0) {
        int expected = 0;
        err.compare_exchange_strong(expected, rc);
      }
    }
  };
  if (n_threads <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    const int k = n_threads < n ? n_threads : n;
    for (int i = 0; i < k; i++) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return err.load();
}

int c2s_load_batch(const char** paths, int n, int t_bucket, float pad_value,
                   const float* mean, const float* stdv, const int* reorder,
                   int c_out, int h, int w, void* out, unsigned char* mask,
                   int* lengths, int n_threads, int planar, int bf16) {
  return c2s_load_batch_aug(paths, n, t_bucket, pad_value, mean, stdv,
                            reorder, c_out, h, w, out, mask, lengths,
                            n_threads, planar, bf16, nullptr, nullptr);
}

// Parse just the (T, C, H, W) shape of an npy file (returns ndim or <0).
int c2s_npy_shape(const char* path, int64_t* shape4) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  NpyInfo info;
  const bool ok = parse_npy_header(f, &info);
  fclose(f);
  if (!ok) return -2;
  for (int i = 0; i < 4; i++) shape4[i] = info.shape[i];
  return info.ndim;
}

}  // extern "C"
