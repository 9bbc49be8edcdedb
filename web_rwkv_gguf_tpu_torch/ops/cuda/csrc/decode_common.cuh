// Device code shared by the whole-stack decode kernels (layer7.cu, layer56.cu):
// the matrix forms the kernels take (MatForm) and their slot operands,
// quantized and dense row gemvs for up to 16 lanes in every form (layer7.cu's
// row path), block and warp sums, L2 prefetch, and the device clock. Each
// kernel is one cooperative launch of 256-thread blocks that walks the
// layers.
//
// Nibble rows (Q4_K and the f32-scale nibbles of Q4_0 / Q4_1) use the port's
// split-halves layout (models/matrix.py): code byte j of a row holds
// elements j (low nibble) and j + K/2 (high nibble); the weight is q * s - mn
// per 32-element group, with s = d * sc and mn = dmin * mn formed in f32 from
// Q4_K's native factors or read from f32 group arrays (the gemv class of
// q4k_gemv.cu and qs_gemv.cu). Byte-code rows hold one code a byte, with s
// and mn formed in f32 per 32- or 16-group (Q5_K, Q2_K), s = d * sc per
// 16-group and no offset (Q6_K, Q3_K: i8 codes and scale codes), or f32
// group scales and optional mins (Q8_0, Q5_0, Q5_1, Q4_1 and Q4_0 bytes; the
// engine's Int8 in 128-groups): the gemv class of qkb_gemv.cu, q6k_gemv.cu
// and qs_gemv.cu, with their scale sources and code decoding (qscales.cuh).
// Dense rows are bf16 weights against the bf16 input, f32 sums.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "qscales.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxB = 16;           // lanes one launch takes
constexpr int kMaxSmem = 232448;    // bytes of shared memory a block may use

// A layer-stacked matrix in one of the forms the kernels take, picked per
// matrix slot at run time (a warp-uniform switch, no template axis): the
// descriptor int packs form | signed << 3 | group size << 4.
enum MatForm {
  kFormQ4K = 0,    // codes u8 [L, M, K/2] split halves; p1, p2 = sc6, mn6 u8
                   // [L, M, K/32]; d8, dm8 f32 [L, M, K/256]
  kFormQKB = 1,    // Q5_K / Q2_K: codes u8 [L, M, K]; p1, p2 = sc6, mn6 u8
                   // [L, M, K/gs]; d8, dm8 f32 [L, M, K/256]
  kFormQS = 2,     // f32 group scales: codes u8 or i8 [L, M, K]; p1 = scales,
                   // p2 = mins (or null) f32 [L, M, K/gs]; no d8, dm8; gs 16
                   // or 32, or 128 (the engine's Int8: s = (mx - mn) / 255
                   // and mins = -mn formed at prep)
  kFormQ6K = 3,    // Q6_K / Q3_K: codes i8 [L, M, K]; p1 = q6s i8 [L, M, K/16];
                   // d8 = q6d f32 [L, M, K/256]; no p2, dm8; gs 16
  kFormQSNib = 4,  // f32 group scales over split-halves nibbles (Q4_0, Q4_1,
                   // Q4_K rows without whole super-blocks): codes u8
                   // [L, M, K/2]; p1 = scales, p2 = mins (or null) f32
                   // [L, M, K/32]; gs 32
  kFormDense = 5,  // bf16 weights: codes = w bf16 [L, M, K]; no factors
};

constexpr int kDescSigned = 3;  // descriptor bit of the signed codes
constexpr int kDescGs = 4;      // descriptor bits of the group size, from here up

struct QMat {
  const uint8_t* codes;
  const void* p1;
  const void* p2;
  const float* d8;
  const float* dm8;
  int form, sgn, gs;
};

__device__ __forceinline__ unsigned long long globaltimer_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sum over the block's threads; red holds kWarps floats.
__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();  // earlier readers of red are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += red[w];
  return s;
}

__device__ __forceinline__ void bf16x8(const uint4 u, float* f) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

// Ask L2 to fetch [p, p + bytes), the lines spread over the whole grid.
__device__ void prefetch_l2(const void* p, size_t bytes) {
  const char* c = static_cast<const char*>(p);
  const size_t step = (size_t)gridDim.x * blockDim.x * 128;
  for (size_t off = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 128; off < bytes;
       off += step) {
    asm volatile("prefetch.global.L2 [%0];" ::"l"(c + off));
  }
}

__device__ void prefetch_mat(const QMat& w, int l, int M, int k) {
  const size_t rows = (size_t)M, at = (size_t)l * rows;
  const bool nib = w.form == kFormQ4K || w.form == kFormQSNib;
  const size_t cb = w.form == kFormDense ? 2 * k : (nib ? k / 2 : k);  // code bytes per row
  prefetch_l2(w.codes + at * cb, rows * cb);
  if (w.p1 == nullptr) return;  // dense: no factors
  const bool f32 = w.form == kFormQS || w.form == kFormQSNib;
  const size_t fb = f32 ? 4 * (k / w.gs) : k / w.gs;  // factor bytes per row
  prefetch_l2(static_cast<const char*>(w.p1) + at * fb, rows * fb);
  if (w.p2 != nullptr) prefetch_l2(static_cast<const char*>(w.p2) + at * fb, rows * fb);
  if (w.d8 != nullptr) prefetch_l2(w.d8 + at * (k / 256), rows * (k / 256) * 4);
  if (w.dm8 != nullptr) prefetch_l2(w.dm8 + at * (k / 256), rows * (k / 256) * 4);
}

// One nibble output row m of layer l (kFormQ4K or kFormQSNib) for every
// lane: acc[t] = x[t] . W[m], in f32 on the exact weight q * s - mn formed
// per element (a 16-element half-chunk never straddles a 32-group). xs:
// shared bf16 [B, k]. Called by a whole warp.
template <int NB>
__device__ void nib_row(const QMat& w, int l, int M, int m, int k, const __nv_bfloat16* xs,
                        int B, float* acc) {
  const int lane = threadIdx.x & 31;
  const int half = k >> 1;
  const int nchunks = half >> 4;
  const size_t row = (size_t)l * M + m;
  const uint8_t* crow = w.codes + row * half;
#pragma unroll
  for (int t = 0; t < NB; ++t) acc[t] = 0.f;
  for (int c = lane; c < nchunks; c += 32) {
    const int j0 = c << 4;  // 16 code bytes: elements j0.. (low), j0 + K/2.. (high)
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(crow + j0));
    const int glo = j0 >> 5, ghi = (j0 + half) >> 5;
    float slo, mlo, shi, mhi;
    if (w.form == kFormQ4K) {
      const NativeScales f{static_cast<const uint8_t*>(w.p1), static_cast<const uint8_t*>(w.p2),
                           w.d8, w.dm8, k >> 5, 8};
      f.get(row, glo, slo, mlo);
      f.get(row, ghi, shi, mhi);
    } else {
      const F32Scales f{static_cast<const float*>(w.p1), static_cast<const float*>(w.p2),
                        k >> 5};
      f.get(row, glo, slo, mlo);
      f.get(row, ghi, shi, mhi);
    }
    const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
    float wlo[16], whi[16];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const uint32_t byte = (words[q] >> (8 * b)) & 0xFFu;
        wlo[4 * q + b] = (float)(byte & 0xFu) * slo - mlo;
        whi[4 * q + b] = (float)(byte >> 4) * shi - mhi;
      }
    }
#pragma unroll
    for (int t = 0; t < NB; ++t) {
      if (t < B) {
        const uint4* xl = reinterpret_cast<const uint4*>(xs + (size_t)t * k + j0);
        const uint4* xh = reinterpret_cast<const uint4*>(xs + (size_t)t * k + half + j0);
        float fl[16], fh[16];
        bf16x8(xl[0], fl);
        bf16x8(xl[1], fl + 8);
        bf16x8(xh[0], fh);
        bf16x8(xh[1], fh + 8);
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < 16; ++e) s += wlo[e] * fl[e] + whi[e] * fh[e];
        acc[t] += s;
      }
    }
  }
#pragma unroll
  for (int t = 0; t < NB; ++t) acc[t] = warp_sum(acc[t]);
}

// One output row m of layer l of a byte-code matrix (kFormQKB, kFormQS or
// kFormQ6K) for every lane: acc[t] = x[t] . W[m], in f32 on the exact weight
// q * s - mn, formed per element (a 16-element chunk never straddles a 16-,
// 32- or 128-group). xs: shared bf16 [B, k]. Called by a warp.
template <int NB>
__device__ void byte_row(const QMat& w, int l, int M, int m, int k, const __nv_bfloat16* xs,
                         int B, float* acc) {
  const int lane = threadIdx.x & 31;
  const int G = k / w.gs;
  const size_t row = (size_t)l * M + m;
  const uint8_t* crow = w.codes + row * k;
#pragma unroll
  for (int t = 0; t < NB; ++t) acc[t] = 0.f;
  for (int c = lane; c < (k >> 4); c += 32) {
    const int j0 = c << 4;
    const int g = j0 / w.gs;
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(crow + j0));
    float s, off;
    if (w.form == kFormQKB) {
      NativeScales{static_cast<const uint8_t*>(w.p1), static_cast<const uint8_t*>(w.p2), w.d8,
                   w.dm8, G, 256 / w.gs}.get(row, g, s, off);
    } else if (w.form == kFormQ6K) {
      NominScales{static_cast<const int8_t*>(w.p1), w.d8, G, 256 / w.gs}.get(row, g, s, off);
    } else {
      F32Scales{static_cast<const float*>(w.p1), static_cast<const float*>(w.p2), G}.get(
          row, g, s, off);
    }
    const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
    float wv[16];  // the weights q * s - mn of the chunk
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float q = w.sgn ? code_at<kI8>(words[i], b) : code_at<kU8>(words[i], b);
        wv[4 * i + b] = q * s - off;
      }
    }
#pragma unroll
    for (int t = 0; t < NB; ++t) {
      if (t < B) {
        const uint4* xp = reinterpret_cast<const uint4*>(xs + (size_t)t * k + j0);
        float f[16];
        bf16x8(xp[0], f);
        bf16x8(xp[1], f + 8);
        float p = 0.f;
#pragma unroll
        for (int e = 0; e < 16; ++e) p += wv[e] * f[e];
        acc[t] += p;
      }
    }
  }
#pragma unroll
  for (int t = 0; t < NB; ++t) acc[t] = warp_sum(acc[t]);
}

// One bf16 dense row (k elements) for every lane: acc[t] = x[t] . w.
template <int NB>
__device__ void bf16_row(const __nv_bfloat16* wrow, int k, const __nv_bfloat16* xs, int B,
                         float* acc) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int t = 0; t < NB; ++t) acc[t] = 0.f;
  for (int c = lane; c < (k >> 3); c += 32) {
    float wf[8];
    bf16x8(__ldg(reinterpret_cast<const uint4*>(wrow) + c), wf);
#pragma unroll
    for (int t = 0; t < NB; ++t) {
      if (t < B) {
        float xf[8];
        bf16x8(reinterpret_cast<const uint4*>(xs + (size_t)t * k)[c], xf);
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) s += wf[e] * xf[e];
        acc[t] += s;
      }
    }
  }
#pragma unroll
  for (int t = 0; t < NB; ++t) acc[t] = warp_sum(acc[t]);
}

// One output row of a layer matrix in whichever form it has.
template <int NB>
__device__ __forceinline__ void mat_row(const QMat& w, int l, int M, int m, int k,
                                        const __nv_bfloat16* xs, int B, float* acc) {
  if (w.form == kFormQ4K || w.form == kFormQSNib) {
    nib_row<NB>(w, l, M, m, k, xs, B, acc);
  } else if (w.form == kFormDense) {
    bf16_row<NB>(reinterpret_cast<const __nv_bfloat16*>(w.codes) + ((size_t)l * M + m) * k, k,
                 xs, B, acc);
  } else {
    byte_row<NB>(w, l, M, m, k, xs, B, acc);
  }
}

// The arguments of a decode kernel's C entry point, taken in order.
template <class T>
T take(const void* const* p, int& i) {
  return (T)(p[i++]);
}

// A matrix slot's five pointers (codes, p1, p2, d8, dm8; null where the
// form has none) and its descriptor (see MatForm).
QMat take_mat(const void* const* p, int& i, int desc) {
  QMat w;
  w.codes = take<const uint8_t*>(p, i);
  w.p1 = take<const void*>(p, i);
  w.p2 = take<const void*>(p, i);
  w.d8 = take<const float*>(p, i);
  w.dm8 = take<const float*>(p, i);
  w.form = desc & ((1 << kDescSigned) - 1);
  w.sgn = (desc >> kDescSigned) & 1;
  w.gs = desc >> kDescGs;
  return w;
}

// Whether a slot's descriptor and pointers make a matrix the kernels take
// at [M, K] (K % 256 == 0 is checked by the caller).
bool mat_ok(const QMat& w) {
  if (w.codes == nullptr) return false;
  if (w.form == kFormDense) return true;
  if (w.p1 == nullptr) return false;
  switch (w.form) {
    case kFormQ4K: return w.gs == 32 && w.p2 && w.d8 && w.dm8;
    case kFormQKB: return (w.gs == 16 || w.gs == 32) && w.p2 && w.d8 && w.dm8;
    case kFormQS: return w.gs == 16 || w.gs == 32 || w.gs == 128;
    case kFormQ6K: return w.gs == 16 && w.sgn && w.d8;
    case kFormQSNib: return w.gs == 32 && !w.sgn;
    default: return false;
  }
}

}  // namespace
