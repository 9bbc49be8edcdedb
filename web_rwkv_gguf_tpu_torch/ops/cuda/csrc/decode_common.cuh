// Device code shared by the whole-stack decode kernels (layer7.cu, layer56.cu):
// Q4_K and bf16 row gemvs for up to 16 lanes, LayerNorm rows, block and warp
// sums, staging through L2, L2 prefetch, and the device clock. Each kernel
// is one cooperative launch of 256-thread blocks that walks the layers.
//
// Q4_K rows use the port's split-halves layout (models/matrix.py): code
// byte j of a row holds elements j (low nibble) and j + K/2 (high nibble);
// the weight is q * (d * sc) - dmin * mn per 32-element group, in f32 (the
// gemv class of q4k_gemv.cu).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxB = 16;           // lanes one launch takes
constexpr int kMaxSmem = 232448;    // bytes of shared memory a block may use

struct Q4K {
  const uint8_t* codes;  // [L, M, K/2] split halves
  const uint8_t* sc6;    // [L, M, K/32]
  const uint8_t* mn6;    // [L, M, K/32]
  const float* d8;       // [L, M, K/256]
  const float* dm8;      // [L, M, K/256]
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

// Copy n bf16 (n % 8 == 0) written earlier in this launch into shared memory.
__device__ void stage(__nv_bfloat16* dst, const __nv_bfloat16* src, int n) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* d = reinterpret_cast<uint4*>(dst);
  for (int i = threadIdx.x; i < n / 8; i += blockDim.x) d[i] = __ldcg(s + i);
  __syncthreads();
}

// LayerNorm of every lane's row of x [B, C] (written in this launch) into
// rows [B, C] (shared f32), one warp per lane: two-pass mean and variance,
// as the plain version computes them.
__device__ void layer_norm_rows(const float* x, int B, int C, float eps, const float* w,
                                const float* bias, float* rows) {
  const int lane = threadIdx.x & 31;
  for (int b = threadIdx.x >> 5; b < B; b += kWarps) {
    const float* xr = x + (size_t)b * C;
    float* row = rows + (size_t)b * C;
    float s = 0.f;
#pragma unroll 8
    for (int c = lane; c < C; c += 32) {
      const float v = __ldcg(xr + c);
      row[c] = v;
      s += v;
    }
    const float mean = warp_sum(s) / C;
    float q = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = row[c] - mean;
      q += d * d;
    }
    const float rs = rsqrtf(warp_sum(q) / C + eps);
    for (int c = lane; c < C; c += 32) row[c] = (row[c] - mean) * rs * w[c] + bias[c];
  }
  __syncthreads();
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

__device__ void prefetch_q4k(const Q4K& w, int l, int M, int k) {
  const size_t rows = (size_t)M, at = (size_t)l * rows;
  prefetch_l2(w.codes + at * (k / 2), rows * (k / 2));
  prefetch_l2(w.sc6 + at * (k / 32), rows * (k / 32));
  prefetch_l2(w.mn6 + at * (k / 32), rows * (k / 32));
  prefetch_l2(w.d8 + at * (k / 256), rows * (k / 256) * 4);
  prefetch_l2(w.dm8 + at * (k / 256), rows * (k / 256) * 4);
}

// One Q4_K output row m of layer l for every lane: acc[t] = x[t] . W[m].
// xs: shared bf16 [B, k]. Called by a whole warp.
template <int NB>
__device__ void q4k_row(const Q4K& w, int l, int M, int m, int k, const __nv_bfloat16* xs,
                        int B, float* acc) {
  const int lane = threadIdx.x & 31;
  const int half = k >> 1;
  const int nchunks = half >> 4;
  const int g32 = k >> 5, g256 = k >> 8;
  const size_t row = (size_t)l * M + m;
  const uint8_t* crow = w.codes + row * half;
  const uint8_t* srow = w.sc6 + row * g32;
  const uint8_t* mrow = w.mn6 + row * g32;
  const float* drow = w.d8 + row * g256;
  const float* dmrow = w.dm8 + row * g256;
#pragma unroll
  for (int t = 0; t < NB; ++t) acc[t] = 0.f;
  for (int c = lane; c < nchunks; c += 32) {
    const int j0 = c << 4;  // 16 code bytes: elements j0.. (low), j0 + K/2.. (high)
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(crow + j0));
    const int glo = j0 >> 5, ghi = (j0 + half) >> 5;
    const float slo = drow[glo >> 3] * (float)srow[glo];
    const float mlo = dmrow[glo >> 3] * (float)mrow[glo];
    const float shi = drow[ghi >> 3] * (float)srow[ghi];
    const float mhi = dmrow[ghi >> 3] * (float)mrow[ghi];
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

// The arguments of a decode kernel's C entry point, taken in order.
template <class T>
T take(const void* const* p, int& i) {
  return (T)(p[i++]);
}

Q4K take_q4k(const void* const* p, int& i) {
  Q4K w;
  w.codes = take<const uint8_t*>(p, i);
  w.sc6 = take<const uint8_t*>(p, i);
  w.mn6 = take<const uint8_t*>(p, i);
  w.d8 = take<const float*>(p, i);
  w.dm8 = take<const float*>(p, i);
  return w;
}

}  // namespace
