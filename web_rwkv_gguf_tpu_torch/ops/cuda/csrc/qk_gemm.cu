// K-quant dequant-GEMM for Hopper (sm_90a): y[n, m] = sum_k x[n, k] * W[m, k]
// at any row count n, W held as the port's logical Q4_K or Q6_K arrays. On
// the main path it runs every quantized matmul of a prefill chunk (n = B*T)
// and the decode matmuls whose n * groups exceeds the gemv's gate.
//
// Replaces: web_rwkv_gguf_tpu/ops/pallas/matmul.py::quant_matmul, slab
// branch (def at line 1225, pallas_call at line 1416; kernel body _kernel
// at line 86).
//
// What it computes (the slab kernel's numerics class, not the gemv's):
//   Q4_K  y = sum_k bf16(x) * bf16(q * s)  -  sum_g mn[m, g] * xs[n, g]
//         q the 4-bit code (split halves: low nibble of byte j is element
//         j, high nibble element j + K/2), s = d8 * sc6 and mn = dm8 * mn6
//         formed in f32, xs[n, g] the f32 sum of bf16(x) over group g.
//   Q6_K  y = sum_k bf16(x) * bf16(q * s), q the signed i8 code,
//         s = q6d * q6s in f32; no offset.
// Products are bf16 x bf16 on the tensor cores (mma.sync.m16n8k16, f32
// accumulation); the offset term is kept in its own f32 accumulators and
// subtracted in the epilogue, as the TPU kernel adds it after its dot.
//
// Bound on this card: bytes at small n (decode: the weight is read once
// for a handful of rows), operations at prefill n (B*T = 512 rows do
// 512 multiply-adds per weight, above the ~295 operations per byte where
// H100 stops being memory-bound). This first version is simple, not
// fast: one block of 4 warps per 64 weight rows x 64 input rows, looping
// over K 64 elements at a time (Q4_K: 32 code bytes per row, one low and
// one high 32-group; Q6_K: 64 code bytes, four 16-groups). Each step
// dequantizes the weight tile to bf16 in shared memory and stages the x
// tile beside it (zero-padded past M and n, x never read past its end),
// the next step's codes and x are loaded into registers while the tensor
// cores work, and each warp computes a 32 x 32 output tile. wgmma, TMA
// and a ring of stages are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;       // weight rows per block
constexpr int kBN = 64;       // input rows per block
constexpr int kKT = 64;       // K elements per step
constexpr int kStride = 72;   // bf16 per shared row: 64 + 8 pad (no bank conflicts)
constexpr int kThreads = 128;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat16 a = __float2bfloat16_rn(lo);
  const __nv_bfloat16 b = __float2bfloat16_rn(hi);
  return (uint32_t)__bfloat16_as_ushort(a) |
         ((uint32_t)__bfloat16_as_ushort(b) << 16);
}

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xFFFF0000u);
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Q4_K: thread t dequantizes 16 code bytes of weight row t/2 (bytes
// (t%2)*16.. of the step's 32), giving 16 low-group and 16 high-group
// elements. Q6_K: 32 code bytes of row t/2 (bytes (t%2)*32.. of 64).
template <bool kQ4>
struct Codes {
  uint4 v[kQ4 ? 1 : 2];
};

template <bool kQ4>
__global__ void __launch_bounds__(kThreads)
qk_gemm_kernel(const __nv_bfloat16* __restrict__ x,
               const uint8_t* __restrict__ codes,
               const uint8_t* __restrict__ sc,   // sc6 (Q4_K) or q6s (Q6_K)
               const uint8_t* __restrict__ mn6,  // Q4_K only
               const float* __restrict__ d,      // d8 or q6d
               const float* __restrict__ dm8,    // Q4_K only
               float* __restrict__ y, int n, int m, int k) {
  __shared__ __align__(16) __nv_bfloat16 ws[kBM * kStride];
  __shared__ __align__(16) __nv_bfloat16 xs[kBN * kStride];
  __shared__ float mn_t[kBM][2];  // Q4_K group offsets of this step
  __shared__ float xs_t[kBN][2];  // Q4_K group sums of bf16 x of this step

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int half = k >> 1;
  const int steps = kQ4 ? half / 32 : k / kKT;
  const int g32 = k >> 5;      // Q4_K groups per row
  const int g16 = k >> 4;      // Q6_K groups per row
  const int g256 = k >> 8;     // super-blocks per row

  // loader roles: weight row wr, part wp; x row xr, segment xp
  const int wr = tid >> 1, wp = tid & 1;
  const int xr = tid >> 1, xp = tid & 1;
  const bool w_ok = m0 + wr < m;
  const bool x_ok = n0 + xr < n;
  const size_t row_bytes = kQ4 ? (size_t)half : (size_t)k;
  const uint8_t* crow = codes + (size_t)(w_ok ? m0 + wr : 0) * row_bytes;
  const __nv_bfloat16* xrow = x + (size_t)(x_ok ? n0 + xr : 0) * k;

  auto load_codes = [&](int s, Codes<kQ4>& c) {
    const uint8_t* src = kQ4 ? crow + s * 32 + wp * 16 : crow + s * kKT + wp * 32;
#pragma unroll
    for (int i = 0; i < (kQ4 ? 1 : 2); ++i) {
      c.v[i] = w_ok ? reinterpret_cast<const uint4*>(src)[i] : make_uint4(0, 0, 0, 0);
    }
  };
  // x segment of this thread: 32 bf16 (64 bytes) of input row xr
  auto x_col = [&](int s) {
    return kQ4 ? (xp == 0 ? s * 32 : half + s * 32) : s * kKT + xp * 32;
  };
  auto load_x = [&](int s, uint4* xv) {
    const uint4* p = reinterpret_cast<const uint4*>(xrow + x_col(s));
#pragma unroll
    for (int i = 0; i < 4; ++i) xv[i] = x_ok ? p[i] : make_uint4(0, 0, 0, 0);
  };

  const int warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = (warp & 1) * 32;   // warp's weight-row offset in the tile
  const int wn = (warp >> 1) * 32;  // warp's input-row offset in the tile

  float acc[2][4][4];
  float corr[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = corr[i][j][e] = 0.f;

  Codes<kQ4> cur;
  uint4 xv[4];
  load_codes(0, cur);
  load_x(0, xv);

  for (int s = 0; s < steps; ++s) {
    // ---- dequantize the weight tile into shared memory ----
    if constexpr (kQ4) {
      const int glo = s, ghi = (half >> 5) + s;  // the step's two 32-groups
      float slo = 0.f, shi = 0.f, mlo = 0.f, mhi = 0.f;
      if (w_ok) {
        const size_t r = (size_t)(m0 + wr);
        slo = d[r * g256 + (glo >> 3)] * (float)sc[r * g32 + glo];
        shi = d[r * g256 + (ghi >> 3)] * (float)sc[r * g32 + ghi];
        mlo = dm8[r * g256 + (glo >> 3)] * (float)mn6[r * g32 + glo];
        mhi = dm8[r * g256 + (ghi >> 3)] * (float)mn6[r * g32 + ghi];
      }
      if (wp == 0) {
        mn_t[wr][0] = mlo;
        mn_t[wr][1] = mhi;
      }
      const uint32_t words[4] = {cur.v[0].x, cur.v[0].y, cur.v[0].z, cur.v[0].w};
      uint32_t lo[8], hi[8];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t wv = words[q];
        const float q0 = (float)(wv & 0xFu), q1 = (float)((wv >> 8) & 0xFu);
        const float q2 = (float)((wv >> 16) & 0xFu), q3 = (float)((wv >> 24) & 0xFu);
        const float h0 = (float)((wv >> 4) & 0xFu), h1 = (float)((wv >> 12) & 0xFu);
        const float h2 = (float)((wv >> 20) & 0xFu), h3 = (float)((wv >> 28) & 0xFu);
        lo[2 * q] = pack_bf16(q0 * slo, q1 * slo);
        lo[2 * q + 1] = pack_bf16(q2 * slo, q3 * slo);
        hi[2 * q] = pack_bf16(h0 * shi, h1 * shi);
        hi[2 * q + 1] = pack_bf16(h2 * shi, h3 * shi);
      }
      uint4* dst_lo = reinterpret_cast<uint4*>(ws + wr * kStride + wp * 16);
      uint4* dst_hi = reinterpret_cast<uint4*>(ws + wr * kStride + 32 + wp * 16);
      dst_lo[0] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      dst_lo[1] = make_uint4(lo[4], lo[5], lo[6], lo[7]);
      dst_hi[0] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      dst_hi[1] = make_uint4(hi[4], hi[5], hi[6], hi[7]);
    } else {
      const int g0 = (s * kKT + wp * 32) >> 4;  // the thread's two 16-groups
      float s0 = 0.f, s1 = 0.f;
      if (w_ok) {
        const size_t r = (size_t)(m0 + wr);
        s0 = d[r * g256 + (g0 >> 4)] *
             (float)reinterpret_cast<const int8_t*>(sc)[r * g16 + g0];
        s1 = d[r * g256 + ((g0 + 1) >> 4)] *
             (float)reinterpret_cast<const int8_t*>(sc)[r * g16 + g0 + 1];
      }
      const uint32_t words[8] = {cur.v[0].x, cur.v[0].y, cur.v[0].z, cur.v[0].w,
                                 cur.v[1].x, cur.v[1].y, cur.v[1].z, cur.v[1].w};
      uint32_t out[16];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const uint32_t wv = words[q];
        const float sq = q < 4 ? s0 : s1;
        const float e0 = (float)(int8_t)(wv & 0xFFu);
        const float e1 = (float)(int8_t)((wv >> 8) & 0xFFu);
        const float e2 = (float)(int8_t)((wv >> 16) & 0xFFu);
        const float e3 = (float)(int8_t)(wv >> 24);
        out[2 * q] = pack_bf16(e0 * sq, e1 * sq);
        out[2 * q + 1] = pack_bf16(e2 * sq, e3 * sq);
      }
      uint4* dst = reinterpret_cast<uint4*>(ws + wr * kStride + wp * 32);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        dst[i] = make_uint4(out[4 * i], out[4 * i + 1], out[4 * i + 2], out[4 * i + 3]);
      }
    }
    // ---- stage the x tile (and, for Q4_K, its group sums) ----
    {
      uint4* dst = reinterpret_cast<uint4*>(xs + xr * kStride + xp * 32);
      float gsum = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        dst[i] = xv[i];
        if constexpr (kQ4) {
          gsum += bf16_lo(xv[i].x) + bf16_hi(xv[i].x) + bf16_lo(xv[i].y) +
                  bf16_hi(xv[i].y) + bf16_lo(xv[i].z) + bf16_hi(xv[i].z) +
                  bf16_lo(xv[i].w) + bf16_hi(xv[i].w);
        }
      }
      if constexpr (kQ4) xs_t[xr][xp] = gsum;
    }
    __syncthreads();

    // ---- prefetch the next step while the tensor cores work ----
    if (s + 1 < steps) {
      load_codes(s + 1, cur);
      load_x(s + 1, xv);
    }

#pragma unroll
    for (int kk = 0; kk < kKT; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const __nv_bfloat16* base = ws + (wm + i * 16 + gid) * kStride + kk + 2 * tig;
        a[i][0] = *reinterpret_cast<const uint32_t*>(base);
        a[i][1] = *reinterpret_cast<const uint32_t*>(base + 8 * kStride);
        a[i][2] = *reinterpret_cast<const uint32_t*>(base + 8);
        a[i][3] = *reinterpret_cast<const uint32_t*>(base + 8 * kStride + 8);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const __nv_bfloat16* base = xs + (wn + j * 8 + gid) * kStride + kk + 2 * tig;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(base);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(base + 8);
#pragma unroll
        for (int i = 0; i < 2; ++i) mma_bf16(acc[i][j], a[i], b0, b1);
      }
    }
    if constexpr (kQ4) {
      // offset term: corr[m, n] += mn[m, g] * xs[n, g] over the step's groups
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r0 = wm + i * 16 + gid;
        const float ma0 = mn_t[r0][0], ma1 = mn_t[r0][1];
        const float mb0 = mn_t[r0 + 8][0], mb1 = mn_t[r0 + 8][1];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c0 = wn + j * 8 + 2 * tig;
          const float x00 = xs_t[c0][0], x01 = xs_t[c0][1];
          const float x10 = xs_t[c0 + 1][0], x11 = xs_t[c0 + 1][1];
          corr[i][j][0] += ma0 * x00 + ma1 * x01;
          corr[i][j][1] += ma0 * x10 + ma1 * x11;
          corr[i][j][2] += mb0 * x00 + mb1 * x01;
          corr[i][j][3] += mb0 * x10 + mb1 * x11;
        }
      }
    }
    __syncthreads();  // the tiles are rewritten by the next step
  }

  // ---- epilogue: y[n, m] = acc - corr ----
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + wm + i * 16 + gid + (e >> 1) * 8;
        const int col = n0 + wn + j * 8 + 2 * tig + (e & 1);
        if (row < m && col < n) {
          y[(size_t)col * m + row] = acc[i][j][e] - corr[i][j][e];
        }
      }
    }
  }
}

template <bool kQ4>
int launch(const void* x, const void* codes, const void* sc, const void* mn6,
           const void* d, const void* dm8, void* y, int n, int m, int k,
           void* stream) {
  if (k % 256 != 0 || m <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((m + kBM - 1) / kBM, (n + kBN - 1) / kBN);
  qk_gemm_kernel<kQ4><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(codes),
      static_cast<const uint8_t*>(sc), static_cast<const uint8_t*>(mn6),
      static_cast<const float*>(d), static_cast<const float*>(dm8),
      static_cast<float*>(y), n, m, k);
  return (int)cudaGetLastError();
}

}  // namespace

// x bf16 [n, k] (16-byte aligned); codes u8 [m, k/2] (16-byte aligned);
// sc6, mn6 u8 [m, k/32]; d8, dm8 f32 [m, k/256]; y f32 [n, m]. All
// contiguous, k % 256 == 0. Returns the cudaError_t of the launch.
extern "C" int q4k_gemm(const void* x, const void* codes, const void* sc6,
                        const void* mn6, const void* d8, const void* dm8,
                        void* y, int n, int m, int k, void* stream) {
  return launch<true>(x, codes, sc6, mn6, d8, dm8, y, n, m, k, stream);
}

// x bf16 [n, k] (16-byte aligned); codes i8 [m, k] (16-byte aligned); q6s
// i8 [m, k/16]; q6d f32 [m, k/256]; y f32 [n, m]. All contiguous,
// k % 256 == 0. Returns the cudaError_t of the launch.
extern "C" int q6k_gemm(const void* x, const void* codes, const void* q6s,
                        const void* q6d, void* y, int n, int m, int k,
                        void* stream) {
  return launch<false>(x, codes, q6s, nullptr, q6d, nullptr, y, n, m, k, stream);
}
