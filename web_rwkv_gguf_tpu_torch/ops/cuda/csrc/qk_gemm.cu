// K-quant dequant-GEMM for Hopper (sm_90a): y[n, m] = sum_k x[n, k] * W[m, k]
// at any row count n, W held as any of the port's logical quantized forms. On
// the main path it runs every quantized matmul of a prefill chunk (n = B*T)
// and the decode matmuls whose n * groups exceeds the gemv's gate.
//
// Replaces: web_rwkv_gguf_tpu/ops/pallas/matmul.py::quant_matmul, slab
// branch (def at line 1225, pallas_call at line 1416; kernel body _kernel
// at line 86).
//
// What it computes (the slab kernel's numerics class, not the gemv's):
//   y = sum_k bf16(x) * bf16(q * s)  -  sum_g mn[m, g] * xs[n, g]
// q the code: split-halves nibbles (low nibble of byte j is element j,
// high nibble element j + K/2; Q4_K, Q4_0, Q4_1), u8 bytes (Q5_K, Q2_K,
// Q5_0, Q5_1, Q4_1 bytes, the engine's Int8) or i8 bytes (Q6_K, Q3_K,
// Q8_0, Q4_0 bytes), or the codebook value of a 4-bit index in pair order
// (the engine's NF4 / SF4: low nibble of byte j is element 2j, high nibble
// 2j + 1; q * s = lut[idx] * absmax in f32, then rounded); s and mn the
// group scale and offset of the element's group (16, 32 or 128 elements;
// 64 for codebook indices): f32 arrays, or 8-bit codes times per-256
// super-scales formed in f32 here (Q4_K / Q5_K / Q2_K: s = d8 * sc6, mn =
// dm8 * mn6; Q6_K / Q3_K: s = q6d * q6s, no offset); xs[n, g] the f32 sum
// of bf16(x) over group g.
// Products are bf16 x bf16 on the tensor cores (mma.sync.m16n8k16, f32
// accumulation); the offset term is kept in its own f32 accumulators and
// subtracted in the epilogue, as the TPU kernel adds it after its dot.
// Each mma starts from zero and its four sums are added to the running
// accumulators by ordinary f32 adds (round to nearest): the tensor core
// aligns and truncates its addends to the largest one, so chained through
// a whole row (K/16 steps) it would pull a sum of same-signed products
// (relu^2 inputs into the FFN value) toward zero by about half an ulp of
// the running sum at each step; where the offset term then cancels most
// of that sum, the drift is many ulps of y.
//
// Bound on this card: bytes at small n (decode: the weight is read once
// for a handful of rows), operations at prefill n (B*T = 512 rows do
// 512 multiply-adds per weight, above the ~295 operations per byte where
// H100 stops being memory-bound). At n <= 8 (the decode rows past the
// gemv's gate) where the tensor-core grid of M/64 blocks would leave SMs
// idle (every layer matrix; not a vocabulary head), the same function runs
// on the CUDA cores in qgemv.cuh's structure (kSlab): one warp per weight
// row, each weight bf16(q * s) - mn formed per element and summed in f32.
// There the tensor cores, even with a fresh sum per mma, left the products'
// sum of relu^2 inputs (16-27x max|y| before the offset term cancels it)
// 3-7x further from its f64 value than an f32 GEMM of the same bf16
// operands (on an H100: 3.9e-5 against 7.6e-6 of max|y|, Int8 at [2048,
// 7168], n = 3), and used 12-32 of the 132 SMs; the per-element form sits
// within 1.2e-7.
// Otherwise it is the tensor-core kernel below, simple, not
// fast: one block of 4 warps per 64 weight rows x 64 input rows, looping
// over K 64 elements at a time (nibbles: 32 code bytes per row, 32 low and
// 32 high elements; bytes: 64 code bytes, the last step of a row whose K is
// an odd multiple of 32 half empty). Each step dequantizes the weight tile
// to bf16 in shared memory and stages the x tile beside it (zero-padded
// past M, n and K, x never read past its end) with its sums over each 16
// elements, the next step's codes and x are loaded into registers while
// the tensor cores work, and each warp computes a 32 x 32 output tile.
// wgmma, TMA and a ring of stages are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "qgemv.cuh"
#include "qscales.cuh"

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

__device__ __forceinline__ float sum8(uint4 v) {
  return bf16_lo(v.x) + bf16_hi(v.x) + bf16_lo(v.y) + bf16_hi(v.y) + bf16_lo(v.z) +
         bf16_hi(v.z) + bf16_lo(v.w) + bf16_hi(v.w);
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Nibbles: thread t dequantizes 16 code bytes of weight row t/2 (bytes
// (t%2)*16.. of the step's 32), giving 16 low and 16 high elements. Bytes:
// 32 code bytes of row t/2 (bytes (t%2)*32.. of the step's 64). Codebook
// indices: 16 code bytes of row t/2 (bytes (t%2)*16.. of the step's 32),
// the elements (t%2)*32.. of the step's 64, in order.
template <int kCodes>
struct Codes {
  uint4 v[kCodes == kU8 || kCodes == kI8 ? 2 : 1];
};

// A step's 64 elements of a row fall in four 16-element slots: for nibbles
// slots 0, 1 are the low elements (32 s ..), slots 2, 3 the high ones
// (K/2 + 32 s ..); for bytes slot j is elements 64 s + 16 j ... The
// offset term sums, per slot, the slot's group offset times its x sum.
template <int kCodes, class S>
__global__ void __launch_bounds__(kThreads)
qk_gemm_kernel(const __nv_bfloat16* __restrict__ x,
               const uint8_t* __restrict__ codes, const S scales,
               float* __restrict__ y, int n, int m, int k, int gs) {
  constexpr bool kNibble = kCodes == kNib;
  constexpr bool kBytes = kCodes == kU8 || kCodes == kI8;
  __shared__ __align__(16) __nv_bfloat16 ws[kBM * kStride];
  __shared__ __align__(16) __nv_bfloat16 xs[kBN * kStride];
  __shared__ float mn_t[kBM][4];  // group offsets of this step's slots
  __shared__ float xs_t[kBN][4];  // sums of bf16 x over this step's slots
  __shared__ float lut_s[16];     // codebook indices: the f32 codebook
  if constexpr (kCodes == kLut) {
    if (threadIdx.x < 16) lut_s[threadIdx.x] = scales.lut[threadIdx.x];
    __syncthreads();
  }

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int half = k >> 1;
  const int steps = kNibble ? half / 32 : (k + kKT - 1) / kKT;
  const bool offsets = scales.has_min();

  // loader roles: weight row wr, part wp; x row xr, segment xp
  const int wr = tid >> 1, wp = tid & 1;
  const int xr = tid >> 1, xp = tid & 1;
  const bool w_ok = m0 + wr < m;
  const bool x_ok = n0 + xr < n;
  const size_t row_bytes = kBytes ? (size_t)k : (size_t)half;
  const uint8_t* crow = codes + (size_t)(w_ok ? m0 + wr : 0) * row_bytes;
  const __nv_bfloat16* xrow = x + (size_t)(x_ok ? n0 + xr : 0) * k;

  // the first element of the 32 this thread loads (nibbles: of the low half)
  auto col0 = [&](int s, int part) { return kNibble ? s * 32 + part * 16 : s * kKT + part * 32; };
  auto load_codes = [&](int s, Codes<kCodes>& c) {
    const int e = col0(s, wp);
    const bool ok = w_ok && (!kBytes || e < k);
    const uint4* src = reinterpret_cast<const uint4*>(crow + (kCodes == kLut ? e / 2 : e));
#pragma unroll
    for (int i = 0; i < (kBytes ? 2 : 1); ++i) c.v[i] = ok ? src[i] : make_uint4(0, 0, 0, 0);
  };
  // x segment of this thread: 32 bf16 (64 bytes) of input row xr
  auto x_col = [&](int s) {
    return kNibble ? (xp == 0 ? s * 32 : half + s * 32) : s * kKT + xp * 32;
  };
  auto load_x = [&](int s, uint4* xv) {
    const int c = x_col(s);
    const bool ok = x_ok && c < k;
    const uint4* p = reinterpret_cast<const uint4*>(xrow + c);
#pragma unroll
    for (int i = 0; i < 4; ++i) xv[i] = ok ? p[i] : make_uint4(0, 0, 0, 0);
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

  Codes<kCodes> cur;
  uint4 xv[4];
  load_codes(0, cur);
  load_x(0, xv);

  for (int s = 0; s < steps; ++s) {
    // ---- dequantize the weight tile into shared memory ----
    const size_t r = (size_t)(w_ok ? m0 + wr : 0);
    if constexpr (kNibble) {
      const int e = col0(s, wp);  // low elements e.., high elements K/2 + e..
      float slo = 0.f, shi = 0.f, mlo = 0.f, mhi = 0.f;
      if (w_ok) {
        scales.get(r, e / gs, slo, mlo);
        scales.get(r, (half + e) / gs, shi, mhi);
      }
      mn_t[wr][wp] = mlo;
      mn_t[wr][2 + wp] = mhi;
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
    } else if constexpr (kCodes == kLut) {
      const int e = col0(s, wp);  // elements e .. e + 31, one 64-group
      float sc = 0.f, off = 0.f;
      if (w_ok) scales.get(r, e / gs, sc, off);
      const uint32_t words[4] = {cur.v[0].x, cur.v[0].y, cur.v[0].z, cur.v[0].w};
      uint32_t out[16];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const uint32_t byte = (words[q] >> (8 * b)) & 0xFFu;
          out[4 * q + b] = pack_bf16(lut_s[byte & 0xFu] * sc, lut_s[byte >> 4] * sc);
        }
      }
      uint4* dst = reinterpret_cast<uint4*>(ws + wr * kStride + wp * 32);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        dst[i] = make_uint4(out[4 * i], out[4 * i + 1], out[4 * i + 2], out[4 * i + 3]);
      }
    } else {
      const int e = col0(s, wp);  // elements e .. e + 31: slots 2 wp, 2 wp + 1
      float s0 = 0.f, s1 = 0.f, o0 = 0.f, o1 = 0.f;
      if (w_ok && e < k) {
        scales.get(r, e / gs, s0, o0);
        scales.get(r, (e + 16) / gs, s1, o1);
      }
      mn_t[wr][2 * wp] = o0;
      mn_t[wr][2 * wp + 1] = o1;
      const uint32_t words[8] = {cur.v[0].x, cur.v[0].y, cur.v[0].z, cur.v[0].w,
                                 cur.v[1].x, cur.v[1].y, cur.v[1].z, cur.v[1].w};
      uint32_t out[16];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const uint32_t wv = words[q];
        const float sq = q < 4 ? s0 : s1;
        out[2 * q] = pack_bf16(code_at<kCodes>(wv, 0) * sq, code_at<kCodes>(wv, 1) * sq);
        out[2 * q + 1] = pack_bf16(code_at<kCodes>(wv, 2) * sq, code_at<kCodes>(wv, 3) * sq);
      }
      uint4* dst = reinterpret_cast<uint4*>(ws + wr * kStride + wp * 32);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        dst[i] = make_uint4(out[4 * i], out[4 * i + 1], out[4 * i + 2], out[4 * i + 3]);
      }
    }
    // ---- stage the x tile and its sums over each 16 elements ----
    {
      uint4* dst = reinterpret_cast<uint4*>(xs + xr * kStride + xp * 32);
#pragma unroll
      for (int i = 0; i < 4; ++i) dst[i] = xv[i];
      xs_t[xr][2 * xp] = sum8(xv[0]) + sum8(xv[1]);
      xs_t[xr][2 * xp + 1] = sum8(xv[2]) + sum8(xv[3]);
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
        for (int i = 0; i < 2; ++i) {
          float t[4] = {0.f, 0.f, 0.f, 0.f};  // a fresh sum: see the note at the top
          mma_bf16(t, a[i], b0, b1);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += t[e];
        }
      }
    }
    if (offsets) {
      // offset term: corr[m, n] += mn[m, g] * xs[n, g] over the step's groups
      // (a 32-group is two slots with one offset, a 128-group all four
      // slots of a byte step: their x sums add first)
      const bool pairs = gs == 32, whole = gs == 128;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r0 = wm + i * 16 + gid + 8 * h;
          const float* mr = mn_t[r0];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const float* xc = xs_t[wn + j * 8 + 2 * tig + c];
              corr[i][j][2 * h + c] +=
                  whole ? mr[0] * ((xc[0] + xc[1]) + (xc[2] + xc[3]))
                  : pairs ? mr[0] * (xc[0] + xc[1]) + mr[2] * (xc[2] + xc[3])
                          : mr[0] * xc[0] + mr[1] * xc[1] + mr[2] * xc[2] + mr[3] * xc[3];
            }
          }
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

template <int kCodes, class S>
int launch(const void* x, const void* codes, const S& scales, void* y, int n, int m, int k,
           int gs, void* stream) {
  const bool gs_ok = kCodes == kNib   ? gs == 32 && k % 64 == 0
                    : kCodes == kLut ? gs == 64 && k % 64 == 0
                                     : gs == 16 || gs == 32 || gs == 128;
  if (m <= 0 || n <= 0 || k % 32 || k % gs || !gs_ok) return (int)cudaErrorInvalidValue;
  if (n <= 8 && (size_t)n * k * sizeof(float) + 64 <= (size_t)kGemvSmem) {
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if ((m + kBM - 1) / kBM < sms)
      return qgemv_dispatch<kCodes, true>(x, codes, scales, y, n, m, k, gs, stream);
  }
  const dim3 grid((m + kBM - 1) / kBM, (n + kBN - 1) / kBN);
  qk_gemm_kernel<kCodes, S><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(codes), scales,
      static_cast<float*>(y), n, m, k, gs);
  return (int)cudaGetLastError();
}

}  // namespace

// Every entry: x bf16 [n, k] (16-byte aligned); codes 16-byte aligned; y
// f32 [n, m]; all contiguous. Returns the cudaError_t of the launch.

// codes u8 [m, k/2] split halves; sc6, mn6 u8 [m, k/32]; d8, dm8 f32
// [m, k/256]; k % 256 == 0.
extern "C" int q4k_gemm(const void* x, const void* codes, const void* sc6,
                        const void* mn6, const void* d8, const void* dm8,
                        void* y, int n, int m, int k, void* stream) {
  if (k % 256) return (int)cudaErrorInvalidValue;
  const NativeScales s{static_cast<const uint8_t*>(sc6), static_cast<const uint8_t*>(mn6),
                       static_cast<const float*>(d8), static_cast<const float*>(dm8), k / 32, 8};
  return launch<kNib>(x, codes, s, y, n, m, k, 32, stream);
}

// codes i8 [m, k]; q6s i8 [m, k/16]; q6d f32 [m, k/256]; k % 256 == 0.
extern "C" int q6k_gemm(const void* x, const void* codes, const void* q6s,
                        const void* q6d, void* y, int n, int m, int k,
                        void* stream) {
  if (k % 256) return (int)cudaErrorInvalidValue;
  const NominScales s{static_cast<const int8_t*>(q6s), static_cast<const float*>(q6d), k / 16, 16};
  return launch<kI8>(x, codes, s, y, n, m, k, 16, stream);
}

// Q5_K / Q2_K: codes u8 [m, k]; sc6, mn6 u8 [m, k/gs]; d8, dm8 f32
// [m, k/256]; k % 256 == 0; gs 32 (Q5_K) or 16 (Q2_K).
extern "C" int qkb_gemm(const void* x, const void* codes, const void* sc6,
                        const void* mn6, const void* d8, const void* dm8,
                        void* y, int n, int m, int k, int gs, void* stream) {
  if (k % 256 || (gs != 16 && gs != 32)) return (int)cudaErrorInvalidValue;
  const NativeScales s{static_cast<const uint8_t*>(sc6), static_cast<const uint8_t*>(mn6),
                       static_cast<const float*>(d8), static_cast<const float*>(dm8), k / gs,
                       256 / gs};
  return launch<kU8>(x, codes, s, y, n, m, k, gs, stream);
}

// f32 group scales: codes [m, k/2] u8 split-halves nibbles (code_kind 0) or
// [m, k] u8 (1) / i8 (2) bytes; scales f32 [m, k/gs]; mins f32 [m, k/gs] or
// null; gs 16, 32 or 128 (32 for nibbles); k % 32 == 0, k % gs == 0 (k % 64
// == 0 for nibbles). The engine's Int8: u8 codes, gs 128, mins = -mn.
extern "C" int qs_gemm(const void* x, const void* codes, const void* scales,
                       const void* mins, void* y, int n, int m, int k, int gs,
                       int code_kind, void* stream) {
  if (gs != 16 && gs != 32 && gs != 128) return (int)cudaErrorInvalidValue;
  const F32Scales s{static_cast<const float*>(scales), static_cast<const float*>(mins), k / gs};
  switch (code_kind) {
    case kNib: return launch<kNib>(x, codes, s, y, n, m, k, gs, stream);
    case kU8: return launch<kU8>(x, codes, s, y, n, m, k, gs, stream);
    case kI8: return launch<kI8>(x, codes, s, y, n, m, k, gs, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// NF4 / SF4: codes u8 [m, k/2] codebook indices in pair order; absmax f32
// [m, k/64]; lut f32 [16]; k % 64 == 0.
extern "C" int nf4_gemm(const void* x, const void* codes, const void* absmax,
                        const void* lut, void* y, int n, int m, int k, void* stream) {
  if (k % 64) return (int)cudaErrorInvalidValue;
  const LutScales s{static_cast<const float*>(absmax), static_cast<const float*>(lut), k / 64};
  return launch<kLut>(x, codes, s, y, n, m, k, 64, stream);
}
