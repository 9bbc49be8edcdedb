// Grouped-scale dequant gemv for Hopper (sm_90a), shared by qs_gemv.cu,
// qkb_gemv.cu and nf4_gemv.cu: y[n, m] = sum_k x[n, k] * (q[m, k] *
// s[m, g(k)] - mn[m, g(k)])
// for n <= 8 input rows (x rounded to bf16 by the caller), in f32 on the
// exact weight, formed per element as the plain version forms it (the TPU
// kernel's factored form s * sum q x - mn * sum x was measured too: the same
// error against the plain version, PERF.md Findings PR 5; the per-element
// form is the one the whole-stack rows and the GEMM's tiles share). Codes
// and scale sources are those of qscales.cuh.
//
// Bound on this card: bytes. At n <= 8 each weight byte feeds at most 16
// multiply-adds, far below the ~295 operations per byte where H100 stops
// being memory-bound, so the least time is the code and scale bytes over
// HBM bandwidth. Design:
// - A persistent grid: as many blocks of 8 warps as the SMs hold at the
//   shared memory x takes (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
//   or fewer where the rows run out. Each block stages x once, as the bf16
//   it already is (n = 8 at K = 7168: 129 KB), and then walks its rows, so
//   x crosses L2 once per block, not once per few rows (per 8 rows, a
//   [65536, 2048] head at n = 4 would move 134 MB of x beside its 143 MB
//   of weights).
// - Conflict-free x reads: a lane reads the x of one 16-byte code chunk in
//   16-byte units, and a 16-byte pad after every 64 x elements puts the
//   units that eight neighbouring lanes read (consecutive chunks: 32 bytes
//   of x apart for byte codes and nibbles, 64 for codebook indices) in
//   eight distinct bank groups (unpadded, a 32- or 64-byte lane stride is
//   a 2- or 4-way conflict, repeated for each input row).
// - Short rows: a row takes `lanes` lanes (the largest power of two up to
//   32 dividing its chunk count, at least 4), and a warp 32 / lanes rows,
//   so that every lane has whole chunks at K = 768 (48 byte chunks: two
//   rows of 16 lanes; 24 nibble or index chunks: four rows of 8).
// - Weights: one 128-bit load per lane per code chunk (16 bytes: 16 byte
//   codes, 16 low and 16 high nibbles, or 32 codebook indices; a chunk
//   never straddles a group, since groups are 16, 32 or 128 elements (64
//   for codebook indices) and chunks start at multiples of 16 (32)), the
//   next chunk's load issued before this one is decoded, each weight
//   formed once and applied to all n inputs while it sits in registers.
//   Codes become floats exactly through the exponent of 2^23 (a byte
//   permute and a subtraction), not the quarter-rate integer conversion;
//   forms without offsets skip the subtraction of a zero offset.
// What still bounds it at n >= 2 (on an H100, PERF.md, Findings): instruction
// issue, about 225 instructions a 16-byte chunk at n = 4 (the weight
// formed per element, then each input's bf16 converted and multiplied).
// x staged as f32 instead (XOR-swizzled, no pad) measured within 3 % but
// at the [65536, 2048] head at n = 4 (7 % faster): bf16 kept, half the
// shared memory.
// Codebook indices (kLut) read the 16-entry codebook from shared memory,
// rounded to bf16 as the TPU kernel rounds it (its per-group sums of
// bf16(x) * bf16(lut[idx]) are scaled by the absmax after the dot): the
// weight bf16(lut[idx]) * absmax is exact in f32 (8 by 11 significant
// bits), so forming it per element keeps that class. Lanes that read
// different entries hit different banks, and equal entries broadcast.
//
// kSlab: the dequant-GEMM's numerics class (qk_gemm.cu) in this structure,
// for the n <= 8 rows that the gemv/GEMM gate sends to the GEMM: each
// weight bf16(q * s) - mn (codebook indices: bf16(lut[idx] * absmax) with
// the f32 codebook), formed per element. The sum is the slab's,
// sum bf16(x) bf16(q * s) - sum_g mn xs, taken per element so that the
// offset never cancels a large sum of products.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "qscales.cuh"

namespace {

constexpr int kGemvWarps = 8;      // warps per block
constexpr int kGemvSmem = 232448;  // bytes of shared memory a block may use

// v, or v rounded to bf16 (kSlab: the dequant-GEMM's weight rounding)
template <bool kSlab>
__device__ __forceinline__ float slab_round(float v) {
  return kSlab ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// The four bytes of a code word as floats, exactly: u8, or i8 for kI8
// (2^23 + b has b in its low mantissa bits; i8 is biased by 128 first).
template <int kCodes>
__device__ __forceinline__ void bytes4(uint32_t w, float* f) {
  if constexpr (kCodes == kI8) w ^= 0x80808080u;
  const float bias = kCodes == kI8 ? 8388736.f : 8388608.f;
#pragma unroll
  for (int b = 0; b < 4; ++b) f[b] = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540 + b)) - bias;
}

// f32 values of the eight bf16 of a 16-byte unit
__device__ __forceinline__ void bf16x8(uint4 u, float* f) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

// Streaming 128-bit load of weight codes (read once: not kept in L1).
__device__ __forceinline__ uint4 ld_stream(const uint8_t* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// Where element e of a staged x row sits (bf16 elements): 8 elements (16
// bytes) of pad after every 64.
__host__ __device__ constexpr int xpad(int e) { return e + (e >> 6) * 8; }

// Lanes per row: the largest power of two from 4 to 32 dividing the row's
// chunk count (16-byte code chunks), or more (whole warps at most) where
// that leaves fewer warps of rows than 8 a SM: short matrices trade idle
// lanes for SMs.
inline int gemv_lanes(int chunks, int m, int sms) {
  int l = 32;
  while (l > 4 && chunks % l) l >>= 1;
  while (l < 32 && (long long)m * l < 32LL * 8 * sms) l <<= 1;
  return l;
}

template <int kCodes>
__host__ __device__ constexpr int gemv_chunks(int k) {
  return kCodes == kU8 || kCodes == kI8 ? k >> 4 : k >> 5;
}

// acc[t] += the chunk's weights times x row t's elements, for the 16
// elements at x offset xo (x units xo and xo + 8, in one 64-element run).
template <int N>
__device__ __forceinline__ void dot16(const __nv_bfloat16* xs, int kp, int xo, const float* wv,
                                      float* acc) {
#pragma unroll
  for (int t = 0; t < N; ++t) {
    const uint4* p = reinterpret_cast<const uint4*>(xs + t * kp + xo);
    float xf[16];
    bf16x8(p[0], xf);
    bf16x8(p[1], xf + 8);
    float part[4] = {0.f, 0.f, 0.f, 0.f};  // four chains, not one of 16
#pragma unroll
    for (int e = 0; e < 16; ++e) part[e & 3] = fmaf(wv[e], xf[e], part[e & 3]);
    acc[t] += (part[0] + part[1]) + (part[2] + part[3]);
  }
}

template <int N, int kCodes, bool kSlab, class S>
__global__ void __launch_bounds__(kGemvWarps * 32)
qgemv_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ codes,
             const S scales, float* __restrict__ y, int m, int k, int gs, int lanes) {
  extern __shared__ uint4 xs4[];  // [N, xpad(k)] bf16
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(xs4);
  const int kp = xpad(k);  // a multiple of 8: rows stay 16-byte aligned
  const int units = k >> 3;
  for (int i = threadIdx.x; i < N * units; i += blockDim.x) {
    const int t = i / units, u = i - t * units;
    const uint4 v = reinterpret_cast<const uint4*>(x + (size_t)t * k)[u];
    *reinterpret_cast<uint4*>(xs + t * kp + xpad(u << 3)) = v;
  }
  __shared__ float lut_s[16];
  if constexpr (kCodes == kLut) {
    if (threadIdx.x < 16)
      lut_s[threadIdx.x] = slab_round<!kSlab>(scales.lut[threadIdx.x]);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int chunks = gemv_chunks<kCodes>(k);
  const int rows_w = 32 / lanes;  // rows per warp; `lanes` a row (gemv_lanes)
  const int sub = lane & (lanes - 1);
  const int half = k >> 1;
  const size_t row_bytes = kCodes == kU8 || kCodes == kI8 ? (size_t)k : (size_t)half;
  const int step = gridDim.x * kGemvWarps;

  for (int g = blockIdx.x * kGemvWarps + warp; g * rows_w < m; g += step) {
    const int row = g * rows_w + lane / lanes;
    float acc[N];
#pragma unroll
    for (int t = 0; t < N; ++t) acc[t] = 0.f;
    if (row < m) {
      const uint8_t* crow = codes + (size_t)row * row_bytes;
      uint4 raw = make_uint4(0, 0, 0, 0);
      if (sub < chunks) raw = ld_stream(crow + (sub << 4));
      for (int c = sub; c < chunks; c += lanes) {
        const uint4 cur = raw;
        if (c + lanes < chunks) raw = ld_stream(crow + ((c + lanes) << 4));
        const uint32_t words[4] = {cur.x, cur.y, cur.z, cur.w};
        if constexpr (kCodes == kNib) {
          const int j0 = c << 4;  // elements j0.. (low nibbles) and j0 + K/2.. (high)
          float slo, mlo, shi, mhi;
          scales.get(row, j0 / gs, slo, mlo);
          scales.get(row, (j0 + half) / gs, shi, mhi);
          float wlo[16], whi[16];  // the weights of the 16 low and 16 high elements
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            bytes4<kU8>(words[q] & 0x0F0F0F0Fu, wlo + 4 * q);
            bytes4<kU8>((words[q] >> 4) & 0x0F0F0F0Fu, whi + 4 * q);
          }
#pragma unroll
          for (int e = 0; e < 16; ++e) {
            wlo[e] = slab_round<kSlab>(wlo[e] * slo);
            whi[e] = slab_round<kSlab>(whi[e] * shi);
          }
          if (scales.has_min()) {  // the same for every row: no divergence
#pragma unroll
            for (int e = 0; e < 16; ++e) {
              wlo[e] -= mlo;
              whi[e] -= mhi;
            }
          }
          dot16<N>(xs, kp, xpad(j0), wlo, acc);
          dot16<N>(xs, kp, xpad(half + j0), whi, acc);
        } else if constexpr (kCodes == kLut) {
          const int e0 = c << 5;  // elements e0 .. e0 + 31, one group
          float s, off;
          scales.get(row, e0 / gs, s, off);
          float wv[32];  // the weights of the chunk, in element order
#pragma unroll
          for (int q = 0; q < 4; ++q) {
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              const uint32_t byte = (words[q] >> (8 * b)) & 0xFFu;
              wv[8 * q + 2 * b] = slab_round<kSlab>(lut_s[byte & 0xFu] * s);
              wv[8 * q + 2 * b + 1] = slab_round<kSlab>(lut_s[byte >> 4] * s);
            }
          }
          dot16<N>(xs, kp, xpad(e0), wv, acc);
          dot16<N>(xs, kp, xpad(e0) + 16, wv + 16, acc);
        } else {
          const int j0 = c << 4;  // elements j0 .. j0 + 15, one group
          float s, off;
          scales.get(row, j0 / gs, s, off);
          float wv[16];
#pragma unroll
          for (int q = 0; q < 4; ++q) bytes4<kCodes>(words[q], wv + 4 * q);
#pragma unroll
          for (int e = 0; e < 16; ++e) wv[e] = slab_round<kSlab>(wv[e] * s);
          if (scales.has_min()) {  // the same for every row: no divergence
#pragma unroll
            for (int e = 0; e < 16; ++e) wv[e] -= off;
          }
          dot16<N>(xs, kp, xpad(j0), wv, acc);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < N; ++t) {
      float v = acc[t];
      for (int off = lanes >> 1; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (row < m && sub == 0) y[(size_t)t * m + row] = v;
    }
  }
}

template <int N, int kCodes, bool kSlab, class S>
cudaError_t qgemv_launch(const void* x, const void* codes, const S& scales, void* y, int m,
                         int k, int gs, cudaStream_t stream) {
  const size_t smem = (size_t)N * xpad(k) * sizeof(__nv_bfloat16);
  // beside it the codebook's 64 static bytes (kLut): the default limit of
  // 48 KB holds dynamic and static together
  if (smem + 64 > (size_t)kGemvSmem) return cudaErrorInvalidValue;
  auto kernel = qgemv_kernel<N, kCodes, kSlab, S>;
  // blocks per SM by shared memory size, found once per size (a few sizes
  // per model: one per K)
  static size_t seen_smem[8];
  static int seen_blocks[8];
  static int n_seen = 0;
  int per_sm = 0;
  for (int i = 0; i < n_seen; ++i)
    if (seen_smem[i] == smem) per_sm = seen_blocks[i];
  if (per_sm == 0) {
    // the limit once for every size (the codebook's 64 static bytes beside it)
    cudaError_t err = n_seen > 0 ? cudaSuccess
                                 : cudaFuncSetAttribute(kernel,
                                                        cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                        kGemvSmem - 64);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kGemvWarps * 32, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    if (n_seen < 8) {
      seen_smem[n_seen] = smem;
      seen_blocks[n_seen++] = per_sm;
    }
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int lanes = gemv_lanes(gemv_chunks<kCodes>(k), m, sms);
  const int rows_w = 32 / lanes;
  const int groups = (m + rows_w - 1) / rows_w;  // one warp's rows each
  const int need = (groups + kGemvWarps - 1) / kGemvWarps;
  const int blocks = need < per_sm * sms ? need : per_sm * sms;
  kernel<<<blocks, kGemvWarps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(codes), scales,
      static_cast<float*>(y), m, k, gs, lanes);
  return cudaGetLastError();
}

// n = 1..8 to the kernel instantiated for it.
template <int kCodes, bool kSlab = false, class S>
int qgemv_dispatch(const void* x, const void* codes, const S& scales, void* y, int n, int m,
                   int k, int gs, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 1: return (int)qgemv_launch<1, kCodes, kSlab>(x, codes, scales, y, m, k, gs, s);
    case 2: return (int)qgemv_launch<2, kCodes, kSlab>(x, codes, scales, y, m, k, gs, s);
    case 3: return (int)qgemv_launch<3, kCodes, kSlab>(x, codes, scales, y, m, k, gs, s);
    case 4: return (int)qgemv_launch<4, kCodes, kSlab>(x, codes, scales, y, m, k, gs, s);
    case 5: return (int)qgemv_launch<5, kCodes, kSlab>(x, codes, scales, y, m, k, gs, s);
    case 6: return (int)qgemv_launch<6, kCodes, kSlab>(x, codes, scales, y, m, k, gs, s);
    case 7: return (int)qgemv_launch<7, kCodes, kSlab>(x, codes, scales, y, m, k, gs, s);
    case 8: return (int)qgemv_launch<8, kCodes, kSlab>(x, codes, scales, y, m, k, gs, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
