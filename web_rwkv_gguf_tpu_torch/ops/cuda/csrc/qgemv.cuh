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
// HBM bandwidth. Design, as q4k_gemv.cu: one warp per output row streams
// the row's codes 16 bytes per lane (one 128-bit load each; a 16-byte chunk
// never straddles a group, since groups are 16, 32 or 128 elements (64 for
// the 32 elements of a chunk of codebook indices) and chunks start at
// multiples of 16 (32)), applies all n inputs to each decoded chunk
// while it sits in registers (each weight formed once, whatever n is); x is
// staged once per block in shared memory as f32. Speed work (several rows
// per warp, a packed 5-bit plane for Q5_K's byte codes) is later work.
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

constexpr int kGemvWarps = 8;      // output rows per block, one warp each
constexpr int kGemvSmem = 232448;  // bytes of shared memory a block may use

// v, or v rounded to bf16 (kSlab: the dequant-GEMM's weight rounding)
template <bool kSlab>
__device__ __forceinline__ float slab_round(float v) {
  return kSlab ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

template <int N, int kCodes, bool kSlab, class S>
__global__ void __launch_bounds__(kGemvWarps * 32)
qgemv_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ codes,
             const S scales, float* __restrict__ y, int m, int k, int gs) {
  extern __shared__ float4 xs4[];  // [N, k] f32, 16-byte aligned
  float* xs = reinterpret_cast<float*>(xs4);
  for (int i = threadIdx.x; i < N * k; i += blockDim.x) xs[i] = __bfloat162float(x[i]);
  __shared__ float lut_s[16];
  if constexpr (kCodes == kLut) {
    if (threadIdx.x < 16)
      lut_s[threadIdx.x] = slab_round<!kSlab>(scales.lut[threadIdx.x]);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kGemvWarps + warp;
  if (row >= m) return;

  float acc[N];
#pragma unroll
  for (int t = 0; t < N; ++t) acc[t] = 0.f;

  if constexpr (kCodes == kNib) {
    const int half = k >> 1;  // code bytes per row
    const uint8_t* crow = codes + (size_t)row * half;
    for (int c = lane; c < (half >> 4); c += 32) {
      const int j0 = c << 4;  // elements j0.. (low nibbles) and j0 + K/2.. (high)
      const uint4 raw = *reinterpret_cast<const uint4*>(crow + j0);
      float slo, mlo, shi, mhi;
      scales.get(row, j0 / gs, slo, mlo);
      scales.get(row, (j0 + half) / gs, shi, mhi);
      const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
      float wlo[16], whi[16];  // the weights q * s - mn of the 16 low and 16 high elements
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const uint32_t byte = (words[q] >> (8 * b)) & 0xFFu;
          wlo[4 * q + b] = slab_round<kSlab>((float)(byte & 0xFu) * slo) - mlo;
          whi[4 * q + b] = slab_round<kSlab>((float)(byte >> 4) * shi) - mhi;
        }
      }
#pragma unroll
      for (int t = 0; t < N; ++t) {
        float sum = 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 xl = xs4[((t * k + j0) >> 2) + q];
          const float4 xh = xs4[((t * k + half + j0) >> 2) + q];
          sum += wlo[4 * q] * xl.x + wlo[4 * q + 1] * xl.y + wlo[4 * q + 2] * xl.z +
                 wlo[4 * q + 3] * xl.w + whi[4 * q] * xh.x + whi[4 * q + 1] * xh.y +
                 whi[4 * q + 2] * xh.z + whi[4 * q + 3] * xh.w;
        }
        acc[t] += sum;
      }
    }
  } else if constexpr (kCodes == kLut) {
    const int half = k >> 1;  // code bytes per row
    const uint8_t* crow = codes + (size_t)row * half;
    for (int c = lane; c < (half >> 4); c += 32) {
      const int e0 = c << 5;  // elements e0 .. e0 + 31, one group
      const uint4 raw = *reinterpret_cast<const uint4*>(crow + (c << 4));
      float s, off;
      scales.get(row, e0 / gs, s, off);
      const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
      float wv[32];  // the weights bf16(lut[idx]) * absmax of the chunk
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const uint32_t byte = (words[q] >> (8 * b)) & 0xFFu;
          wv[8 * q + 2 * b] = slab_round<kSlab>(lut_s[byte & 0xFu] * s);
          wv[8 * q + 2 * b + 1] = slab_round<kSlab>(lut_s[byte >> 4] * s);
        }
      }
#pragma unroll
      for (int t = 0; t < N; ++t) {
        float sum = 0.f;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const float4 xv = xs4[((t * k + e0) >> 2) + q];
          sum += wv[4 * q] * xv.x + wv[4 * q + 1] * xv.y + wv[4 * q + 2] * xv.z +
                 wv[4 * q + 3] * xv.w;
        }
        acc[t] += sum;
      }
    }
  } else {
    const uint8_t* crow = codes + (size_t)row * k;
    for (int c = lane; c < (k >> 4); c += 32) {
      const int j0 = c << 4;  // elements j0 .. j0 + 15, one group
      const uint4 raw = *reinterpret_cast<const uint4*>(crow + j0);
      float s, off;
      scales.get(row, j0 / gs, s, off);
      const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
      float wv[16];  // the weights q * s - mn of the chunk
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int b = 0; b < 4; ++b)
          wv[4 * q + b] = slab_round<kSlab>(code_at<kCodes>(words[q], b) * s) - off;
      }
#pragma unroll
      for (int t = 0; t < N; ++t) {
        float sum = 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 xv = xs4[((t * k + j0) >> 2) + q];
          sum += wv[4 * q] * xv.x + wv[4 * q + 1] * xv.y + wv[4 * q + 2] * xv.z +
                 wv[4 * q + 3] * xv.w;
        }
        acc[t] += sum;
      }
    }
  }

#pragma unroll
  for (int t = 0; t < N; ++t) {
    float v = acc[t];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) y[(size_t)t * m + row] = v;
  }
}

template <int N, int kCodes, bool kSlab, class S>
cudaError_t qgemv_launch(const void* x, const void* codes, const S& scales, void* y, int m,
                         int k, int gs, cudaStream_t stream) {
  const size_t smem = (size_t)N * k * sizeof(float);
  // beside it the codebook's 64 static bytes (kLut): the default limit of
  // 48 KB holds dynamic and static together
  if (smem + 64 > (size_t)kGemvSmem) return cudaErrorInvalidValue;
  if (smem + 64 > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        qgemv_kernel<N, kCodes, kSlab, S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int blocks = (m + kGemvWarps - 1) / kGemvWarps;
  qgemv_kernel<N, kCodes, kSlab, S><<<blocks, kGemvWarps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(codes), scales,
      static_cast<float*>(y), m, k, gs);
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
