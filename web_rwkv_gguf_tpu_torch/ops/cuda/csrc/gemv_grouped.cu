// Grouped dequant gemv for Hopper (sm_90a): the r, k and v projections of an
// RWKV-7 decode step at batch 1 in one launch. For each of three same-shape
// quantized matrices W_i [m, k], y[i, n, :] = xs[i, n, :] . W_i^T for n <= 8
// input rows of its own, each W_i held as its own code tensor with f32 group
// scale products s and signed offsets mn [3, m, k / gs] formed once at unroll
// time (models/loader.py, group_gemv_matrices): w = q * s - mn per group.
//
// Replaces: web_rwkv_gguf_tpu/ops/pallas/matmul.py::quant_gemv_grouped (def
// at line 1154, pallas_call at line 1192; kernel body _gemv_grouped_kernel at
// line 1078). The TPU kernel reads one row-concatenated copy of the three
// code tensors and position-interleaved scale rows; here each matrix's codes
// are read where the model keeps them (no copy), and the scales are plain
// [m, G] rows per matrix.
//
// Numerics, as the TPU kernel computes them: x rounded to bf16 (by the
// caller), codes exact, per group the f32 sum of q * x times the f32 scale
// product s, minus the offset times the group's f32 sum of x (the factored
// form s * sum q x - mn * sum x; the int8 kind's added offset comes as mn =
// -min, exact). The sums run per 16-code chunk (a chunk never straddles a
// group: groups are 16, 32 or 128 elements), so the group sums are taken in
// another order than the plain version's: f32 rounding only.
//
// Bound on this card: bytes. At n <= 8 each code byte feeds at most 16
// multiply-adds, far below the ~295 operations per byte where the H100 stops
// being memory-bound, so the least time is the three matrices' code and
// scale bytes over HBM bandwidth. Design, as qgemv.cuh: one warp per output
// row streams the row's codes 16 bytes per lane (one 128-bit load), applies
// all n inputs to each decoded chunk while it sits in registers, and x is
// staged once per block in shared memory as f32; a second grid axis picks
// the matrix, its input rows and its output rows, so the three matrices'
// 3 * m / 8 blocks fill the card together (one launch where three would each
// leave most SMs idle at m = 768). Speed work (several rows per warp, native
// scale factors instead of f32 products) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "qscales.cuh"

namespace {

constexpr int kMats = 3;                   // matrices one launch serves
constexpr int kGroupedWarps = 8;           // output rows per block, one warp each
constexpr int kGroupedSmem = 232448;       // bytes of shared memory a block may use

struct Grouped {
  const uint8_t* codes[kMats];  // each [m, k/2] split-halves nibbles or [m, k] bytes
  const float* scales;          // [kMats, m, G]
  const float* offsets;         // [kMats, m, G] or null
};

// sum_e w[e] * x[e] and sum_e x[e] over a 16-element chunk of row t of the
// staged x, starting at element j0 (a multiple of 4)
__device__ __forceinline__ void chunk_dot(const float* q, const float4* xs4, int at4, float& p,
                                          float& sx) {
  p = 0.f;
  sx = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 xv = xs4[at4 + i];
    p += q[4 * i] * xv.x + q[4 * i + 1] * xv.y + q[4 * i + 2] * xv.z + q[4 * i + 3] * xv.w;
    sx += (xv.x + xv.y) + (xv.z + xv.w);
  }
}

template <int N, int kCodes>
__global__ void __launch_bounds__(kGroupedWarps * 32)
gemv_grouped_kernel(const __nv_bfloat16* __restrict__ x, const Grouped g,
                    float* __restrict__ y, int m, int k, int gs) {
  extern __shared__ float4 xs4[];  // this matrix's [N, k] input rows in f32
  float* xs = reinterpret_cast<float*>(xs4);
  const int mat = blockIdx.y;
  const __nv_bfloat16* xm = x + (size_t)mat * N * k;
  for (int i = threadIdx.x; i < N * k; i += blockDim.x) xs[i] = __bfloat162float(xm[i]);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kGroupedWarps + warp;
  if (row >= m) return;

  const int G = k / gs;
  const F32Scales sc{g.scales + (size_t)mat * m * G,
                     g.offsets != nullptr ? g.offsets + (size_t)mat * m * G : nullptr, G};
  float acc[N];
#pragma unroll
  for (int t = 0; t < N; ++t) acc[t] = 0.f;

  if constexpr (kCodes == kNib) {
    const int half = k >> 1;  // code bytes per row
    const uint8_t* crow = g.codes[mat] + (size_t)row * half;
    for (int c = lane; c < (half >> 4); c += 32) {
      const int j0 = c << 4;  // elements j0.. (low nibbles) and j0 + K/2.. (high)
      const uint4 raw = *reinterpret_cast<const uint4*>(crow + j0);
      float slo, mlo, shi, mhi;
      sc.get(row, j0 / gs, slo, mlo);
      sc.get(row, (j0 + half) / gs, shi, mhi);
      const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
      float qlo[16], qhi[16];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const uint32_t byte = (words[q] >> (8 * b)) & 0xFFu;
          qlo[4 * q + b] = (float)(byte & 0xFu);
          qhi[4 * q + b] = (float)(byte >> 4);
        }
      }
#pragma unroll
      for (int t = 0; t < N; ++t) {
        float plo, xlo, phi, xhi;
        chunk_dot(qlo, xs4, (t * k + j0) >> 2, plo, xlo);
        chunk_dot(qhi, xs4, (t * k + half + j0) >> 2, phi, xhi);
        acc[t] += (plo * slo - mlo * xlo) + (phi * shi - mhi * xhi);
      }
    }
  } else {
    const uint8_t* crow = g.codes[mat] + (size_t)row * k;
    for (int c = lane; c < (k >> 4); c += 32) {
      const int j0 = c << 4;  // elements j0 .. j0 + 15, within one group
      const uint4 raw = *reinterpret_cast<const uint4*>(crow + j0);
      float s, off;
      sc.get(row, j0 / gs, s, off);
      const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
      float qv[16];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int b = 0; b < 4; ++b) qv[4 * q + b] = code_at<kCodes>(words[q], b);
      }
#pragma unroll
      for (int t = 0; t < N; ++t) {
        float p, sx;
        chunk_dot(qv, xs4, (t * k + j0) >> 2, p, sx);
        acc[t] += p * s - off * sx;
      }
    }
  }

#pragma unroll
  for (int t = 0; t < N; ++t) {
    float v = acc[t];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) y[((size_t)mat * N + t) * m + row] = v;
  }
}

template <int N, int kCodes>
cudaError_t launch(const void* x, const Grouped& g, void* y, int m, int k, int gs,
                   cudaStream_t stream) {
  const size_t smem = (size_t)N * k * sizeof(float);
  if (smem > (size_t)kGroupedSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(gemv_grouped_kernel<N, kCodes>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((m + kGroupedWarps - 1) / kGroupedWarps, kMats);
  gemv_grouped_kernel<N, kCodes><<<grid, kGroupedWarps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), g, static_cast<float*>(y), m, k, gs);
  return cudaGetLastError();
}

template <int kCodes>
int dispatch(const void* x, const Grouped& g, void* y, int n, int m, int k, int gs,
             cudaStream_t s) {
  switch (n) {
    case 1: return (int)launch<1, kCodes>(x, g, y, m, k, gs, s);
    case 2: return (int)launch<2, kCodes>(x, g, y, m, k, gs, s);
    case 3: return (int)launch<3, kCodes>(x, g, y, m, k, gs, s);
    case 4: return (int)launch<4, kCodes>(x, g, y, m, k, gs, s);
    case 5: return (int)launch<5, kCodes>(x, g, y, m, k, gs, s);
    case 6: return (int)launch<6, kCodes>(x, g, y, m, k, gs, s);
    case 7: return (int)launch<7, kCodes>(x, g, y, m, k, gs, s);
    case 8: return (int)launch<8, kCodes>(x, g, y, m, k, gs, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x bf16 [3, n, k]; codes_r, codes_k, codes_v [m, k/2] u8 split-halves
// nibbles (code_kind 0) or [m, k] u8 (1) / i8 (2) bytes, each 16-byte
// aligned; scales f32 [3, m, k/gs]; offsets f32 [3, m, k/gs] or null (w =
// q * s - offset); y f32 [3, n, m]. All contiguous; gs 16, 32 or 128 (32 for
// nibbles); k % 32 == 0 (k % 64 == 0 for nibbles); 1 <= n <= 8. Returns the
// cudaError_t of the launch.
extern "C" int quant_gemv_grouped(const void* x, const void* codes_r, const void* codes_k,
                                  const void* codes_v, const void* scales, const void* offsets,
                                  void* y, int n, int m, int k, int gs, int code_kind,
                                  void* stream) {
  if (m <= 0 || k % 32 || (gs != 16 && gs != 32 && gs != 128) || k % gs ||
      (code_kind == kNib && (gs != 32 || k % 64)))
    return (int)cudaErrorInvalidValue;
  const Grouped g{{static_cast<const uint8_t*>(codes_r), static_cast<const uint8_t*>(codes_k),
                   static_cast<const uint8_t*>(codes_v)},
                  static_cast<const float*>(scales), static_cast<const float*>(offsets)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (code_kind) {
    case kNib: return dispatch<kNib>(x, g, y, n, m, k, gs, s);
    case kU8: return dispatch<kU8>(x, g, y, n, m, k, gs, s);
    case kI8: return dispatch<kI8>(x, g, y, n, m, k, gs, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
