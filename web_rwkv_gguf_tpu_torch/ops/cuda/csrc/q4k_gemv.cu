// Q4_K dequant gemv for Hopper (sm_90a): y[n, m] = sum_k x[n, k] * W[m, k]
// for n <= 8 input rows, W held as the port's logical Q4_K arrays.
//
// Replaces: web_rwkv_gguf_tpu/ops/pallas/matmul.py::_quant_gemv2_native
// (def at line 793, pallas_call at line 805; kernel body _gemv_kernel2n).
//
// Weight layout (quant/repack.py): codes u8 [M, K/2] in split halves, byte
// j = el(j) | el(j + K/2) << 4; sc6, mn6 u8 [M, K/32] (6-bit scale and min
// codes per 32-element group); d8, dm8 f32 [M, K/256] (super-scales).
// Element e of a row is  q(e) * (d8[g/8] * sc6[g]) - dm8[g/8] * mn6[g],
// g = e / 32, with d*sc and dmin*mn formed in f32 as the loader would.
//
// Bound on this card: bytes. At n <= 8 each weight byte feeds at most 16
// multiply-adds, far below the ~295 operations per byte where H100 stops
// being memory-bound, so the least time is the ~0.56 bytes per weight
// (codes + factors) over HBM bandwidth. Design for that: one warp per
// output row streams the row's codes 16 bytes per lane (coalesced, one
// 128-bit load each), all n inputs are applied to each decoded weight
// while it sits in registers (the weight is read once whatever n is), x
// is staged once per block in shared memory as f32 and read back 16 bytes
// at a time, and the per-lane sums are reduced with warp shuffles. Speed
// work (several rows per warp, swizzled x to remove the remaining 4-way
// bank conflicts, split-K for short matrices) is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // output rows per block, one warp each
constexpr int kMaxSmem = 232448;  // bytes of shared memory a block may use

template <int N>
__global__ void __launch_bounds__(kWarps * 32)
q4k_gemv_kernel(const __nv_bfloat16* __restrict__ x,
                const uint8_t* __restrict__ codes,
                const uint8_t* __restrict__ sc6,
                const uint8_t* __restrict__ mn6,
                const float* __restrict__ d8,
                const float* __restrict__ dm8,
                float* __restrict__ y, int m, int k) {
  extern __shared__ float4 xs4[];  // [N, k] f32, 16-byte aligned
  float* xs = reinterpret_cast<float*>(xs4);
  for (int i = threadIdx.x; i < N * k; i += blockDim.x) {
    xs[i] = __bfloat162float(x[i]);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= m) return;

  const int half = k >> 1;        // code bytes per row
  const int nchunks = half >> 4;  // 16-byte chunks per row
  const int g32 = k >> 5;
  const int g256 = k >> 8;
  const uint8_t* crow = codes + (size_t)row * half;
  const uint8_t* srow = sc6 + (size_t)row * g32;
  const uint8_t* mrow = mn6 + (size_t)row * g32;
  const float* drow = d8 + (size_t)row * g256;
  const float* dmrow = dm8 + (size_t)row * g256;

  float acc[N];
#pragma unroll
  for (int t = 0; t < N; ++t) acc[t] = 0.f;

  for (int c = lane; c < nchunks; c += 32) {
    const int j0 = c << 4;  // 16 bytes: elements j0.. (low) and j0+K/2.. (high)
    const uint4 raw = *reinterpret_cast<const uint4*>(crow + j0);
    // a 16-byte chunk never straddles a 32-group (K/2 is a multiple of 128)
    const int glo = j0 >> 5;
    const int ghi = (j0 + half) >> 5;
    const float slo = drow[glo >> 3] * (float)srow[glo];
    const float mlo = dmrow[glo >> 3] * (float)mrow[glo];
    const float shi = drow[ghi >> 3] * (float)srow[ghi];
    const float mhi = dmrow[ghi >> 3] * (float)mrow[ghi];
    const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float wlo[4], whi[4];  // the 4 low and 4 high elements of word q
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const uint32_t byte = (words[q] >> (8 * b)) & 0xFFu;
        wlo[b] = (float)(byte & 0xFu) * slo - mlo;
        whi[b] = (float)(byte >> 4) * shi - mhi;
      }
      const int e4 = (j0 >> 2) + q;  // float4 index of element j0 + 4q
#pragma unroll
      for (int t = 0; t < N; ++t) {
        const float4 xl = xs4[((t * k) >> 2) + e4];
        const float4 xh = xs4[((t * k + half) >> 2) + e4];
        acc[t] += wlo[0] * xl.x + wlo[1] * xl.y + wlo[2] * xl.z + wlo[3] * xl.w
                + whi[0] * xh.x + whi[1] * xh.y + whi[2] * xh.z + whi[3] * xh.w;
      }
    }
  }

#pragma unroll
  for (int t = 0; t < N; ++t) {
    float v = acc[t];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v += __shfl_xor_sync(0xffffffffu, v, off);
    }
    if (lane == 0) y[(size_t)t * m + row] = v;
  }
}

template <int N>
cudaError_t launch(const void* x, const void* codes, const void* sc6,
                   const void* mn6, const void* d8, const void* dm8, void* y,
                   int m, int k, cudaStream_t stream) {
  const size_t smem = (size_t)N * k * sizeof(float);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        q4k_gemv_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int blocks = (m + kWarps - 1) / kWarps;
  q4k_gemv_kernel<N><<<blocks, kWarps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(codes),
      static_cast<const uint8_t*>(sc6), static_cast<const uint8_t*>(mn6),
      static_cast<const float*>(d8), static_cast<const float*>(dm8),
      static_cast<float*>(y), m, k);
  return cudaGetLastError();
}

}  // namespace

// x bf16 [n, k]; codes u8 [m, k/2]; sc6, mn6 u8 [m, k/32]; d8, dm8 f32
// [m, k/256]; y f32 [n, m]. All contiguous, codes 16-byte aligned,
// k % 256 == 0, 1 <= n <= 8. Returns the cudaError_t of the launch.
extern "C" int q4k_gemv(const void* x, const void* codes, const void* sc6,
                        const void* mn6, const void* d8, const void* dm8,
                        void* y, int n, int m, int k, void* stream) {
  if (k % 256 != 0 || m <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 1: return (int)launch<1>(x, codes, sc6, mn6, d8, dm8, y, m, k, s);
    case 2: return (int)launch<2>(x, codes, sc6, mn6, d8, dm8, y, m, k, s);
    case 3: return (int)launch<3>(x, codes, sc6, mn6, d8, dm8, y, m, k, s);
    case 4: return (int)launch<4>(x, codes, sc6, mn6, d8, dm8, y, m, k, s);
    case 5: return (int)launch<5>(x, codes, sc6, mn6, d8, dm8, y, m, k, s);
    case 6: return (int)launch<6>(x, codes, sc6, mn6, d8, dm8, y, m, k, s);
    case 7: return (int)launch<7>(x, codes, sc6, mn6, d8, dm8, y, m, k, s);
    case 8: return (int)launch<8>(x, codes, sc6, mn6, d8, dm8, y, m, k, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
