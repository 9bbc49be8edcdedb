// Q6_K dequant gemv for Hopper (sm_90a): y[n, m] = sum_k x[n, k] * W[m, k]
// for n <= 8 input rows, W held as the port's logical Q6_K arrays. On the
// main path this is the output head, [65536, 768] for a 0.1B model.
//
// Replaces: web_rwkv_gguf_tpu/ops/pallas/matmul.py::_quant_gemv2_nomin_native
// (def at line 629, pallas_call at line 639; kernel body
// _gemv_kernel2n_nomin with _gemv_sf_body).
//
// Weight layout (quant/repack.py): codes i8 [M, K] (values -32..31, one
// byte per weight); q6s i8 [M, K/16] (signed scale codes per 16-element
// group); q6d f32 [M, K/256] (super-scales). Element e of a row is
// q(e) * (q6d[g/16] * q6s[g]), g = e / 16, with d*sc formed in f32.
//
// Bound on this card: bytes — about 1.06 bytes per weight (codes + scale
// codes + super-scales), against at most 16 multiply-adds per weight at
// n <= 8. Design for that: one warp per output row streams the row's
// codes 16 bytes (one 16-group) per lane per step with 128-bit loads, all
// n inputs are applied to each decoded weight in registers, x is staged
// once per block in shared memory as f32 and read back 16 bytes at a
// time, and lanes reduce with warp shuffles. The 6-bit codes still take a
// whole byte each; packing them (0.75 byte per weight) is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // output rows per block, one warp each
constexpr int kMaxSmem = 232448;  // bytes of shared memory a block may use

template <int N>
__global__ void __launch_bounds__(kWarps * 32)
q6k_gemv_kernel(const __nv_bfloat16* __restrict__ x,
                const int8_t* __restrict__ codes,
                const int8_t* __restrict__ q6s,
                const float* __restrict__ q6d,
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

  const int nchunks = k >> 4;  // 16-byte chunks = 16-element groups
  const int8_t* crow = codes + (size_t)row * k;
  const int8_t* srow = q6s + (size_t)row * (k >> 4);
  const float* drow = q6d + (size_t)row * (k >> 8);

  float acc[N];
#pragma unroll
  for (int t = 0; t < N; ++t) acc[t] = 0.f;

  for (int c = lane; c < nchunks; c += 32) {
    const int j0 = c << 4;
    const uint4 raw = *reinterpret_cast<const uint4*>(crow + j0);
    const float s = drow[c >> 4] * (float)srow[c];
    const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float w[4];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        // sign-extend byte b of the word: move it to the top, shift back
        const int code = ((int32_t)(words[q] << (24 - 8 * b))) >> 24;
        w[b] = (float)code * s;
      }
      const int e4 = (j0 >> 2) + q;  // float4 index of element j0 + 4q
#pragma unroll
      for (int t = 0; t < N; ++t) {
        const float4 xv = xs4[((t * k) >> 2) + e4];
        acc[t] += w[0] * xv.x + w[1] * xv.y + w[2] * xv.z + w[3] * xv.w;
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
cudaError_t launch(const void* x, const void* codes, const void* q6s,
                   const void* q6d, void* y, int m, int k,
                   cudaStream_t stream) {
  const size_t smem = (size_t)N * k * sizeof(float);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        q6k_gemv_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int blocks = (m + kWarps - 1) / kWarps;
  q6k_gemv_kernel<N><<<blocks, kWarps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(codes),
      static_cast<const int8_t*>(q6s), static_cast<const float*>(q6d),
      static_cast<float*>(y), m, k);
  return cudaGetLastError();
}

}  // namespace

// x bf16 [n, k]; codes i8 [m, k]; q6s i8 [m, k/16]; q6d f32 [m, k/256];
// y f32 [n, m]. All contiguous, codes 16-byte aligned, k % 256 == 0,
// 1 <= n <= 8. Returns the cudaError_t of the launch.
extern "C" int q6k_gemv(const void* x, const void* codes, const void* q6s,
                        const void* q6d, void* y, int n, int m, int k,
                        void* stream) {
  if (k % 256 != 0 || m <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 1: return (int)launch<1>(x, codes, q6s, q6d, y, m, k, s);
    case 2: return (int)launch<2>(x, codes, q6s, q6d, y, m, k, s);
    case 3: return (int)launch<3>(x, codes, q6s, q6d, y, m, k, s);
    case 4: return (int)launch<4>(x, codes, q6s, q6d, y, m, k, s);
    case 5: return (int)launch<5>(x, codes, q6s, q6d, y, m, k, s);
    case 6: return (int)launch<6>(x, codes, q6s, q6d, y, m, k, s);
    case 7: return (int)launch<7>(x, codes, q6s, q6d, y, m, k, s);
    case 8: return (int)launch<8>(x, codes, q6s, q6d, y, m, k, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
