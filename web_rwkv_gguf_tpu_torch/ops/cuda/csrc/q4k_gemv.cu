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
// Bound on this card: bytes, ~0.56 a weight (codes and factors) over HBM
// bandwidth. The body is qgemv_mma.cuh: each 32-group's products on the
// tensor cores in the TPU kernel's factored form (two fresh m16n8k16
// products of the group's exact codes against bf16 x, added in f32, times
// d*sc, less dmin*mn times the group's f32 sum of x), 16-row tiles
// streamed through a cp.async ring per warp on a persistent grid, x
// staged once per block.

#include "qgemv_mma.cuh"

// x bf16 [n, k]; codes u8 [m, k/2]; sc6, mn6 u8 [m, k/32]; d8, dm8 f32
// [m, k/256]; y f32 [n, m]. All contiguous, codes 16-byte aligned, sc6 and
// mn6 4-byte aligned, k % 256 == 0, 1 <= n <= 8. Returns the cudaError_t of
// the launch.
extern "C" int q4k_gemv(const void* x, const void* codes, const void* sc6,
                        const void* mn6, const void* d8, const void* dm8,
                        void* y, int n, int m, int k, void* stream) {
  if (k % 256 != 0 || m <= 0 || (uintptr_t)codes % 16 || (uintptr_t)sc6 % 4 ||
      (uintptr_t)mn6 % 4)
    return (int)cudaErrorInvalidValue;
  const MmaArgs a{static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(codes),
                  static_cast<const uint8_t*>(sc6), static_cast<const uint8_t*>(mn6),
                  static_cast<const float*>(d8), static_cast<const float*>(dm8),
                  static_cast<float*>(y), m, k, 1, 0};
  return qgemv_mma_dispatch<kFormQ4K>(a, n, stream);
}
