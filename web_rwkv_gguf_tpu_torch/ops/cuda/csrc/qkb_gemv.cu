// Q5_K / Q2_K dequant gemv for Hopper (sm_90a): y[n, m] = sum_k x[n, k] *
// W[m, k] for n <= 8 input rows, W held as the port's logical byte-kind
// arrays with native factors: codes u8 [M, K] (Q5_K 0..31, Q2_K 0..3), sc6
// and mn6 u8 [M, G] (the scale and min codes of each 32-group for Q5_K,
// each 16-group for Q2_K), d8 and dm8 f32 [M, K/256] (super-scales). Element
// e of a row is q(e) * (d8 * sc6[g]) - dm8 * mn6[g], g = e / gs, with the
// products formed in f32 in the kernel, as the loader would form them.
//
// Replaces: web_rwkv_gguf_tpu/ops/pallas/matmul.py::_quant_gemv2_b_native
// (def at line 587, pallas_call at line 597; kernel body _gemv_kernel2n_b).
//
// Bound on this card, and the design: qgemv.cuh. The codes keep the one
// byte per weight of the JAX layout (1.09 bytes per weight with the
// factors for Q5_K); a packed 5-bit plane (0.69) is later speed work.

#include "qgemv.cuh"

// x bf16 [n, k]; codes u8 [m, k] (16-byte aligned); sc6, mn6 u8 [m, k/gs];
// d8, dm8 f32 [m, k/256]; y f32 [n, m]. All contiguous; k % 256 == 0; gs 16
// or 32; 1 <= n <= 8. Returns the cudaError_t of the launch.
extern "C" int qkb_gemv(const void* x, const void* codes, const void* sc6, const void* mn6,
                        const void* d8, const void* dm8, void* y, int n, int m, int k, int gs,
                        void* stream) {
  if (m <= 0 || k % 256 || (gs != 16 && gs != 32)) return (int)cudaErrorInvalidValue;
  const NativeScales s{static_cast<const uint8_t*>(sc6), static_cast<const uint8_t*>(mn6),
                       static_cast<const float*>(d8), static_cast<const float*>(dm8), k / gs,
                       256 / gs};
  return qgemv_dispatch<kU8>(x, codes, s, y, n, m, k, gs, stream);
}
