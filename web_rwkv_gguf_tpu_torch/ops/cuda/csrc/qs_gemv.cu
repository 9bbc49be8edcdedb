// Scaled-code dequant gemv for Hopper (sm_90a): y[n, m] = sum_k x[n, k] *
// W[m, k] for n <= 8 input rows, W = s * q - mn per group with f32 group
// scales s and optional offsets mn, q split-halves nibbles, u8 or i8 bytes.
// It serves every matrix the port keeps with f32 group scales: Q8_0 (i8,
// 32-groups), the legacy Q4_0 / Q4_1 (nibbles with offsets at K % 64 == 0;
// i8 or u8 bytes otherwise), Q5_0 / Q5_1 (u8, offsets), Q4_K / Q6_K /
// Q5_K / Q2_K / Q3_K rows that do not hold whole 256-element super-blocks,
// and the engine's Int8 requantization (u8, 128-groups; the JAX weight
// mn + s * u, whose offset is added, comes as mins = -mn, exact in f32).
//
// Replaces: web_rwkv_gguf_tpu/ops/pallas/matmul.py::_quant_gemv2 (def at
// line 939, pallas_call at line 952; kernel bodies _gemv_kernel2 and
// _gemv_kernel2w). The TPU kernel folds a +128 code bias and the offsets
// into one operand to use its bitcast planes; here the logical s and mn are
// applied directly, so nothing of that fold is carried over.
//
// Bound on this card, and the design: qgemv.cuh.

#include "qgemv.cuh"

// x bf16 [n, k]; codes [m, k/2] u8 split-halves nibbles (code_kind 0) or
// [m, k] u8 (1) / i8 (2) bytes, 16-byte aligned; scales f32 [m, k/gs]; mins
// f32 [m, k/gs] or null; y f32 [n, m]. All contiguous; gs 16, 32 or 128
// (32 for nibbles); k % gs == 0, k % 32 == 0 (k % 64 == 0 for nibbles);
// 1 <= n <= 8. Returns the cudaError_t of the launch.
extern "C" int qs_gemv(const void* x, const void* codes, const void* scales, const void* mins,
                       void* y, int n, int m, int k, int gs, int code_kind, void* stream) {
  if (m <= 0 || k % 32 || (gs != 16 && gs != 32 && gs != 128) || k % gs ||
      (code_kind == kNib && (gs != 32 || k % 64)))
    return (int)cudaErrorInvalidValue;
  const F32Scales s{static_cast<const float*>(scales), static_cast<const float*>(mins), k / gs};
  switch (code_kind) {
    case kNib: return qgemv_dispatch<kNib>(x, codes, s, y, n, m, k, gs, stream);
    case kU8: return qgemv_dispatch<kU8>(x, codes, s, y, n, m, k, gs, stream);
    case kI8: return qgemv_dispatch<kI8>(x, codes, s, y, n, m, k, gs, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
