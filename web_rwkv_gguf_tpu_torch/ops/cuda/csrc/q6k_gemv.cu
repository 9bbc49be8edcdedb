// Q6_K dequant gemv for Hopper (sm_90a): y[n, m] = sum_k x[n, k] * W[m, k]
// for n <= 8 input rows, W held as the port's logical Q6_K arrays (Q3_K's
// native factors take the same form). On the main path this is the output
// head, [65536, 768] for a 0.1B model.
//
// Replaces: web_rwkv_gguf_tpu/ops/pallas/matmul.py::_quant_gemv2_nomin_native
// (def at line 629, pallas_call at line 639; kernel body
// _gemv_kernel2n_nomin with _gemv_sf_body).
//
// Weight layout (quant/repack.py): codes i8 [M, K] (Q6_K -32..31, Q3_K
// -4..3, one byte per weight); q6s i8 [M, K/16] (signed scale codes per
// 16-element group); q6d f32 [M, K/256] (super-scales). Element e of a row
// is q(e) * (q6d[g/16] * q6s[g]), g = e / 16, with d*sc formed in f32.
//
// Bound on this card: bytes, ~1.06 a weight (codes, scale codes and
// super-scales) over HBM bandwidth. The body is qgemv_mma.cuh: each
// 16-group's products on the tensor cores in the TPU kernel's factored
// form (one fresh m16n8k16 product of the group's exact codes against bf16
// x, times d*sc, added in f32), 16-row tiles streamed through a cp.async
// ring per warp on a persistent grid, x staged once per block. The 6-bit
// codes still take a whole byte each; packing them (0.75 byte per weight)
// is later work.

#include "qgemv_mma.cuh"

// x bf16 [n, k]; codes i8 [m, k] in -32..31; q6s i8 [m, k/16]; q6d f32
// [m, k/256]; y f32 [n, m]. All contiguous, codes 16-byte aligned, q6s
// 8-byte aligned, k % 256 == 0, 1 <= n <= 8. Returns the cudaError_t of the
// launch.
extern "C" int q6k_gemv(const void* x, const void* codes, const void* q6s,
                        const void* q6d, void* y, int n, int m, int k,
                        void* stream) {
  if (k % 256 != 0 || m <= 0 || (uintptr_t)codes % 16 || (uintptr_t)q6s % 8)
    return (int)cudaErrorInvalidValue;
  const MmaArgs a{static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(codes),
                  static_cast<const uint8_t*>(q6s), nullptr, static_cast<const float*>(q6d),
                  nullptr, static_cast<float*>(y), m, k, 1, 0};
  return qgemv_mma_dispatch<kFormQ6K>(a, n, stream);
}
