// NF4 / SF4 codebook gemv for Hopper (sm_90a): y[n, m] = sum_k x[n, k] *
// W[m, k] for n <= 8 input rows, W held as the engine's NF4 / SF4
// requantization (models/matrix.py, kind "nf4"): codes u8 [M, K/2], two
// 4-bit codebook indices a byte in pair order (low nibble element 2j, high
// nibble 2j + 1); absmax f32 [M, K/64]; lut f32 [16], the codebook (NF4's
// normal quantiles or SF4's Student-t ones: the same kernel). Element e of
// a row is bf16(lut[idx(e)]) * absmax[e / 64].
//
// Replaces: web_rwkv_gguf_tpu/ops/pallas/matmul.py::_quant_gemv (def at
// line 1002, pallas_call at line 1055; kernel body _gemv_kernel at line
// 195, codebook lookup _lut_tree at line 73). The TPU kernel de-interleaves
// x into [evens | odds] to share the split-halves plane math and looks the
// codebook up with a tree of 15 selects (Mosaic has no lane gather); here a
// lane reads its chunk's 32 elements in order and gathers from the
// codebook in shared memory.
//
// Bound on this card, and the design: qgemv.cuh (code storage kLut, scale
// source LutScales of qscales.cuh). 0.53 bytes per weight with the absmax.

#include "qgemv.cuh"

// x bf16 [n, k]; codes u8 [m, k/2] (16-byte aligned); absmax f32 [m, k/64];
// lut f32 [16]; y f32 [n, m]. All contiguous; k % 64 == 0; 1 <= n <= 8.
// Returns the cudaError_t of the launch.
extern "C" int nf4_gemv(const void* x, const void* codes, const void* absmax, const void* lut,
                        void* y, int n, int m, int k, void* stream) {
  if (m <= 0 || k % 64) return (int)cudaErrorInvalidValue;
  const LutScales s{static_cast<const float*>(absmax), static_cast<const float*>(lut), k / 64};
  return qgemv_dispatch<kLut>(x, codes, s, y, n, m, k, 64, stream);
}
