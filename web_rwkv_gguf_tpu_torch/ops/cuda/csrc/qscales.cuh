// Group scales and codes of the port's quantized forms, shared by the
// matmul kernels (qgemv.cuh, qk_gemm.cu) and the whole-stack decode rows
// (decode_common.cuh). A weight is q * s - mn, with q a code of its row and
// s, mn its group's scale and offset (groups of 16, 32 or 128 elements
// along K; NF4 / SF4: q the codebook value of a 4-bit index, s the absmax
// of a 64-group, no offset). A scale source gives (s, mn) of row `row`,
// group g: stored f32 arrays, or 8-bit codes times per-256 super-scales
// formed in f32 here, as the loader would form them (models/matrix.py,
// scale_products).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// How a row's codes are stored: split-halves nibbles (byte j holds element
// j in its low nibble and element j + K/2 in its high one), u8 bytes, i8
// bytes (sign-extended: a Q8_0 file may hold -128), or codebook indices in
// pair order (byte j holds element 2j in its low nibble and element 2j + 1
// in its high one; the codebook comes with LutScales).
enum CodeKind { kNib = 0, kU8 = 1, kI8 = 2, kLut = 3 };

// f32 group scales and (optional) offsets, [m, G] each.
struct F32Scales {
  const float* s;
  const float* mn;  // null: no offsets
  int G;
  __device__ __forceinline__ bool has_min() const { return mn != nullptr; }
  __device__ __forceinline__ void get(size_t row, int g, float& sc, float& off) const {
    sc = s[row * G + g];
    off = mn != nullptr ? mn[row * G + g] : 0.f;
  }
};

// Q4_K / Q5_K / Q2_K factors: u8 scale and min codes [m, G], f32
// super-scales [m, G / reps]; s = d * sc and mn = dmin * mn.
struct NativeScales {
  const uint8_t* sc;
  const uint8_t* mnc;
  const float* d;
  const float* dm;
  int G, reps;
  __device__ __forceinline__ bool has_min() const { return true; }
  __device__ __forceinline__ void get(size_t row, int g, float& s, float& off) const {
    const size_t j = row * (G / reps) + g / reps;
    s = d[j] * (float)sc[row * G + g];
    off = dm[j] * (float)mnc[row * G + g];
  }
};

// Q6_K / Q3_K factors: i8 scale codes [m, G], f32 super-scales [m, G / reps];
// no offsets.
struct NominScales {
  const int8_t* sc;
  const float* d;
  int G, reps;
  __device__ __forceinline__ bool has_min() const { return false; }
  __device__ __forceinline__ void get(size_t row, int g, float& s, float& off) const {
    s = d[row * (G / reps) + g / reps] * (float)sc[row * G + g];
    off = 0.f;
  }
};

// NF4 / SF4: f32 absmax per 64-group [m, G] and the 16-entry f32 codebook
// (each kernel stages it in shared memory, rounded as its class rounds it);
// no offsets.
struct LutScales {
  const float* absmax;
  const float* lut;
  int G;
  __device__ __forceinline__ bool has_min() const { return false; }
  __device__ __forceinline__ void get(size_t row, int g, float& s, float& off) const {
    s = absmax[row * G + g];
    off = 0.f;
  }
};

// Byte b of a 4-byte word of u8 or i8 codes, as a float.
template <int kCodes>
__device__ __forceinline__ float code_at(uint32_t word, int b) {
  const uint32_t byte = (word >> (8 * b)) & 0xFFu;
  return kCodes == kI8 ? (float)(int8_t)byte : (float)byte;
}

}  // namespace
