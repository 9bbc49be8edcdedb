// RWKV-7 WKV scan over a chunk of T tokens, Hopper sm_90a.
//
// Replaces: web_rwkv_gguf_tpu/ops/pallas/wkv7.py::wkv7_pallas (def at line
// 176, pallas_call at line 206; kernel body _wkv7_kernel at line 46), the
// WKV of prefill chunks with 2 <= T < 128.
//
// Per (batch lane b, head h), with head size K = V = 64, for each token:
//   sa = a^T S;  S <- diag(w) S + k v^T + b sa^T;  y = S^T r
// w is already activated. A padded token (mask 0) is pre-masked as the
// TPU kernel does it: w <- 1, k <- 0, b <- 0, so S stays as it was, and y
// there is read from the unchanged state (r and v are not masked).
//
// Bound on this card: the state update is sequential in T, so the work of
// one (b, h) is a chain of T dependent 64x64 updates; the bytes (the state
// once in and once out, six 64-vectors per token) are small. Design, in
// the frame of att_core7.cu: one block of 64 threads per (b, h); thread t
// holds value column t of S in 64 registers for the whole chunk, so the
// state never leaves the SM between tokens. Per token the five per-key
// vectors (r, w, k, a, b) are staged in shared memory (double-buffered,
// so one barrier per token suffices), sa, S and y come from registers,
// and y is written coalesced across the block. S is written once at the
// end. B*H blocks leave most SMs idle at small batch; splitting value
// columns over more blocks is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHs = 64;  // head size this kernel takes (K = V = 64)

__global__ void __launch_bounds__(kHs)
wkv7_scan_kernel(const float* __restrict__ state, const float* __restrict__ r,
                 const float* __restrict__ w, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ a,
                 const float* __restrict__ b, const uint8_t* __restrict__ mask,
                 float* __restrict__ y, float* __restrict__ state_out, int T,
                 int H) {
  __shared__ float s_r[2][kHs], s_w[2][kHs], s_k[2][kHs], s_a[2][kHs],
      s_b[2][kHs];

  const int bh = blockIdx.x;  // lane * H + head
  const int h = bh % H;
  const int lane = bh / H;
  const int t = threadIdx.x;

  const float* S = state + (size_t)bh * kHs * kHs;
  float col[kHs];
#pragma unroll
  for (int i = 0; i < kHs; ++i) col[i] = S[i * kHs + t];

  for (int tok = 0; tok < T; ++tok) {
    const int buf = tok & 1;
    // [B, T, H, 64] vectors: element t of (lane, tok, h)
    const size_t idx = (((size_t)lane * T + tok) * H + h) * kHs + t;
    const bool live = mask[(size_t)lane * T + tok] != 0;
    s_r[buf][t] = r[idx];
    s_w[buf][t] = live ? w[idx] : 1.f;
    s_k[buf][t] = live ? k[idx] : 0.f;
    s_a[buf][t] = a[idx];
    s_b[buf][t] = live ? b[idx] : 0.f;
    const float vt = v[idx];
    __syncthreads();

    float sa = 0.f;
#pragma unroll
    for (int i = 0; i < kHs; ++i) sa += s_a[buf][i] * col[i];
    float yt = 0.f;
#pragma unroll
    for (int i = 0; i < kHs; ++i) {
      col[i] = s_w[buf][i] * col[i] + s_k[buf][i] * vt + s_b[buf][i] * sa;
      yt += s_r[buf][i] * col[i];
    }
    y[idx] = yt;
  }

  float* So = state_out + (size_t)bh * kHs * kHs;
#pragma unroll
  for (int i = 0; i < kHs; ++i) So[i * kHs + t] = col[i];
}

}  // namespace

// state f32 [B, H, 64, 64]; r, w, k, a, b f32 [B, T, H, 64]; v f32
// [B, T, H, 64]; mask u8 [B, T] (0 = padded token); y f32 [B, T, H, 64];
// state_out f32 [B, H, 64, 64] (must not alias state). All contiguous.
// Returns the cudaError_t of the launch.
extern "C" int wkv7_scan(const void* state, const void* r, const void* w,
                         const void* k, const void* v, const void* a,
                         const void* b, const void* mask, void* y,
                         void* state_out, int B, int T, int H, int hs,
                         void* stream) {
  if (hs != kHs || B <= 0 || T <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  wkv7_scan_kernel<<<B * H, kHs, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(state), static_cast<const float*>(r),
      static_cast<const float*>(w), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<const uint8_t*>(mask),
      static_cast<float*>(y), static_cast<float*>(state_out), T, H);
  return (int)cudaGetLastError();
}
