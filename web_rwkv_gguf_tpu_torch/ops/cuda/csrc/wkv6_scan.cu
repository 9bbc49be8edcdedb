// RWKV-6 WKV scan over a chunk of T tokens, Hopper sm_90a.
//
// Replaces: web_rwkv_gguf_tpu/ops/pallas/wkv456.py::wkv6_pallas (def at line
// 46, pallas_call at line 63; kernel body _wkv6_kernel at line 30), the WKV
// of V6 prefill chunks with 2 <= T < 128 (and, in the port, of a V6 token
// at T = 1 on the per-layer decode path).
//
// Per (batch lane b, head h), with head size K = V = 64, for each token:
//   y = S^T r + (sum_k r u k) v;  S <- diag(w) S + k v^T
// w is already activated (exp(-exp(w_raw))), u is the head's time_first.
// The bonus u k v^T enters y only, never S. A padded token (mask 0) is
// pre-masked as the TPU kernel does it: w <- 1, k <- 0, so S stays exactly
// as it was; y there is unspecified (read from the unchanged state).
//
// Bound on this card: the update is sequential in T, so the work of one
// (b, h) is a chain of T dependent 64x64 updates; the bytes (the state once
// in and once out, four 64-vectors per token) are small, so the chain's
// latency, not HBM, bounds it. Design, as wkv7_scan.cu: one block of 64
// threads per (b, h); thread t holds value column t of S in 64 registers
// for the whole chunk, so the state never leaves the SM between tokens.
// Per token the three per-key vectors (r, k, w) are staged in shared memory
// (double-buffered, so one barrier per token suffices), u sits in shared
// memory for the whole chunk, y is written coalesced across the block, and
// S is written once at the end. B*H blocks leave most SMs idle at small
// batch; splitting value columns over more blocks is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHs = 64;  // head size this kernel takes (K = V = 64)

__global__ void __launch_bounds__(kHs)
wkv6_scan_kernel(const float* __restrict__ state, const float* __restrict__ r,
                 const float* __restrict__ k, const float* __restrict__ v,
                 const float* __restrict__ u, const float* __restrict__ w,
                 const uint8_t* __restrict__ mask, float* __restrict__ y,
                 float* __restrict__ state_out, int T, int H) {
  __shared__ float s_r[2][kHs], s_k[2][kHs], s_w[2][kHs], s_u[kHs];

  const int bh = blockIdx.x;  // lane * H + head
  const int h = bh % H;
  const int lane = bh / H;
  const int t = threadIdx.x;

  s_u[t] = u[h * kHs + t];
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
    s_k[buf][t] = live ? k[idx] : 0.f;
    s_w[buf][t] = live ? w[idx] : 1.f;
    const float vt = v[idx];
    __syncthreads();  // also publishes s_u on the first token

    float yt = 0.f;
#pragma unroll
    for (int i = 0; i < kHs; ++i) {
      const float kv = s_k[buf][i] * vt;
      yt += s_r[buf][i] * (s_u[i] * kv + col[i]);
      col[i] = s_w[buf][i] * col[i] + kv;
    }
    y[idx] = yt;
  }

  float* So = state_out + (size_t)bh * kHs * kHs;
#pragma unroll
  for (int i = 0; i < kHs; ++i) So[i * kHs + t] = col[i];
}

}  // namespace

// state f32 [B, H, 64, 64]; r, k, w f32 [B, T, H, 64]; v f32 [B, T, H, 64];
// u f32 [H, 64]; mask u8 [B, T] (0 = padded token); y f32 [B, T, H, 64];
// state_out f32 [B, H, 64, 64] (must not alias state). All contiguous.
// Returns the cudaError_t of the launch.
extern "C" int wkv6_scan(const void* state, const void* r, const void* k,
                         const void* v, const void* u, const void* w,
                         const void* mask, void* y, void* state_out, int B,
                         int T, int H, int hs, void* stream) {
  if (hs != kHs || B <= 0 || T <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  wkv6_scan_kernel<<<B * H, kHs, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(state), static_cast<const float*>(r),
      static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(u), static_cast<const float*>(w),
      static_cast<const uint8_t*>(mask), static_cast<float*>(y),
      static_cast<float*>(state_out), T, H);
  return (int)cudaGetLastError();
}
