// RWKV-4 WKV scan over a chunk of T tokens, Hopper sm_90a.
//
// Replaces: web_rwkv_gguf_tpu/ops/pallas/wkv456.py::wkv4_pallas (def at line
// 143, pallas_call at line 154; kernel body _wkv4_kernel at line 101), the
// WKV of every V4 chunk (T = 1 included).
//
// Per (batch lane b, channel c), with the running-max state (aa, bb, pp),
// for each token (r before the sigmoid, u = time_first, w = -exp(decay)):
//   q  = max(pp, u + k);  e1 = exp(pp - q);  e2 = exp(u + k - q)
//   y  = sigmoid(r) (e1 aa + e2 v) / (e1 bb + e2)
//   q' = max(w + pp, k);  e1 = exp(w + pp - q');  e2 = exp(k - q')
//   aa <- e1 aa + e2 v;  bb <- e1 bb + e2;  pp <- q'
// A padded token (mask 0) leaves the state bit for bit by a select: pp holds
// the F32_MIN sentinel until a channel's first token, so no masking of the
// inputs could make the update a no-op. y there is unspecified.
// Every exp is IEEE expf and the division is IEEE (no fast math), as the
// f32 TPU kernel computes them.
//
// Bound on this card: each (b, c) is independent and sequential in T, with a
// few flops per token, so the chunk is bound by HBM bytes (k, v, r read and y
// written once, the state read and written once). Design: one thread per
// (b, c), the state in registers for the whole chunk; loads of a token row
// are coalesced across the channels. The loads of kUnroll tokens are issued
// before their chain of updates, so the memory latency is paid once per
// kUnroll tokens and not once per token.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 8;

__global__ void __launch_bounds__(kThreads)
wkv4_scan_kernel(const float* __restrict__ state, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ r,
                 const float* __restrict__ u, const float* __restrict__ w,
                 const uint8_t* __restrict__ mask, float* __restrict__ y,
                 float* __restrict__ state_out, int T, int C) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (c >= C) return;
  const size_t s = ((size_t)b * C + c) * 3;
  float aa = state[s], bb = state[s + 1], pp = state[s + 2];
  const float uc = u[c], wc = w[c];
  for (int t0 = 0; t0 < T; t0 += kUnroll) {
    float kt[kUnroll], vt[kUnroll], rt[kUnroll];
    bool live[kUnroll];
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      if (t0 + i < T) {
        const size_t idx = ((size_t)b * T + t0 + i) * C + c;
        kt[i] = k[idx];
        vt[i] = v[idx];
        rt[i] = r[idx];
        live[i] = mask[(size_t)b * T + t0 + i] != 0;
      }
    }
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      if (t0 + i < T) {
        const float ww = uc + kt[i];
        const float q = fmaxf(pp, ww);
        const float e1 = expf(pp - q), e2 = expf(ww - q);
        const float sig = 1.f / (1.f + expf(-rt[i]));
        y[((size_t)b * T + t0 + i) * C + c] = sig * (e1 * aa + e2 * vt[i]) / (e1 * bb + e2);
        const float ww2 = wc + pp;
        const float q2 = fmaxf(ww2, kt[i]);
        const float f1 = expf(ww2 - q2), f2 = expf(kt[i] - q2);
        if (live[i]) {
          aa = f1 * aa + f2 * vt[i];
          bb = f1 * bb + f2;
          pp = q2;
        }
      }
    }
  }
  state_out[s] = aa;
  state_out[s + 1] = bb;
  state_out[s + 2] = pp;
}

}  // namespace

// state f32 [B, C, 3] (aa, bb, pp); k, v, r f32 [B, T, C]; u, w f32 [C];
// mask u8 [B, T] (0 = padded token); y f32 [B, T, C]; state_out f32
// [B, C, 3] (must not alias state). All contiguous. Returns the cudaError_t
// of the launch.
extern "C" int wkv4_scan(const void* state, const void* k, const void* v, const void* r,
                         const void* u, const void* w, const void* mask, void* y,
                         void* state_out, int B, int T, int C, void* stream) {
  if (B <= 0 || B > 65535 || T <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((C + kThreads - 1) / kThreads, B);
  wkv4_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(state), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(r),
      static_cast<const float*>(u), static_cast<const float*>(w),
      static_cast<const uint8_t*>(mask), static_cast<float*>(y),
      static_cast<float*>(state_out), T, C);
  return (int)cudaGetLastError();
}
