// Fused RWKV-7 attention core for one decode token (T = 1), Hopper sm_90a.
//
// Replaces: web_rwkv_gguf_tpu/ops/pallas/wkv7.py::att_core7_step (def at
// line 108, pallas_call at line 151; kernel body _att_core7_kernel).
//
// Per (batch lane b, head h), with head size K = V = 64:
//   w  = exp(-0.606531 * sigmoid(w_raw))      decay activation
//   a  = sigmoid(a_raw)                        in-context learning rate
//   kk = l2norm(k_raw * k_k)                   (eps l2_eps)
//   k' = k_raw * (1 + (a - 1) * k_a)           control-k
//   sa = (-kk)^T S;  S' = diag(w) S + k' v^T + (kk * a) sa^T;  y = S'^T r
//   y  = (group_norm_V(y) + (sum r * k' * r_k) * v) * g
// S' is written only where mask[b] != 0 (masked lanes keep S).
//
// Bound on this card: bytes — the 16 KB f32 state of each (b, h) is read
// and written once (32 KB), against 8 flops per state element. Design for
// that: one block of 64 threads per (b, h). Thread t first builds the
// per-key vectors of key row t (w, k', -kk, kk*a, r) into shared memory,
// then owns value column t of the state: it loads the column into
// registers with loads that are coalesced across the block (row i of the
// tile is 256 contiguous bytes), forms sa, S' and y from registers, and
// writes S' back once. Group norm and the bonus are block reductions over
// the 64 threads. A block per (b, h) leaves most SMs idle at B = 1
// (12 heads); splitting columns over more blocks is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHs = 64;  // head size this kernel takes (K = V = 64)

// Sum of v over the block's 64 threads (two warps). red holds two floats.
__device__ __forceinline__ float block_sum64(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  __syncthreads();  // earlier readers of red are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  return red[0] + red[1];
}

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.f / (1.f + expf(-x));
}

__global__ void __launch_bounds__(kHs)
att_core7_kernel(const float* __restrict__ state, const float* __restrict__ r,
                 const float* __restrict__ w_raw,
                 const float* __restrict__ k_raw, const float* __restrict__ v,
                 const float* __restrict__ a_raw, const float* __restrict__ g,
                 const float* __restrict__ k_k, const float* __restrict__ k_a,
                 const float* __restrict__ gn_w, const float* __restrict__ gn_b,
                 const float* __restrict__ r_k, const float* __restrict__ mask,
                 float* __restrict__ y, float* __restrict__ state_out, int H,
                 float eps, float l2_eps) {
  __shared__ float s_w[kHs], s_k[kHs], s_a[kHs], s_b[kHs], s_r[kHs];
  __shared__ float red[2];

  const int bh = blockIdx.x;  // b * H + h
  const int h = bh % H;
  const int b = bh / H;
  const int t = threadIdx.x;
  const size_t vec = (size_t)bh * kHs + t;  // [B, H, 64] vectors
  const int par = h * kHs + t;              // [H, 64] parameters

  // per-key vectors, key row t
  const float kraw = k_raw[vec];
  const float kkr = kraw * k_k[par];
  const float kk = kkr * rsqrtf(block_sum64(kkr * kkr, red) + l2_eps);
  const float a2 = sigmoid_f32(a_raw[vec]);
  const float k2 = kraw * (1.f + (a2 - 1.f) * k_a[par]);
  const float rr = r[vec];
  s_w[t] = expf(-0.606531f * sigmoid_f32(w_raw[vec]));
  s_k[t] = k2;
  s_a[t] = -kk;
  s_b[t] = kk * a2;
  s_r[t] = rr;
  // bonus scalar sum_k r * k' * r_k (its __syncthreads also publishes s_*)
  const float sb = block_sum64(rr * k2 * r_k[par], red);

  // value column t of the state
  const float* S = state + (size_t)bh * kHs * kHs;
  float col[kHs];
  float sa = 0.f;
#pragma unroll
  for (int i = 0; i < kHs; ++i) {
    col[i] = S[i * kHs + t];
    sa += s_a[i] * col[i];
  }
  const float vt = v[vec];
  const bool keep = mask[b] == 0.f;
  float* So = state_out + (size_t)bh * kHs * kHs;
  float y0 = 0.f;
#pragma unroll
  for (int i = 0; i < kHs; ++i) {
    const float sn = s_w[i] * col[i] + s_k[i] * vt + s_b[i] * sa;
    y0 += s_r[i] * sn;
    So[i * kHs + t] = keep ? col[i] : sn;
  }

  // group norm over the head's 64 values (two-pass mean / variance)
  const float mu = block_sum64(y0, red) * (1.f / kHs);
  const float dv = y0 - mu;
  const float var = block_sum64(dv * dv, red) * (1.f / kHs);
  const float yn = dv * rsqrtf(var + eps) * gn_w[par] + gn_b[par];
  y[vec] = (yn + sb * vt) * g[vec];
}

}  // namespace

// state f32 [B, H, 64, 64]; r, w_raw, k_raw, a_raw f32 [B, H, 64]; v, g f32
// [B, H, 64]; k_k, k_a, r_k, gn_w, gn_b f32 [H, 64]; mask f32 [B] (0 or 1);
// y f32 [B, H, 64]; state_out f32 [B, H, 64, 64] (must not alias state).
// Returns the cudaError_t of the launch.
extern "C" int att_core7(const void* state, const void* r, const void* w_raw,
                         const void* k_raw, const void* v, const void* a_raw,
                         const void* g, const void* k_k, const void* k_a,
                         const void* gn_w, const void* gn_b, const void* r_k,
                         const void* mask, void* y, void* state_out, int B,
                         int H, int hs, float eps, float l2_eps,
                         void* stream) {
  if (hs != kHs || B <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  att_core7_kernel<<<B * H, kHs, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(state), static_cast<const float*>(r),
      static_cast<const float*>(w_raw), static_cast<const float*>(k_raw),
      static_cast<const float*>(v), static_cast<const float*>(a_raw),
      static_cast<const float*>(g), static_cast<const float*>(k_k),
      static_cast<const float*>(k_a), static_cast<const float*>(gn_w),
      static_cast<const float*>(gn_b), static_cast<const float*>(r_k),
      static_cast<const float*>(mask), static_cast<float*>(y),
      static_cast<float*>(state_out), H, eps, l2_eps);
  return (int)cudaGetLastError();
}
