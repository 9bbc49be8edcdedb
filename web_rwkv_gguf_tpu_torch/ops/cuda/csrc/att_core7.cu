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
// S' is written only where mask[b] != 0 (masked lanes keep S, bit for bit).
// Every exp is IEEE expf and every division IEEE; the group norm is two-pass
// (mean, then variance), as the JAX kernel computes it.
//
// Bound on this card: bytes — the 16 KB f32 state of each (b, h) is read and
// written once (32 KB), against 8 flops per state element: 0.13 µs at B=1,
// H=12. At that size the time is a chain of latencies, not bytes: the first
// port (one block of 64 threads a (b, h), 6.07 µs at B=1) read the state
// only after two block reductions over the inputs (the kk norm, the bonus),
// then ran two 64-long FMA chains (sa, y) a thread and 64 scalar stores.
//
// Design: one block of 256 threads a (b, h). Thread (warp wi, lane l) holds
// keys 4 kg .. 4 kg + 3 (kg = 2 wi + l / 16) of values 4 vq .. 4 vq + 3
// (vq = l % 16): a 4 x 4 tile of the state, read at entry by four 16-byte
// loads, a half-warp's load one whole 256-byte row, together with every
// input the thread needs (16-byte loads of its keys' r, w_raw, k_raw,
// a_raw, k_k, k_a, r_k and of its values' v), so the state read and the
// input read overlap. Each thread forms its keys' k' and k_raw k_k, and
// half of their a and w, which it swaps with the lane holding the same
// keys. Every sum over the head's keys then comes from those and the tile
// at once: the kk norm, the bonus, sa before the norm (sa = inv
// (-k_raw k_k)^T S), and y split as (w r)^T S + (r . k') v + (r . kk a) sa;
// one shuffle adds a warp's two key groups and one exchange through shared
// memory (the only barrier) its 8 warps, in place of two block reductions
// and two 64-long chains. S' goes out by four 16-byte stores, whole rows
// again; warp 0, whose half-warps each hold all 64 values of y, takes the
// group norm (both passes by shuffles) and the gate. The mask comes as
// bytes (a bool tensor read in place), so a call is one launch.
// Measured on an H100 80GB HBM3 at 700 W (scripts/torch_kernel_cases.py,
// each launch on inputs not in L2): 3.31 µs at B=1, H=12 (the first port
// 6.08), 3.55 at B=4, 5.43 at B=16. The state's access pattern decides
// most of it: read and written with no arithmetic, it took 3.72 µs at B=1
// with a warp's load over 16 rows of 32 bytes (this kernel's first layout,
// which then took 3.89) and 2.5-2.9 with a half-warp's load one whole row.
// Tried and dropped: the activations once a block through shared memory
// (a barrier more), each of a half-warp's 8 activations formed by one lane
// and swapped by shuffles (0.4 µs slower at B=1), and each head over a
// cluster of two blocks with the group norm's sums swapped through
// distributed shared memory (two cluster barriers: 0.6 µs slower at B=1).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHs = 64;        // head size this kernel takes (K = V = 64)
constexpr int kThreads = 256;  // 16 key groups x 16 value quads
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float at(const float4& x, int i) {
  return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
}

__global__ void __launch_bounds__(kThreads)
att_core7_kernel(const float* __restrict__ state, const float* __restrict__ r,
                 const float* __restrict__ w_raw,
                 const float* __restrict__ k_raw, const float* __restrict__ v,
                 const float* __restrict__ a_raw, const float* __restrict__ g,
                 const float* __restrict__ k_k, const float* __restrict__ k_a,
                 const float* __restrict__ gn_w, const float* __restrict__ gn_b,
                 const float* __restrict__ r_k, const uint8_t* __restrict__ mask,
                 float* __restrict__ y, float* __restrict__ state_out, int H,
                 float eps, float l2_eps) {
  // each warp's sums over its 8 keys: sa before the norm and (w r)^T S by
  // value quad, and (the kk norm, the bonus, r . k', r . kk a)
  __shared__ float4 s_sa[kWarps][16], s_wr[kWarps][16], s_sc[kWarps];

  const int bh = blockIdx.x;  // b * H + h
  const int h = bh % H;
  const int b = bh / H;
  const int wi = threadIdx.x >> 5, l = threadIdx.x & 31;
  const int kg = 2 * wi + (l >> 4);  // keys 4 kg .. 4 kg + 3
  const int vq = l & 15;             // values 4 vq .. 4 vq + 3
  const size_t vec = (size_t)bh * kHs;  // [B, H, 64] vectors
  const int par = h * kHs;              // [H, 64] parameters

  // the state tile first, then every input, all in flight together
  const float* S = state + vec * kHs + (size_t)(4 * kg) * kHs + 4 * vq;
  float4 st[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) st[i] = ld4(S + i * kHs);
  const float4 rr = ld4(r + vec + 4 * kg), wr = ld4(w_raw + vec + 4 * kg);
  const float4 kr = ld4(k_raw + vec + 4 * kg), ar = ld4(a_raw + vec + 4 * kg);
  const float4 kkp = ld4(k_k + par + 4 * kg), kap = ld4(k_a + par + 4 * kg);
  const float4 rkp = ld4(r_k + par + 4 * kg);
  const float4 vv = ld4(v + vec + 4 * vq);
  const bool keep = mask[b] == 0;
  float4 gg = {}, nw = {}, nb = {};
  if (wi == 0) {  // the group norm's and the gate's operands
    gg = ld4(g + vec + 4 * vq);
    nw = ld4(gn_w + par + 4 * vq);
    nb = ld4(gn_b + par + 4 * vq);
  }

  // this thread's keys: a and w, which lanes l and l ^ 1 (the same keys)
  // form two keys each of and swap; k' and kk before its norm
  float kkr[4], wk[4], k2[4], a2[4];
  {
    const bool odd = l & 1;
    float a[2], w[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      a[i] = sigmoid_f32(at(ar, 2 * odd + i));
      w[i] = expf(-0.606531f * sigmoid_f32(at(wr, 2 * odd + i)));
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float ao = __shfl_xor_sync(0xffffffffu, a[i], 1);
      const float wo = __shfl_xor_sync(0xffffffffu, w[i], 1);
      a2[i] = odd ? ao : a[i];
      a2[2 + i] = odd ? a[i] : ao;
      wk[i] = odd ? wo : w[i];
      wk[2 + i] = odd ? w[i] : wo;
    }
  }

  // Every sum over the head's keys is formed from these and the tile at
  // once: the kk norm, the bonus, sa before the norm, and y = S'^T r split
  // as (w r)^T S + (r . k') v + (r . kk a) sa. A shuffle adds the warp's
  // two key groups, one exchange through shared memory its 8 warps.
  float ss = 0.f, bonus = 0.f, c1 = 0.f, c2 = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    kkr[i] = at(kr, i) * at(kkp, i);
    k2[i] = at(kr, i) * (1.f + (a2[i] - 1.f) * at(kap, i));
    ss += kkr[i] * kkr[i];
    bonus += at(rr, i) * k2[i] * at(rkp, i);
    c1 += at(rr, i) * k2[i];
    c2 += at(rr, i) * kkr[i] * a2[i];
  }
  float sa[4], y0[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    sa[j] = 0.f;
    y0[j] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      sa[j] -= kkr[i] * at(st[i], j);
      y0[j] += at(rr, i) * wk[i] * at(st[i], j);
    }
    sa[j] += __shfl_xor_sync(0xffffffffu, sa[j], 16);
    y0[j] += __shfl_xor_sync(0xffffffffu, y0[j], 16);
  }
  ss += __shfl_xor_sync(0xffffffffu, ss, 16);
  bonus += __shfl_xor_sync(0xffffffffu, bonus, 16);
  c1 += __shfl_xor_sync(0xffffffffu, c1, 16);
  c2 += __shfl_xor_sync(0xffffffffu, c2, 16);
  if (l < 16) {
    s_sa[wi][vq] = make_float4(sa[0], sa[1], sa[2], sa[3]);
    s_wr[wi][vq] = make_float4(y0[0], y0[1], y0[2], y0[3]);
  }
  if (l == 0) s_sc[wi] = make_float4(ss, bonus, c1, c2);
  __syncthreads();
  float4 sc = s_sc[0], sat = s_sa[0][vq], wrt = s_wr[0][vq];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    const float4 c = s_sc[w], p = s_sa[w][vq], q = s_wr[w][vq];
    sc.x += c.x, sc.y += c.y, sc.z += c.z, sc.w += c.w;
    sat.x += p.x, sat.y += p.y, sat.z += p.z, sat.w += p.w;
    wrt.x += q.x, wrt.y += q.y, wrt.z += q.z, wrt.w += q.w;
  }
  bonus = sc.y;
  const float inv = rsqrtf(sc.x + l2_eps);  // kk = (k_raw k_k) inv
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    sa[j] = at(sat, j) * inv;
    y0[j] = at(wrt, j) + sc.z * at(vv, j) + sc.w * inv * sa[j];
  }

  // S' = diag(w) S + k' v^T + (kk a) sa^T, four 16-byte stores (a
  // half-warp's store is one 256-byte row)
  float* So = state_out + vec * kHs + (size_t)(4 * kg) * kHs + 4 * vq;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float bk = kkr[i] * inv * a2[i];
    float sn[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) sn[j] = wk[i] * at(st[i], j) + k2[i] * at(vv, j) + bk * sa[j];
    *reinterpret_cast<float4*>(So + i * kHs) =
        keep ? st[i] : make_float4(sn[0], sn[1], sn[2], sn[3]);
  }
  if (wi != 0) return;

  // group norm over the head's 64 values (two-pass mean / variance) by warp
  // 0: each half-warp holds all 64, four a lane
  float part = y0[0] + y0[1] + y0[2] + y0[3];
#pragma unroll
  for (int off = 1; off < 16; off <<= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
  const float mu = part * (1.f / kHs);
  part = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    y0[j] -= mu;
    part += y0[j] * y0[j];
  }
#pragma unroll
  for (int off = 1; off < 16; off <<= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
  const float rs = rsqrtf(part * (1.f / kHs) + eps);
  float o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    o[j] = (y0[j] * rs * at(nw, j) + at(nb, j) + bonus * at(vv, j)) * at(gg, j);
  if (l < 16) *reinterpret_cast<float4*>(y + vec + 4 * vq) = make_float4(o[0], o[1], o[2], o[3]);
}

}  // namespace

// state f32 [B, H, 64, 64]; r, w_raw, k_raw, a_raw f32 [B, H, 64]; v, g f32
// [B, H, 64]; k_k, k_a, r_k, gn_w, gn_b f32 [H, 64]; mask u8 [B] (0 = masked);
// y f32 [B, H, 64]; state_out f32 [B, H, 64, 64] (must not alias state).
// Every array contiguous and 16-byte aligned (the kernel reads and writes
// 16 bytes at a time). Returns the cudaError_t of the launch.
extern "C" int att_core7(const void* state, const void* r, const void* w_raw,
                         const void* k_raw, const void* v, const void* a_raw,
                         const void* g, const void* k_k, const void* k_a,
                         const void* gn_w, const void* gn_b, const void* r_k,
                         const void* mask, void* y, void* state_out, int B,
                         int H, int hs, float eps, float l2_eps,
                         void* stream) {
  if (hs != kHs || B <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  att_core7_kernel<<<B * H, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(state), static_cast<const float*>(r),
      static_cast<const float*>(w_raw), static_cast<const float*>(k_raw),
      static_cast<const float*>(v), static_cast<const float*>(a_raw),
      static_cast<const float*>(g), static_cast<const float*>(k_k),
      static_cast<const float*>(k_a), static_cast<const float*>(gn_w),
      static_cast<const float*>(gn_b), static_cast<const float*>(r_k),
      static_cast<const uint8_t*>(mask), static_cast<float*>(y),
      static_cast<float*>(state_out), H, eps, l2_eps);
  return (int)cudaGetLastError();
}
