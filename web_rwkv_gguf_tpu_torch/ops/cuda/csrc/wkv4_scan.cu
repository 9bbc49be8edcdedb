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
// Every exp is IEEE expf and every division IEEE (no fast math), as the f32
// TPU kernel computes them.
//
// Bound on this card: HBM bytes (k, v, r read and y written once, the state
// read and written once), 0.96 µs at B=4, T=64, C=768. The recurrence is
// sequential in T, and each token costs ~100 instructions (five expf, a
// sigmoid, two divides), so one thread a channel carrying all T tokens (the
// first port: 24 blocks of 4 warps at B=4, 21.02 µs) is bound by one warp's
// issue and by its load rounds, not by bytes.
//
// Design: split each channel's tokens over S warps. The update is
// associative: pp is a running max of k_j + (t - j) w, and aa e^pp, bb e^pp
// are linear in the state. A segment of n live tokens, folded from the empty
// state (0, 0, F32_MIN) into its summary (sa, sb, sp), maps a state
// (aa, bb, pp) to
//   q = max(pp + n w, sp);  aa' = e^(pp + n w - q) aa + e^(sp - q) sa
//   bb' = e^(pp + n w - q) bb + e^(sp - q) sb;  pp' = q
// and a segment with n = 0 is the identity, taken by a select, so padded
// tokens still leave the state bit for bit and an unused lane keeps its
// F32_MIN. A block takes 32 consecutive channels of one lane (each warp reads
// 128-byte rows) and S warps; warp s takes kSeg consecutive tokens of each
// round of S kSeg, issuing all of its k, v, r loads at once into registers:
//   pass 1  each warp but the last folds its live tokens into (sa, sb, sp, n)
//           (the update only: no y, no sigmoid, no divide);
//   combine after one barrier the last warp, which holds the round's incoming
//           state, applies the summaries in order and leaves each warp's
//           incoming state in shared memory (a chain of an FMA and a max per
//           segment; the exps off it); a second barrier;
//   pass 2  each warp replays its tokens from its incoming state, writing y
//           and the update as the first port did. The last warp ends with the
//           round's state, the next round's incoming, and writes it at the
//           chunk's end.
// S and kSeg come from T (wkv4_scan below): one warp at T = 1, the sequential
// form; 8 warps of one token to T = 8; 16 warps of 1, 2, 4 and 8 tokens to
// T = 16, 32, 64 and 128 (96 blocks of 16 warps at B=4, C=768), in rounds
// beyond T = 128. The fewer tokens a warp, the shorter the last warp's chain:
// at B=4, 16 warps of 1 token take 3.57 µs at T = 16 and of 2 tokens 4.31 at
// T = 32, against 4.58 and 4.77 for 16 warps of 4 (H100 80GB HBM3, 700 W).
// Rounding: pp + n w in one fmaf in place of n additions moves pp by a few
// ulp, well inside the tolerance of 1e-4 max|pp| the tests hold it to;
// the sentinel stays exact (F32_MIN + n w rounds back to F32_MIN).
// The mask comes as bytes (a bool tensor read in place), so a call is one
// launch. What is left: each warp's ~100 instructions a token in pass 2 and
// the one round of loads. Measured on an H100 80GB HBM3 at 700 W
// (scripts/torch_kernel_cases.py, each launch on inputs not in L2): 5.33 µs
// at B=4, T=64 (the first port 20.94), 7.76 at B=4, T=128 (39.47), 2.34 at
// B=1, T=1 (4.41). Tried and dropped: 8 warps of 8 tokens at T=64 (5.43)
// and one warp of 8 tokens at T=8 (3.88, against 3.03 for 8 warps of one).

#include <cuda_runtime.h>
#include <stdint.h>

#include <cfloat>

namespace {

constexpr int kLanes = 32;      // channels a block: one warp's row of 128 bytes
constexpr int kMaxWarps = 16;   // segments a round
constexpr float kF32Min = -FLT_MAX;  // pp before a channel's first token

// The V4 update of (aa, bb, pp) by one token, where live.
__device__ __forceinline__ void update(float& aa, float& bb, float& pp, float k, float v,
                                       float w, bool live) {
  const float ww = w + pp;
  const float q = fmaxf(ww, k);
  const float e1 = expf(ww - q), e2 = expf(k - q);
  const float a1 = e1 * aa + e2 * v, b1 = e1 * bb + e2;
  aa = live ? a1 : aa;
  bb = live ? b1 : bb;
  pp = live ? q : pp;
}

// (aa, bb, pp) through a segment of n live tokens summarised as (sa, sb, sp);
// n = 0 leaves it bit for bit.
__device__ __forceinline__ void absorb(float& aa, float& bb, float& pp, float4 seg, float w) {
  const int n = __float_as_int(seg.w);
  const float p1 = fmaf(static_cast<float>(n), w, pp);
  const float q = fmaxf(p1, seg.z);
  const float e1 = expf(p1 - q), e2 = expf(seg.z - q);
  const float a1 = e1 * aa + e2 * seg.x, b1 = e1 * bb + e2 * seg.y;
  aa = n ? a1 : aa;
  bb = n ? b1 : bb;
  pp = n ? q : pp;
}

template <int kSeg, int kWarps>
__global__ void __launch_bounds__(kLanes * kWarps)
wkv4_scan_kernel(const float* __restrict__ state, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ r,
                 const float* __restrict__ u, const float* __restrict__ w,
                 const uint8_t* __restrict__ mask, float* __restrict__ y,
                 float* __restrict__ state_out, int T, int C) {
  static_assert(kWarps <= kMaxWarps, "a round has at most kMaxWarps segments");
  __shared__ float4 s_seg[kWarps > 1 ? kWarps : 1][kLanes];  // (sa, sb, sp, n)
  __shared__ float4 s_in[kWarps > 1 ? kWarps : 1][kLanes];   // each warp's incoming

  const int lane = threadIdx.x & 31;
  const int s = threadIdx.x >> 5;
  const int c = blockIdx.x * kLanes + lane;
  const int b = blockIdx.y;
  const bool on = c < C;  // channels past C take part in the barriers only
  const int cc = on ? c : C - 1;
  const float uc = u[cc], wc = w[cc];
  float aa = 0.f, bb = 0.f, pp = kF32Min;
  const size_t so = ((size_t)b * C + cc) * 3;
  if (s == kWarps - 1) {  // the last warp carries the rounds' state
    aa = state[so];
    bb = state[so + 1];
    pp = state[so + 2];
  }

  for (int t0 = 0; t0 < T; t0 += kWarps * kSeg) {
    const int ts = t0 + s * kSeg;  // this warp's first token
    float kt[kSeg], vt[kSeg], rt[kSeg];
    bool live[kSeg];
#pragma unroll
    for (int i = 0; i < kSeg; ++i) {
      const int t = ts + i;
      live[i] = false;
      kt[i] = vt[i] = rt[i] = 0.f;
      if (t < T) {
        const size_t idx = ((size_t)b * T + t) * C + cc;
        kt[i] = k[idx];
        vt[i] = v[idx];
        rt[i] = r[idx];
        live[i] = mask[(size_t)b * T + t] != 0;
      }
    }

    if (kWarps > 1) {
      if (s < kWarps - 1) {  // pass 1: this segment's summary from the empty state
        float sa = 0.f, sb = 0.f, sp = kF32Min;
        int n = 0;
#pragma unroll
        for (int i = 0; i < kSeg; ++i) {
          update(sa, sb, sp, kt[i], vt[i], wc, live[i]);
          n += live[i];
        }
        s_seg[s][lane] = make_float4(sa, sb, sp, __int_as_float(n));
      }
      __syncthreads();
      if (s == kWarps - 1) {  // combine: each warp's incoming state, in order
#pragma unroll
        for (int j = 0; j < kWarps - 1; ++j) {
          s_in[j][lane] = make_float4(aa, bb, pp, 0.f);
          absorb(aa, bb, pp, s_seg[j][lane], wc);
        }
      }
      __syncthreads();
      if (s < kWarps - 1) {
        const float4 in = s_in[s][lane];
        aa = in.x;
        bb = in.y;
        pp = in.z;
      }
    }

    // pass 2: y and the update, token by token from the incoming state
#pragma unroll
    for (int i = 0; i < kSeg; ++i) {
      const int t = ts + i;
      if (t < T) {
        const float ww = uc + kt[i];
        const float q = fmaxf(pp, ww);
        const float e1 = expf(pp - q), e2 = expf(ww - q);
        const float sig = 1.f / (1.f + expf(-rt[i]));
        if (on) y[((size_t)b * T + t) * C + c] = sig * (e1 * aa + e2 * vt[i]) / (e1 * bb + e2);
      }
      update(aa, bb, pp, kt[i], vt[i], wc, live[i]);
    }
  }
  if (s == kWarps - 1 && on) {
    state_out[so] = aa;
    state_out[so + 1] = bb;
    state_out[so + 2] = pp;
  }
}

template <int kSeg, int kWarps>
cudaError_t launch(const void* state, const void* k, const void* v, const void* r,
                   const void* u, const void* w, const void* mask, void* y, void* state_out,
                   int B, int T, int C, cudaStream_t stream) {
  const dim3 grid((C + kLanes - 1) / kLanes, B);
  wkv4_scan_kernel<kSeg, kWarps><<<grid, kLanes * kWarps, 0, stream>>>(
      static_cast<const float*>(state), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(r),
      static_cast<const float*>(u), static_cast<const float*>(w),
      static_cast<const uint8_t*>(mask), static_cast<float*>(y),
      static_cast<float*>(state_out), T, C);
  return cudaGetLastError();
}

using Launch = cudaError_t (*)(const void*, const void*, const void*, const void*,
                               const void*, const void*, const void*, void*, void*, int, int,
                               int, cudaStream_t);

}  // namespace

// state f32 [B, C, 3] (aa, bb, pp); k, v, r f32 [B, T, C]; u, w f32 [C];
// mask u8 [B, T] (0 = padded token); y f32 [B, T, C]; state_out f32
// [B, C, 3] (must not alias state). All contiguous. Returns the cudaError_t
// of the launch.
extern "C" int wkv4_scan(const void* state, const void* k, const void* v, const void* r,
                         const void* u, const void* w, const void* mask, void* y,
                         void* state_out, int B, int T, int C, void* stream) {
  if (B <= 0 || B > 65535 || T <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  // tokens a warp (kSeg) and warps a block (S): S kSeg covers T up to 128
  Launch fn = launch<8, 16>;
  if (T == 1) fn = launch<1, 1>;
  else if (T <= 8) fn = launch<1, 8>;
  else if (T <= 16) fn = launch<1, 16>;
  else if (T <= 32) fn = launch<2, 16>;
  else if (T <= 64) fn = launch<4, 16>;
  return (int)fn(state, k, v, r, u, w, mask, y, state_out, B, T, C,
                 static_cast<cudaStream_t>(stream));
}
