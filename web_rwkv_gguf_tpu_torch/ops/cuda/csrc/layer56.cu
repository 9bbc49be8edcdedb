// Whole-stack RWKV-6, -5 and -4 decode step (T = 1) as ONE kernel launch,
// Hopper sm_90a.
//
// Replaces: web_rwkv_gguf_tpu/ops/pallas/layer56.py::layer_scan56 (def at line
// 445, pallas_call at line 548; kernel body _layer_scan56_kernel at 64-283),
// with each of its static versions 6, 5 and 4 (the template parameter V).
//
// Version 6. Per layer l, for B <= 16 lanes (the residual x [B, C] is
// carried in place; Q(.) is a gemv of the bf16-rounded input (Q4_K, Q5_K,
// Q2_K, Q6_K, Q3_K, an f32-scale byte or nibble form or dense bf16, picked per
// matrix slot at run time; decode_common.cuh), bf(.) a
// bf16 adapter product with f32 sums):
//   xx = LN1(x); sx = xx + mix_x (sh - xx)
//   z = bf16(tanh(bf(tm_w1 sx)));  mix_s = bf(tm_w2[s] z_s) + time_mix[s]
//   w, k, v, r, g inputs: xx + mix_s (sh - xx)
//   r, k, v, g = Q(.);  w = exp(-exp(bf(td_w2 bf16(tanh(bf(td_w1 wx)))) + decay))
//   per head: y = S^T r + (sum r u k) v;  S <- diag(w) S + k v^T
//   y = GroupNorm(y) * silu(g);  x += Q(Wo y)
//   xx2 = LN2(x); x += sigmoid(Q(Wr (xx2 + mix_r (fsh - xx2)))) *
//                    Q(Wv relu(Q(Wk (xx2 + mix_k (fsh - xx2))))^2)
//   x *= 0.5 every `rescale` layers (counted from first_layer, the global
//   index of the launch's first layer, so a slice of the stack stays aligned).
// The mixes are reversed (xx + m (prev - xx)), as V6 and V7 define them. The
// states are written as the JAX kernel's blend S + m (S_new - S), in the form
// m S_new + (1 - m) S, which gives S_new or S exactly for a mask of 1 or 0.
//
// Numerics are the class of the JAX kernel at its default settings: every
// quantized matrix multiplies the bf16-rounded input by the exact f32 weight
// (the gemv class of q4k_gemv.cu, qkb_gemv.cu, q6k_gemv.cu and qs_gemv.cu, at
// every B), a dense one by its bf16 weight with f32 sums, the
// four adapters take bf16 operands and accumulate in f32 (their tanh outputs
// rounded to bf16 before the up product), everything else is f32 with IEEE
// expf (no fast math: StableExp and the group norm stay exact to f32).
//
// Version 5 is version 6 without the adapters: the four inputs are static
// mixes sh + mix_s (xx - sh) (not reversed), the decay w is static per
// channel (activated at load), the FFN shifts are not reversed either:
//   r, k, v, g = Q(sh + mix (xx - sh));  per head the same WKV, group norm
//   and silu(g) gate;  x += Q(Wo y);
//   xx2 = LN2(x); x += sigmoid(Q(Wr (fsh + mix_r (xx2 - fsh)))) *
//                    Q(Wv relu(Q(Wk (fsh + mix_k (xx2 - fsh))))^2)
// Version 4 has one per-channel state (aa, bb, pp) in place of the heads,
// no gate and no group norm:
//   r, k, v = Q(sh + mix (xx - sh));  q = max(pp, u + k);
//   y = sigmoid(r) (e^{pp-q} aa + e^{u+k-q} v) / (e^{pp-q} bb + e^{u+k-q});
//   q' = max(w + pp, k);  aa <- e^{w+pp-q'} aa + e^{k-q'} v;
//   bb <- e^{w+pp-q'} bb + e^{k-q'};  pp <- q'   (w = -exp(decay));
//   x += Q(Wo y); the FFN of version 5.
// Version 4's state is written by a select (new or old), as the JAX kernel
// writes it: pp holds the F32_MIN sentinel, next to which a blend
// S + m (S_new - S) would round S_new away.
//
// Bound on this card: the weights are read once per token (8 matrices, in
// Q4_K ~30.7 MB per layer at the 1.6B widths, plus 0.9 MB of bf16 adapters) and
// the WKV state is read and written once (B * 1 MB per layer), so the step
// is bound by HBM bytes; its dependency chain has seven phases per layer.
//
// Design, after layer7.cu: the TPU kernel is a sequential grid over layers
// with the residual in VMEM; a GPU has no sequential grid, so this is one
// cooperative launch of a persistent grid (every block resident, one or two
// per SM) that walks the layers itself and separates the seven dependent
// phases of a layer with a grid-wide barrier (grid.sync):
//   1. LN1 (every block, all lanes, into shared memory); sx; the time-mix
//      down-projection tm_w1 (5R rows) and tanh -> z;
//   2. the five mixes, one (mix, channel) item per thread -> the five
//      inputs, bf16 in global scratch (no block could hold all of them);
//   3. Wr, Wk, Wv, Wg (one warp per row, all lanes per decoded
//      weight), each over its input staged in shared memory in turn; the
//      decay down-projection td_w1 and tanh -> dz;
//   4. per (lane, head), one block of 256 threads, four per channel: the
//      decay up-projection, StableExp, the WKV step with a quarter of value
//      column t of the state in registers, the group norm and the gate;
//   5. Wo and the residual add;
//   6. LN2 and the FFN shifts, the FFN key with relu^2 and the FFN
//      receptance, their inputs staged in turn;
//   7. the FFN value, x += sigmoid(rf) * vf, and the rescale.
// Versions 5 and 4 need fewer phases (their mixes are static, so each block
// can form a mixed input from LN1 and the shift state alone):
//   1. LN1, the static mixes and the projections r, k, v (and g), each
//      input staged in shared memory in turn. Version 4 then runs the WKV
//      step of channel m in the warp that computed row m of all three: the
//      rows of a projection go to warps by (block, warp) alone, so that warp
//      owns row m in each pass, and reads back its own r and k;
//   2. (version 5) per (lane, head), the attention of phase 4 above with the
//      static decay, the group norm and the gate;
//   then Wo, LN2 with the FFN key and receptance, and the FFN value, as
//   phases 5-7 above: five phases per layer for version 5, four for 4.
// Each phase asks L2 to prefetch what a later phase reads from device memory.
// Data produced inside the launch is read with ld.global.cg (L2, never a
// stale L1 line); weights and parameters are read-only and may use L1. What
// this leaves on the table (later work): seven barriers per layer (168 per
// step at L = 24), phases 1 and 2 that keep most of the grid idle, the
// attention phase on B * H blocks, and gemv rows that are one warp's
// latency-bound walk.

#include <cooperative_groups.h>

#include "decode_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kHs = 64;                 // head size the attention phase takes
constexpr int kParts = kThreads / kHs;  // threads per value column in phase 4
// rows of the mixed-input scratch [5, B, C]: the order of time_mix
constexpr int kInW = 0, kInK = 1, kInV = 2, kInR = 3, kInG = 4;

struct Args {
  const float *ln1_w, *ln1_b, *ln2_w, *ln2_b;  // [L, C]
  // [L, C]; decay: raw (V6), exp(-exp(raw)) (V5) or -exp(raw) (V4); first:
  // time_first ([L, H, 64] for V6 and V5); mix_x: V6 only
  const float *mix_x, *decay, *first;
  const float *gn_w, *gn_b, *ffn_mk, *ffn_mr;   // [L, C]
  const float* time_mix;                        // [L, 5, C]: w, k, v, r, g (V6)
  const __nv_bfloat16* tm_w1;                   // [L, 5R, C] (V6)
  const __nv_bfloat16* tm_w2;                   // [L, 5, C, R] (V6)
  const __nv_bfloat16* td_w1;                   // [L, D, C] (V6)
  const __nv_bfloat16* td_w2;                   // [L, C, D] (V6)
  QMat wr, wk, wv, wg, wo, fk, fv, fr;           // no wg for V4
  const float *ash_in, *fsh_in, *wkv_in;        // [L, B, C] x2, [L, B, H, 64, 64] (V6, V5)
  float *ash_out, *fsh_out, *wkv_out;
  const float* mask;                            // [B], 0 or 1
  float* x;                                     // [B, C], in and out
  float* xx;                                    // [B, C] scratch: LN1(x)
  __nv_bfloat16* z;                             // [B, 5R] scratch
  __nv_bfloat16* mixed;                         // [5, B, C] scratch
  float* rkvg;                                  // [4, B, C] scratch: r, k, v, g
  __nv_bfloat16* dz;                            // [B, D] scratch
  __nv_bfloat16* y;                             // [B, C] scratch
  __nv_bfloat16* khid;                          // [B, hidden] scratch
  float* rf;                                    // [B, C] scratch: FFN receptance
  unsigned long long* phase_ns;                 // [1 + P L] or null: trace
  const float *mix_k, *mix_v, *mix_r, *mix_g;   // [L, C] static mixes (V5, V4; no g in V4)
  const float *aa_in, *bb_in, *pp_in;           // [L, B, C] (V4)
  float *aa_out, *bb_out, *pp_out;
  int L, B, C, H, hidden, R, D, rescale, first_layer;
  float eps_ln, eps_gn;
};

// m * new + (1 - m) * old: the state blend, exact at m = 0 and m = 1
__device__ __forceinline__ float blend(float m, float nw, float old) {
  return m * nw + (1.f - m) * old;
}

// Phase 1: LN1, the att shift state and xx (block 0 writes them), sx into
// shared memory as bf16; then the time-mix down-projection and tanh -> z.
template <int NB>
__device__ void phase_shift(const Args& a, int l, unsigned char* smem) {
  const int C = a.C, B = a.B, R5 = 5 * a.R;
  prefetch_l2(a.tm_w2 + (size_t)l * 5 * C * a.R, (size_t)5 * C * a.R * 2);  // phase 2
  prefetch_l2(a.td_w1 + (size_t)l * a.D * C, (size_t)a.D * C * 2);          // phase 3
  prefetch_mat(a.wr, l, C, C);
  prefetch_mat(a.wk, l, C, C);
  prefetch_mat(a.wv, l, C, C);
  prefetch_mat(a.wg, l, C, C);
  float* rows = reinterpret_cast<float*>(smem);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + (size_t)B * C * 4);
  layer_norm_rows(a.x, B, C, a.eps_ln, a.ln1_w + (size_t)l * C, a.ln1_b + (size_t)l * C,
                  rows);
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const float mx = __ldg(a.mix_x + (size_t)l * C + c);
    float sh[NB];
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      sh[b] = b < B ? __ldg(a.ash_in + ((size_t)l * B + b) * C + c) : 0.f;
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      if (b < B) {
        const size_t i = (size_t)b * C + c;
        const float xx = rows[i];
        if (blockIdx.x == 0) {
          a.xx[i] = xx;
          a.ash_out[(size_t)l * B * C + i] = blend(a.mask[b], xx, sh[b]);
        }
        xs[i] = __float2bfloat16_rn(xx + mx * (sh[b] - xx));
      }
    }
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float acc[NB];
  for (int j = blockIdx.x * kWarps + warp; j < R5; j += gridDim.x * kWarps) {
    bf16_row<NB>(a.tm_w1 + ((size_t)l * R5 + j) * C, C, xs, B, acc);
    if (lane == 0) {
      for (int t = 0; t < B; ++t) a.z[(size_t)t * R5 + j] = __float2bfloat16_rn(tanhf(acc[t]));
    }
  }
}

// Phase 2: per (mix s, channel c) item, every lane: mix_s = tm_w2[s][c] . z_s
// + time_mix[s][c], then the mixed input xx + mix_s (sh - xx) as bf16.
template <int NB>
__device__ void phase_mix(const Args& a, int l, float* smem) {
  const int C = a.C, B = a.B, R = a.R, R5 = 5 * R;
  float* s_z = smem;  // [B, 5R]
  for (int i = threadIdx.x; i < B * R5; i += blockDim.x) {
    s_z[i] = __bfloat162float(__ldcg(a.z + i));
  }
  __syncthreads();
  for (int item = blockIdx.x * blockDim.x + threadIdx.x; item < 5 * C;
       item += gridDim.x * blockDim.x) {
    const int s = item / C, c = item - s * C;
    const size_t sc = ((size_t)l * 5 + s) * C + c;
    const uint4* w2 = reinterpret_cast<const uint4*>(a.tm_w2 + sc * R);
    float acc[NB];
#pragma unroll
    for (int b = 0; b < NB; ++b) acc[b] = 0.f;
    for (int q = 0; q < R / 8; ++q) {
      float w8[8];
      bf16x8(__ldg(w2 + q), w8);
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        if (b < B) {
          const float* zb = s_z + (size_t)b * R5 + s * R + 8 * q;
          float p = 0.f;
#pragma unroll
          for (int e = 0; e < 8; ++e) p += w8[e] * zb[e];
          acc[b] += p;
        }
      }
    }
    const float tm = __ldg(a.time_mix + sc);
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      if (b < B) {
        const size_t i = (size_t)b * C + c;
        const float xx = __ldcg(a.xx + i);
        const float sh = __ldg(a.ash_in + (size_t)l * B * C + i);
        const float mix = acc[b] + tm;
        a.mixed[(size_t)s * B * C + i] = __float2bfloat16_rn(xx + mix * (sh - xx));
      }
    }
  }
}

// Phase 3: r, k, v, g over their inputs, staged in turn; then the
// decay down-projection over the w input, tanh -> dz.
template <int NB>
__device__ void phase_proj(const Args& a, int l, __nv_bfloat16* xs) {
  const int C = a.C, B = a.B, D = a.D, H = a.H;
  // for phase 4: the decay up-projection and the WKV state; for phase 5: Wo
  prefetch_l2(a.td_w2 + (size_t)l * C * D, (size_t)C * D * 2);
  prefetch_l2(a.wkv_in + (size_t)l * B * H * kHs * kHs, (size_t)B * H * kHs * kHs * 4);
  prefetch_mat(a.wo, l, C, C);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float acc[NB];
  for (int j = 0; j < 4; ++j) {  // r, k, v, g
    const QMat& w = j == 0 ? a.wr : (j == 1 ? a.wk : (j == 2 ? a.wv : a.wg));
    const int in = j == 0 ? kInR : (j == 1 ? kInK : (j == 2 ? kInV : kInG));
    __syncthreads();  // the previous input's readers are done
    stage(xs, a.mixed + (size_t)in * B * C, B * C);
    for (int m = blockIdx.x * kWarps + warp; m < C; m += gridDim.x * kWarps) {
      mat_row<NB>(w, l, C, m, C, xs, B, acc);
      if (lane == 0) {
        for (int t = 0; t < B; ++t) a.rkvg[((size_t)j * B + t) * C + m] = acc[t];
      }
    }
  }
  __syncthreads();
  stage(xs, a.mixed + (size_t)kInW * B * C, B * C);
  for (int j = blockIdx.x * kWarps + warp; j < D; j += gridDim.x * kWarps) {
    bf16_row<NB>(a.td_w1 + ((size_t)l * D + j) * C, C, xs, B, acc);
    if (lane == 0) {
      for (int t = 0; t < B; ++t) a.dz[(size_t)t * D + j] = __float2bfloat16_rn(tanhf(acc[t]));
    }
  }
}

// Phase 4: one (lane, head) item per block at a time. Thread (part, t) =
// (threadIdx.x / 64, threadIdx.x % 64) serves channel / value column t of
// the head with a quarter of the work: decay-rank chunks part, part + 4, ...
// and the key rows [16 part, 16 part + 16) of the state; shared memory sums
// the four quarters.
template <int V>
__device__ void phase_att(const Args& a, int l, float* smem) {
  const int C = a.C, B = a.B, H = a.H, D = V == 6 ? a.D : 0;
  prefetch_mat(a.fk, l, a.hidden, C);  // for phases 6 and 7
  prefetch_mat(a.fr, l, C, C);
  prefetch_mat(a.fv, l, C, a.hidden);
  const int part = threadIdx.x / kHs, t = threadIdx.x % kHs;
  float* red = smem;             // kWarps
  float* s_dz = red + kWarps;    // D
  float* s_r = s_dz + D;         // per key row: r, k, w, u
  float* s_k = s_r + kHs;
  float* s_w = s_k + kHs;
  float* s_u = s_w + kHs;
  float* s_part = s_u + kHs;     // [kParts][kHs]: partial sums
  for (int item = blockIdx.x; item < B * H; item += gridDim.x) {
    const int b = item / H, h = item % H;
    const int c = h * kHs + t;  // this thread's channel
    const size_t lc = (size_t)l * C + c;
    const size_t bc = (size_t)b * C + c;
    if constexpr (V == 6) {
      for (int j = threadIdx.x; j < D; j += kThreads) {
        s_dz[j] = __bfloat162float(__ldcg(a.dz + (size_t)b * D + j));
      }
      __syncthreads();
      {  // a quarter of channel c's decay up-projection, 8 bf16 per load
        const uint4* w8p = reinterpret_cast<const uint4*>(a.td_w2 + lc * D);
        float p = 0.f;
        for (int q = part; q < D / 8; q += kParts) {
          float w8[8];
          bf16x8(__ldg(w8p + q), w8);
#pragma unroll
          for (int e = 0; e < 8; ++e) p += w8[e] * s_dz[8 * q + e];
        }
        s_part[part * kHs + t] = p;
      }
      __syncthreads();
    }
    if (part == 0) {
      if constexpr (V == 6) {
        const float up = s_part[t] + s_part[kHs + t] + s_part[2 * kHs + t] + s_part[3 * kHs + t];
        s_w[t] = expf(-expf(up + a.decay[lc]));  // StableExp
      } else {
        s_w[t] = a.decay[lc];  // activated at load
      }
      s_r[t] = __ldcg(a.rkvg + bc);
      s_k[t] = __ldcg(a.rkvg + (size_t)B * C + bc);
      s_u[t] = a.first[lc];
    }
    __syncthreads();
    const float v = __ldcg(a.rkvg + 2 * (size_t)B * C + bc);
    const float m = a.mask[b];
    const size_t soff = ((((size_t)l * B + b) * H + h) * kHs) * kHs;
    const int row0 = part * (kHs / kParts);
    float yp = 0.f;
#pragma unroll
    for (int i = 0; i < kHs / kParts; ++i) {
      const int row = row0 + i;
      const float S = __ldg(a.wkv_in + soff + (size_t)row * kHs + t);
      const float kv = s_k[row] * v;
      yp += s_r[row] * (s_u[row] * kv + S);
      a.wkv_out[soff + (size_t)row * kHs + t] = blend(m, s_w[row] * S + kv, S);
    }
    s_part[part * kHs + t] = yp;
    __syncthreads();
    const float y0 = s_part[t] + s_part[kHs + t] + s_part[2 * kHs + t] + s_part[3 * kHs + t];
    const float mu = block_sum(part == 0 ? y0 : 0.f, red) * (1.f / kHs);
    const float dv = y0 - mu;
    const float var = block_sum(part == 0 ? dv * dv : 0.f, red) * (1.f / kHs);
    if (part == 0) {
      const float yn = dv * rsqrtf(var + a.eps_gn) * a.gn_w[lc] + a.gn_b[lc];
      const float g = __ldcg(a.rkvg + 3 * (size_t)B * C + bc);
      a.y[bc] = __float2bfloat16_rn(yn * (g * sigmoid_f32(g)));
    }
    __syncthreads();  // shared memory is rewritten by the next item
  }
}

// Version 4's WKV step of channel m for every lane, run by lane 0 of the warp
// that computed row m of r, k (in rkvg, written by this thread) and v (acc).
template <int NB>
__device__ void wkv4_row(const Args& a, int l, int m, const float* acc) {
  const int C = a.C, B = a.B;
  const float u = __ldg(a.first + (size_t)l * C + m);
  const float w = __ldg(a.decay + (size_t)l * C + m);
#pragma unroll
  for (int t = 0; t < NB; ++t) {
    if (t < B) {
      const size_t bc = (size_t)t * C + m, st = ((size_t)l * B + t) * C + m;
      const float r = __ldcg(a.rkvg + bc), k = __ldcg(a.rkvg + (size_t)B * C + bc);
      const float v = acc[t];
      const float aa = __ldg(a.aa_in + st), bb = __ldg(a.bb_in + st), pp = __ldg(a.pp_in + st);
      const float ww = u + k;
      const float q = fmaxf(pp, ww);
      const float e1 = expf(pp - q), e2 = expf(ww - q);
      a.y[bc] = __float2bfloat16_rn(sigmoid_f32(r) * (e1 * aa + e2 * v) / (e1 * bb + e2));
      const float ww2 = w + pp;
      const float q2 = fmaxf(ww2, k);
      const float f1 = expf(ww2 - q2), f2 = expf(k - q2);
      const bool live = a.mask[t] > 0.f;  // a select: pp may hold F32_MIN
      a.aa_out[st] = live ? f1 * aa + f2 * v : aa;
      a.bb_out[st] = live ? f1 * bb + f2 : bb;
      a.pp_out[st] = live ? q2 : pp;
    }
  }
}

// Phase 1 of versions 5 and 4: LN1 and the att shift state (block 0 writes
// it); then per projection (r, k, v, and g for V5) its static mix
// sh + mix (xx - sh) staged in shared memory as bf16 and its matrix rows. In
// version 4 the v pass ends with the WKV step of each row (wkv4_row).
template <int V, int NB>
__device__ void phase_static_proj(const Args& a, int l, unsigned char* smem) {
  const int C = a.C, B = a.B;
  constexpr int kProj = V == 4 ? 3 : 4;
  if constexpr (V == 5) {  // for phase 2
    prefetch_l2(a.wkv_in + (size_t)l * B * C * kHs, (size_t)B * C * kHs * 4);
  }
  prefetch_mat(a.wo, l, C, C);
  float* rows = reinterpret_cast<float*>(smem);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + (size_t)B * C * 4);
  layer_norm_rows(a.x, B, C, a.eps_ln, a.ln1_w + (size_t)l * C, a.ln1_b + (size_t)l * C,
                  rows);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float acc[NB];
  for (int j = 0; j < kProj; ++j) {  // r, k, v, g
    const QMat& w = j == 0 ? a.wr : (j == 1 ? a.wk : (j == 2 ? a.wv : a.wg));
    const float* mixv = j == 0 ? a.mix_r : (j == 1 ? a.mix_k : (j == 2 ? a.mix_v : a.mix_g));
    if (j > 0) __syncthreads();  // the previous projection's readers of xs are done
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      const float mix = __ldg(mixv + (size_t)l * C + c);
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        if (b < B) {
          const size_t i = (size_t)b * C + c;
          const float sh = __ldg(a.ash_in + (size_t)l * B * C + i);
          const float xx = rows[i];
          if (j == 0 && blockIdx.x == 0) {
            a.ash_out[(size_t)l * B * C + i] = blend(a.mask[b], xx, sh);
          }
          xs[i] = __float2bfloat16_rn(sh + mix * (xx - sh));
        }
      }
    }
    __syncthreads();
    for (int m = blockIdx.x * kWarps + warp; m < C; m += gridDim.x * kWarps) {
      mat_row<NB>(w, l, C, m, C, xs, B, acc);
      if (lane == 0) {
        if (V == 4 && j == 2) {
          wkv4_row<NB>(a, l, m, acc);
        } else {
          for (int t = 0; t < B; ++t) a.rkvg[((size_t)j * B + t) * C + m] = acc[t];
        }
      }
    }
  }
}

// Phase 5: Wo over y, the residual add.
template <int NB>
__device__ void phase_wo(const Args& a, int l, __nv_bfloat16* xs) {
  const int C = a.C, B = a.B;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  stage(xs, a.y, B * C);
  float acc[NB];
  for (int m = blockIdx.x * kWarps + warp; m < C; m += gridDim.x * kWarps) {
    mat_row<NB>(a.wo, l, C, m, C, xs, B, acc);
    if (lane == 0) {
      for (int t = 0; t < B; ++t) {
        float* xp = a.x + (size_t)t * C + m;
        *xp = __ldcg(xp) + acc[t];
      }
    }
  }
}

// Phase 6: LN2, the FFN shift state (block 0 writes it); the FFN key over
// its shifted input with relu^2 -> khid, then the FFN receptance -> rf.
template <int V, int NB>
__device__ void phase_ffn_in(const Args& a, int l, unsigned char* smem) {
  const int C = a.C, B = a.B;
  float* rows = reinterpret_cast<float*>(smem);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + (size_t)B * C * 4);
  layer_norm_rows(a.x, B, C, a.eps_ln, a.ln2_w + (size_t)l * C, a.ln2_b + (size_t)l * C,
                  rows);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float acc[NB];
  for (int j = 0; j < 2; ++j) {  // the key's input, then the receptance's
    const float* mixv = j == 0 ? a.ffn_mk : a.ffn_mr;
    if (j == 1) __syncthreads();  // the key's readers of xs are done
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      const float mix = __ldg(mixv + (size_t)l * C + c);
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        if (b < B) {
          const size_t i = (size_t)b * C + c;
          const float fsh = __ldg(a.fsh_in + (size_t)l * B * C + i);
          const float xx = rows[i];
          if (j == 0 && blockIdx.x == 0) {
            a.fsh_out[(size_t)l * B * C + i] = blend(a.mask[b], xx, fsh);
          }
          // reversed for V6 (xx + mix (fsh - xx)), not for V5 and V4
          xs[i] = __float2bfloat16_rn(V == 6 ? xx + mix * (fsh - xx) : fsh + mix * (xx - fsh));
        }
      }
    }
    __syncthreads();
    if (j == 0) {
      for (int m = blockIdx.x * kWarps + warp; m < a.hidden; m += gridDim.x * kWarps) {
        mat_row<NB>(a.fk, l, a.hidden, m, C, xs, B, acc);
        if (lane == 0) {
          for (int t = 0; t < B; ++t) {
            const float p = fmaxf(acc[t], 0.f);
            a.khid[(size_t)t * a.hidden + m] = __float2bfloat16_rn(p * p);
          }
        }
      }
    } else {
      for (int m = blockIdx.x * kWarps + warp; m < C; m += gridDim.x * kWarps) {
        mat_row<NB>(a.fr, l, C, m, C, xs, B, acc);
        if (lane == 0) {
          for (int t = 0; t < B; ++t) a.rf[(size_t)t * C + m] = acc[t];
        }
      }
    }
  }
}

// Phase 7: the FFN value over khid, x += sigmoid(rf) * vf, the rescale.
template <int V, int NB>
__device__ void phase_ffn_out(const Args& a, int l, __nv_bfloat16* xs) {
  const int C = a.C, B = a.B;
  if (l + 1 < a.L) {  // for the next layer's phase 1
    if constexpr (V == 6) {
      prefetch_l2(a.tm_w1 + (size_t)(l + 1) * 5 * a.R * C, (size_t)5 * a.R * C * 2);
    } else {
      prefetch_mat(a.wr, l + 1, C, C);
      prefetch_mat(a.wk, l + 1, C, C);
      prefetch_mat(a.wv, l + 1, C, C);
      if constexpr (V == 5) prefetch_mat(a.wg, l + 1, C, C);
    }
  }
  const bool half_x = a.rescale > 0 && (a.first_layer + l + 1) % a.rescale == 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  stage(xs, a.khid, B * a.hidden);
  float acc[NB];
  for (int m = blockIdx.x * kWarps + warp; m < C; m += gridDim.x * kWarps) {
    mat_row<NB>(a.fv, l, C, m, a.hidden, xs, B, acc);
    if (lane == 0) {
      for (int t = 0; t < B; ++t) {
        float* xp = a.x + (size_t)t * C + m;
        const float xn = __ldcg(xp) + sigmoid_f32(__ldcg(a.rf + (size_t)t * C + m)) * acc[t];
        *xp = half_x ? xn * 0.5f : xn;
      }
    }
  }
}

template <int V, int NB>
__global__ void __launch_bounds__(kThreads)
layer56_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  cg::grid_group grid = cg::this_grid();
  const bool stamp = a.phase_ns != nullptr && blockIdx.x == 0 && threadIdx.x == 0;
  int n = 0;
  // after each barrier: the time every block has finished the phase
  auto done = [&]() {
    grid.sync();
    if (stamp) a.phase_ns[n] = globaltimer_ns();
    ++n;
  };
  if (stamp) a.phase_ns[n] = globaltimer_ns();
  ++n;
  for (int l = 0; l < a.L; ++l) {
    if constexpr (V == 6) {
      phase_shift<NB>(a, l, smem_raw);
      done();
      phase_mix<NB>(a, l, smem);
      done();
      phase_proj<NB>(a, l, xs);
      done();
      phase_att<6>(a, l, smem);
      done();
    } else {
      phase_static_proj<V, NB>(a, l, smem_raw);
      done();
      if constexpr (V == 5) {
        phase_att<5>(a, l, smem);
        done();
      }
    }
    phase_wo<NB>(a, l, xs);
    done();
    phase_ffn_in<V, NB>(a, l, smem_raw);
    done();
    phase_ffn_out<V, NB>(a, l, xs);
    done();
  }
}

template <int V>
size_t smem_bytes(const Args& a) {
  const size_t B = a.B, C = a.C;
  size_t s = B * C * 6;                                                   // LN + staged input
  s = s > B * a.hidden * 2 ? s : B * a.hidden * 2;                        // FFN value
  if (V == 6) s = s > B * 5 * a.R * 4 ? s : B * 5 * a.R * 4;             // phase 2
  if (V == 4) return s;
  const size_t D = V == 6 ? a.D : 0;
  const size_t att = ((size_t)kWarps + D + (size_t)(4 + kParts) * kHs) * 4;  // attention
  return s > att ? s : att;
}

template <int V, int NB>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes<V>(a);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      layer56_kernel<V, NB>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, layer56_kernel<V, NB>,
                                                           kThreads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int blocks = sms * (per_sm < 2 ? per_sm : 2);
  void* params[] = {const_cast<Args*>(&a)};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(layer56_kernel<V, NB>), blocks,
                                    kThreads, params, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int V>
cudaError_t launch_version(const Args& a, cudaStream_t s) {
  if (a.B == 1) return launch<V, 1>(a, s);
  if (a.B == 2) return launch<V, 2>(a, s);
  if (a.B <= 4) return launch<V, 4>(a, s);
  if (a.B <= 8) return launch<V, 8>(a, s);
  return launch<V, 16>(a, s);
}

}  // namespace

// ptrs: 83 device pointers in the order of the fields of Args above (ln1_w,
// ln1_b, ln2_w, ln2_b, mix_x, decay, first, gn_w, gn_b, ffn_mk, ffn_mr,
// time_mix, tm_w1, tm_w2, td_w1, td_w2, then the five pointers (codes, p1,
// p2, d8, dm8 of decode_common.cuh's QMat) of Wr, Wk, Wv, Wg, Wo, FFN key,
// FFN value, FFN receptance, then ash_in, fsh_in,
// wkv_in, ash_out, fsh_out, wkv_out, mask, x, then the scratch xx, z, mixed,
// rkvg, dz, y, khid, rf, then phase_ns, null or u64 [1 + P L] that receives
// the %globaltimer at the start and after each phase's barrier (P = 7, 5, 4
// phases per layer for versions 6, 5, 4), then mix_k, mix_v, mix_r, mix_g,
// aa_in, bb_in, pp_in, aa_out, bb_out, pp_out); a pointer a version does not
// read is null (see Args). ints: L, B, C, H, hidden, R (time-mix rank), D
// (decay rank), rescale (0 for none), first_layer, version (6, 5 or 4),
// then the eight matrices' descriptors (MatForm, decode_common.cuh; Wg's
// is not read for version 4); floats: eps_ln, eps_gn. Every array contiguous and 16-byte aligned, C and
// hidden multiples of 256, 1 <= B <= 16; for versions 6 and 5 C == H * 64;
// for version 6 R and D multiples of 8. Returns the cudaError_t of the
// launch.
extern "C" int layer_scan56(const void* const* ptrs, const int* ints, const float* floats,
                            void* stream) {
  Args a;
  int i = 0;
  a.ln1_w = take<const float*>(ptrs, i);
  a.ln1_b = take<const float*>(ptrs, i);
  a.ln2_w = take<const float*>(ptrs, i);
  a.ln2_b = take<const float*>(ptrs, i);
  a.mix_x = take<const float*>(ptrs, i);
  a.decay = take<const float*>(ptrs, i);
  a.first = take<const float*>(ptrs, i);
  a.gn_w = take<const float*>(ptrs, i);
  a.gn_b = take<const float*>(ptrs, i);
  a.ffn_mk = take<const float*>(ptrs, i);
  a.ffn_mr = take<const float*>(ptrs, i);
  a.time_mix = take<const float*>(ptrs, i);
  a.tm_w1 = take<const __nv_bfloat16*>(ptrs, i);
  a.tm_w2 = take<const __nv_bfloat16*>(ptrs, i);
  a.td_w1 = take<const __nv_bfloat16*>(ptrs, i);
  a.td_w2 = take<const __nv_bfloat16*>(ptrs, i);
  a.wr = take_mat(ptrs, i, ints[10]);
  a.wk = take_mat(ptrs, i, ints[11]);
  a.wv = take_mat(ptrs, i, ints[12]);
  a.wg = take_mat(ptrs, i, ints[13]);
  a.wo = take_mat(ptrs, i, ints[14]);
  a.fk = take_mat(ptrs, i, ints[15]);
  a.fv = take_mat(ptrs, i, ints[16]);
  a.fr = take_mat(ptrs, i, ints[17]);
  a.ash_in = take<const float*>(ptrs, i);
  a.fsh_in = take<const float*>(ptrs, i);
  a.wkv_in = take<const float*>(ptrs, i);
  a.ash_out = take<float*>(ptrs, i);
  a.fsh_out = take<float*>(ptrs, i);
  a.wkv_out = take<float*>(ptrs, i);
  a.mask = take<const float*>(ptrs, i);
  a.x = take<float*>(ptrs, i);
  a.xx = take<float*>(ptrs, i);
  a.z = take<__nv_bfloat16*>(ptrs, i);
  a.mixed = take<__nv_bfloat16*>(ptrs, i);
  a.rkvg = take<float*>(ptrs, i);
  a.dz = take<__nv_bfloat16*>(ptrs, i);
  a.y = take<__nv_bfloat16*>(ptrs, i);
  a.khid = take<__nv_bfloat16*>(ptrs, i);
  a.rf = take<float*>(ptrs, i);
  a.phase_ns = take<unsigned long long*>(ptrs, i);
  a.mix_k = take<const float*>(ptrs, i);
  a.mix_v = take<const float*>(ptrs, i);
  a.mix_r = take<const float*>(ptrs, i);
  a.mix_g = take<const float*>(ptrs, i);
  a.aa_in = take<const float*>(ptrs, i);
  a.bb_in = take<const float*>(ptrs, i);
  a.pp_in = take<const float*>(ptrs, i);
  a.aa_out = take<float*>(ptrs, i);
  a.bb_out = take<float*>(ptrs, i);
  a.pp_out = take<float*>(ptrs, i);
  a.L = ints[0];
  a.B = ints[1];
  a.C = ints[2];
  a.H = ints[3];
  a.hidden = ints[4];
  a.R = ints[5];
  a.D = ints[6];
  a.rescale = ints[7];
  a.first_layer = ints[8];
  a.eps_ln = floats[0];
  a.eps_gn = floats[1];
  const int version = ints[9];
  if (a.B < 1 || a.B > kMaxB || a.C % 256 || a.hidden % 256 || a.L < 1 || a.first_layer < 0 ||
      a.rescale < 0 || (version != 4 && a.C != a.H * kHs) ||
      (version == 6 && (a.R < 8 || a.R % 8 || a.D < 8 || a.D % 8)))
    return (int)cudaErrorInvalidValue;
  for (const QMat* w : {&a.wr, &a.wk, &a.wv, &a.wg, &a.wo, &a.fk, &a.fv, &a.fr}) {
    if (w != &a.wg || version != 4) {
      if (!mat_ok(*w)) return (int)cudaErrorInvalidValue;
    }
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (version == 6) return (int)launch_version<6>(a, s);
  if (version == 5) return (int)launch_version<5>(a, s);
  if (version == 4) return (int)launch_version<4>(a, s);
  return (int)cudaErrorInvalidValue;
}
