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
// quantized matrix multiplies the bf16-rounded input by the exact f32 weight,
// summed as stack_mma.cuh says (exact code products of each k16 step on the
// tensor cores, the step's factors and offset in f32, at every B), a dense
// one by its bf16 weight with f32 sums, the four adapters take bf16
// operands and accumulate in f32 (their tanh outputs rounded to bf16 before
// the up product), everything else is f32 with IEEE expf (no fast math:
// StableExp and the group norm stay exact to f32); each token-shift mix
// rounds after its product and its sum, as the plain version's
// (stk::mix_rn, not a fused multiply-add).
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
// Q4_K ~30.7 MB per layer at the 1.6B widths, plus 0.9 MB of bf16 adapters)
// and the WKV state is read and written once (B * 1 MB per layer): bytes, at
// every B up to 16 (the products, on bf16 tensor cores, take a tenth of the
// bytes' time).
//
// Design. The TPU kernel is a sequential grid over layers with the residual
// in VMEM; a GPU has no sequential grid, so this is one cooperative launch
// of a persistent grid (every block resident, two per SM) that walks the
// layers itself and separates a layer's dependent phases with a grid-wide
// barrier. Version 6 (seven phases a layer):
//   1. LN1 and the mix by mix_x; the time-mix down-projection tm_w1 (5R
//      rows) and tanh -> z;
//   2. the five mixes, one (mix, channel) item per thread -> the five
//      inputs, bf16 in global scratch in the staged order;
//   3. Wr, Wk, Wv, Wg and the decay down-projection td_w1 (tanh -> dz);
//   4. per (lane, head), one block of 256 threads, four per channel: the
//      decay up-projection, StableExp, the WKV step with a quarter of value
//      column t of the state in registers, the group norm and the gate (y
//      stored bf16 in the staged order);
//   5. Wo and the residual add;
//   6. LN2 and the FFN mixes: the FFN key with relu^2 (khid stored bf16 in
//      the staged order) and the FFN receptance;
//   7. the FFN value, x += sigmoid(rf) * vf, and the rescale.
// Version 5 (five): LN1, the static mixes and r, k, v, g; the attention of
// phase 4 with the static decay; then phases 5-7. Version 4 (five): LN1, the
// static mixes and r, k, v; per (lane, channel) its WKV step (a select
// writes the state); then phases 5-7.
// Every matrix phase (the layer matrices in every slot form, and the dense
// adapters tm_w1 and td_w1) runs as items of stack_mma.cuh through
// stack_phase.cuh, the code layer7.cu runs its own through: a 16-row tile
// over a K-slice, one block an item, its 8 warps splitting the slice's k16
// steps on the tensor cores (warp_tile_by_mode: the code mode chosen once a
// loop), split K added in slice order by the tile's last block. The slices
// are the largest (up to 2048 elements, 1024 for dense bf16) that let two
// blocks share an SM (make_plan, in the entry point): each item's chain of
// loads and waits costs about the same whatever its size, so few large
// items a block win (at the 1.6B widths and B = 4, C = 2048 is one slice:
// about 2 items a block in the large phases). A block takes the phase's
// items blockIdx.x, + gridDim.x, ..., and their weights stream through a
// ring of buffers in shared memory: the block's item sequence over the
// whole launch is fixed, so each buffer, once its item's products are done,
// takes the TMA bulk copies (codes and factors, on its own mbarrier) of the
// item `ring` places later, in this phase or a later one or layer; copies
// are in flight across the grid barriers, and a phase starts on weights
// that have landed. At B <= 2, Wo and the FFN value run one warp a row
// instead (row_phase, as layer7.cu's row phases). An item's input is staged
// per slice: the LayerNorm inputs from x and the shift state (each block's
// LayerNorm statistics once a phase, two passes over x from L2; then
// thread t forms runs t, t + 256, ... of the slice for every lane, and the
// first job's tile 0 writes the shift state), the others (the mixed
// inputs, y, khid) by bulk copies of what their producers stored in the
// staged order; a later item of the same input and slice finds it staged.
// Data produced inside the launch is read with ld.global.cg or bulk copies
// after the barrier and a proxy fence (L2, never a stale L1 line); weights
// and parameters are read-only.
// What bounds it on the H100 (PERF.md; block 0's clock inside each
// phase): not bytes but each item's chain, 8-10 us at the 1.6B widths
// (the weights' wait ~1, the input's staging 1-5, the products 3-6), and
// the barriers. Left: the mixes' own phase (version 6; each block could
// form its slice's mixed inputs from z), each item loading its rows'
// factors for the whole row, the LayerNorm statistics in every block, and
// the attention phase on B * H blocks.

#include <cooperative_groups.h>

#include "stack_phase.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kHs = 64;                 // head size the attention phase takes
constexpr int kParts = kThreads / kHs;  // threads per value column in the attention
constexpr int kMaxPhases = 7;           // phases of a layer (version 6)
constexpr int kMaxJobs = 10;            // jobs of a layer's matrix phases (version 6)
constexpr int kMaxRing = 8;             // weight buffers of a block's ring
constexpr int kAlign = 128;             // shared-memory region alignment
constexpr int kSmemTwo = 113 * 1024;    // at most this a block, two blocks an SM
// rows of the mixed-input scratch [5, B, C]: the order of time_mix
constexpr int kInW = 0, kInK = 1, kInV = 2, kInR = 3, kInG = 4;

// what a block stages as a matrix's bf16 input
enum Input {
  kInLn1 = 0,    // + 0: LN1 mixed by mix_x (V6, reversed); + 1..4: by mix_r, mix_k,
                 // mix_v, mix_g (V5, V4: sh + mix (xx - sh))
  kInLn2K = 5,   // LN2 mixed by the FFN key's mix (reversed for V6)
  kInLn2R = 6,   // by the FFN receptance's
  kInMixed = 7,  // + s: V6's mixed input s (kInW..kInG), stored staged
  kInY = 12,     // the attention output (bf16, stored staged)
  kInKhid = 13,  // khid (bf16, stored staged)
};

// what a tile's sums become
enum Output { kOutZ, kOutRkvg, kOutDz, kOutX, kOutKhid, kOutRf, kOutXFfn };

// what a phase runs (kPhRowWo, kPhRowFv: Wo and the FFN value one warp a
// row, at B <= 2)
enum Kind { kPhMat, kPhMix, kPhAtt, kPhWkv4, kPhRowWo, kPhRowFv };

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
  float* xx;                                    // [B, C] scratch: LN1(x) (V6)
  __nv_bfloat16* z;                             // [B, 5R] scratch (V6)
  __nv_bfloat16* mixed;                         // [5, B, C] scratch, staged order (V6)
  float* rkvg;                                  // [4, B, C] scratch: r, k, v, g
  __nv_bfloat16* dz;                            // [B, D] scratch (V6)
  __nv_bfloat16* y;                             // [B, C] scratch, staged order
  __nv_bfloat16* khid;                          // [B, hidden] scratch, staged order
  float* rf;                                    // [B, C] scratch: FFN receptance
  unsigned long long* phase_ns;                 // [1 + P L] or null: trace
  const float *mix_k, *mix_v, *mix_r, *mix_g;   // [L, C] static mixes (V5, V4; no g in V4)
  const float *aa_in, *bb_in, *pp_in;           // [L, B, C] (V4)
  float *aa_out, *bb_out, *pp_out;
  float* part;                                  // split-K partial sums (make_plan's part)
  unsigned int* cnt;                            // per-tile counters, zero at launch and after
  int L, B, C, H, hidden, R, D, rescale, first_layer;
  float eps_ln, eps_gn;
};

// The phases of a layer, their jobs and the shared-memory regions: fixed
// for a launch.
struct Plan {
  stk::Job jobs[kMaxJobs];
  int kind[kMaxPhases];   // Kind
  int j0[kMaxPhases];     // a matrix phase's first job
  int nj[kMaxPhases];     // and its number of jobs
  int items[kMaxPhases];  // and of items
  int P;                  // phases a layer
  int ring;               // weight buffers
  int buf;                // bytes of a weight buffer
  int ki_max;
  int off_x, off_tab, off_xsum, off_red, off_misc, smem;  // bytes
};

__host__ __device__ inline int round_up(int v, int a) { return (v + a - 1) / a * a; }

// m * new + (1 - m) * old: the state blend, exact at m = 0 and m = 1
__device__ __forceinline__ float blend(float m, float nw, float old) {
  return m * nw + (1.f - m) * old;
}

// The next item of this block's item sequence (layers, phases, and the
// phase's items blockIdx.x, + gridDim.x, ...) from the cursor (l, ph, k:
// the block's k-th item of phase ph of layer l); false past the last.
struct Cursor {
  int l, ph, k;
  __device__ bool next(const Plan& p, int L, int& item, int& layer) {
    while (l < L) {
      if (p.kind[ph] == kPhMat) {
        const int it = (int)blockIdx.x + k * (int)gridDim.x;
        if (it < p.items[ph]) {
          item = it;
          layer = l;
          ++k;
          return true;
        }
      }
      k = 0;
      if (++ph == p.P) {
        ph = 0;
        ++l;
      }
    }
    return false;
  }
};

// The block's weight ring: buffer i of `ring` (p.buf bytes each, from the
// start of shared memory) completes on barrier i; the staged inputs on
// barrier `ring`. `issue` sends the copies of the next item of the
// sequence into the next buffer.
struct Ring {
  stk::Bars bs;
  Cursor cur;
  int issued, used;  // items issued and consumed
  __device__ void issue(const Plan& p, int L, unsigned char* smem) {
    int item, layer;
    if (!cur.next(p, L, item, layer)) return;
    const int b = issued++ % p.ring;
    int tile, s, tbase;
    const stk::Job& j =
        stk::locate_item(p.jobs + p.j0[cur.ph], p.nj[cur.ph], item, tile, s, tbase);
    stk::load_job_item(j, layer, tile, s, smem + (size_t)b * p.buf, bs, b);
  }
};

// Each lane's LayerNorm mean and 1 / sqrt(var + eps) of its row of x [B, C]
// (written in this launch) into mean[n], rs[n]: two passes from L2, P warps
// a lane, each a segment, the segments' sums met in shared memory (segs) in
// segment order.
__device__ void ln_stats(const float* x, int B, int C, float eps, float* mean, float* rs,
                         float* segs) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int P = B == 1 ? kWarps : (B == 2 ? 4 : (B <= 4 ? 2 : 1));
  const int per = kWarps / P, seg = C / P;
  for (int n0 = 0; n0 < B; n0 += per) {
    const int n = n0 + warp / P;
    const float4* row = reinterpret_cast<const float4*>(x + (size_t)n * C + (warp % P) * seg);
    float m = 0.f;
    for (int pass = 0; pass < 2; ++pass) {
      if (n < B) {
        float q0 = 0.f, q1 = 0.f;
#pragma unroll 4
        for (int i = lane; i < seg / 4; i += 32) {
          const float4 v = __ldcg(row + i);
          if (pass) {
            const float a0 = v.x - m, a1 = v.y - m, a2 = v.z - m, a3 = v.w - m;
            q0 += a0 * a0 + a1 * a1;
            q1 += a2 * a2 + a3 * a3;
          } else {
            q0 += v.x + v.y;
            q1 += v.z + v.w;
          }
        }
        const float q = warp_sum(q0 + q1);
        if (lane == 0) segs[warp] = q;
      }
      __syncthreads();
      if (n < B) {
        float tot = 0.f;
        for (int i = 0; i < P; ++i) tot += segs[(warp / P) * P + i];
        if (pass == 0) m = tot / C;
        else if (warp % P == 0 && lane == 0) {
          mean[n] = m;
          rs[n] = rsqrtf(tot / C + eps);
        }
      }
      __syncthreads();
    }
  }
}

// Stage the LayerNorm input of item slice s of job j into xs [nb][ki +
// kXPad] (runs of 4 in the order 0, 2, 1, 3) and each step's sum of it
// (xsum, for a form with offsets): thread t forms the elements of runs t,
// t + 256, ... of the slice for every lane, from x and the shift state
// (loaded 4 lanes at a time; `meanwhile` runs while the first loads land);
// a writer item also
// writes the new shift state (the LayerNorm output, or a masked lane's kept
// state) and, for V6's LN1, xx.
template <int V, int NB, class Meanwhile>
__device__ void stage_ln(const Args& a, const stk::Job& j, int l, int s, bool writer,
                         __nv_bfloat16* xs, float* xsum, const float* mean, const float* rs,
                         Meanwhile meanwhile) {
  const int B = a.B, C = a.C, ki = j.ki, xstride = ki + stk::kXPad;
  const int t = threadIdx.x, groups = ki / 4;
  const bool ln2 = j.input == kInLn2K || j.input == kInLn2R;
  // reversed (xx + mix (sh - xx)): V6's mix_x and its FFN mixes
  const bool rev = V == 6;
  const float* mixv;
  switch (j.input) {
    case kInLn1 + 0: mixv = a.mix_x; break;
    case kInLn1 + 1: mixv = a.mix_r; break;
    case kInLn1 + 2: mixv = a.mix_k; break;
    case kInLn1 + 3: mixv = a.mix_v; break;
    case kInLn1 + 4: mixv = a.mix_g; break;
    case kInLn2K: mixv = a.ffn_mk; break;
    default: mixv = a.ffn_mr; break;
  }
  const float* sh = (ln2 ? a.fsh_in : a.ash_in) + (size_t)l * B * C;
  float* sh_out = (ln2 ? a.fsh_out : a.ash_out) + (size_t)l * B * C;
  constexpr int kChunk = NB < 4 ? NB : 4;  // lanes loaded at a time
  // run q = q0 + t of the slice (groups is a multiple of 32: a warp's
  // threads are all in or all out)
  for (int q0 = 0; q0 < groups; q0 += kThreads) {
    const int q = q0 + t;
    const bool on = q < groups;
    const int c = on ? stk::slice_elem(j, s, 4 * q) : 0;
    const size_t lc = (size_t)l * C + c;
    float4 w = make_float4(0.f, 0.f, 0.f, 0.f), bb = w, mix = w, xv[kChunk], sv[kChunk];
    if (on) {
      w = __ldg(reinterpret_cast<const float4*>((ln2 ? a.ln2_w : a.ln1_w) + lc));
      bb = __ldg(reinterpret_cast<const float4*>((ln2 ? a.ln2_b : a.ln1_b) + lc));
      mix = __ldg(reinterpret_cast<const float4*>(mixv + lc));
    }
    for (int n0 = 0; n0 < B; n0 += kChunk) {
      if (on) {
#pragma unroll
        for (int r = 0; r < kChunk; ++r) {
          if (n0 + r < B) {
            xv[r] = __ldcg(reinterpret_cast<const float4*>(a.x + (size_t)(n0 + r) * C + c));
            sv[r] = __ldg(reinterpret_cast<const float4*>(sh + (size_t)(n0 + r) * C + c));
          }
        }
      }
      if (q0 == 0 && n0 == 0) meanwhile();
      if (!on) continue;
#pragma unroll
      for (int r = 0; r < kChunk; ++r) {
        const int n = n0 + r;
        if (n >= B) break;
        const float m = mean[n], rq = rs[n];
        const float4 xq = xv[r], sq = sv[r];
        const float4 xx = make_float4((xq.x - m) * rq * w.x + bb.x, (xq.y - m) * rq * w.y + bb.y,
                                      (xq.z - m) * rq * w.z + bb.z, (xq.w - m) * rq * w.w + bb.w);
        if (writer) {
          const float mk = a.mask[n];
          *reinterpret_cast<float4*>(sh_out + (size_t)n * C + c) =
              make_float4(blend(mk, xx.x, sq.x), blend(mk, xx.y, sq.y), blend(mk, xx.z, sq.z),
                          blend(mk, xx.w, sq.w));
          if (V == 6 && !ln2) *reinterpret_cast<float4*>(a.xx + (size_t)n * C + c) = xx;
        }
        float4 in;
        if (rev)
          in = make_float4(stk::mix_rn(xx.x, mix.x, sq.x), stk::mix_rn(xx.y, mix.y, sq.y),
                           stk::mix_rn(xx.z, mix.z, sq.z), stk::mix_rn(xx.w, mix.w, sq.w));
        else
          in = make_float4(stk::mix_rn(sq.x, mix.x, xx.x), stk::mix_rn(sq.y, mix.y, xx.y),
                           stk::mix_rn(sq.z, mix.z, xx.z), stk::mix_rn(sq.w, mix.w, xx.w));
        const uint2 u = make_uint2(stk::bf2(in.x, in.z), stk::bf2(in.y, in.w));
        *reinterpret_cast<uint2*>(xs + (size_t)n * xstride + 4 * q) = u;
        if (j.offs) stk::step_sum(stk::bf16_sum4(u), q, n, NB, xsum);
      }
    }
  }
}

// the sums of a tile's row r and lane n (xold: x there, for a residual add)
__device__ __forceinline__ void epilogue(const Args& a, const stk::Job& j, int l, int tile,
                                         int r, int n, float v, float xold) {
  const int m = tile * stk::kRows + r;
  if (m >= j.M) return;
  const int B = a.B, C = a.C;
  switch (j.out) {
    case kOutZ: a.z[(size_t)n * 5 * a.R + m] = __float2bfloat16_rn(tanhf(v)); break;
    case kOutDz: a.dz[(size_t)n * a.D + m] = __float2bfloat16_rn(tanhf(v)); break;
    case kOutRkvg: a.rkvg[((size_t)j.arg * B + n) * C + m] = v; break;
    case kOutKhid: {
      const float q = fmaxf(v, 0.f);
      a.khid[(size_t)n * a.hidden + stk::perm4(m)] = __float2bfloat16_rn(q * q);
      break;
    }
    case kOutRf: a.rf[(size_t)n * C + m] = v; break;
    case kOutX: a.x[(size_t)n * C + m] = xold + v; break;
    default: {  // the FFN value: x += sigmoid(rf) * vf, the rescale
      const float xn = xold + sigmoid_f32(__ldcg(a.rf + (size_t)n * C + m)) * v;
      const bool halve = a.rescale > 0 && (a.first_layer + l + 1) % a.rescale == 0;
      a.x[(size_t)n * C + m] = halve ? xn * 0.5f : xn;
    }
  }
}

// A matrix phase: this block's items, each from the next buffer of the
// ring (its copies issued `ring` items earlier), each freed buffer taking
// the copies of the item `ring` places on.
template <int V, int NB>
__device__ void mat_phase(const Args& a, const Plan& p, int ph, int l, unsigned char* smem,
                          Ring& rg) {
  const int items = p.items[ph];
  if ((int)blockIdx.x >= items) return;
  const stk::Job* jobs = p.jobs + p.j0[ph];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + p.off_x);
  float* xsum = reinterpret_cast<float*>(smem + p.off_xsum);
  float2* tab = reinterpret_cast<float2*>(smem + p.off_tab);
  float* red = reinterpret_cast<float*>(smem + p.off_red);  // [kWarps][16][NB]
  float* misc = reinterpret_cast<float*>(smem + p.off_misc);
  float *mean = misc, *rs = misc + kMaxB, *segs = misc + 2 * kMaxB;
  unsigned int* flag = reinterpret_cast<unsigned int*>(misc + 2 * kMaxB + kWarps);
  const int B = a.B, outs = stk::kRows * B;
  const int in0 = jobs[0].input;
  if (in0 <= kInLn2R)  // a LayerNorm phase: the statistics once
    ln_stats(a.x, B, a.C, a.eps_ln, mean, rs, segs);
  int staged = -1;  // what xs and xsum hold: (input, slice, offsets) of the last item
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    int tile, s, tbase;
    const stk::Job& j = stk::locate_item(jobs, p.nj[ph], item, tile, s, tbase);
    const int b = rg.used++ % p.ring;
    const uint8_t* buf = smem + (size_t)b * p.buf;
    const bool resid = j.out == kOutX || j.out == kOutXFfn;
    const int m_own = tile * stk::kRows + (threadIdx.x < outs ? threadIdx.x / B : 0);
    float xold = 0.f;  // x at this thread's (row, lane), read with the inputs
    if (resid && j.S == 1 && (int)threadIdx.x < outs && m_own < j.M)
      xold = __ldcg(a.x + (size_t)(threadIdx.x % B) * a.C + m_own);
    auto meanwhile = [&]() {
      rg.bs.wait(b);
      stk::factor_table(j, s, buf, tab);
    };
    // a later item of the same input and slice finds it staged (the FFN
    // key's items at K = C in one slice; a split job's items where the
    // grid's stride is a multiple of its slices)
    const int key = (j.input * 64 + s) * 2 * 4096 + j.ki * 2 + j.offs;
    const bool writer = tile == 0 && tbase == 0 && j.input <= kInLn2R;
    if (key == staged && !writer) {
      meanwhile();  // (the previous item's readers of tab are done: item_products)
    } else if (j.input <= kInLn2R) {
      // the first job's tile 0 writes the shift state
      __syncthreads();  // the previous item's readers of xs are done
      stage_ln<V, NB>(a, j, l, s, writer, xs, xsum, mean, rs, meanwhile);
    } else {
      const __nv_bfloat16* src =
          j.input == kInY ? a.y
                          : (j.input == kInKhid ? a.khid
                                                : a.mixed + (size_t)(j.input - kInMixed) * B * a.C);
      stk::stage_copied(j, s, B, NB, src, xs, xsum, rg.bs, p.ring, meanwhile);
    }
    staged = key;
    auto freed = [&]() { rg.issue(p, a.L, smem); };
    auto epi = [&](int r, int n, float v, float xo) { epilogue(a, j, l, tile, r, n, v, xo); };
    stk::item_products<NB, decltype(freed), decltype(epi), true>(
        j, tile, s, tbase, B, buf, tab, xs, xsum, red, flag, a.part, a.cnt,
        resid ? a.x : nullptr, a.C, xold, freed, epi);
  }
}

// Version 6's phase 2: per (mix s, channel c) item, every lane: mix_s =
// tm_w2[s][c] . z_s + time_mix[s][c], then the mixed input xx + mix_s (sh -
// xx) as bf16, stored in the staged order.
template <int NB>
__device__ void phase_mix(const Args& a, int l, float* s_z) {
  const int C = a.C, B = a.B, R = a.R, R5 = 5 * R;
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
        a.mixed[(size_t)s * B * C + (size_t)b * C + stk::perm4(c)] =
            __float2bfloat16_rn(stk::mix_rn(xx, mix, sh));
      }
    }
  }
  __syncthreads();  // s_z is rewritten by the next phase
}

// Versions 6 and 5's attention: one (lane, head) item per block at a time.
// Thread (part, t) = (threadIdx.x / 64, threadIdx.x % 64) serves channel /
// value column t of the head with a quarter of the work: decay-rank chunks
// part, part + 4, ... and the key rows [16 part, 16 part + 16) of the
// state; shared memory sums the four quarters. y is stored in the staged
// order (Wo's input).
template <int V>
__device__ void phase_att(const Args& a, int l, float* smem) {
  const int C = a.C, B = a.B, H = a.H, D = V == 6 ? a.D : 0;
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
      a.y[(size_t)b * C + stk::perm4(c)] = __float2bfloat16_rn(yn * (g * sigmoid_f32(g)));
    }
    __syncthreads();  // shared memory is rewritten by the next item
  }
}

// Version 4's WKV step, one (lane, channel) a thread: y (bf16, staged
// order) and the state, written by a select (pp may hold F32_MIN).
__device__ void phase_wkv4(const Args& a, int l) {
  const int C = a.C, B = a.B;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < B * C; i += gridDim.x * blockDim.x) {
    const int t = i / C, m = i - t * C;
    const float u = __ldg(a.first + (size_t)l * C + m);
    const float w = __ldg(a.decay + (size_t)l * C + m);
    const size_t bc = (size_t)t * C + m, st = ((size_t)l * B + t) * C + m;
    const float r = __ldcg(a.rkvg + bc), k = __ldcg(a.rkvg + (size_t)B * C + bc);
    const float v = __ldcg(a.rkvg + 2 * (size_t)B * C + bc);
    const float aa = __ldg(a.aa_in + st), bb = __ldg(a.bb_in + st), pp = __ldg(a.pp_in + st);
    const float ww = u + k;
    const float q = fmaxf(pp, ww);
    const float e1 = expf(pp - q), e2 = expf(ww - q);
    a.y[(size_t)t * C + stk::perm4(m)] =
        __float2bfloat16_rn(sigmoid_f32(r) * (e1 * aa + e2 * v) / (e1 * bb + e2));
    const float ww2 = w + pp;
    const float q2 = fmaxf(ww2, k);
    const float f1 = expf(ww2 - q2), f2 = expf(k - q2);
    const bool live = a.mask[t] > 0.f;
    a.aa_out[st] = live ? f1 * aa + f2 * v : aa;
    a.bb_out[st] = live ? f1 * bb + f2 : bb;
    a.pp_out[st] = live ? q2 : pp;
  }
}

// At B <= 2, Wo and the FFN value run one warp a row on the CUDA cores
// (decode_common.cuh's mat_row, their weights asked of L2 a phase ahead), as
// layer7.cu's row phases do: there a row's chain is shorter than a tile
// item's (PERF.md). The input (y or khid, stored in the staged
// order) is un-permuted into shared memory in one batch of loads; then the
// residual add (the FFN value's gated by sigmoid(rf), and the rescale).
template <int NB>
__device__ void row_phase(const Args& a, bool wo, int l, unsigned char* smem) {
  const QMat& w = wo ? a.wo : a.fv;
  const int B = a.B, C = a.C, K = wo ? C : a.hidden;
  const __nv_bfloat16* src = wo ? a.y : a.khid;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);  // [B][K]
  for (int i = threadIdx.x; i < B * K / 4; i += blockDim.x) {
    // positions 4j.. hold elements (0, 2, 1, 3) of the run: the same swap back
    const uint2 v = __ldcg(reinterpret_cast<const uint2*>(src) + i);
    reinterpret_cast<uint2*>(xs)[i] =
        make_uint2(__byte_perm(v.x, v.y, 0x5410), __byte_perm(v.x, v.y, 0x7632));
  }
  __syncthreads();
  const bool halve = !wo && a.rescale > 0 && (a.first_layer + l + 1) % a.rescale == 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float acc[NB];
  for (int m = blockIdx.x * kWarps + warp; m < C; m += gridDim.x * kWarps) {
    mat_row<NB>(w, l, C, m, K, xs, B, acc);
    if (lane == 0) {
      for (int t = 0; t < B; ++t) {
        float* xp = a.x + (size_t)t * C + m;
        if (wo) {
          *xp = __ldcg(xp) + acc[t];
        } else {
          const float xn = __ldcg(xp) + sigmoid_f32(__ldcg(a.rf + (size_t)t * C + m)) * acc[t];
          *xp = halve ? xn * 0.5f : xn;
        }
      }
    }
  }
}

template <int V, int NB>
__global__ void __launch_bounds__(kThreads, 2) layer56_kernel(const Args args, const Plan plan) {
  extern __shared__ __align__(128) unsigned char smem[];
  // the parameters, read everywhere (by indexed job and field), from
  // shared memory, as layer7.cu keeps them
  __shared__ Args a;
  __shared__ Plan p;
  {
    const int* src_a = reinterpret_cast<const int*>(&args);
    const int* src_p = reinterpret_cast<const int*>(&plan);
    int* dst_a = reinterpret_cast<int*>(&a);
    int* dst_p = reinterpret_cast<int*>(&p);
    for (int i = threadIdx.x; i < (int)(sizeof(Args) / 4); i += blockDim.x) dst_a[i] = src_a[i];
    for (int i = threadIdx.x; i < (int)(sizeof(Plan) / 4); i += blockDim.x) dst_p[i] = src_p[i];
    __syncthreads();
  }
  Ring rg{{reinterpret_cast<uint64_t*>(smem + p.smem - (p.ring + 1) * 8), 0u}, {0, 0, 0}, 0, 0};
  if (threadIdx.x == 0) {
    for (int i = 0; i <= p.ring; ++i) stk::mbar_init(rg.bs.bar + i);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  for (int i = 0; i < p.ring; ++i) rg.issue(p, a.L, smem);
  cg::grid_group grid = cg::this_grid();
  const bool stamp = a.phase_ns != nullptr && blockIdx.x == 0 && threadIdx.x == 0;
  int n = 0;
  if (stamp) a.phase_ns[n] = globaltimer_ns();
  ++n;
  float* work = reinterpret_cast<float*>(smem + p.off_x);  // the other phases' scratch
  for (int l = 0; l < a.L; ++l) {
    if (V != 4) {  // for the attention: the layer's state (and V6's decay up-projection)
      prefetch_l2(a.wkv_in + (size_t)l * a.B * a.H * kHs * kHs,
                  (size_t)a.B * a.H * kHs * kHs * 4);
      if (V == 6) prefetch_l2(a.td_w2 + (size_t)l * a.C * a.D, (size_t)a.C * a.D * 2);
    }
#pragma unroll 1
    for (int ph = 0; ph < p.P; ++ph) {
      // (at B <= 2) a row phase's weights, asked of L2 a phase ahead; the
      // kernels of more lanes hold no row phase's code (it cost them ~4 %:
      // PERF.md)
      if constexpr (NB <= 2) {
        const int next = ph + 1 < p.P ? p.kind[ph + 1] : -1;
        if (next == kPhRowWo) prefetch_mat(a.wo, l, a.C, a.C);
        else if (next == kPhRowFv) prefetch_mat(a.fv, l, a.C, a.hidden);
      }
      switch (p.kind[ph]) {
        case kPhMat: mat_phase<V, NB>(a, p, ph, l, smem, rg); break;
        case kPhMix:
          if constexpr (V == 6) phase_mix<NB>(a, l, work);
          break;
        case kPhAtt:
          if constexpr (V != 4) phase_att<V>(a, l, work);
          break;
        default:
          if constexpr (NB <= 2) {
            if (p.kind[ph] != kPhWkv4) {
              row_phase<NB>(a, p.kind[ph] == kPhRowWo, l, smem + p.off_x);
              break;
            }
          }
          phase_wkv4(a, l);
      }
      grid.sync();
      // after each barrier: the time every block has finished the phase
      if (stamp) a.phase_ns[n] = globaltimer_ns();
      ++n;
    }
  }
}

// The K-slice of a job's items: the largest multiple of 256 that divides K
// within kmax, or dmax for dense bf16 (the launch's, see layer_scan56). Few
// large items a block: each item's chain of loads and waits costs about
// the same whatever its size.
int slice_k(int K, int form, int kmax, int dmax) {
  if (form == kFormDense) kmax = dmax;
  for (int ki = kmax; ki > 256; ki -= 256)
    if (K % ki == 0) return ki;
  return 256;
}

stk::Job make_job(const QMat& w, int M, int K, int input, int out, int arg, int kmax,
                  int dmax) {
  stk::Job j;
  j.w = w;
  j.M = M;
  j.row0 = 0;
  j.Mst = M;
  j.K = K;
  j.input = input;
  j.out = out;
  j.arg = arg;
  j.act = 0;
  stk::job_geometry(j, slice_k(K, w.form, kmax, dmax));
  return j;
}

QMat dense(const __nv_bfloat16* w) {
  return QMat{reinterpret_cast<const uint8_t*>(w), nullptr, nullptr, nullptr, nullptr,
              kFormDense, 0, 0};
}

// The phases of a layer by version and their jobs, in K-slices of at most
// kmax elements (dmax for dense bf16); sizes of the split-K scratch
// (floats) and counters.
Plan make_plan(const Args& a, int version, int kmax, int dmax, int& part, int& cnt) {
  Plan p{};
  const int C = a.C;
  int nj = 0, ph = 0;
  auto mat = [&](std::initializer_list<stk::Job> jobs) {
    p.kind[ph] = kPhMat;
    p.j0[ph] = nj;
    for (const stk::Job& j : jobs) p.jobs[nj++] = j;
    p.nj[ph] = nj - p.j0[ph];
    ++ph;
  };
  auto other = [&](int kind) { p.kind[ph++] = kind; };
  if (version == 6) {
    mat({make_job(dense(a.tm_w1), 5 * a.R, C, kInLn1 + 0, kOutZ, 0, kmax, dmax)});
    other(kPhMix);
    mat({make_job(a.wr, C, C, kInMixed + kInR, kOutRkvg, 0, kmax, dmax),
         make_job(a.wk, C, C, kInMixed + kInK, kOutRkvg, 1, kmax, dmax),
         make_job(a.wv, C, C, kInMixed + kInV, kOutRkvg, 2, kmax, dmax),
         make_job(a.wg, C, C, kInMixed + kInG, kOutRkvg, 3, kmax, dmax),
         make_job(dense(a.td_w1), a.D, C, kInMixed + kInW, kOutDz, 0, kmax, dmax)});
    other(kPhAtt);
  } else if (version == 5) {
    mat({make_job(a.wr, C, C, kInLn1 + 1, kOutRkvg, 0, kmax, dmax),
         make_job(a.wk, C, C, kInLn1 + 2, kOutRkvg, 1, kmax, dmax),
         make_job(a.wv, C, C, kInLn1 + 3, kOutRkvg, 2, kmax, dmax),
         make_job(a.wg, C, C, kInLn1 + 4, kOutRkvg, 3, kmax, dmax)});
    other(kPhAtt);
  } else {
    mat({make_job(a.wr, C, C, kInLn1 + 1, kOutRkvg, 0, kmax, dmax),
         make_job(a.wk, C, C, kInLn1 + 2, kOutRkvg, 1, kmax, dmax),
         make_job(a.wv, C, C, kInLn1 + 3, kOutRkvg, 2, kmax, dmax)});
    other(kPhWkv4);
  }
  const bool rows = a.B <= 2;  // Wo and the FFN value one warp a row (row_phase)
  if (rows) other(kPhRowWo);
  else mat({make_job(a.wo, C, C, kInY, kOutX, 0, kmax, dmax)});
  mat({make_job(a.fk, a.hidden, C, kInLn2K, kOutKhid, 0, kmax, dmax),
       make_job(a.fr, C, C, kInLn2R, kOutRf, 0, kmax, dmax)});
  if (rows) other(kPhRowFv);
  else mat({make_job(a.fv, C, a.hidden, kInKhid, kOutXFfn, 0, kmax, dmax)});
  p.P = ph;
  part = cnt = 0;
  int buf = 0, ki_max = 0;
  for (int q = 0; q < p.P; ++q) {
    if (p.kind[q] != kPhMat) continue;
    int tiles = 0, parts = 0, items = 0;
    for (int i = p.j0[q]; i < p.j0[q] + p.nj[q]; ++i) {
      const stk::Job& j = p.jobs[i];
      // a split job's partial sums sit at (its first tile + tile) * S + s
      const int end = (tiles + j.tiles) * j.S * stk::kRows * a.B;
      if (j.S > 1) parts = end > parts ? end : parts;
      tiles += j.tiles;
      items += j.tiles * j.S;
      const int bb = stk::buffer_bytes(j.w.form, j.w.gs, j.w.p2 != nullptr, j.K, j.ki);
      buf = bb > buf ? bb : buf;
      ki_max = j.ki > ki_max ? j.ki : ki_max;
    }
    p.items[q] = items;
    cnt = tiles > cnt ? tiles : cnt;
    part = parts > part ? parts : part;
  }
  p.buf = round_up(buf, kAlign);
  p.ki_max = ki_max;
  return p;
}

// Shared-memory regions for NB lanes: the ring's buffers, then the staged
// inputs, the factor table, the step sums and the warps' sums (which the
// mixes, the attention and the row phases use as their scratch), the
// LayerNorm statistics and flag, and the ring's mbarriers last.
void place(Plan& p, const Args& a, int nb, int ring) {
  const int steps = p.ki_max / 16;
  p.ring = ring;
  p.off_x = ring * p.buf;
  p.off_tab = p.off_x + round_up(nb * (p.ki_max + stk::kXPad) * 2, kAlign);
  p.off_xsum = p.off_tab + round_up(stk::kRows * stk::tab_stride(steps) * 8, kAlign);
  p.off_red = p.off_xsum + round_up(steps * nb * 4, kAlign);
  int end = p.off_red + round_up(kWarps * stk::kRows * nb * 4, kAlign);
  const int att = (kWarps + a.D + (4 + kParts) * kHs) * 4, mix = a.B * 5 * a.R * 4;
  const int rows = a.B <= 2 ? a.B * a.hidden * 2 : 0;  // a row phase's input
  int work = att > mix ? att : mix;
  work = work > rows ? work : rows;
  end = end > p.off_x + work ? end : round_up(p.off_x + work, kAlign);
  p.off_misc = end;
  p.smem = p.off_misc + round_up((2 * kMaxB + kWarps + 1) * 4, 16) + (ring + 1) * 8;
}

template <int V, int NB>
cudaError_t launch(const Args& a, Plan p, cudaStream_t stream) {
  constexpr int kStatic = (int)(sizeof(Args) + sizeof(Plan));  // the parameters' copy
  // as many buffers as let two blocks share an SM, at least two
  int ring = kMaxRing;
  place(p, a, NB, ring);
  while (ring > 2 && p.smem + kStatic > kSmemTwo) place(p, a, NB, --ring);
  if (p.smem + kStatic > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      layer56_kernel<V, NB>, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, layer56_kernel<V, NB>,
                                                           kThreads, p.smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int blocks = sms * (per_sm < 2 ? per_sm : 2);
  void* params[] = {const_cast<Args*>(&a), &p};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(layer56_kernel<V, NB>), blocks,
                                    kThreads, params, p.smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int V>
cudaError_t launch_version(const Args& a, const Plan& p, cudaStream_t s) {
  if (a.B == 1) return launch<V, 1>(a, p, s);
  if (a.B == 2) return launch<V, 2>(a, p, s);
  if (a.B <= 4) return launch<V, 4>(a, p, s);
  if (a.B <= 8) return launch<V, 8>(a, p, s);
  return launch<V, 16>(a, p, s);
}

}  // namespace

// ptrs: 85 device pointers in the order of the fields of Args above (ln1_w,
// ln1_b, ln2_w, ln2_b, mix_x, decay, first, gn_w, gn_b, ffn_mk, ffn_mr,
// time_mix, tm_w1, tm_w2, td_w1, td_w2, then the five pointers (codes, p1,
// p2, d8, dm8 of decode_common.cuh's QMat) of Wr, Wk, Wv, Wg, Wo, FFN key,
// FFN value, FFN receptance, then ash_in, fsh_in,
// wkv_in, ash_out, fsh_out, wkv_out, mask, x, then the scratch xx, z, mixed,
// rkvg, dz, y, khid, rf, then phase_ns, null or u64 [1 + P L] that receives
// the %globaltimer at the start and after each phase's barrier (P = 7, 5, 5
// phases per layer for versions 6, 5, 4), then mix_k, mix_v, mix_r, mix_g,
// aa_in, bb_in, pp_in, aa_out, bb_out, pp_out, then part (f32) and cnt
// (u32, zero; every launch leaves it zero) of the split-K sums); a pointer
// a version does not read is null (see Args). ints: L, B, C, H, hidden, R
// (time-mix rank), D (decay rank), rescale (0 for none), first_layer,
// version (6, 5 or 4), then the eight matrices' descriptors (MatForm,
// decode_common.cuh; Wg's is not read for version 4), then the floats of
// part and the entries of cnt (at least make_plan's; fewer is
// cudaErrorInvalidValue); floats: eps_ln, eps_gn. Every array contiguous
// and 16-byte aligned, C and hidden multiples of 256, 1 <= B <= 16; for
// versions 6 and 5 C == H * 64; for version 6 R and D multiples of 8 (5R
// and D rows of the adapters' tiles). Returns the cudaError_t of the
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
  a.part = take<float*>(ptrs, i);
  a.cnt = take<unsigned int*>(ptrs, i);
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
      (version == 6 && (a.R < 8 || a.R % 8 || a.D < 8 || a.D % 8)) ||
      (version != 4 && version != 5 && version != 6))
    return (int)cudaErrorInvalidValue;
  for (const QMat* w : {&a.wr, &a.wk, &a.wv, &a.wg, &a.wo, &a.fk, &a.fv, &a.fr}) {
    if (w != &a.wg || version != 4) {
      if (!mat_ok(*w)) return (int)cudaErrorInvalidValue;
    }
  }
  // the largest slices (dense bf16's at most 1024) whose plan lets two
  // blocks share an SM with two weight buffers each (the lanes' staged
  // inputs and the buffers grow with them)
  int part = 0, cnt = 0;
  Plan p;
  const int nb = a.B <= 2 ? a.B : (a.B <= 4 ? 4 : (a.B <= 8 ? 8 : 16));
  bool fits = false;
  for (int kmax = 2048; kmax >= 256 && !fits; kmax /= 2) {
    for (int dmax = kmax < 1024 ? kmax : 1024; dmax >= 256 && !fits; dmax /= 2) {
      p = make_plan(a, version, kmax, dmax, part, cnt);
      place(p, a, nb, 2);
      fits = p.smem + (int)(sizeof(Args) + sizeof(Plan)) <= kSmemTwo;
    }
  }
  if (ints[18] < part || ints[19] < cnt || (part > 0 && a.part == nullptr) ||
      (cnt > 0 && a.cnt == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (version == 6) return (int)launch_version<6>(a, p, s);
  if (version == 5) return (int)launch_version<5>(a, p, s);
  return (int)launch_version<4>(a, p, s);
}
