// Whole-stack RWKV-7 decode step (T = 1) as ONE kernel launch, Hopper sm_90a.
//
// Replaces: web_rwkv_gguf_tpu/ops/pallas/layer7.py::layer_scan7 (def at line
// 1011, pallas_call at line 1120; kernel body _layer_scan_kernel at 429).
//
// Per layer l, for B <= 16 lanes (the residual x [B, C] is carried in place):
//   xx = LN1(x); six token-shift mixes of xx with the shift state
//   r, k, v = quantized gemvs; w, a, g, v-mix from the bf16 inner-LoRA pairs
//   value residual towards layer 0's v; the attention core of att_core7.cu
//   x += Wo y;  xx2 = LN2(x);  x += Wv relu(Wk mix(xx2))^2;  x *= 0.5 every
//   `rescale` layers.
// Shift and WKV states are written only where mask[b] != 0. A launch may
// run a contiguous slice of the stack, as the JAX kernel's pipeline-stage
// mode does: first_layer is the slice's global index (for the rescale and
// for which layer is layer 0), and a slice after layer 0 gets layer 0's v
// in the vfirst buffer.
//
// Numerics are the class of the JAX kernel at its default settings: every
// quantized matrix multiplies the bf16-rounded input by the exact f32 weight
// (q * (d * sc) - dmin * mn for Q4_K, Q5_K and Q2_K, q * (d * sc) for Q6_K and
// Q3_K, q * s - mn for the f32-scale byte and nibble forms), summed as
// stack_mma.cuh says (exact code products of each k16 step on the tensor
// cores, the step's factors and offset in f32), a dense bf16 matrix
// multiplies it by its bf16 weight with f32 sums, the LoRA pairs take bf16
// operands and accumulate in f32, everything else is f32; each token-shift
// mix rounds after its product and its sum, as the plain version's
// (stk::mix_rn, not a fused multiply-add).
//
// Design. The TPU kernel is a grid over layers whose steps Pallas pipelines;
// a GPU has no such sequential grid, so this is one cooperative launch of a
// persistent grid (every block resident, one or two per SM) that walks the
// layers itself and separates the five dependent phases of a layer with a
// grid-wide barrier:
//   1. LN1 and the mixes; Wr, Wk, Wv and the four LoRA downs (tanh for w,
//      sigmoid for g, z stored bf16);
//   2. per (lane, head) item: the LoRA ups of the head, the value
//      residual, the attention core, the head's group norm, bonus and gate;
//      y stored bf16 in the order Wo stages it;
//   3. Wo, x += ;
//   4. LN2 and the FFN mix, the FFN key and relu^2 (khid stored bf16 in the
//      order the FFN value stages it);
//   5. the FFN value, x += , the rescale.
// Matrix phases (1, 3-5) run as items of stack_mma.cuh: a 16-row tile over
// a K-slice of at most 768 elements, one block an item, the block's 8 warps
// splitting the slice's k16 steps on the tensor cores (mma.sync m16n8k16;
// two n8 fragments at B > 8). A block's item arrives in one of two shared
// buffers by TMA bulk copies (its 16 code row slices and its factor parts,
// completing on an mbarrier), issued right after the barrier that ends the
// buffer's last phase, for the matrix phase two ahead. After a barrier a
// phase issues its input copies in one batch (y or khid, which their
// producers store in the staged order; for a LayerNorm phase each lane
// chunk's x rows and shift state), builds the item's factor table while
// they land, then computes from shared memory: the LayerNorm statistics
// (two passes, every warp), the mixes and each step's input sum (thread t
// taking elements 4t..4t+3 of every lane), the products, the warps' sums
// in warp order. A matrix whose K is split (the FFN value: four slices of
// 768) writes each slice's f32 partial sums to scratch; a per-tile counter
// (released with a fence and an atomic, reset by its last arrival, so the
// next launch, or a replay in a CUDA graph, finds it at zero with no
// memset: the wrapper keeps one such buffer a device) tells the last block
// of a tile, which adds the slices in slice order: no atomics on values,
// one launch, deterministic. The attention item issues its loads (the state, the
// LoRA-up rows, r / k / v, z, the head's parameters) before any use; the
// LoRA ups and the WKV state are asked of L2 while phase 1 runs. At B <= 2
// Wo and the FFN value run one warp a row instead (row_path).
// Data produced inside the launch is read with ld.global.cg or bulk copies
// after the barrier and a proxy fence (L2, never a stale L1 line); weights
// and parameters are read-only and may use L1.
// What bounds it on the H100 (PERF.md; the device clock inside each
// phase): not bytes (24 us of the step's ~570 at Q4_K, B = 4) but each
// phase's chain: the barrier (1.1-1.5 us), about 1 us before an item's
// first wait, the inputs' copies (0.5-2 us, longer when weight copies are
// in flight: copies in flight slow every load they meet), the LayerNorm
// and mixes (2-3 us), the products (1.5-2.5 us with 16 warps an SM). Left:
// the five barriers a layer, each LayerNorm phase reading the whole x row
// in every block, the attention's chain of block sums.

#include <cooperative_groups.h>

#include "stack_phase.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kHs = 64;          // head size the attention phase takes
constexpr int kMaxJobs = 7;      // jobs of phase 1: Wr, Wk, Wv, four LoRA downs
constexpr int kUpRuns = 10;      // 8-element LoRA-up runs a thread loads ahead
constexpr int kAlign = 128;      // shared-memory region alignment
constexpr int kSmemTwo = 113 * 1024;  // at most this a block, two blocks an SM
constexpr int kMiscBars = (2 * kMaxB + kWarps + 2) * 4;  // misc: mean, rs, segs, flag; mbarriers

// what a block stages as a matrix's bf16 input
enum Input {
  kInMix1 = 0,   // + s: LN1 mix s of x_stack (r, w, k, v, a, g)
  kInMix2 = 6,   // LN2 and the FFN key mix
  kInY = 7,      // the attention output (bf16, stored in staged order)
  kInKhid = 8,   // khid (bf16, stored in staged order)
};

// what a tile's sums become
enum Output { kOutRkv, kOutZ, kOutX, kOutKhid, kOutXFfn };

struct Args {
  const float *ln1_w, *ln1_b, *ln2_w, *ln2_b;  // [L, C]
  const float* x_stack;                         // [L, 6, C]: r, w, k, v, a, g
  const float *w0, *a0, *v0, *k_k, *k_a, *ffn_xk, *gn_w, *gn_b, *r_k;  // [L, C]
  const __nv_bfloat16* down;                    // [L, D, C]: w1 | a1 | g1 | v1
  const __nv_bfloat16* up;                      // [L, C, D]: w2 | a2 | g2 | v2
  QMat wr, wk, wv, wo, fk, fv;
  const float *ash_in, *fsh_in, *wkv_in;        // [L, B, C] x2, [L, B, H, 64, 64]
  float *ash_out, *fsh_out, *wkv_out;
  const float* mask;                            // [B], 0 or 1
  float* x;                                     // [B, C], in and out
  float* rkv;                                   // [3, B, C] scratch
  __nv_bfloat16* z;                             // [B, D] scratch
  float* vfirst;                                // [B, C]: layer 0's v
  __nv_bfloat16* y;                             // [B, C] scratch, staged order
  __nv_bfloat16* khid;                          // [B, hidden] scratch, staged order
  unsigned long long* phase_ns;                 // [1 + 5 L] or null: trace
  float* part;                                  // split-K partial sums (make_plan's part)
  unsigned int* cnt;                            // per-tile counters, zero at launch and after
  int L, B, C, H, hidden, D, dw, da, dg, dv, rescale, first_layer;
  float eps_ln, eps_gn, eps_l2;
};

// Items of the phases, shared-memory regions: fixed for a launch.
struct Plan {
  stk::Job p1[kMaxJobs];
  int n1;
  stk::Job wo, fk, fv;
  int buf;                  // bytes of a weight buffer
  int lanes;                // lanes of x a LayerNorm phase copies at a time
  int ki_max;
  int off_b, off_x, off_ln, off_xsum, off_tab, off_red, off_misc, smem;  // bytes
};

__host__ __device__ inline int round_up(int v, int a) { return (v + a - 1) / a * a; }

// jobs of a matrix phase (1, 3, 4, 5)
__device__ __forceinline__ const stk::Job* phase_jobs(const Plan& p, int phase, int& n) {
  n = phase == 1 ? p.n1 : 1;
  return phase == 1 ? p.p1 : (phase == 3 ? &p.wo : (phase == 4 ? &p.fk : &p.fv));
}

__device__ __forceinline__ int phase_items(const Plan& p, int phase) {
  int n;
  const stk::Job* jobs = phase_jobs(p, phase, n);
  return stk::jobs_items(jobs, n);
}

// item -> (job, tile, slice); tbase: the job's first tile in the phase
__device__ __forceinline__ const stk::Job& locate(const Plan& p, int phase, int item, int& tile,
                                                  int& s, int& tbase) {
  int n;
  const stk::Job* jobs = phase_jobs(p, phase, n);
  return stk::locate_item(jobs, n, item, tile, s, tbase);
}

// The block's copy barriers (stk::Bars): 0 weight buffer A, 1 weight
// buffer B, 2 staged inputs.
using stk::Bars;

// the copies of this block's first item of a phase at layer l into buffer
// `which` (none for phase 0: nothing follows)
__device__ void prefetch_phase(const Args& a, const Plan& p, int phase, int l, uint8_t* buf,
                               Bars& bs, int which) {
  if (phase > 0 && (int)blockIdx.x < phase_items(p, phase)) {
    int tile, s, tbase;
    const stk::Job& j = locate(p, phase, blockIdx.x, tile, s, tbase);
    stk::load_job_item(j, l, tile, s, buf, bs, which);
  }
}

// Stage the bf16 input of item slice s of job j into xs [nb][ki + kXPad]
// (runs of 4 in the order 0, 2, 1, 3) and each step's sum of it (xsum
// [steps][nb], for a form with offsets). The input's bulk copies go out
// first, then `meanwhile` runs (the weight-side work), then the copies are
// waited for. Y and khid are stored in staged order by their producers:
// one batch of copies. A LayerNorm input comes from x in lane chunks: each
// chunk's x rows (all C) and shift state in one batch, the statistics
// (first item of the phase only) and the mixes from shared memory, thread
// t taking elements 4t..4t+3 of every lane (their LayerNorm weight, bias
// and mix read once); a writer item also writes the shift state (the
// LayerNorm output, or a masked lane's kept state).
template <class Meanwhile>
__device__ __forceinline__ void stage_input(const Args& a, const Plan& p, const stk::Job& j, int l, int s,
                            int nb, bool first, bool writer, const uint8_t* buf,
                            unsigned char* smem, float* mean, float* rs, float* xsum, Bars& bs,
                            Meanwhile meanwhile) {
  const int B = a.B, C = a.C, ki = j.ki, xstride = ki + stk::kXPad;
  const int nr = stk::is_nib(j.w.form) ? 2 : 1, span = ki / nr;  // ranges of the slice
  const bool copier = (threadIdx.x >> 5) == 1;
  const int t = threadIdx.x, groups = ki / 4;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + p.off_x);
  if (j.input == kInY || j.input == kInKhid) {
    stk::stage_copied(j, s, B, nb, j.input == kInY ? a.y : a.khid, xs, xsum, bs, 2, meanwhile);
    return;
  }
  const bool ffn = j.input == kInMix2;
  float* xch = reinterpret_cast<float*>(smem + p.off_ln);  // [lanes][C]
  float* shch = xch + p.lanes * C;                         // [lanes][ki]
  const float* sh = (ffn ? a.fsh_in : a.ash_in) + (size_t)l * B * C;
  // this thread's 4 elements of the LayerNorm weight, bias and mix
  // (read-only; loaded while the copies land)
  float4 w = make_float4(0.f, 0.f, 0.f, 0.f), bb = w, mix = w;
  if (t < groups) {
    const int c = stk::slice_elem(j, s, 4 * t);
    const size_t lc = (size_t)l * C + c;
    w = __ldg(reinterpret_cast<const float4*>((ffn ? a.ln2_w : a.ln1_w) + lc));
    bb = __ldg(reinterpret_cast<const float4*>((ffn ? a.ln2_b : a.ln1_b) + lc));
    mix = __ldg(reinterpret_cast<const float4*>(
        ffn ? a.ffn_xk + lc : a.x_stack + ((size_t)l * 6 + (j.input - kInMix1)) * C + c));
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* segs = rs + kMaxB;  // kWarps segment sums, after mean and rs in misc
  for (int n0 = 0; n0 < B; n0 += p.lanes) {
    const int nl = min(p.lanes, B - n0);
    if (n0 > 0) __syncthreads();  // the previous chunk is staged
    bs.arm(2);
    if (copier)
      stk::warp_bulk(bs.bar + 2, nl * (C + ki) * 4, 1 + nl * nr, true,
                     [&](int i, void*& dst, const void*& from, uint32_t& size) {
                       if (i == 0) {
                         dst = xch;
                         from = a.x + (size_t)n0 * C;
                         size = nl * C * 4;
                         return;
                       }
                       const int r = (i - 1) / nr, e = (i - 1 - r * nr) * span;
                       dst = shch + r * ki + e;
                       from = sh + (size_t)(n0 + r) * C + stk::slice_elem(j, s, e);
                       size = span * 4;
                     });
    if (n0 == 0) meanwhile();
    bs.wait(2);
    if (first) {
      // two passes over each lane's row: P warps a lane, each a segment
      // with two accumulators; the segments' sums meet in shared memory in
      // segment order
      const int P = nl == 1 ? kWarps : (nl == 2 ? 4 : (nl <= 4 ? 2 : 1));
      const int r = warp / P, seg = C / P, c0 = (warp - r * P) * seg;
      const float* row = xch + r * C + c0;
      float m = 0.f;
      for (int pass = 0; pass < 2; ++pass) {
        if (r < nl) {
          float q0 = 0.f, q1 = 0.f;
          for (int c = lane; c < seg; c += 64) {
            const float v0 = row[c] - m;
            q0 += pass ? v0 * v0 : v0;
            if (c + 32 < seg) {
              const float v1 = row[c + 32] - m;
              q1 += pass ? v1 * v1 : v1;
            }
          }
          q0 = warp_sum(q0 + q1);
          if (lane == 0) segs[warp] = q0;
        }
        __syncthreads();
        if (r < nl) {
          float tot = 0.f;
          for (int i = 0; i < P; ++i) tot += segs[r * P + i];
          if (pass == 0) m = tot / C;
          else if (threadIdx.x == (unsigned)(r * P * 32)) {
            mean[n0 + r] = m;
            rs[n0 + r] = rsqrtf(tot / C + a.eps_ln);
          }
        }
        __syncthreads();
      }
    }
    if (t < groups) {
      const int i4 = 4 * t, c = stk::slice_elem(j, s, i4);
      for (int r = 0; r < nl; ++r) {
        const int n = n0 + r;
        const float4 xv = *reinterpret_cast<const float4*>(xch + r * C + c);
        const float4 sv = *reinterpret_cast<const float4*>(shch + r * ki + i4);
        const float m = mean[n], q = rs[n];
        const float4 xx = make_float4((xv.x - m) * q * w.x + bb.x, (xv.y - m) * q * w.y + bb.y,
                                      (xv.z - m) * q * w.z + bb.z, (xv.w - m) * q * w.w + bb.w);
        if (writer) {
          float* o = (ffn ? a.fsh_out : a.ash_out) + ((size_t)l * B + n) * C + c;
          *reinterpret_cast<float4*>(o) = a.mask[n] == 0.f ? sv : xx;
        }
        const uint2 u =
            make_uint2(stk::bf2(stk::mix_rn(xx.x, mix.x, sv.x), stk::mix_rn(xx.z, mix.z, sv.z)),
                       stk::bf2(stk::mix_rn(xx.y, mix.y, sv.y), stk::mix_rn(xx.w, mix.w, sv.w)));
        *reinterpret_cast<uint2*>(xs + (size_t)n * xstride + i4) = u;
        if (j.offs) stk::step_sum(stk::bf16_sum4(u), t, n, nb, xsum);
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
    case kOutRkv: a.rkv[((size_t)j.arg * B + n) * C + m] = v; break;
    case kOutZ: {
      if (j.act == 1) v = tanhf(v);
      else if (j.act == 2) v = sigmoid_f32(v);
      a.z[(size_t)n * a.D + j.arg + m] = __float2bfloat16_rn(v);
      break;
    }
    case kOutKhid: {
      const float q = fmaxf(v, 0.f);
      a.khid[(size_t)n * a.hidden + stk::perm4(m)] = __float2bfloat16_rn(q * q);
      break;
    }
    default: {  // the residual add (and, after the FFN value, the rescale)
      const float xn = xold + v;
      const bool halve = j.out == kOutXFfn && a.rescale > 0 &&
                         (a.first_layer + l + 1) % a.rescale == 0;
      a.x[(size_t)n * C + m] = halve ? xn * 0.5f : xn;
    }
  }
}

// At B <= 2, Wo and the FFN value run one warp a row on the CUDA cores
// (decode_common.cuh's mat_row, weights asked of L2 a phase or more
// ahead): there a row's chain is shorter than a tile item's; from B = 3
// the tiles win (and the row code's registers cost the wider kernels
// spills: PERF.md).
template <int NB>
__host__ __device__ constexpr bool row_path(int phase) {
  return (phase == 3 || phase == 5) && NB <= 2;
}

// bytes of the staged input of a row phase at NB lanes (0: none)
template <int NB>
int row_bytes(const Args& a) {
  return row_path<NB>(5) ? NB * a.hidden * 2 : 0;
}

// A row phase: its input (y or khid, stored in the tiles' staged order)
// un-permuted into shared memory in one batch of loads, then one warp a
// row of Wo or the FFN value, the residual add (and the rescale).
template <int NB>
__device__ void row_phase(const Args& a, const Plan& p, int phase, int l, unsigned char* smem) {
  const bool wo = phase == 3;
  const QMat& w = wo ? a.wo : a.fv;
  const int B = a.B, C = a.C, K = wo ? C : a.hidden;
  const __nv_bfloat16* src = wo ? a.y : a.khid;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + p.off_ln);  // [B][K]
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
        const float xn = __ldcg(xp) + acc[t];
        *xp = halve ? xn * 0.5f : xn;
      }
    }
  }
}

// A matrix phase: this block's items, the first from buffer `which` (its
// copies issued a phase or more earlier), later ones loaded here.
template <int NB>
__device__ void mat_phase(const Args& a, const Plan& p, int phase, int l, int which,
                          unsigned char* smem, Bars& bs) {
  if (row_path<NB>(phase)) {
    row_phase<NB>(a, p, phase, l, smem);
    return;
  }
  uint8_t* buf = smem + (which ? p.off_b : 0);
  const int items = phase_items(p, phase);
  if ((int)blockIdx.x >= items) return;
  const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(smem + p.off_x);
  float* xsum = reinterpret_cast<float*>(smem + p.off_xsum);
  float2* tab = reinterpret_cast<float2*>(smem + p.off_tab);
  float* red = reinterpret_cast<float*>(smem + p.off_red);  // [kWarps][16][NB]
  float* misc = reinterpret_cast<float*>(smem + p.off_misc);
  float *mean = misc, *rs = misc + kMaxB;
  unsigned int* flag = reinterpret_cast<unsigned int*>(misc + 2 * kMaxB + kWarps);
  const int B = a.B, outs = stk::kRows * B;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    int tile, s, tbase;
    const stk::Job& j = locate(p, phase, item, tile, s, tbase);
    const bool first = item == (int)blockIdx.x;
    if (!first) {  // a later item: its copies now
      __syncthreads();
      stk::load_job_item(j, l, tile, s, buf, bs, which);
    }
    const bool resid = j.out == kOutX || j.out == kOutXFfn;
    const int m_own = tile * stk::kRows + (threadIdx.x < outs ? threadIdx.x / B : 0);
    float xold = 0.f;  // x at this thread's (row, lane), read with the inputs
    if (resid && j.S == 1 && (int)threadIdx.x < outs && m_own < j.M)
      xold = __ldcg(a.x + (size_t)(threadIdx.x % B) * a.C + m_own);
    // the first job's first tile writes the shift state (LN1, LN2 output)
    const bool writer = tile == 0 && tbase == 0 && (phase == 1 || phase == 4);
    // the inputs' copies go out, then the weights (issued a phase or more
    // ago for the first item) and their factor table while they land
    stage_input(a, p, j, l, s, NB, first, writer, buf, smem, mean, rs, xsum, bs, [&]() {
      bs.wait(which);
      stk::factor_table(j, s, buf, tab);
    });
    stk::item_products<NB>(j, tile, s, tbase, B, buf, tab, xs, xsum, red, flag, a.part, a.cnt,
                           resid ? a.x : nullptr, a.C, xold, [] {},
                           [&](int r, int n, float v, float xo) {
                             epilogue(a, j, l, tile, r, n, v, xo);
                           });
  }
}

// Ask L2 for what this block's attention items of layer l read from
// device memory: the head's LoRA-up rows and the lane's state of the head.
__device__ void att_prefetch(const Args& a, int l) {
  const size_t upb = (size_t)kHs * a.D * 2, stb = (size_t)kHs * kHs * 4;
  for (int item = blockIdx.x; item < a.B * a.H; item += gridDim.x) {
    const int b = item / a.H, h = item - b * a.H;
    const char* up = reinterpret_cast<const char*>(a.up + ((size_t)l * a.C + h * kHs) * a.D);
    const char* st = reinterpret_cast<const char*>(
        a.wkv_in + (((size_t)l * a.B + b) * a.H + h) * kHs * kHs);
    for (size_t off = threadIdx.x * 128; off < upb; off += blockDim.x * 128)
      asm volatile("prefetch.global.L2 [%0];" ::"l"(up + off));
    for (size_t off = threadIdx.x * 128; off < stb; off += blockDim.x * 128)
      asm volatile("prefetch.global.L2 [%0];" ::"l"(st + off));
  }
}

// Phase 2: one (lane b, head h) item at a time, every load of the item
// issued before any use. Thread (i, p4) = (threadIdx.x / 4, threadIdx.x %
// 4) forms a quarter of channel i's four LoRA-up sums (the 4 quarters meet
// by shuffles) and the row terms of key row i; thread (rp, tc) =
// (threadIdx.x / 64, threadIdx.x % 64) keeps rows rp, rp + 4, ... of value
// column tc of the state. The head's group norm, bonus and gate end it; y
// is stored bf16 in staged order (Wo's input).
__device__ void phase_att(const Args& a, const Plan& p, int l, unsigned char* smem) {
  const int C = a.C, B = a.B, H = a.H, D = a.D;
  float* s_z = reinterpret_cast<float*>(smem + p.off_ln);  // D
  float* s_row = s_z + round_up(D, 4);                     // 7 x 64: w, k2, -kk, kk*a, r, v, gate
  float* s_red = s_row + 7 * kHs;                          // 256
  float* s_sum = s_red + kThreads;                         // 4 x kWarps
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int i = tid >> 2, p4 = tid & 3;
  const int tc = tid & (kHs - 1), rp = tid >> 6;
  constexpr int kRowsT = kHs * kHs / kThreads;  // state rows a thread keeps
  constexpr int kRowStep = kThreads / kHs;
  const int e0 = a.dw / 8, e1 = (a.dw + a.da) / 8, e2 = (a.dw + a.da + a.dg) / 8, runs = D / 8;
  const bool first = a.first_layer + l == 0;
  for (int item = blockIdx.x; item < B * H; item += gridDim.x) {
    const int b = item / H, h = item - b * H;
    const int c = h * kHs + i, ct = h * kHs + tc;
    const size_t lc = (size_t)l * C + c, bc = (size_t)b * C + c;
    const size_t soff = (((size_t)l * B + b) * H + h) * kHs * kHs + tc;
    float col[kRowsT];
#pragma unroll
    for (int m = 0; m < kRowsT; ++m) col[m] = __ldg(a.wkv_in + soff + (size_t)(rp + kRowStep * m) * kHs);
    const uint4* u4 = reinterpret_cast<const uint4*>(a.up + lc * D);
    uint4 ur[kUpRuns];
#pragma unroll
    for (int m = 0; m < kUpRuns; ++m)
      if (p4 + 4 * m < runs) ur[m] = __ldg(u4 + p4 + 4 * m);
    const float r = __ldcg(a.rkv + bc);
    const float k = __ldcg(a.rkv + (size_t)B * C + bc);
    float v = __ldcg(a.rkv + 2 * (size_t)B * C + bc);
    const float vf = first ? 0.f : __ldcg(a.vfirst + bc);
    const float w0 = a.w0[lc], a0 = a.a0[lc], v0 = a.v0[lc], kkc = a.k_k[lc], kac = a.k_a[lc],
                rkc = a.r_k[lc];
    const float gw = a.gn_w[(size_t)l * C + ct], gb = a.gn_b[(size_t)l * C + ct];
    for (int jz = tid; jz < D; jz += kThreads)
      s_z[jz] = __bfloat162float(__ldcg(a.z + (size_t)b * D + jz));
    __syncthreads();
    float u[4] = {0.f, 0.f, 0.f, 0.f};
    auto run = [&](int qq, uint4 raw) {
      float w8[8];
      bf16x8(raw, w8);
      const float4 z0 = *reinterpret_cast<const float4*>(s_z + 8 * qq);
      const float4 z1 = *reinterpret_cast<const float4*>(s_z + 8 * qq + 4);
      const float zf[8] = {z0.x, z0.y, z0.z, z0.w, z1.x, z1.y, z1.z, z1.w};
      float d = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) d += w8[e] * zf[e];
      if (qq < e0) u[0] += d;
      else if (qq < e1) u[1] += d;
      else if (qq < e2) u[2] += d;
      else u[3] += d;
    };
#pragma unroll
    for (int m = 0; m < kUpRuns; ++m)
      if (p4 + 4 * m < runs) run(p4 + 4 * m, ur[m]);
    for (int qq = p4 + 4 * kUpRuns; qq < runs; qq += 4) run(qq, __ldg(u4 + qq));
#pragma unroll
    for (int sg = 0; sg < 4; ++sg) {
      u[sg] += __shfl_xor_sync(0xffffffffu, u[sg], 1);
      u[sg] += __shfl_xor_sync(0xffffffffu, u[sg], 2);
    }
    // the row terms of key row i (the attention core, att_core7.cu)
    const float w_in = w0 + u[0], a_in = a0 + u[1], gate = u[2];
    if (!first) v = v + sigmoid_f32(v0 + u[3]) * (vf - v);
    else if (p4 == 0) a.vfirst[bc] = v;
    const float kkr = k * kkc;
    const float a2 = sigmoid_f32(a_in);
    const float k2 = k * (1.f + (a2 - 1.f) * kac);
    float s1 = p4 == 0 ? kkr * kkr : 0.f, s2 = p4 == 0 ? r * k2 * rkc : 0.f;
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) {
      s_sum[warp] = s1;
      s_sum[kWarps + warp] = s2;
    }
    __syncthreads();
    float n2 = 0.f, sb = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      n2 += s_sum[w];
      sb += s_sum[kWarps + w];
    }
    if (p4 == 0) {
      const float kk = kkr * rsqrtf(n2 + a.eps_l2);
      s_row[i] = expf(-0.606531f * sigmoid_f32(w_in));
      s_row[kHs + i] = k2;
      s_row[2 * kHs + i] = -kk;
      s_row[3 * kHs + i] = kk * a2;
      s_row[4 * kHs + i] = r;
      s_row[5 * kHs + i] = v;
      s_row[6 * kHs + i] = gate;
    }
    __syncthreads();
    // the state: sa = (-kk) . S, the new state, y0 = r . S'
    float sa = 0.f;
#pragma unroll
    for (int m = 0; m < kRowsT; ++m) sa += s_row[2 * kHs + rp + kRowStep * m] * col[m];
    s_red[tid] = sa;
    __syncthreads();
    sa = 0.f;
#pragma unroll
    for (int x = 0; x < kRowStep; ++x) sa += s_red[x * kHs + tc];
    __syncthreads();  // s_red is rewritten below
    const float vj = s_row[5 * kHs + tc];
    const bool keep = a.mask[b] == 0.f;
    float y0 = 0.f;
#pragma unroll
    for (int m = 0; m < kRowsT; ++m) {
      const int row = rp + kRowStep * m;
      const float sn = s_row[row] * col[m] + s_row[kHs + row] * vj + s_row[3 * kHs + row] * sa;
      y0 += s_row[4 * kHs + row] * sn;
      a.wkv_out[soff + (size_t)row * kHs] = keep ? col[m] : sn;
    }
    s_red[tid] = y0;
    __syncthreads();
    // the head's group norm over its 64 read-outs (threads 0..63: 2 warps)
    y0 = 0.f;
#pragma unroll
    for (int x = 0; x < kRowStep; ++x) y0 += s_red[x * kHs + tc];
    float t1 = warp_sum(tid < kHs ? y0 : 0.f);
    if (lane == 0) s_sum[2 * kWarps + warp] = t1;
    __syncthreads();
    const float mu = (s_sum[2 * kWarps] + s_sum[2 * kWarps + 1]) * (1.f / kHs);
    const float dy = y0 - mu;
    t1 = warp_sum(tid < kHs ? dy * dy : 0.f);
    if (lane == 0) s_sum[3 * kWarps + warp] = t1;
    __syncthreads();
    if (tid < kHs) {
      const float var = (s_sum[3 * kWarps] + s_sum[3 * kWarps + 1]) * (1.f / kHs);
      const float yn = (dy * rsqrtf(var + a.eps_gn)) * gw + gb;
      a.y[(size_t)b * C + stk::perm4(ct)] =
          __float2bfloat16_rn((yn + sb * vj) * s_row[6 * kHs + tc]);
    }
    __syncthreads();  // shared memory is rewritten by the next item
  }
}

template <int NB>
__global__ void __launch_bounds__(kThreads, 2) layer7_kernel(const Args args, const Plan plan) {
  extern __shared__ __align__(128) unsigned char smem[];
  // The parameters, read everywhere (by indexed job and field), from
  // shared memory: the constant cache behind the kernel's large code missed
  // at each phase's start.
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
  Bars bs{reinterpret_cast<uint64_t*>(smem + p.off_misc + kMiscBars), 0u};
  if (threadIdx.x == 0) {
    for (int i = 0; i < 3; ++i) stk::mbar_init(bs.bar + i);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
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
  // Phases 1, 3, 4, 5 take buffers A, B, A, B. Right after the barrier that
  // ends a matrix phase, its buffer takes the copies of the matrix phase two
  // ahead: the FFN key's after phase 1, the FFN value's after Wo, the next
  // layer's phase 1 and Wo after the FFN key and value. (Copies in flight
  // slow every load of the grid that meets them; issued there, they meet
  // the fewest: PERF.md.) The phases run from one loop, not
  // unrolled: one copy of a matrix phase's code serves all four.
  // a row phase's weights are asked of L2 where its tile copies would go
  auto ahead = [&](int phase, int l, uint8_t* buf, int which) {
    if (row_path<NB>(phase)) {
      if (phase == 3) prefetch_mat(a.wo, l, a.C, a.C);
      else prefetch_mat(a.fv, l, a.C, a.hidden);
    } else {
      prefetch_phase(a, p, phase, l, buf, bs, which);
    }
  };
  ahead(1, 0, smem, 0);
  ahead(3, 0, smem + p.off_b, 1);
  for (int l = 0; l < a.L; ++l) {
    att_prefetch(a, l);
#pragma unroll 1
    for (int ph = 1; ph <= 5; ++ph) {
      const int which = ph == 3 || ph == 5;  // buffer B
      if (ph == 2) phase_att(a, p, l, smem);
      else mat_phase<NB>(a, p, ph, l, which, smem, bs);
      done();
      const int next = ph == 1 ? 4 : (ph == 3 ? 5 : (ph == 4 ? 1 : (ph == 5 ? 3 : 0)));
      const int next_l = ph >= 4 ? l + 1 : l;
      if (next && next_l < a.L) ahead(next, next_l, which ? smem + p.off_b : smem, which);
    }
  }
}

stk::Job make_job(const QMat& w, int M, int row0, int Mst, int K, int input, int out, int arg,
                  int act) {
  stk::Job j;
  j.w = w;
  j.M = M;
  j.row0 = row0;
  j.Mst = Mst;
  j.K = K;
  j.input = input;
  j.out = out;
  j.arg = arg;
  j.act = act;
  stk::job_geometry(j);
  return j;
}

// The phases' jobs; sizes of the split-K scratch (floats) and counters.
Plan make_plan(const Args& a, int& part, int& cnt) {
  Plan p;
  const int C = a.C;
  p.p1[0] = make_job(a.wr, C, 0, C, C, kInMix1 + 0, kOutRkv, 0, 0);
  p.p1[1] = make_job(a.wk, C, 0, C, C, kInMix1 + 2, kOutRkv, 1, 0);
  p.p1[2] = make_job(a.wv, C, 0, C, C, kInMix1 + 3, kOutRkv, 2, 0);
  QMat down{reinterpret_cast<const uint8_t*>(a.down), nullptr, nullptr, nullptr, nullptr,
            kFormDense, 0, 0};
  const int dims[4] = {a.dw, a.da, a.dg, a.dv}, streams[4] = {1, 4, 5, 3}, acts[4] = {1, 0, 2, 0};
  p.n1 = 3;
  for (int s = 0, off = 0; s < 4; off += dims[s++]) {
    if (dims[s] > 0)
      p.p1[p.n1++] = make_job(down, dims[s], off, a.D, C, kInMix1 + streams[s], kOutZ, off,
                              acts[s]);
  }
  p.wo = make_job(a.wo, C, 0, C, C, kInY, kOutX, 0, 0);
  p.fk = make_job(a.fk, a.hidden, 0, a.hidden, C, kInMix2, kOutKhid, 0, 0);
  p.fv = make_job(a.fv, C, 0, C, a.hidden, kInKhid, kOutXFfn, 0, 0);
  part = cnt = 0;
  int buf = 0, ki_max = 0;
  auto phase = [&](const stk::Job* jobs, int nj) {
    int tiles = 0, parts = 0;
    for (int i = 0; i < nj; ++i) {
      const stk::Job& j = jobs[i];
      tiles += j.tiles;
      if (j.S > 1) parts += j.tiles * j.S * stk::kRows * a.B;
      const int bb = stk::buffer_bytes(j.w.form, j.w.gs, j.w.p2 != nullptr, j.K);
      buf = bb > buf ? bb : buf;
      ki_max = j.ki > ki_max ? j.ki : ki_max;
    }
    cnt = tiles > cnt ? tiles : cnt;
    part = parts > part ? parts : part;
  };
  phase(p.p1, p.n1);
  phase(&p.wo, 1);
  phase(&p.fk, 1);
  phase(&p.fv, 1);
  p.buf = round_up(buf, kAlign);
  p.ki_max = ki_max;
  return p;
}

// Shared-memory regions for NB lanes, `lanes` of them a LayerNorm chunk:
// the two weight buffers, the staged inputs, the factor table and step
// sums, then one region that
// holds in turn a LayerNorm chunk (x rows, shift state), the warp sums of
// the products, a row phase's input, and the attention's scratch.
void place(Plan& p, const Args& a, int nb, int lanes, int rows) {
  const int steps = p.ki_max / 16;
  const int ln = (lanes * a.C + lanes * p.ki_max) * 4;
  const int att = (round_up(a.D, 4) + 7 * kHs + kThreads + 4 * kWarps) * 4;
  const int red = kWarps * stk::kRows * nb * 4;
  p.lanes = lanes;
  p.off_b = p.buf;
  p.off_x = p.off_b + p.buf;
  p.off_tab = p.off_x + round_up(nb * (p.ki_max + stk::kXPad) * 2, kAlign);
  p.off_xsum = p.off_tab + round_up(stk::kRows * stk::tab_stride(steps) * 8, kAlign);
  p.off_ln = p.off_xsum + round_up(steps * nb * 4, kAlign);
  p.off_red = p.off_ln;
  int big = ln > att ? ln : att;
  big = big > red ? big : red;
  big = big > rows ? big : rows;
  p.off_misc = p.off_ln + round_up(big, kAlign);
  p.smem = p.off_misc + round_up(kMiscBars + 3 * 8, kAlign);
}

template <int NB>
cudaError_t launch(const Args& a, Plan p, cudaStream_t stream) {
  // the most lanes a LayerNorm chunk whose regions let two blocks share an SM
  int lanes = NB < 8 ? NB : 8;
  const int rows = row_bytes<NB>(a);
  place(p, a, NB, lanes, rows);
  constexpr int kStatic = (int)(sizeof(Args) + sizeof(Plan));  // the parameters' copy
  while (lanes > 1 && p.smem + kStatic > kSmemTwo) place(p, a, NB, lanes /= 2, rows);
  if (p.smem + kStatic > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      layer7_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, layer7_kernel<NB>, kThreads,
                                                           p.smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int blocks = sms * (per_sm < 2 ? per_sm : 2);
  void* params[] = {const_cast<Args*>(&a), &p};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(layer7_kernel<NB>), blocks,
                                    kThreads, params, p.smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// ptrs: 62 device pointers in the order of the fields of Args above (ln1_w,
// ln1_b, ln2_w, ln2_b, x_stack, w0, a0, v0, k_k, k_a, ffn_xk, gn_w, gn_b,
// r_k, down, up, then the five pointers of Wr, Wk, Wv, Wo, FFN key, FFN
// value (codes, p1, p2, d8, dm8 of decode_common.cuh's QMat), then ash_in,
// fsh_in, wkv_in, ash_out, fsh_out, wkv_out, mask, x, then rkv, z, vfirst, y,
// khid (scratch, but vfirst holds layer 0's v after the
// launch and must hold it before one whose first_layer > 0), then phase_ns,
// null or u64 [1 + 5 L] that receives the %globaltimer at the start and
// after each phase's barrier, then part (f32) and cnt (u32, zero; every
// launch leaves it zero) of the split-K sums; ints: L, B, C, H, hidden, D,
// dw, da, dg, dv, rescale (0 for none), first_layer, then the six
// matrices' descriptors (MatForm, decode_common.cuh), then the floats of
// part and the entries of cnt (at least make_plan's; fewer is
// cudaErrorInvalidValue); floats: eps_ln, eps_gn, eps_l2. Every array
// contiguous and 16-byte aligned, C and hidden multiples of 256, C ==
// H * 64, every LoRA rank a multiple of 8, 1 <= B <= 16. Returns the
// cudaError_t of the launch.
extern "C" int layer_scan7(const void* const* ptrs, const int* ints, const float* floats,
                           void* stream) {
  Args a;
  int i = 0;
  a.ln1_w = take<const float*>(ptrs, i);
  a.ln1_b = take<const float*>(ptrs, i);
  a.ln2_w = take<const float*>(ptrs, i);
  a.ln2_b = take<const float*>(ptrs, i);
  a.x_stack = take<const float*>(ptrs, i);
  a.w0 = take<const float*>(ptrs, i);
  a.a0 = take<const float*>(ptrs, i);
  a.v0 = take<const float*>(ptrs, i);
  a.k_k = take<const float*>(ptrs, i);
  a.k_a = take<const float*>(ptrs, i);
  a.ffn_xk = take<const float*>(ptrs, i);
  a.gn_w = take<const float*>(ptrs, i);
  a.gn_b = take<const float*>(ptrs, i);
  a.r_k = take<const float*>(ptrs, i);
  a.down = take<const __nv_bfloat16*>(ptrs, i);
  a.up = take<const __nv_bfloat16*>(ptrs, i);
  a.wr = take_mat(ptrs, i, ints[12]);
  a.wk = take_mat(ptrs, i, ints[13]);
  a.wv = take_mat(ptrs, i, ints[14]);
  a.wo = take_mat(ptrs, i, ints[15]);
  a.fk = take_mat(ptrs, i, ints[16]);
  a.fv = take_mat(ptrs, i, ints[17]);
  a.ash_in = take<const float*>(ptrs, i);
  a.fsh_in = take<const float*>(ptrs, i);
  a.wkv_in = take<const float*>(ptrs, i);
  a.ash_out = take<float*>(ptrs, i);
  a.fsh_out = take<float*>(ptrs, i);
  a.wkv_out = take<float*>(ptrs, i);
  a.mask = take<const float*>(ptrs, i);
  a.x = take<float*>(ptrs, i);
  a.rkv = take<float*>(ptrs, i);
  a.z = take<__nv_bfloat16*>(ptrs, i);
  a.vfirst = take<float*>(ptrs, i);
  a.y = take<__nv_bfloat16*>(ptrs, i);
  a.khid = take<__nv_bfloat16*>(ptrs, i);
  a.phase_ns = take<unsigned long long*>(ptrs, i);
  a.part = take<float*>(ptrs, i);
  a.cnt = take<unsigned int*>(ptrs, i);
  a.L = ints[0];
  a.B = ints[1];
  a.C = ints[2];
  a.H = ints[3];
  a.hidden = ints[4];
  a.D = ints[5];
  a.dw = ints[6];
  a.da = ints[7];
  a.dg = ints[8];
  a.dv = ints[9];
  a.rescale = ints[10];
  a.first_layer = ints[11];
  a.eps_ln = floats[0];
  a.eps_gn = floats[1];
  a.eps_l2 = floats[2];
  if (a.B < 1 || a.B > kMaxB || a.C % 256 || a.hidden % 256 || a.C != a.H * kHs || a.L < 1 ||
      a.dw % 8 || a.da % 8 || a.dg % 8 || a.dv % 8 || a.dw + a.da + a.dg + a.dv != a.D ||
      a.first_layer < 0)
    return (int)cudaErrorInvalidValue;
  for (const QMat* w : {&a.wr, &a.wk, &a.wv, &a.wo, &a.fk, &a.fv}) {
    if (!mat_ok(*w)) return (int)cudaErrorInvalidValue;
  }
  int part = 0, cnt = 0;
  const Plan p = make_plan(a, part, cnt);
  if (ints[18] < part || ints[19] < cnt || (part > 0 && a.part == nullptr) ||
      (cnt > 0 && a.cnt == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.B == 1) return (int)launch<1>(a, p, s);
  if (a.B == 2) return (int)launch<2>(a, p, s);
  if (a.B <= 4) return (int)launch<4>(a, p, s);
  if (a.B <= 8) return (int)launch<8>(a, p, s);
  return (int)launch<16>(a, p, s);
}
