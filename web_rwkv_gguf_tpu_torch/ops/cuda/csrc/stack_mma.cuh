// Tensor-core matrix tiles for the whole-stack decode kernels (layer7.cu,
// layer56.cu, through stack_phase.cuh) and the grouped gemv
// (gemv_grouped.cu): one 16-row tile of a layer matrix, over one K-slice of
// it, against the staged bf16 inputs of up to 16 lanes, in every slot form
// of decode_common.cuh (MatForm), with mma.sync m16n8k16 (warp_tile; or
// warp_tile_by_mode, the same steps with the code mode chosen once a loop).
//
// An item is (matrix, 16-row tile, K-slice s of item_k(K) elements, or of
// a slice its kernel picks: job_geometry). A block
// takes an item whole: its codes (16 row slices) and the tile's raw factors
// (whole rows: contiguous) land in shared memory through TMA bulk copies
// (cp.async.bulk, completing on an mbarrier; issued phases ahead of use, so
// they land while the grid works and waits at its barriers), the block
// stages the slice of its input as bf16, and its 8 warps split the slice's
// k16 steps; their partial sums meet in shared memory in warp order.
//
// Numerics (the class of qgemv_mma.cuh): every code is an integer that bf16
// holds exactly (Q4_K and the f32-scale nibbles 0..15, Q5_K / Q2_K u8, Q6_K /
// Q3_K and Q8_0 i8, the f32-scale byte forms u8 or i8), so the products of
// one k16 step are exact and their sum is an f32 sum; each step's mma starts
// from a zero accumulator, and its sum takes the step's group factors in f32:
// acc += s * (sum_k q x) - mn * (sum_k x), s = d * sc formed in f32 as the
// plain version forms it (a table of them a row and step, built once an
// item). Codes become bf16 by integer operations where the form bounds
// them (nibbles, Q5_K / Q2_K's codes below 128, Q6_K / Q3_K's 6-bit ones:
// bf16(128 + q) from the mantissa, then one exact bf16x2 FMA), through f32
// otherwise (any 8-bit code). Nothing chains across steps inside the tensor
// core, so a long same-signed sum (relu^2 into the FFN value) stays an f32
// sum of 16-element terms. A dense bf16 slot takes its bf16 weights as A,
// each k16 step from a zero accumulator, added in f32.
//
// k order. Lane (g, t) of an m16n8k16 fragment holds k slots {2t, 2t+1,
// 2t+8, 2t+9}; here those slots are the step's elements (4t, 4t+2 | 4t+1,
// 4t+3), so a lane reads one 32-bit word of 4 codes (or 8 bytes of 4 bf16)
// per row, and the staged inputs hold each run of 4 elements in the order
// (0, 2, 1, 3). A nibble row's 16-byte chunk is two steps: its low nibbles
// (elements j..j+15) and its high nibbles (elements K/2 + j..).

#pragma once

#include "decode_common.cuh"

namespace {
namespace stk {

constexpr int kRows = 16;        // rows of a tile
constexpr int kXPad = 16;        // bf16 past a staged input row (stride 32 mod 128 bytes)

// The K-slice of an item: the largest of 768, 512, 256 that divides K (K is
// a multiple of 256).
__host__ __device__ inline int item_k(int K) {
  return K % 768 == 0 ? 768 : (K % 512 == 0 ? 512 : 256);
}

__host__ __device__ inline bool is_nib(int form) { return form == kFormQ4K || form == kFormQSNib; }

// code bytes of a row of an item, and their shared-memory stride (16 mod
// 128: conflict-free 4-byte reads of rows g = 0..7; dense 32 mod 128:
// conflict-free 8-byte reads)
__host__ __device__ inline int code_bytes(int form, int ki) {
  return form == kFormDense ? 2 * ki : (is_nib(form) ? ki / 2 : ki);
}
__host__ __device__ inline int code_stride(int form, int ki) {
  return code_bytes(form, ki) + (form == kFormDense ? 32 : 16);
}

// Raw factor bytes of a row of a tile: its group scale codes (or f32
// scales), its offsets, then its f32 super-scales (d, then dmin), each part
// for the whole row (a tile's 16 rows of a part are contiguous in memory).
struct ScaleLayout {
  int sc, mn, d, dm;  // bytes of each part (0 where the form has none)
  __host__ __device__ int row() const { return sc + mn + d + dm; }
};

__host__ __device__ inline ScaleLayout scale_layout(int form, int gs, bool has_mn, int K) {
  ScaleLayout s{0, 0, 0, 0};
  switch (form) {
    case kFormQ4K: s.sc = s.mn = K / 32; s.d = s.dm = K / 256 * 4; break;
    case kFormQKB: s.sc = s.mn = K / gs; s.d = s.dm = K / 256 * 4; break;
    case kFormQ6K: s.sc = K / 16; s.d = K / 256 * 4; break;
    case kFormQS: s.sc = K / gs * 4; s.mn = has_mn ? s.sc : 0; break;
    case kFormQSNib: s.sc = K / 32 * 4; s.mn = has_mn ? s.sc : 0; break;
    default: break;
  }
  return s;
}

// bytes of an item's weight buffer: 16 rows of codes, then 16 rows of
// factors (ki: the item's K-slice; 0: item_k(K))
__host__ __device__ inline int buffer_bytes(int form, int gs, bool has_mn, int K, int ki = 0) {
  return kRows * (code_stride(form, ki ? ki : item_k(K)) + scale_layout(form, gs, has_mn, K).row());
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait for the phase of bar with this parity; a wait past ~2^31 cycles
// (a copy that can never land) traps instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const long long t0 = clock64();
  uint32_t done;
  do {
    if (clock64() - t0 > (1ll << 31)) __trap();
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// A TMA bulk copy of `bytes` (a multiple of 16; both ends 16-byte aligned)
// into shared memory, completing on bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Order this thread's generic-proxy view before its bulk copies: of shared
// memory (the block's reads of a buffer before copies overwrite it), and,
// with `global`, of global memory written in this launch before a barrier.
__device__ __forceinline__ void fence_proxy_async(bool global) {
  if (global) asm volatile("fence.proxy.async;" ::: "memory");
  else asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// One warp's batch of bulk copies on bar: lane 0 announces `bytes` in all,
// then copy i (of n, from copy_of(i) -> dst, src, size) goes out from lane
// i % 32. `global`: some source was written in this launch.
template <class CopyOf>
__device__ __forceinline__ void warp_bulk(uint64_t* bar, uint32_t bytes, int n, bool global,
                                          CopyOf copy_of) {
  const int lane = threadIdx.x & 31;
  fence_proxy_async(global);
  if (lane == 0) mbar_expect_tx(bar, bytes);
  __syncwarp();
  for (int i = lane; i < n; i += 32) {
    void* dst;
    const void* src;
    uint32_t size;
    copy_of(i, dst, src, size);
    bulk_copy(dst, src, size, bar);
  }
}

// d = A * B over one k16 step, from a zero accumulator
__device__ __forceinline__ void mma16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                      uint32_t a3, uint32_t b0, uint32_t b1) {
  const float z = 0.f;
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1), "f"(z), "f"(z), "f"(z), "f"(z));
}

// two floats (exact integers here) as bf16x2: lo in the low half
__device__ __forceinline__ uint32_t bf2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// byte b of w as a float: u8 0..255, or (sgn) i8 -128..127; exact, through
// the mantissa of 2^23
__device__ __forceinline__ float byte_f(uint32_t w, int b, int sgn) {
  const uint32_t u = ((w >> (8 * b)) & 0xFFu) ^ (sgn ? 0x80u : 0u);
  return __uint_as_float(0x4B000000u | u) - (sgn ? 8388736.f : 8388608.f);
}

// bf16x2 a - bias (a * 1 + (-bias)), exact for the small integers here
__device__ __forceinline__ uint32_t bf2_unbias(uint32_t a, uint32_t neg_bias) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(0x3F803F80u), "r"(neg_bias));
  return d;
}

// How a form's codes become exact bf16 (its k16 step's A halves).
enum CodeMode {
  kCodeLow = 1,    // low nibbles: bf16(128 + q) from the mantissa, 128 off
  kCodeHigh = 2,   // high nibbles
  kCode7 = 3,      // u8 codes below 128 (Q5_K, Q2_K): the same
  kCode6 = 4,      // i8 codes in -32..31 (Q6_K, Q3_K): (b & 0x3F) ^ 0x20 = q + 32
  kCodeU8 = 5,     // any u8 code: through f32
  kCodeI8 = 6,     // any i8 code: through f32
};

// A-fragment halves of one row from its word of 4 codes (elements 4t..4t+3
// of the step): (e0, e2) and (e1, e3).
__device__ __forceinline__ void code_pairs(uint32_t w, int mode, uint32_t& p02, uint32_t& p13) {
  switch (mode) {
    case kCodeLow:
    case kCodeHigh: {
      const uint32_t q = mode == kCodeLow ? w : w >> 4;
      p02 = bf2_unbias((q & 0x000F000Fu) | 0x43004300u, 0xC300C300u);
      p13 = bf2_unbias(((q >> 8) & 0x000F000Fu) | 0x43004300u, 0xC300C300u);
      break;
    }
    case kCode7:
      p02 = bf2_unbias((w & 0x007F007Fu) | 0x43004300u, 0xC300C300u);
      p13 = bf2_unbias(((w >> 8) & 0x007F007Fu) | 0x43004300u, 0xC300C300u);
      break;
    case kCode6:
      p02 = bf2_unbias((w & 0x003F003Fu) ^ 0x43204320u, 0xC320C320u);
      p13 = bf2_unbias(((w >> 8) & 0x003F003Fu) ^ 0x43204320u, 0xC320C320u);
      break;
    default: {
      const int sgn = mode == kCodeI8;
      p02 = bf2(byte_f(w, 0, sgn), byte_f(w, 2, sgn));
      p13 = bf2(byte_f(w, 1, sgn), byte_f(w, 3, sgn));
    }
  }
}

// One job of a phase: a matrix (or a row segment of one: the LoRA downs)
// and where its input and output go.
struct Job {
  QMat w;
  int M;        // rows of the job
  int row0;     // its first row in the stored matrix
  int Mst;      // rows of the stored matrix a layer
  int K;        // input width
  int input;    // what the block stages (layer7.cu: kIn*)
  int out;      // epilogue (layer7.cu: kOut*)
  int arg;      // the epilogue's argument (which of r/k/v; the LoRA's offset in z)
  int act;      // LoRA down activation: 0 none, 1 tanh, 2 sigmoid
  int ki, S, tiles;
  int steps, nlo;  // k16 steps of an item; nibble: steps of its low range
  int lg_gs;       // log2 of the group size of a factor (0: dense)
  int code;        // CodeMode of a byte form (nibble forms: kCodeLow / kCodeHigh by step)
  int offs;        // whether the form has offsets (mn * sum x)
};

__host__ __device__ inline int log2i(int v) {
  int r = 0;
  while ((1 << r) < v) ++r;
  return r;
}

// ki: the K-slice of the job's items (a multiple of 256 that divides K;
// 0: item_k(K))
__host__ __device__ inline void job_geometry(Job& j, int ki = 0) {
  const int f = j.w.form;
  j.ki = ki ? ki : item_k(j.K);
  j.S = j.K / j.ki;
  j.tiles = (j.M + kRows - 1) / kRows;
  j.steps = j.ki / 16;
  j.nlo = is_nib(f) ? j.ki / 32 : j.steps;
  j.lg_gs = f == kFormDense ? 0 : log2i(is_nib(f) ? 32 : j.w.gs);
  j.code = f == kFormQKB ? kCode7 : (f == kFormQ6K ? kCode6 : (j.w.sgn ? kCodeI8 : kCodeU8));
  j.offs = f == kFormQ4K || f == kFormQKB ||
           ((f == kFormQS || f == kFormQSNib) && j.w.p2 != nullptr);
}

// The steps (k16 mma) of an item, and the absolute element of step st's
// first code (nibble: the low steps, then the high ones).
__device__ __forceinline__ int step_elem(const Job& j, int s, int st) {
  if (st < j.nlo) return s * (j.ki >> (j.nlo < j.steps)) + 16 * st;
  return j.K / 2 + s * (j.ki / 2) + 16 * (st - j.nlo);  // nibble, high range
}

// The bulk copies of item (tile, s) of job j at layer l into buf, by the
// calling warp, on bar: the tile's 16 row slices of codes (rows past M
// repeat row M - 1; only a dense LoRA segment has such rows), then each of
// its factor parts (16 whole rows, contiguous). `extra` more copies of
// `extra_bytes` in all come from extra_of (layer7.cu: the LayerNorm
// vectors).
template <class ExtraOf>
__device__ void load_item(const Job& j, int l, int tile, int s, uint8_t* buf, uint64_t* bar,
                          int extra, uint32_t extra_bytes, ExtraOf extra_of) {
  const QMat& w = j.w;
  const int ki = j.ki, cb = code_bytes(w.form, ki), cs = code_stride(w.form, ki);
  const int row_cb = code_bytes(w.form, j.K);  // code bytes of a whole row
  const ScaleLayout sl = scale_layout(w.form, w.gs, w.p2 != nullptr, j.K);
  const size_t row0 = (size_t)l * j.Mst + j.row0 + tile * kRows;  // the tile's first row
  uint8_t* fbase = buf + kRows * cs;
  const int nparts = (sl.sc > 0) + (sl.mn > 0) + (sl.d > 0) + (sl.dm > 0);
  const int fbytes = kRows * sl.row();
  warp_bulk(bar, kRows * cb + fbytes + extra_bytes, kRows + nparts + extra, false,
            [&](int i, void*& dst, const void*& src, uint32_t& size) {
              if (i < kRows) {
                const size_t row = (size_t)l * j.Mst + j.row0 + min(tile * kRows + i, j.M - 1);
                dst = buf + i * cs;
                src = w.codes + row * row_cb + (size_t)s * cb;
                size = cb;
                return;
              }
              i -= kRows;
              if (i < nparts) {  // the i-th present part: sc, mn, d, dm in order
                int seen = 0, off = 0;
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                  const int sz = q == 0 ? sl.sc : (q == 1 ? sl.mn : (q == 2 ? sl.d : sl.dm));
                  const void* pp = q == 0 ? w.p1 : (q == 1 ? w.p2 : (q == 2 ? (const void*)w.d8
                                                                             : (const void*)w.dm8));
                  if (sz) {
                    if (seen == i) {
                      dst = fbase + off;
                      src = static_cast<const uint8_t*>(pp) + row0 * sz;
                      size = kRows * sz;
                    }
                    ++seen;
                    off += kRows * sz;
                  }
                }
                return;
              }
              extra_of(i - nparts, dst, src, size);
            });
}

// Row stride of the factor table: odd, so that rows g = 0..7 of a step sit
// in different banks (an even stride of 48 steps put all 8 in one).
__host__ __device__ inline int tab_stride(int steps) { return steps | 1; }

// The f32 factors (s, mn) of every row and step of an item, from the
// tile's raw factors in buf, into tab [kRows][tab_stride(steps)]. Called by
// the whole block.
__device__ void factor_table(const Job& j, int s, const uint8_t* buf, float2* tab) {
  const QMat& w = j.w;
  if (w.form == kFormDense) return;
  const int steps = j.steps;
  const ScaleLayout sl = scale_layout(w.form, w.gs, w.p2 != nullptr, j.K);
  const uint8_t* sc = buf + kRows * code_stride(w.form, j.ki);
  const uint8_t* mn = sc + kRows * sl.sc;
  const float* d = reinterpret_cast<const float*>(mn + kRows * sl.mn);
  const float* dm = d + kRows * (sl.d / 4);
  const int lg = j.lg_gs, G = j.K >> lg, S = j.K >> 8;
  // thread (r, st0) = (threadIdx.x % 16, threadIdx.x / 16): steps st0, st0 + 16, ...
  const int r = threadIdx.x & (kRows - 1);
  for (int st = threadIdx.x >> 4; st < steps; st += blockDim.x >> 4) {
    const int i = r * tab_stride(steps) + st;
    const int e = step_elem(j, s, st), g = e >> lg, sb = e >> 8;
    float f, m = 0.f;
    switch (w.form) {
      case kFormQ4K:
      case kFormQKB:
        f = d[r * S + sb] * (float)sc[r * G + g];
        m = dm[r * S + sb] * (float)mn[r * G + g];
        break;
      case kFormQ6K:
        f = d[r * S + sb] * (float)(int8_t)sc[r * G + g];
        break;
      default:  // f32 scales and optional offsets
        f = reinterpret_cast<const float*>(sc)[r * G + g];
        if (sl.mn) m = reinterpret_cast<const float*>(mn)[r * G + g];
        break;
    }
    tab[i] = make_float2(f, m);
  }
}

// One warp's share of an item: steps warp, warp + 8, ... of the slice,
// against the staged inputs xs ([NB][ki + kXPad] bf16, runs of 4 in the
// order 0, 2, 1, 3) and their step sums xsum ([steps][NB] f32, for forms
// with offsets). acc[f][i]: rows g, g (cols 2t, 2t+1), g + 8, g + 8 of the
// f-th n8 fragment (lanes 8f..8f+7).
template <int NB>
__device__ __forceinline__ void warp_tile(const Job& j, const uint8_t* buf, const float2* tab,
                                          const __nv_bfloat16* xs, const float* xsum,
                                          float (&acc)[NB > 8 ? 2 : 1][4]) {
  constexpr int NF = NB > 8 ? 2 : 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const QMat& w = j.w;
  const int ki = j.ki, steps = j.steps, xstride = ki + kXPad;
  const int cs = code_stride(w.form, ki);
  const bool dense = w.form == kFormDense, nib = is_nib(w.form), offs = j.offs;
  const int nlo = j.nlo, code = j.code;
#pragma unroll
  for (int f = 0; f < NF; ++f)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[f][i] = 0.f;
  for (int st = warp; st < steps; st += kWarps) {
    uint32_t a0, a1, a2, a3;  // rows g, g + 8 by k slots (2t, 2t+1), (2t+8, 2t+9)
    if (dense) {
      const uint2 lo = *reinterpret_cast<const uint2*>(buf + g * cs + 32 * st + 8 * t);
      const uint2 hi = *reinterpret_cast<const uint2*>(buf + (g + 8) * cs + 32 * st + 8 * t);
      a0 = __byte_perm(lo.x, lo.y, 0x5410);
      a2 = __byte_perm(lo.x, lo.y, 0x7632);
      a1 = __byte_perm(hi.x, hi.y, 0x5410);
      a3 = __byte_perm(hi.x, hi.y, 0x7632);
    } else {
      const int chunk = st < nlo ? st : st - nlo;  // nibble: low, then high steps
      const int mode = nib ? (st < nlo ? kCodeLow : kCodeHigh) : code;
      const uint32_t wl = *reinterpret_cast<const uint32_t*>(buf + g * cs + 16 * chunk + 4 * t);
      const uint32_t wh =
          *reinterpret_cast<const uint32_t*>(buf + (g + 8) * cs + 16 * chunk + 4 * t);
      code_pairs(wl, mode, a0, a2);
      code_pairs(wh, mode, a1, a3);
    }
    float2 f0 = make_float2(1.f, 0.f), f1 = f0;  // (s, mn) of rows g, g + 8
    if (!dense) {
      f0 = tab[g * tab_stride(steps) + st];
      f1 = tab[(g + 8) * tab_stride(steps) + st];
    }
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const int n = 8 * f + g;  // this lane's B column
      uint2 b = make_uint2(0u, 0u);
      if (n < NB) b = *reinterpret_cast<const uint2*>(xs + n * xstride + 16 * st + 4 * t);
      float c[4];
      mma16(c, a0, a1, a2, a3, b.x, b.y);
      if (dense) {
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[f][i] += c[i];
      } else {
        float2 x2 = make_float2(0.f, 0.f);  // step sums of columns 2t, 2t + 1
        if (offs) {
          const int c0 = 8 * f + 2 * t;
          if (c0 < NB) x2.x = xsum[st * NB + c0];
          if (c0 + 1 < NB) x2.y = xsum[st * NB + c0 + 1];
        }
        acc[f][0] = fmaf(f0.x, c[0], fmaf(-f0.y, x2.x, acc[f][0]));
        acc[f][1] = fmaf(f0.x, c[1], fmaf(-f0.y, x2.y, acc[f][1]));
        acc[f][2] = fmaf(f1.x, c[2], fmaf(-f1.y, x2.x, acc[f][2]));
        acc[f][3] = fmaf(f1.x, c[3], fmaf(-f1.y, x2.y, acc[f][3]));
      }
    }
  }
}

// warp_tile's steps [st0, st1) (step st0 + warp, + 8, ...) with the code
// mode fixed (kMode: a CodeMode, or 0 for dense bf16 weights), chunk st -
// c0 of the buffer's rows: the same products and sums, without warp_tile's
// per-step choice of mode.
template <int NB, int kMode>
__device__ __forceinline__ void tile_steps(const Job& j, const uint8_t* buf, const float2* tab,
                                           const __nv_bfloat16* xs, const float* xsum, int st0,
                                           int st1, int c0, float (&acc)[NB > 8 ? 2 : 1][4]) {
  constexpr int NF = NB > 8 ? 2 : 1;
  constexpr bool dense = kMode == 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int xstride = j.ki + kXPad, cs = code_stride(j.w.form, j.ki), ts = tab_stride(j.steps);
  const bool offs = j.offs;
  const uint8_t* rg = buf + g * cs;  // rows g and g + 8
  const uint8_t* rh = buf + (g + 8) * cs;
#pragma unroll 2
  for (int st = st0 + warp; st < st1; st += kWarps) {
    uint32_t a0, a1, a2, a3;  // rows g, g + 8 by k slots (2t, 2t+1), (2t+8, 2t+9)
    float2 f0 = make_float2(1.f, 0.f), f1 = f0;  // (s, mn) of rows g, g + 8
    if constexpr (dense) {
      const uint2 lo = *reinterpret_cast<const uint2*>(rg + 32 * st + 8 * t);
      const uint2 hi = *reinterpret_cast<const uint2*>(rh + 32 * st + 8 * t);
      a0 = __byte_perm(lo.x, lo.y, 0x5410);
      a2 = __byte_perm(lo.x, lo.y, 0x7632);
      a1 = __byte_perm(hi.x, hi.y, 0x5410);
      a3 = __byte_perm(hi.x, hi.y, 0x7632);
    } else {
      const int chunk = st - c0;
      code_pairs(*reinterpret_cast<const uint32_t*>(rg + 16 * chunk + 4 * t), kMode, a0, a2);
      code_pairs(*reinterpret_cast<const uint32_t*>(rh + 16 * chunk + 4 * t), kMode, a1, a3);
      f0 = tab[g * ts + st];
      f1 = tab[(g + 8) * ts + st];
    }
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const int n = 8 * f + g;  // this lane's B column
      uint2 b = make_uint2(0u, 0u);
      if (n < NB) b = *reinterpret_cast<const uint2*>(xs + n * xstride + 16 * st + 4 * t);
      float c[4];
      mma16(c, a0, a1, a2, a3, b.x, b.y);
      if constexpr (dense) {
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[f][i] += c[i];
      } else {
        float2 x2 = make_float2(0.f, 0.f);  // step sums of columns 2t, 2t + 1
        if (offs) {
          const int cc = 8 * f + 2 * t;
          if (cc < NB) x2.x = xsum[st * NB + cc];
          if (cc + 1 < NB) x2.y = xsum[st * NB + cc + 1];
        }
        acc[f][0] = fmaf(f0.x, c[0], fmaf(-f0.y, x2.x, acc[f][0]));
        acc[f][1] = fmaf(f0.x, c[1], fmaf(-f0.y, x2.y, acc[f][1]));
        acc[f][2] = fmaf(f1.x, c[2], fmaf(-f1.y, x2.x, acc[f][2]));
        acc[f][3] = fmaf(f1.x, c[3], fmaf(-f1.y, x2.y, acc[f][3]));
      }
    }
  }
}

// warp_tile with the form's code mode chosen once, outside the steps (a
// loop for each mode; a nibble slice's low steps, then its high ones): the
// same steps for each warp in the same order, the same products and sums.
template <int NB>
__device__ __forceinline__ void warp_tile_by_mode(const Job& j, const uint8_t* buf,
                                                  const float2* tab, const __nv_bfloat16* xs,
                                                  const float* xsum,
                                                  float (&acc)[NB > 8 ? 2 : 1][4]) {
  constexpr int NF = NB > 8 ? 2 : 1;
#pragma unroll
  for (int f = 0; f < NF; ++f)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[f][i] = 0.f;
  const int steps = j.steps;
  if (j.w.form == kFormDense) {
    tile_steps<NB, 0>(j, buf, tab, xs, xsum, 0, steps, 0, acc);
  } else if (is_nib(j.w.form)) {
    // a warp's low steps st = warp + 8 i < nlo, then its high ones from the
    // first of them at or past nlo
    const int nlo = j.nlo, warp = threadIdx.x >> 5;
    const int hi0 = nlo + ((warp - nlo) % kWarps + kWarps) % kWarps - warp;
    tile_steps<NB, kCodeLow>(j, buf, tab, xs, xsum, 0, nlo, 0, acc);
    tile_steps<NB, kCodeHigh>(j, buf, tab, xs, xsum, hi0, steps, nlo, acc);
  } else {
    switch (j.code) {
      case kCode7: tile_steps<NB, kCode7>(j, buf, tab, xs, xsum, 0, steps, 0, acc); break;
      case kCode6: tile_steps<NB, kCode6>(j, buf, tab, xs, xsum, 0, steps, 0, acc); break;
      case kCodeU8: tile_steps<NB, kCodeU8>(j, buf, tab, xs, xsum, 0, steps, 0, acc); break;
      default: tile_steps<NB, kCodeI8>(j, buf, tab, xs, xsum, 0, steps, 0, acc);
    }
  }
}

// Each 16-element step's sum of the staged bf16 inputs of lane n (f32),
// from thread t's 4 of them (t = 4 st + q: the step's 4 threads are
// neighbouring lanes); the first of them writes it.
__device__ __forceinline__ void step_sum(float v, int t, int n, int nb, float* xsum) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  if ((t & 3) == 0) xsum[(t >> 2) * nb + n] = v;
}

__device__ __forceinline__ float bf16_sum4(uint2 u) {
  return (__uint_as_float(u.x << 16) + __uint_as_float(u.x & 0xFFFF0000u)) +
         (__uint_as_float(u.y << 16) + __uint_as_float(u.y & 0xFFFF0000u));
}

// Position of element i of a staged row: each run of 4 in the order 0, 2, 1, 3.
__device__ __forceinline__ int perm4(int i) { return (i & ~3) | ((i & 1) << 1) | ((i >> 1) & 1); }

}  // namespace stk
}  // namespace
