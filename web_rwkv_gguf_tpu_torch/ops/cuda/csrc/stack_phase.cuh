// The matrix phases of the whole-stack decode kernels (layer7.cu,
// layer56.cu) over stack_mma.cuh's tensor-core items: where an item sits
// in a phase's jobs, its weight copies, the staged inputs that come by bulk
// copy from scratch the launch wrote in the staged order, and an item's
// products, their sum over the block's warps and the split-K fold.
//
// A phase is a list of jobs (stk::Job); its items are each job's tiles
// times its K-slices, job by job, tile-major. A matrix whose K is split
// writes each slice's f32 partial sums of a tile to scratch (part); a
// per-tile counter (cnt, released with a fence and an atomic, reset by its
// last arrival, so the next phase, launch or CUDA graph replay finds it at
// zero with no memset) tells the last block of a tile, which adds the
// slices in slice order: no atomics on values, deterministic. The scratch
// and counters are sized by the kernel's own plan; the wrapper passes at
// least what an upper bound of it needs, and the kernel checks.

#pragma once

#include "stack_mma.cuh"

namespace {
namespace stk {

// The block's copy barriers (shared memory): bit i of `armed` is the
// parity of barrier i's armings (a register: no indexed array, which would
// live in local memory). The n-th arming of one completes its phase n - 1.
struct Bars {
  uint64_t* bar;
  uint32_t armed;
  __device__ void arm(int i) { armed ^= 1u << i; }
  __device__ void wait(int i) const { mbar_wait(bar + i, ((armed >> i) & 1u) ^ 1u); }
};

// items of a phase's n jobs
// A token-shift mix x + m (s - x), rounded after the difference, the
// product and the sum, as the plain versions (and the JAX package) round
// it. A fused multiply-add, which the compiler contracts this to otherwise,
// rounds once; where the mix sits at a bf16 tie the two round it to
// neighbouring bf16 operands of the products after it (the Q4_1 RWKV-7
// stack of scripts/torch_kernel_cases.py at B = 16 moved its WKV state
// 1.41-1.57 of MEGA_LAYER_TOL from the plain version's so;
// scripts/torch_stack_chain.py).
__device__ __forceinline__ float mix_rn(float x, float m, float s) {
  return __fadd_rn(x, __fmul_rn(m, __fsub_rn(s, x)));
}

__device__ __forceinline__ int jobs_items(const Job* jobs, int n) {
  int items = 0;
  for (int i = 0; i < n; ++i) items += jobs[i].tiles * jobs[i].S;
  return items;
}

// item -> (job, tile, slice); tbase: the job's first tile in the phase
__device__ __forceinline__ const Job& locate_item(const Job* jobs, int n, int item, int& tile,
                                                  int& s, int& tbase) {
  tbase = 0;
  int i = 0;
  for (; i < n - 1 && item >= jobs[i].tiles * jobs[i].S; ++i) {
    item -= jobs[i].tiles * jobs[i].S;
    tbase += jobs[i].tiles;
  }
  tile = item / jobs[i].S;
  s = item - tile * jobs[i].S;
  return jobs[i];
}

// The staged position's element (input channel): a nibble slice is its
// low range, then its high range.
__device__ __forceinline__ int slice_elem(const Job& j, int s, int i) {
  if (is_nib(j.w.form)) {
    const int j0 = s * (j.ki / 2);
    return i < j.ki / 2 ? j0 + i : j.K / 2 + j0 + (i - j.ki / 2);
  }
  return s * j.ki + i;
}

// The bulk copies of item (tile, s) of job j at layer l (its weight tile)
// into buf, by warp 1, on barrier `which`; every thread counts the arming.
__device__ void load_job_item(const Job& j, int l, int tile, int s, uint8_t* buf, Bars& bs,
                              int which) {
  bs.arm(which);
  if ((threadIdx.x >> 5) == 1)
    load_item(j, l, tile, s, buf, bs.bar + which, 0, 0u,
              [](int, void*&, const void*&, uint32_t&) {});
}

// Stage slice s of job j's bf16 input from src ([B][K], written in this
// launch in the staged order: each run of 4 as 0, 2, 1, 3) into xs
// [nb][ki + kXPad] by one batch of bulk copies on barrier `in`, and each
// step's sum of it (xsum [steps][nb], for a form with offsets); `meanwhile`
// (the weight-side work) runs while the copies land.
template <class Meanwhile>
__device__ __forceinline__ void stage_copied(const Job& j, int s, int B, int nb,
                                             const __nv_bfloat16* src, __nv_bfloat16* xs,
                                             float* xsum, Bars& bs, int in, Meanwhile meanwhile) {
  const int ki = j.ki, xstride = ki + kXPad;
  const int nr = is_nib(j.w.form) ? 2 : 1, span = ki / nr;  // ranges of the slice
  const int t = threadIdx.x, groups = ki / 4;  // runs of 4 of the slice
  bs.arm(in);
  if ((threadIdx.x >> 5) == 1)
    warp_bulk(bs.bar + in, B * ki * 2, B * nr, true,
              [&](int i, void*& dst, const void*& from, uint32_t& size) {
                const int n = i / nr, e = (i - n * nr) * span;
                dst = xs + (size_t)n * xstride + e;
                from = src + (size_t)n * j.K + slice_elem(j, s, e);
                size = span * 2;
              });
  meanwhile();
  bs.wait(in);
  if (j.offs) {  // groups is a multiple of 32: a warp's threads are all in or all out
    for (int q = t; q < groups; q += kThreads)
      for (int n = 0; n < B; ++n)
        step_sum(bf16_sum4(*reinterpret_cast<const uint2*>(xs + (size_t)n * xstride + 4 * q)),
                 q, n, nb, xsum);
  }
}

// An item's products, once its input is staged (xs, xsum) and its weights
// (buf) and factor table (tab) are in place (kByMode: by warp_tile_by_mode,
// else warp_tile): the block's warps split the
// slice's steps on the tensor cores, their sums meet in red [kWarps][16][NB]
// in warp order (then `freed()`: no thread reads buf again), and thread
// (r, n) < 16 B of the tile's rows and lanes gets the sum of row r, lane n:
// epi(r, n, v, xold) for an unsplit tile; a split tile's partial sums go
// to part and the last of its S blocks (counter cnt[tbase + tile]) adds
// the slices in slice order and calls epi. xold: x [B][C] at (n, row) for
// a residual add, read by the caller for an unsplit tile and here, after
// the fold, for a split one (xres non-null: x).
template <int NB, class Freed, class Epi, bool kByMode = false>
__device__ __forceinline__ void item_products(const Job& j, int tile, int s, int tbase, int B,
                                              const uint8_t* buf, const float2* tab,
                                              const __nv_bfloat16* xs, const float* xsum,
                                              float* red, unsigned int* flag, float* part,
                                              unsigned int* cnt, const float* xres, int C,
                                              float xold, Freed freed, Epi epi) {
  constexpr int NF = NB > 8 ? 2 : 1;
  const int outs = kRows * B;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  __syncthreads();
  float acc[NF][4];
  if constexpr (kByMode) warp_tile_by_mode<NB>(j, buf, tab, xs, xsum, acc);
  else warp_tile<NB>(j, buf, tab, xs, xsum, acc);
#pragma unroll
  for (int f = 0; f < NF; ++f) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = g + 8 * (i >> 1), n = 8 * f + 2 * t + (i & 1);
      if (n < NB) red[(warp * kRows + r) * NB + n] = acc[f][i];
    }
  }
  __syncthreads();
  freed();
  float v = 0.f;
  int r = 0, n = 0;
  if ((int)threadIdx.x < outs) {
    r = threadIdx.x / B;
    n = threadIdx.x - r * B;
    for (int w = 0; w < kWarps; ++w) v += red[(w * kRows + r) * NB + n];
  }
  if (j.S == 1) {
    if ((int)threadIdx.x < outs) epi(r, n, v, xold);
    return;
  }
  // a split tile: the partial sums of this slice, then the last of the
  // tile's S blocks adds the S slices in slice order
  const size_t tix = (size_t)tbase + tile;
  if ((int)threadIdx.x < outs) part[(tix * j.S + s) * outs + threadIdx.x] = v;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int prev = atomicAdd(cnt + tix, 1u);
    const bool last = prev == (unsigned int)j.S - 1;
    if (last) cnt[tix] = 0u;  // for the next use (a later phase, past a barrier)
    *flag = last;
  }
  __syncthreads();
  if (*flag && (int)threadIdx.x < outs) {
    __threadfence();
    const int m = tile * kRows + r;
    if (xres != nullptr && m < j.M) xold = __ldcg(xres + (size_t)n * C + m);
    float sum = 0.f;
#pragma unroll 4
    for (int q = 0; q < j.S; ++q) sum += __ldcg(part + (tix * j.S + q) * outs + threadIdx.x);
    epi(r, n, sum, xold);
  }
}

}  // namespace stk
}  // namespace
