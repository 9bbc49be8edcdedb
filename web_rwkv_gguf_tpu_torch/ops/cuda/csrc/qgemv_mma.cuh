// Per-group tensor-core dequant gemv for Hopper (sm_90a), shared by
// q4k_gemv.cu (Q4_K native factors) and q6k_gemv.cu (Q6_K and Q3_K native
// factors): y[n, m] = sum_k x[n, k] * W[m, k] for n <= 8 input rows (x
// rounded to bf16 by the caller), W = q * s - mn per group with the scale
// sources of qscales.cuh (s = d * sc and mn = dmin * mn formed in f32).
//
// Numerics: the factored form of the TPU kernels (_gemv2_body,
// _gemv_sf_body in web_rwkv_gguf_tpu/ops/pallas/matmul.py), per group
//   y[n, row] += s[row, g] * (sum_{k in g} q[row, k] * x[n, k])
//              - mn[row, g] * xs[n, g],
// xs the f32 sum of bf16(x) over the group, formed once per block. The
// codes are small integers and bf16 holds them exactly (Q4_K 0..15, Q6_K
// -32..31, Q3_K -4..3), so each group's products are exact and their sum
// is an f32 sum: one mma.sync m16n8k16 (16 weight rows by the 16 codes of
// one group, against the same 16 elements of the n <= 8 rows of x, zero
// columns past n) per group, its accumulator zero at the start of every
// group; Q4_K's 32-groups take two, each fresh, added in f32. Nothing
// chains across groups, so a long same-signed sum never sits in one
// tensor-core accumulator. The same function as the plain version
// (x @ (q * s - mn).T in f32), summed in another order.
//
// Bound on this card: bytes. At n <= 8 each weight byte feeds at most 16
// multiply-adds, far below the ~295 operations per byte where the H100
// stops being memory-bound. Design:
// - A persistent grid of 8-warp blocks, as many as the SMs hold at this
//   shared memory size (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or
//   fewer where the tiles run out. Each block stages x once, as bf16, in
//   the order the B fragments read it (each 32-element run permuted so a
//   lane's elements for two groups are one 16-byte load; rows padded to 64
//   bytes mod 128 so the loads are conflict-free). x's first loads go out
//   before the code ring's: behind it they waited on megabytes of codes.
// - A warp streams 16-row tiles in units of 128 code bytes a row (Q4_K 256
//   weights, Q6_K 128) through a ring of kMmaRing stages of its own:
//   cp.async (16-byte code chunks, the unit's scale codes and
//   super-scales), three units in flight per warp. Chunks land XOR-swizzled
//   so that ldmatrix.x4 reads them without bank conflicts; ldmatrix hands
//   lane (g, t) bytes 4t..4t+3 of a chunk of rows g and g + 8, the k slots
//   its A fragment needs (a 16-byte chunk is one Q6_K group and half of two
//   Q4_K groups). Within a group the k order is (4t, 4t+2 | 4t+1, 4t+3):
//   A and the staged x use the same order.
// - Codes to bf16 exactly with integer operations: (byte & 0x3F) ^ 0x20 in
//   the mantissa of 128 is bf16(160 + q) for Q6_K/Q3_K, a nibble is
//   bf16(128 + q) for Q4_K; one bf16x2 FMA subtracts the bias exactly.
//   Scale codes become f32 through the exponent of 2^23 and one FMA that
//   rounds d * sc once, as the plain version's product.
// - Short matrices: the 8 warps of a block split a tile's units (ks warps a
//   tile, 8 / ks tiles a block, ks picked per shape to spread the tiles'
//   units over the SMs); their partial sums meet in shared memory and are
//   added in a fixed order. One launch, deterministic. Where a tile has
//   fewer units than a block has warps and the tiles fit one block an SM,
//   a unit's four chunk pairs split over 2 or 4 warps (kSplit): one warp's
//   unit of products was most of such a launch's time.
// - Any M >= 1 (the last tile reads row M - 1 again and stores nothing of
//   the rows past M), K % 256 == 0, any x the wrapper takes (n * K * 4 <=
//   the shared memory of a block).
// What bounds it (H100, PERF.md, Findings; parts switched off in turn):
// the stream itself (codes only) runs at 2.1-2.5 TB/s, and Q4_K's unit of
// products and scales, not hidden behind it, adds 2-14 µs on the large
// shapes (the Q6_K head's ~2 µs).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMmaWarps = 8;       // warps per block
constexpr int kMmaRing = 4;        // stages of a warp's ring
constexpr int kMmaSmem = 232448;   // bytes of shared memory a block may use
constexpr int kUnitBytes = 128;    // code bytes of a tile row per stage
constexpr int kMmaMinBlocks = 2;   // blocks an SM holds (registers: __launch_bounds__)
constexpr int kMmaBatch = 4;       // 16-byte x loads in flight a thread while x is staged

enum MmaForm { kFormQ4K = 0, kFormQ6K = 1 };

// Scale bytes of a tile row per stage: Q4_K the unit's four low and four
// high sc6 and mn6 codes and its two d8 and dm8 super-scales (32), Q6_K its
// eight q6s codes and its q6d super-scale (12, padded to 16).
template <int kForm>
__host__ __device__ constexpr int mma_scale_bytes() { return kForm == kFormQ4K ? 32 : 16; }

template <int kForm>
__host__ __device__ constexpr int mma_stage_bytes() { return 16 * (kUnitBytes + mma_scale_bytes<kForm>()); }

// f32 row stride of the staged group sums: even (two columns a lane), >= n
template <int N>
__host__ __device__ constexpr int mma_xs_stride() { return N < 2 ? 2 : (N + 1) & ~1; }

struct MmaArgs {
  const __nv_bfloat16* x;  // [n, k]
  const uint8_t* codes;    // Q4_K [m, k/2] split-halves nibbles; Q6_K [m, k] i8
  const uint8_t* sc;       // Q4_K sc6 u8 [m, k/32]; Q6_K q6s i8 [m, k/16]
  const uint8_t* mn;       // Q4_K mn6 u8 [m, k/32]
  const float* d;          // Q4_K d8 [m, k/256]; Q6_K q6d [m, k/256]
  const float* dm;         // Q4_K dm8 [m, k/256]
  float* y;                // [n, m]
  int m, k;
  int ks;                  // warps per tile (1, 2, 4 or 8)
  int lg_parts;            // log2 of the items a unit splits into (0, 1 or 2)
};

template <int N, int kForm>
size_t mma_smem_bytes(int k) {
  return (size_t)kMmaWarps * kMmaRing * mma_stage_bytes<kForm>()  // rings
         + 2 * kMmaWarps * 128 * sizeof(float)                    // split-K partial sums
         + (size_t)N * (k + 32) * sizeof(__nv_bfloat16)           // x
         + (kForm == kFormQ4K ? (size_t)(k / 32) * mma_xs_stride<N>() * sizeof(float) : 0);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
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

// bf16x2 a - bias (a * 1 + (-bias)), exact for the small integers here
__device__ __forceinline__ uint32_t bf2_unbias(uint32_t a, uint32_t neg_bias) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(0x3F803F80u), "r"(neg_bias));
  return d;
}

// Q6_K / Q3_K: the i8 codes of bytes 0 and 2 (e02) or 1 and 3 (e13) of a
// word as bf16x2: (b & 0x3F) ^ 0x20 = q + 32 in the mantissa of 128 is
// bf16(160 + q), then 160 off
__device__ __forceinline__ void q6_pairs(uint32_t w, uint32_t& e02, uint32_t& e13) {
  e02 = bf2_unbias((w & 0x003F003Fu) ^ 0x43204320u, 0xC320C320u);
  e13 = bf2_unbias(((w >> 8) & 0x003F003Fu) ^ 0x43204320u, 0xC320C320u);
}

// Q4_K: the low (element j) and high (element j + K/2) nibbles of bytes 0
// and 2 or 1 and 3 of a word as bf16x2: bf16(128 + q), then 128 off
__device__ __forceinline__ void q4_pairs(uint32_t w, uint32_t& lo02, uint32_t& lo13,
                                         uint32_t& hi02, uint32_t& hi13) {
  lo02 = bf2_unbias((w & 0x000F000Fu) | 0x43004300u, 0xC300C300u);
  lo13 = bf2_unbias(((w >> 8) & 0x000F000Fu) | 0x43004300u, 0xC300C300u);
  hi02 = bf2_unbias(((w >> 4) & 0x000F000Fu) | 0x43004300u, 0xC300C300u);
  hi13 = bf2_unbias(((w >> 12) & 0x000F000Fu) | 0x43004300u, 0xC300C300u);
}

// round(d * byte b of w) for u8 scale codes: 2^23 + b from the exponent of
// 2^23, then one FMA with -2^23 * d (exact) rounds d * b once
__device__ __forceinline__ float u8_times(uint32_t w, int b, float d) {
  return fmaf(d, __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540 + b)), -8388608.f * d);
}

// round(d * byte b of w) for i8 scale codes (w biased by 0x80 in each byte
// beforehand): u = b + 128 exactly, then d * u - 128 * d rounded once
__device__ __forceinline__ float i8_times(uint32_t wb, int b, float d) {
  const float u = __uint_as_float(__byte_perm(wb, 0x4B000000u, 0x7540 + b)) - 8388608.f;
  return fmaf(d, u, -128.f * d);
}

// kSplit: units split into 2^lg_parts items (tiny matrices); otherwise one
// item a unit, and the item loop compiles as such.
template <int N, int kForm, bool kSplit>
__global__ void __launch_bounds__(kMmaWarps * 32, kMmaMinBlocks) qgemv_mma_kernel(const MmaArgs a) {
  constexpr bool kQ4 = kForm == kFormQ4K;
  constexpr int kScl = mma_scale_bytes<kForm>();
  constexpr int kStage = mma_stage_bytes<kForm>();
  constexpr int kXs = mma_xs_stride<N>();
  extern __shared__ __align__(128) uint8_t smem[];
  const int m = a.m, k = a.k, ks = a.ks;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  uint8_t* ring = smem + warp * kMmaRing * kStage;
  float* red = reinterpret_cast<float*>(smem + kMmaWarps * kMmaRing * kStage);  // [2][8][128]
  __nv_bfloat16* xsm = reinterpret_cast<__nv_bfloat16*>(red + 2 * kMmaWarps * 128);
  const int kx = k + 32;  // staged x row: 2k + 64 bytes, 64 mod 128
  float* xsum = reinterpret_cast<float*>(xsm + N * kx);  // [k/32][kXs] (Q4_K)

  // A tile's work: its units, each split into 2^lg_parts items of 4 >>
  // lg_parts chunk pairs (the unit's 16-byte chunks 2cp, 2cp + 1 of every
  // row); the ks warps of a tile take items kp, kp + ks, ...
  const int row_bytes = kQ4 ? k >> 1 : k;
  const int lg_parts = kSplit ? a.lg_parts : 0;
  const int items = (row_bytes / kUnitBytes) << lg_parts;  // of a tile
  const int ntiles = (m + 15) >> 4;
  const int tpb = kMmaWarps / ks;  // tiles a block takes at a time
  const int slot = warp / ks, kp = warp % ks;
  const int ntg = (ntiles + tpb - 1) / tpb;
  const int iters = (int)blockIdx.x < ntg ? (ntg - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  const int cnt = kp < items ? (items - kp + ks - 1) / ks : 0;  // this warp's items of a tile
  auto tile_of = [&](int it) { return ((int)blockIdx.x + it * (int)gridDim.x) * tpb + slot; };
  auto items_of = [&](int it) { return tile_of(it) < ntiles ? cnt : 0; };
  const int cps = 4 >> lg_parts;  // chunk pairs an item

  // ---- producer: item (pit, pi) of this warp's sequence into a ring stage
  int pit = 0, pi = 0;
  while (pit < iters && items_of(pit) == 0) ++pit;
  // Q4_K scale piece of this lane: 0/1 sc6 low/high, 2/3 mn6, 4/5 d8, 6/7 dm8
  const int piece = lane & 7;
  const uint8_t* sbase = piece < 2 ? a.sc
                         : piece < 4 ? a.mn
                         : piece < 6 ? reinterpret_cast<const uint8_t*>(a.d)
                                     : reinterpret_cast<const uint8_t*>(a.dm);
  const int sstride = piece < 4 ? k >> 5 : (k >> 8) * 4;  // bytes a row
  auto issue = [&](int s) {
    const int tile = tile_of(pit);
    const int item = kp + pi * ks;
    const int u = item >> lg_parts, c0 = (item & ((1 << lg_parts) - 1)) * 2 * cps;
    const uint32_t st = smem_addr(ring + s * kStage);
    // the item's 16 rows by 2 * cps chunks, 4 >> lg_parts chunks a lane
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i < cps) {
        const int idx = i * 32 + lane;
        const int r = idx >> (3 - lg_parts), c = c0 + (idx & (2 * cps - 1));
        const int grow = min(tile * 16 + r, m - 1);
        cp_async16(st + r * kUnitBytes + ((c ^ (r & 7)) << 4),
                   a.codes + (size_t)grow * row_bytes + u * kUnitBytes + c * 16);
      }
    }
    const int crow = lane >> 3;  // scale copy i: row 4i + crow
    const uint32_t ss = st + 16 * kUnitBytes;
    if constexpr (kQ4) {
      // first element of the unit's low (code bytes' low nibbles) or high half
      const int e0 = (piece & 1 ? k >> 1 : 0) + u * kUnitBytes;
      const int off = piece < 4 ? e0 >> 5 : (e0 >> 8) * 4;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 4 * i + crow;
        const int grow = min(tile * 16 + r, m - 1);
        cp_async4(ss + r * kScl + piece * 4, sbase + (size_t)grow * sstride + off);
      }
    } else {
      const int r = lane & 15;
      const int grow = min(tile * 16 + r, m - 1);
      if (lane < 16)
        cp_async8(ss + r * kScl, a.sc + (size_t)grow * (k >> 4) + u * 8);
      else
        cp_async4(ss + r * kScl + 8, a.d + (size_t)grow * (k >> 8) + (u >> 1));
    }
    if (++pi == items_of(pit)) {
      pi = 0;
      do ++pit;
      while (pit < iters && items_of(pit) == 0);
    }
  };
  // ---- x (and Q4_K's group sums), once per block. The first kMmaBatch
  // 16-byte loads a thread go out before the ring's prologue: loads issued
  // after it wait behind every block's first units (megabytes), and the
  // first products wait on x.
  const int oct = k >> 3;         // 16-byte pieces (8 elements) of an x row
  const int total = N * oct;      // a multiple of 32: a warp's pieces all in or all out
  constexpr int kStep = kMmaWarps * 32;
  uint4 v[kMmaBatch];
  auto load_x = [&](int i0) {
#pragma unroll
    for (int b = 0; b < kMmaBatch; ++b)
      if (i0 + b * kStep < total) v[b] = reinterpret_cast<const uint4*>(a.x)[i0 + b * kStep];
  };
  auto store_x = [&](int i0) {
#pragma unroll
    for (int b = 0; b < kMmaBatch; ++b) {
      const int i = i0 + b * kStep;
      if (i < total) {
        const int n = i / oct, p = i - n * oct;  // granules 2p, 2p + 1 of row n
        const uint32_t w[4] = {v[b].x, v[b].y, v[b].z, v[b].w};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // granule s = 4h' + t' of a 32-run (elements 16h' + 4t' ..) to
          // place 2t' + h', its elements in the order (0, 2 | 1, 3)
          const int sg = (2 * p + h) & 7;
          *reinterpret_cast<uint2*>(xsm + n * kx + (p >> 2) * 32 + (2 * (sg & 3) + (sg >> 2)) * 4) =
              make_uint2(__byte_perm(w[2 * h], w[2 * h + 1], 0x5410),
                         __byte_perm(w[2 * h], w[2 * h + 1], 0x7632));
        }
        if constexpr (kQ4) {  // the run's sum over its 4 pieces: 4 neighbouring lanes
          float e[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            e[q] = __uint_as_float(w[q] << 16) + __uint_as_float(w[q] & 0xFFFF0000u);
          float sum = (e[0] + e[1]) + (e[2] + e[3]);
          sum += __shfl_xor_sync(0xffffffffu, sum, 1);
          sum += __shfl_xor_sync(0xffffffffu, sum, 2);
          if ((p & 3) == 0) xsum[(p >> 2) * kXs + n] = sum;
        }
      }
    }
  };
  load_x(threadIdx.x);
#pragma unroll
  for (int s = 0; s < kMmaRing - 1; ++s) {
    if (pit < iters) issue(s);
    cp_async_commit();
  }
  for (int i0 = threadIdx.x; i0 < total; i0 += kMmaBatch * kStep) {
    if (i0 != (int)threadIdx.x) load_x(i0);
    store_x(i0);
  }
  __syncthreads();

  // ---- consumer
  // ldmatrix.x4 of chunks (2cp, 2cp + 1): lane l gives row l & 15, chunk 2cp + (l >> 4)
  const int lrow = lane & 15, lhalf = lane >> 4;
  auto ldoff = [&](int cp) { return lrow * kUnitBytes + (((2 * cp + lhalf) ^ (lrow & 7)) << 4); };
  const __nv_bfloat16* xg = xsm + g * kx + 8 * t;  // this lane's B fragment column
  const int xt = min(2 * t, kXs - 2);               // its two group-sum columns
  const int hblk = k >> 6;                          // Q4_K: 32-run of element K/2

  int cs = 0, ps = kMmaRing - 1;
  for (int it = 0; it < iters; ++it) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};  // rows g, g + 8 by columns 2t, 2t + 1
    const int tile = tile_of(it);
    const int nu = items_of(it);
    for (int i = 0; i < nu; ++i) {
      cp_async_wait<kMmaRing - 2>();
      __syncwarp();
      const int item = kp + i * ks;
      const int u = item >> lg_parts;
      const int cp0 = (item & ((1 << lg_parts) - 1)) * cps;  // the item's chunk pairs
      const uint8_t* st = ring + cs * kStage;
      const uint32_t st_s = smem_addr(st);
      const uint8_t* scl = st + 16 * kUnitBytes;
      // one chunk pair's products into acc; the item's pairs in straight
      // lines (a branch between them would stop their interleaving)
      auto pairs = [&](auto&& body) {
        if (cps == 4) {
          body(0); body(1); body(2); body(3);
        } else if (cps == 2) {
          body(cp0); body(cp0 + 1);
        } else {
          body(cp0);
        }
      };
      if constexpr (kQ4) {
        uint4 p[2];   // rows g, g + 8: sc6 low, high, mn6 low, high (4 groups each)
        float4 f[2];  // d8 low, high, dm8 low, high
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          p[rr] = *reinterpret_cast<const uint4*>(scl + (g + 8 * rr) * kScl);
          f[rr] = *reinterpret_cast<const float4*>(scl + (g + 8 * rr) * kScl + 16);
        }
        pairs([&](int cp) {
          uint32_t q[4];  // rows g, g + 8 of chunk 2cp; rows g, g + 8 of chunk 2cp + 1
          ldmatrix_x4(q, st_s + ldoff(cp));
          const int lb = 4 * u + cp, hb = hblk + 4 * u + cp;  // 32-runs (groups) of x
          uint4 bl = make_uint4(0, 0, 0, 0), bh = bl;
          if (g < N) {
            bl = *reinterpret_cast<const uint4*>(xg + lb * 32);
            bh = *reinterpret_cast<const uint4*>(xg + hb * 32);
          }
          const float2 xl = *reinterpret_cast<const float2*>(xsum + lb * kXs + xt);
          const float2 xh = *reinterpret_cast<const float2*>(xsum + hb * kXs + xt);
          float sl[2], sh[2], ol[2], oh[2];  // the two groups' factors of rows g, g + 8
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            sl[rr] = u8_times(p[rr].x, cp, f[rr].x);
            sh[rr] = u8_times(p[rr].y, cp, f[rr].y);
            ol[rr] = u8_times(p[rr].z, cp, f[rr].z);
            oh[rr] = u8_times(p[rr].w, cp, f[rr].w);
          }
          float cl[4], ch[4];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            uint32_t l0[2], l1[2], h0[2], h1[2];  // [row g, row g + 8]
            q4_pairs(q[2 * h], l0[0], l1[0], h0[0], h1[0]);
            q4_pairs(q[2 * h + 1], l0[1], l1[1], h0[1], h1[1]);
            float dl[4], dh[4];
            mma16(dl, l0[0], l0[1], l1[0], l1[1], h ? bl.z : bl.x, h ? bl.w : bl.y);
            mma16(dh, h0[0], h0[1], h1[0], h1[1], h ? bh.z : bh.x, h ? bh.w : bh.y);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              cl[j] = h ? cl[j] + dl[j] : dl[j];
              ch[j] = h ? ch[j] + dh[j] : dh[j];
            }
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int rr = j >> 1;
            const float xlj = j & 1 ? xl.y : xl.x, xhj = j & 1 ? xh.y : xh.x;
            acc[j] = fmaf(sl[rr], cl[j], acc[j]);
            acc[j] = fmaf(-ol[rr], xlj, acc[j]);
            acc[j] = fmaf(sh[rr], ch[j], acc[j]);
            acc[j] = fmaf(-oh[rr], xhj, acc[j]);
          }
        });
      } else {
        uint4 p[2];  // rows g, g + 8: eight q6s codes (biased by 128), q6d
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          p[rr] = *reinterpret_cast<const uint4*>(scl + (g + 8 * rr) * kScl);
          p[rr].x ^= 0x80808080u;
          p[rr].y ^= 0x80808080u;
        }
        pairs([&](int cp) {
          uint32_t q[4];
          ldmatrix_x4(q, st_s + ldoff(cp));
          uint4 b = make_uint4(0, 0, 0, 0);
          if (g < N) b = *reinterpret_cast<const uint4*>(xg + (4 * u + cp) * 32);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            uint32_t e02[2], e13[2];  // [row g, row g + 8]
            q6_pairs(q[2 * h], e02[0], e13[0]);
            q6_pairs(q[2 * h + 1], e02[1], e13[1]);
            float c[4];
            mma16(c, e02[0], e02[1], e13[0], e13[1], h ? b.z : b.x, h ? b.w : b.y);
            const int grp = 2 * cp + h;  // of the unit's 8
            float s[2];
#pragma unroll
            for (int rr = 0; rr < 2; ++rr)
              s[rr] = i8_times(grp < 4 ? p[rr].x : p[rr].y, grp & 3, __uint_as_float(p[rr].z));
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[j] = fmaf(s[j >> 1], c[j], acc[j]);
          }
        });
      }
      if (pit < iters) issue(ps);
      cp_async_commit();
      cs = cs + 1 == kMmaRing ? 0 : cs + 1;
      ps = ps + 1 == kMmaRing ? 0 : ps + 1;
    }

    if (ks == 1) {
      if (tile < ntiles) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = 2 * t + (j & 1), row = tile * 16 + g + 8 * (j >> 1);
          if (col < N && row < m) a.y[(size_t)col * m + row] = acc[j];
        }
      }
    } else {  // the ks partial sums of each tile, added in warp order
      float* mine = red + ((it & 1) * kMmaWarps + warp) * 128;
      *reinterpret_cast<float4*>(mine + lane * 4) = make_float4(acc[0], acc[1], acc[2], acc[3]);
      __syncthreads();
      const float* part = red + (it & 1) * kMmaWarps * 128;
      for (int v = threadIdx.x; v < tpb * 16 * N; v += blockDim.x) {
        const int ts = v / (16 * N), rem = v - ts * 16 * N;
        const int col = rem >> 4, r = rem & 15;
        const int row = (((int)blockIdx.x + it * (int)gridDim.x) * tpb + ts) * 16 + r;
        if (row < m) {
          const int e = ((r & 7) * 4 + (col >> 1)) * 4 + (col & 1) + 2 * (r >> 3);
          float sum = 0.f;
          for (int p = 0; p < ks; ++p) sum += part[(ts * ks + p) * 128 + e];
          a.y[(size_t)col * m + row] = sum;
        }
      }
    }
  }
}

// Launch on a persistent grid: blocks per SM by occupancy at this shared
// memory size (found once per size); ks warps a tile and the items a unit
// splits into picked to take the least work a warp.
template <int N, int kForm>
cudaError_t qgemv_mma_launch(MmaArgs args, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes<N, kForm>(args.k);
  if (smem > (size_t)kMmaSmem) return cudaErrorInvalidValue;
  auto kernel = qgemv_mma_kernel<N, kForm, false>;
  auto split = qgemv_mma_kernel<N, kForm, true>;
  static size_t seen_smem[8];
  static int seen_blocks[8];
  static int n_seen = 0;
  int per_sm = 0;
  for (int i = 0; i < n_seen; ++i)
    if (seen_smem[i] == smem) per_sm = seen_blocks[i];
  if (per_sm == 0) {
    cudaError_t err = cudaSuccess;
    if (n_seen == 0) {  // the limit once for every size
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMmaSmem);
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(split, cudaFuncAttributeMaxDynamicSharedMemorySize, kMmaSmem);
    }
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kMmaWarps * 32, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    if (n_seen < 8) {
      seen_smem[n_seen] = smem;
      seen_blocks[n_seen++] = per_sm;
    }
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int slots = per_sm * sms;
  const int units = (kForm == kFormQ4K ? args.k / 2 : args.k) / kUnitBytes;
  const int ntiles = (args.m + 15) / 16;
  // ks: the fewest rounds of resident blocks times units a warp, ties to
  // fewer warps a tile. A tiny matrix (a tile has fewer units than a block
  // has warps, and the tiles fit one block an SM at 8 warps a tile) takes
  // 8 warps a tile and splits its units into items, at most one a warp:
  // one warp's unit of products is most of such a launch's latency.
  long best = -1;
  int blocks = 1;
  for (int ks = 1; ks <= kMmaWarps; ks *= 2) {
    const int ntg = (ntiles + kMmaWarps / ks - 1) / (kMmaWarps / ks);
    const long rounds = (long)((ntg + slots - 1) / slots) * ((units + ks - 1) / ks);
    if (best < 0 || rounds < best) {
      best = rounds;
      args.ks = ks;
      blocks = ntg < slots ? ntg : slots;
    }
  }
  args.lg_parts = 0;
  if (units < kMmaWarps && ntiles <= sms) {
    args.ks = kMmaWarps;
    while (args.lg_parts < 2 && (units << (args.lg_parts + 1)) <= kMmaWarps) ++args.lg_parts;
    blocks = ntiles;
  }
  (args.lg_parts ? split : kernel)<<<blocks, kMmaWarps * 32, smem, stream>>>(args);
  return cudaGetLastError();
}

// n = 1..8 to the kernel instantiated for it.
template <int kForm>
int qgemv_mma_dispatch(const MmaArgs& args, int n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 1: return (int)qgemv_mma_launch<1, kForm>(args, s);
    case 2: return (int)qgemv_mma_launch<2, kForm>(args, s);
    case 3: return (int)qgemv_mma_launch<3, kForm>(args, s);
    case 4: return (int)qgemv_mma_launch<4, kForm>(args, s);
    case 5: return (int)qgemv_mma_launch<5, kForm>(args, s);
    case 6: return (int)qgemv_mma_launch<6, kForm>(args, s);
    case 7: return (int)qgemv_mma_launch<7, kForm>(args, s);
    case 8: return (int)qgemv_mma_launch<8, kForm>(args, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
