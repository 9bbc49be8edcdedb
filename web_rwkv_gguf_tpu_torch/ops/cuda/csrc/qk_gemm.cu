// K-quant dequant-GEMM for Hopper (sm_90a): y[n, m] = sum_k x[n, k] * W[m, k]
// at any row count n, W held as any of the port's logical quantized forms. On
// the main path it runs every quantized matmul of a prefill chunk (n = B*T)
// and the decode matmuls whose n * groups exceeds the gemv's gate.
//
// Replaces: web_rwkv_gguf_tpu/ops/pallas/matmul.py::quant_matmul, slab
// branch (def at line 1225, pallas_call at line 1416; kernel body _kernel
// at line 86).
//
// What it computes (the slab kernel's numerics class, not the gemv's):
//   y = sum_k bf16(x) * bf16(q * s)  -  sum_g mn[m, g] * xs[n, g]
// q the code: split-halves nibbles (low nibble of byte j is element j,
// high nibble element j + K/2; Q4_K, Q4_0, Q4_1), u8 bytes (Q5_K, Q2_K,
// Q5_0, Q5_1, Q4_1 bytes, the engine's Int8) or i8 bytes (Q6_K, Q3_K,
// Q8_0, Q4_0 bytes), or the codebook value of a 4-bit index in pair order
// (the engine's NF4 / SF4: low nibble of byte j is element 2j, high nibble
// 2j + 1; q * s = lut[idx] * absmax in f32, then rounded); s and mn the
// group scale and offset of the element's group (16, 32 or 128 elements;
// 64 for codebook indices): f32 arrays, or 8-bit codes times per-256
// super-scales formed in f32 here (Q4_K / Q5_K / Q2_K: s = d8 * sc6, mn =
// dm8 * mn6; Q6_K / Q3_K: s = q6d * q6s, no offset); xs[n, g] the f32 sum
// of bf16(x) over group g.
// Products are bf16 x bf16 on the tensor cores (wgmma, f32 accumulation),
// the offset term in f32 on the CUDA cores. The tensor core aligns and
// truncates its addends to the largest one, so a sum chained through a
// whole row (K/16 steps) would pull a sum of same-signed products (relu^2
// inputs into the FFN value) toward zero by about half an ulp of the
// running sum at each step; where the offset term then cancels most of
// that sum, the drift is many ulps of y. So each 64-element step's four
// k16 products chain into a fresh fragment (scale-d 0 on the first) that
// ordinary f32 adds (round to nearest) put into the running sums: the
// truncation is then relative to one step's partial sum, not the row's
// (on an H100, tests/test_torch_cuda.py's same-signed inputs sit at
// 0.003-0.016 of that test's limit: scripts/torch_gemm_probe.py).
//
// Bound on this card: operations at prefill n (B*T = 512 rows do 512
// multiply-adds per weight, above the ~295 operations per byte where H100
// stops being memory-bound: [2048, 7168] at n = 512 is 15.2 us of bf16
// tensor work), bytes for the vocabulary heads (a [65536, 2048] head at
// n = 4 or 64 reads its 134-143 MB once: 43-50 us). The design:
// - A block is two consumer warpgroups and a producer warp. The wide
//   tile (n > 128) is 64 weight rows by 2 x 128 input rows: a weight tile
//   is decoded once per 256 rows, twice at n = 512 (64 by 2 x 64 at 64 < n
//   <= 128, where a 256-row tile would be half empty). The narrow tiles
//   (n <= 16, n <= 64) are 2 x 64 weight rows by 16 or 64 input rows, two
//   blocks an SM: the heads stream their weights through 16 warps an SM.
// - Two rings in shared memory, filled by the producer warp with TMA
//   (cp.async.bulk.tensor; tensor maps passed as __grid_constant__,
//   encoded per launch through cuTensorMapEncodeTiled from
//   cudaGetDriverEntryPoint: no -lcuda) and guarded by mbarriers: code
//   tiles (the tile's weight rows x 64 code bytes, swizzled by 64 bytes; 32
//   bytes by 32 for codebook indices), 8 deep (4 in the narrow tiles), and
//   x tiles (the tile's input rows x 64 columns, 128-byte rows in the
//   128-byte-swizzled K-major layout wgmma reads), 3 to 8 deep. A step is
//   64 K columns: a code tile of bytes or indices feeds one, a code tile
//   of nibbles two, its low nibbles (columns 64 p ..) and its high ones
//   (K/2 + 64 p ..), so that every x tile is 64 contiguous columns. TMA
//   fills what lies past M, n and K with zeros: nothing reads past an
//   array's end, and the half-empty last step of a byte row whose K is an
//   odd multiple of 32 (or of a nibble row whose K/2 is) contributes
//   nothing.
// - While a step's wgmma (m64nNk16, A the weight tile and B the x tile,
//   both K-major from shared memory) runs, every consumer thread decodes
//   16 weights of the next step into bf16(q * s) in the other of two
//   weight slots (codes to floats exactly through the exponent of 2^23,
//   codebook entries from shared memory; the scale operands loaded two
//   steps ahead), and one barrier a step publishes them.
// - The offset term: beside the same wgmma, each consumer warpgroup sums
//   its x rows over the step's groups (xs, formed once per x tile: its rows
//   pass through the ring once) and subtracts mn[m, g] * xs[n, g] from its
//   running sums: one f32 product over the G = K/gs groups of an output in
//   all, on the CUDA cores beside the tensor cores. (In the epilogue it
//   would need the group sums of every x row over all of K in shared
//   memory, 229 KB at K = 7168, and run after the products instead of
//   beside them; in warps of its own it would need 128 more registers a
//   thread beside the fragments, which a block of this size cannot give.)
// - Grid: one block per tile; where that leaves more than half the SMs
//   idle ([768, 768], [768, 3072], [2048, 2048] and [2048, 7168] at n =
//   512), K is split across a thread-block cluster of up to 8 blocks (at
//   least 4 steps each, and no more than lets every cluster be resident at
//   once), each taking a contiguous run of code tiles, and the partial
//   tiles are summed through distributed shared memory in rank order (the
//   same order every run).
// - Epilogue: the output tile is staged through shared memory (the rings'
//   space) as [n][m], read back (and from the cluster's other blocks) in
//   16-byte loads and stored row by row, coalesced (scalar loads there
//   cost up to 20 % of a launch: Q8_0 [7168, 2048] at n = 512 took 70.3 us
//   with them, 59.4 with 16-byte ones, on an H100).
// What still bounds it (measured on an H100 by turning parts off,
// PERF.md, Findings): each step is one chain of the wgmma, the decoding, the
// adds into the running sums and the barrier, not hidden behind the next
// step's products; the x and code traffic each take under 5 %.
// At n <= 8 (the decode rows past the gemv's gate) where M/64 tiles would
// leave SMs idle (every layer matrix; not a vocabulary head), the same
// function runs on the CUDA cores in qgemv.cuh's structure (kSlab): one
// row per lane group, each weight bf16(q * s) - mn formed per element and
// summed in f32. There the tensor cores, even with a fresh sum per mma,
// left the products' sum of relu^2 inputs (16-27x max|y| before the
// offset term cancels it) 3-7x further from its f64 value than an f32
// GEMM of the same bf16 operands (on an H100: 3.9e-5 against 7.6e-6 of
// max|y|, Int8 at [2048, 7168], n = 3), and used 12-32 of the 132 SMs; the
// per-element form sits within 1.2e-7.

#include <cuda.h>  // CUtensorMap and its enums (the function itself comes through the runtime)
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "qgemv.cuh"
#include "qscales.cuh"

namespace {

constexpr int kGateRows = 64;  // the gemv gate counts tiles of 64 weight rows
constexpr int kSlots = 4;      // offset groups per 64-element step, at most
constexpr int kMaxSmem = 232448;

// ---- shared memory, barriers, TMA, wgmma (inline PTX) ----------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// 2-D TMA load of the box at (c0 innermost, c1) into shared memory.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// Generic-proxy writes to shared memory made visible to wgmma's async proxy.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// four f32 at p (16-byte aligned) in the shared memory of the cluster's block `rank`
__device__ __forceinline__ float4 ld_cluster4(const float* p, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(smem_u32(p)), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(remote)
               : "memory");
  return v;
}

// wgmma descriptor of a K-major tile of rows of 64 bf16 (128 bytes),
// swizzled by 128 bytes: 8-row groups 1024 bytes apart; the tile 1024-byte
// aligned. The k16 slices of a row start 32 bytes apart (descriptor + 2).
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keeps the compiler from moving reads or writes of a fragment across the
// asynchronous wgmma that owns it
template <int R>
__device__ __forceinline__ void fence_fragment(float* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// two floats rounded to bf16 (nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// D[64 x 16] (= or +=) A[64 x 16] B[16 x 16]^T, both K-major in shared memory
__device__ __forceinline__ void wgmma_n16(float* d, uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(acc));
}

// D[64 x 128] (= or +=) A[64 x 16] B[128 x 16]^T, both K-major in shared memory
__device__ __forceinline__ void wgmma_n128(float* d, uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(acc));
}

// D[64 x 64] (= or +=) A[64 x 16] B[64 x 16]^T, both K-major in shared memory
__device__ __forceinline__ void wgmma_n64(float* d, uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

template <int kN>
__device__ __forceinline__ void wgmma(float* d, uint64_t a, uint64_t b, int acc) {
  if constexpr (kN == 16) wgmma_n16(d, a, b, acc);
  else if constexpr (kN == 64) wgmma_n64(d, a, b, acc);
  else wgmma_n128(d, a, b, acc);
}

// ---- the tile kernel ---------------------------------------------------------

// Raw scale operands of one (row, 16-column quarter) of a step (one group),
// loaded two steps ahead so that their latency hides behind the steps
// between; get() forms s and mn as the scale source's own get() does.
template <class S> struct Pre;

template <> struct Pre<F32Scales> {
  float s, o;
  __device__ __forceinline__ void load(const F32Scales& q, size_t row, int g, bool ok) {
    s = ok ? q.s[row * q.G + g] : 0.f;
    o = ok && q.mn != nullptr ? q.mn[row * q.G + g] : 0.f;
  }
  __device__ __forceinline__ void get(float& sc, float& off) const { sc = s; off = o; }
};

template <> struct Pre<NativeScales> {
  float d, dm;
  uint32_t sc, mn;
  __device__ __forceinline__ void load(const NativeScales& q, size_t row, int g, bool ok) {
    const size_t i = row * q.G + g, sj = row * (q.G / q.reps) + g / q.reps;
    d = ok ? q.d[sj] : 0.f;
    dm = ok ? q.dm[sj] : 0.f;
    sc = ok ? q.sc[i] : 0u;
    mn = ok ? q.mnc[i] : 0u;
  }
  __device__ __forceinline__ void get(float& s, float& off) const {
    s = d * (float)sc;
    off = dm * (float)mn;
  }
};

template <> struct Pre<NominScales> {
  float d;
  int sc;
  __device__ __forceinline__ void load(const NominScales& q, size_t row, int g, bool ok) {
    d = ok ? q.d[row * (q.G / q.reps) + g / q.reps] : 0.f;
    sc = ok ? q.sc[row * q.G + g] : 0;
  }
  __device__ __forceinline__ void get(float& s, float& off) const {
    s = d * (float)sc;
    off = 0.f;
  }
};

template <> struct Pre<LutScales> {
  float a;
  __device__ __forceinline__ void load(const LutScales& q, size_t row, int g, bool ok) {
    a = ok ? q.absmax[row * q.G + g] : 0.f;
  }
  __device__ __forceinline__ void get(float& s, float& off) const {
    s = a;
    off = 0.f;
  }
};

// Shapes and shared memory of one instantiation: 2 consumer warpgroups, as
// kWM weight-row tiles of 64 by kWN input-row tiles of kN (1 x 2: a weight
// tile of 64 rows against 2 x kN input rows; 2 x 1: 128 weight rows
// against kN); kMin: the form has offsets. Two rings filled by one
// producer warp: code tiles and x tiles. A step is 64 K columns; a code
// tile holds one step (bytes, codebook indices) or, for nibbles, the 64
// bytes of a row that feed two steps: their low nibbles (columns 64 p ..)
// and their high ones (columns K/2 + 64 p ..).
template <int kCodes, int kWM, int kN, bool kMin>
struct Tile {
  static constexpr int kWG = 2;                     // consumer warpgroups
  static constexpr int kWN = kWG / kWM;
  static constexpr int kBM = 64 * kWM;              // weight rows per tile
  static constexpr int kBN = kN * kWN;              // input rows per tile
  static constexpr int kCB = kCodes == kLut ? 32 : 64;  // code bytes per weight row per tile
  static constexpr int kSpu = kCodes == kNib ? 2 : 1;   // steps per code tile
  static constexpr int kCodeBytes = kBM * kCB;
  static constexpr int kKC = kWM == 2 ? 4 : 8;      // code ring depth
  static constexpr int kXTile = kBN * 128;          // 64 bf16 columns a row
  static constexpr int kMnOff = kBM * 128;          // A slot: the bf16 weight tile, then offsets
  static constexpr int kASlot = (kMin ? kMnOff + kSlots * kBM * 4 : kMnOff) + 1023 & ~1023;
  static constexpr int kXsBytes = kMin ? kWG * 2 * kSlots * kN * 4 : 0;  // group sums, 2 buffers
  static constexpr int kThreads = 128 * kWG + 32;   // and the producer warp
  static constexpr int kBlocksPerSM = kWM == 2 ? 2 : 1;
  static constexpr int kTail = 1024 + 512;          // alignment; barriers and the codebook
  static constexpr int kFixed = kKC * kCodeBytes + 2 * kASlot + kXsBytes + kTail;
  static constexpr int kBudget = (kBlocksPerSM == 2 ? 115712 : kMaxSmem) - kFixed;
  static constexpr int kKX = kBudget / kXTile < 8 ? kBudget / kXTile : 8;  // x ring depth
  static constexpr int kSmem = kFixed + kKX * kXTile;
  static_assert(kKX >= 3, "x ring depth");
  static_assert(kSmem <= kMaxSmem && kSmem * kBlocksPerSM <= 233472 - 1024 * kBlocksPerSM,
                "shared memory");
  static_assert(kBN * (kBM + 4) * 4 <= kKX * kXTile + kKC * kCodeBytes,
                "the staged output tile fits the two rings");
};

// Code tiles of a row (64 bytes: one step of bytes, two of nibbles; 32: one
// step of codebook indices); K is split between blocks in whole code tiles.
template <int kCodes>
__host__ __device__ inline int code_tiles(int k) {
  return kCodes == kU8 || kCodes == kI8 ? (k + 63) / 64 : kCodes == kLut ? k / 64 : (k + 127) / 128;
}

template <int kCodes, class S, int kWM, int kN, bool kMin>
__global__ void __launch_bounds__(Tile<kCodes, kWM, kN, kMin>::kThreads,
                                  Tile<kCodes, kWM, kN, kMin>::kBlocksPerSM)
qk_gemm_kernel(const __grid_constant__ CUtensorMap tm_codes, const __grid_constant__ CUtensorMap tm_x,
               const S scales, float* __restrict__ y, int n, int m, int k, int gs) {
  using T = Tile<kCodes, kWM, kN, kMin>;
  constexpr int kKC = T::kKC, kKX = T::kKX, kSpu = T::kSpu, kBMt = T::kBM;
  constexpr int kConsumers = 128 * T::kWG;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* xring = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                              ~static_cast<uintptr_t>(1023));
  uint8_t* cring = xring + kKX * T::kXTile;
  uint8_t* aslots = cring + kKC * T::kCodeBytes;
  float* xsums = reinterpret_cast<float*>(aslots + 2 * T::kASlot);
  uint64_t* cfull = reinterpret_cast<uint64_t*>(reinterpret_cast<uint8_t*>(xsums) + T::kXsBytes);
  uint64_t* cempty = cfull + kKC;
  uint64_t* xfull = cempty + kKC;
  uint64_t* xempty = xfull + kKX;
  float* lut_s = reinterpret_cast<float*>(xempty + kKX);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int split = gridDim.x, rank = blockIdx.x;  // the cluster's blocks divide K
  const int m0 = blockIdx.y * kBMt, n0 = blockIdx.z * T::kBN;
  const int tiles = code_tiles<kCodes>(k);
  const int t_begin = (int)((long long)tiles * rank / split);
  const int n_tiles = (int)((long long)tiles * (rank + 1) / split) - t_begin;
  const int s_begin = t_begin * kSpu, n_steps = n_tiles * kSpu;
  const int half = k >> 1;
  // offset groups per step: 64 / gs (nibbles: two 32-groups of one half)
  const int slots = kCodes == kNib ? 2 : gs == 16 ? 4 : gs == 32 ? 2 : 1;

  if (tid == 0) {
    for (int i = 0; i < kKC; ++i) {
      mbar_init(&cfull[i], 1);
      mbar_init(&cempty[i], kConsumers / 32);  // every consumer warp decodes part of a tile
    }
    for (int i = 0; i < kKX; ++i) {
      mbar_init(&xfull[i], 1);
      mbar_init(&xempty[i], kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if constexpr (kCodes == kLut) {
    if (tid < 16) lut_s[tid] = scales.lut[tid];
  }
  __syncthreads();

  float* ys = reinterpret_cast<float*>(xring);  // the output tile [n][m], staged at the end
  if (tid >= kConsumers) {
    // ---- producer warp: code tiles and x tiles, in step order -----------
    if (lane == 0) {
      for (int i = 0; i < n_steps; ++i) {
        if (i % kSpu == 0) {
          const int j = i / kSpu, sl = j % kKC;
          if (j >= kKC) mbar_wait(&cempty[sl], ((j / kKC) - 1) & 1);
          mbar_expect_tx(&cfull[sl], T::kCodeBytes);
          tma_load(cring + sl * T::kCodeBytes, &tm_codes, &cfull[sl], T::kCB * (t_begin + j), m0);
        }
        const int sl = i % kKX, st = s_begin + i;
        if (i >= kKX) mbar_wait(&xempty[sl], ((i / kKX) - 1) & 1);
        mbar_expect_tx(&xfull[sl], T::kXTile);
        tma_load(xring + sl * T::kXTile, &tm_x, &xfull[sl],
                 kCodes == kNib ? (st & 1) * half + 64 * (st >> 1) : 64 * st, n0);
      }
    }
  } else {
    // ---- consumer warpgroup c: weight rows 64 wm .., input rows kN wn ..
    // of the tile. Every consumer thread also decodes part of each step's
    // weight tile: 16 columns of a row, (kBM / 64) times.
    const int c = tid >> 7;
    const int wm = kWM == 2 ? c : 0, wn = kWM == 2 ? 0 : c;
    const int ct = tid & 127;
    const int r0 = 16 * (ct >> 5) + (lane >> 2);  // fragment rows r0, r0 + 8
    constexpr int kPasses = kBMt * 4 / kConsumers;  // (row, 16-column quarter) pairs a thread
    // this thread's groups of step i, loaded into p[]
    auto prefetch = [&](Pre<S>* p, int i) {
      if (i >= n_steps) return;
      const int st = s_begin + i;
#pragma unroll
      for (int ps = 0; ps < kPasses; ++ps) {
        const int u = tid + ps * kConsumers, r = u >> 2, q = u & 3;
        const bool rok = m0 + r < m;
        if constexpr (kCodes == kNib) {
          const int e0 = 64 * (st >> 1) + 16 * q;  // in its half: low st even, high st odd
          p[ps].load(scales, m0 + r, ((st & 1) * half + e0) / 32, rok && e0 < half);
        } else if constexpr (kCodes == kLut) {
          p[ps].load(scales, m0 + r, st, rok);
        } else {
          const int e0 = 64 * st + 16 * q;
          p[ps].load(scales, m0 + r, e0 / gs, rok && e0 < k);
        }
      }
    };
    // step i's weight tile, decoded into A slot i % 2
    auto decode = [&](int i, const Pre<S>* p) {
      const int ctl = i / kSpu, cs = ctl % kKC;
      mbar_wait(&cfull[cs], (ctl / kKC) & 1);
      const uint8_t* ctile = cring + cs * T::kCodeBytes;
      uint8_t* abase = aslots + (i & 1) * T::kASlot;
      const bool high = kCodes == kNib && ((s_begin + i) & 1);
#pragma unroll
      for (int ps = 0; ps < kPasses; ++ps) {
        const int u = tid + ps * kConsumers, r = u >> 2, q = u & 3;
        float s, off;
        p[ps].get(s, off);
        uint32_t out[8];  // the 16 bf16 weights of row r, columns 16 q ..
        if constexpr (kCodes == kLut) {
          const uint2 v = *reinterpret_cast<const uint2*>(
              ctile + r * 32 + 16 * ((q >> 1) ^ ((r >> 2) & 1)) + 8 * (q & 1));  // 32-byte swizzle
          const uint32_t w[2] = {v.x, v.y};
#pragma unroll
          for (int hw = 0; hw < 2; ++hw) {
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              const uint32_t byte = (w[hw] >> (8 * b)) & 0xFFu;
              out[4 * hw + b] = pack_bf16(lut_s[byte & 0xFu] * s, lut_s[byte >> 4] * s);
            }
          }
        } else {
          const uint4 v = *reinterpret_cast<const uint4*>(
              ctile + r * 64 + 16 * (q ^ ((r >> 1) & 3)));  // 64-byte swizzle
          const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float f[4];
            if constexpr (kCodes == kNib) {
              bytes4<kU8>(high ? (w[j] >> 4) & 0x0F0F0F0Fu : w[j] & 0x0F0F0F0Fu, f);
            } else {
              bytes4<kCodes>(w[j], f);
            }
            out[2 * j] = pack_bf16(f[0] * s, f[1] * s);
            out[2 * j + 1] = pack_bf16(f[2] * s, f[3] * s);
          }
        }
        uint8_t* arow = abase + r * 128;  // 128-byte swizzle
        *reinterpret_cast<uint4*>(arow + 16 * ((2 * q) ^ (r & 7))) =
            make_uint4(out[0], out[1], out[2], out[3]);
        *reinterpret_cast<uint4*>(arow + 16 * ((2 * q + 1) ^ (r & 7))) =
            make_uint4(out[4], out[5], out[6], out[7]);
        if constexpr (kMin) {  // the step's group offsets, [slot][row]
          float* mn_s = reinterpret_cast<float*>(abase + T::kMnOff);
          if (slots == 4) mn_s[q * kBMt + r] = off;
          else if (slots == 2 && (q & 1) == 0) mn_s[(q >> 1) * kBMt + r] = off;
          else if (slots == 1 && q == 0) mn_s[r] = off;
        }
      }
      __syncwarp();
      if (lane == 0 && i % kSpu == kSpu - 1) mbar_arrive(&cempty[cs]);  // the code tile is free
    };
    auto publish = [&]() {  // this step's decoded tile visible to every warpgroup's wgmma
      fence_async_smem();
      asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
    };

    float acc[kN / 2];   // the running sums of the warpgroup's 64 x kN outputs
    float frag[kN / 2];  // one step's products
#pragma unroll
    for (int j = 0; j < kN / 2; ++j) acc[j] = frag[j] = 0.f;
    Pre<S> pa[kPasses], pb[kPasses];  // steps i and i + 1: no load is waited on early
    prefetch(pa, 0);
    prefetch(pb, 1);
    if (n_steps > 0) {
      decode(0, pa);
      prefetch(pa, 2);
      publish();
    }
    auto step = [&](int i, Pre<S>* pn) {  // pn: the operands of step i + 1
      const int xsl = i % kKX;
      mbar_wait(&xfull[xsl], (i / kKX) & 1);
      const uint8_t* xt = xring + xsl * T::kXTile + wn * kN * 128;
      const uint8_t* abase = aslots + (i & 1) * T::kASlot;
      const uint64_t a = sw128_desc(abase + wm * 64 * 128), b = sw128_desc(xt);
      fence_fragment<kN / 2>(frag);
      wg_fence();
      wgmma<kN>(frag, a, b, 0);  // a fresh sum: see the note at the top
      wgmma<kN>(frag, a + 2, b + 2, 1);
      wgmma<kN>(frag, a + 4, b + 4, 1);
      wgmma<kN>(frag, a + 6, b + 6, 1);
      wg_commit();
      // beside the wgmma: the next step's weights, then the offset term
      if (i + 1 < n_steps) {
        decode(i + 1, pn);
        prefetch(pn, i + 3);
      }
      if constexpr (kMin) {
        // the step's group sums of this warpgroup's x rows, then
        // acc -= mn[m, g] * xs[n, g] over the step's groups
        float* xsb = xsums + (c * 2 + (i & 1)) * kSlots * kN;
        if (ct < kN) {
          float u[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};  // sums over each 8 columns
          if (n0 + wn * kN + ct < n) {
#pragma unroll
            for (int q = 0; q < 8; ++q) {  // kN is a multiple of 8: the tile row's swizzle
              const uint4 v = *reinterpret_cast<const uint4*>(xt + ct * 128 + 16 * (q ^ (ct & 7)));
              float f[8];
              bf16x8(v, f);
              u[q] = ((f[0] + f[1]) + (f[2] + f[3])) + ((f[4] + f[5]) + (f[6] + f[7]));
            }
          }
          if (slots == 4) {
#pragma unroll
            for (int g = 0; g < 4; ++g) xsb[g * kN + ct] = u[2 * g] + u[2 * g + 1];
          } else if (slots == 2) {
#pragma unroll
            for (int g = 0; g < 2; ++g)
              xsb[g * kN + ct] = (u[4 * g] + u[4 * g + 1]) + (u[4 * g + 2] + u[4 * g + 3]);
          } else {
            xsb[ct] = ((u[0] + u[1]) + (u[2] + u[3])) + ((u[4] + u[5]) + (u[6] + u[7]));
          }
        }
        asm volatile("bar.sync %0, 128;" ::"r"(2 + c) : "memory");
        const float* mn_s = reinterpret_cast<const float*>(abase + T::kMnOff) + wm * 64;
        const float* xq = xsb + 2 * (lane & 3);
#pragma unroll 1
        for (int g = 0; g < slots; ++g) {
          const float ma = mn_s[g * kBMt + r0], mb = mn_s[g * kBMt + r0 + 8];
#pragma unroll
          for (int j = 0; j < kN / 8; ++j) {
            const float2 xv = *reinterpret_cast<const float2*>(xq + g * kN + 8 * j);
            acc[4 * j] = fmaf(-ma, xv.x, acc[4 * j]);
            acc[4 * j + 1] = fmaf(-ma, xv.y, acc[4 * j + 1]);
            acc[4 * j + 2] = fmaf(-mb, xv.x, acc[4 * j + 2]);
            acc[4 * j + 3] = fmaf(-mb, xv.y, acc[4 * j + 3]);
          }
        }
      }
      wg_wait0();
      fence_fragment<kN / 2>(frag);
      __syncwarp();
      if (lane == 0) mbar_arrive(&xempty[xsl]);  // the x tile is free
#pragma unroll
      for (int j = 0; j < kN / 2; ++j) acc[j] += frag[j];
      publish();  // step i + 1's weights are in place; step i's slot is free again
    };
    for (int i = 0; i < n_steps; i += 2) {
      step(i, pb);
      if (i + 1 < n_steps) step(i + 1, pa);
    }
    // stage the tile as [n][m] over the two rings (every step consumed: no
    // load in flight; the last publish() was the consumers' last barrier)
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
      const int col = wn * kN + 8 * j + 2 * (lane & 3), row = wm * 64 + r0;
      ys[col * (kBMt + 4) + row] = acc[4 * j];
      ys[(col + 1) * (kBMt + 4) + row] = acc[4 * j + 1];
      ys[col * (kBMt + 4) + row + 8] = acc[4 * j + 2];
      ys[(col + 1) * (kBMt + 4) + row + 8] = acc[4 * j + 3];
    }
  }

  // ---- epilogue: sum the cluster's staged tiles in rank order, store -----
  __syncwarp();
  cluster_sync();
  const int rows = n - n0 < T::kBN ? n - n0 : T::kBN;
  for (int idx = tid;; idx += T::kThreads) {  // 4 outputs a thread, from 16-byte loads
    const int j = rank + split * (idx / (kBMt / 4));  // this block's rows: j = rank mod split
    if (j >= rows) break;
    const int mm = 4 * (idx % (kBMt / 4));
    if (m0 + mm < m) {
      float4 v;
      if (split == 1) {
        v = *reinterpret_cast<const float4*>(ys + j * (kBMt + 4) + mm);
      } else {
        v = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int p = 0; p < split; ++p) {
          const float4 u = ld_cluster4(ys + j * (kBMt + 4) + mm, p);
          v.x += u.x;
          v.y += u.y;
          v.z += u.z;
          v.w += u.w;
        }
      }
      float* yr = y + (size_t)(n0 + j) * m + m0 + mm;
      const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (m0 + mm + e < m) yr[e] = vs[e];
    }
  }
  cluster_sync();  // no block leaves while another reads its tile
}

// ---- host side ---------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, looked up through the runtime (no -lcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 2-D row-major [rows, cols] array of `elem`-byte elements, read in boxes
// of [box_rows, box_cols], zero past its ends.
bool tensor_map(CUtensorMap* map, CUtensorMapDataType type, int elem, const void* ptr,
                uint64_t cols, uint64_t rows, uint32_t box_cols, uint32_t box_rows,
                CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * elem};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kCodes, class S, int kWM, int kN, bool kMin>
int launch_tiles(const void* x, const void* codes, const S& scales, void* y, int n, int m, int k,
                 int gs, int sms, cudaStream_t stream) {
  using T = Tile<kCodes, kWM, kN, kMin>;
  auto kernel = qk_gemm_kernel<kCodes, S, kWM, kN, kMin>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int tiles_m = (m + T::kBM - 1) / T::kBM, tiles_n = (n + T::kBN - 1) / T::kBN;
  const int tiles = tiles_m * tiles_n;
  const int units = code_tiles<kCodes>(k);  // K is split in whole code tiles
  // Split K across a cluster where the tiles would leave over half the SMs
  // idle: at least 4 steps a block, and no more blocks a cluster than lets
  // every cluster be resident at once (clusters of 5 at one block an SM do
  // not all fit: [768, 3072] at n = 512 took 51 us split 5, 30 split 4).
  const int capacity = sms * T::kBlocksPerSM;
  int split = 1;
  if (2 * tiles <= capacity) {
    split = capacity / tiles;
    if (split > 8) split = 8;
    const int most = units * T::kSpu / 4;
    if (split > most) split = most > 1 ? most : 1;
    static int resident[9];  // clusters of each size resident at once, found once
    for (; split > 1; --split) {
      if (resident[split] == 0) {
        cudaLaunchConfig_t q = {};
        q.gridDim = dim3(split, 1, 1);
        q.blockDim = dim3(T::kThreads);
        q.dynamicSmemBytes = T::kSmem;
        cudaLaunchAttribute a[1];
        a[0].id = cudaLaunchAttributeClusterDimension;
        a[0].val.clusterDim.x = split;
        a[0].val.clusterDim.y = 1;
        a[0].val.clusterDim.z = 1;
        q.attrs = a;
        q.numAttrs = 1;
        int count = 0;
        const cudaError_t err = cudaOccupancyMaxActiveClusters(&count, kernel, &q);
        if (err != cudaSuccess) return (int)err;
        resident[split] = count > 0 ? count : -1;
      }
      if (resident[split] >= tiles) break;
    }
  }
  const uint64_t row_bytes = kCodes == kU8 || kCodes == kI8 ? (uint64_t)k : (uint64_t)k / 2;
  CUtensorMap tm_codes, tm_x;
  if (!tensor_map(&tm_codes, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, codes, row_bytes, m, T::kCB, T::kBM,
                  T::kCB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B) ||
      !tensor_map(&tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, k, n, 64, T::kBN,
                  CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, tiles_m, tiles_n);
  cfg.blockDim = dim3(T::kThreads);
  cfg.dynamicSmemBytes = T::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, tm_codes, tm_x, scales,
                                             static_cast<float*>(y), n, m, k, gs);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// Whether a scale source has offsets: always, never, or where its array is
// given (f32 scales).
template <class S> struct Offsets { static constexpr int kind = 2; };
template <> struct Offsets<NativeScales> { static constexpr int kind = 1; };
template <> struct Offsets<NominScales> { static constexpr int kind = 0; };
template <> struct Offsets<LutScales> { static constexpr int kind = 0; };

template <int kCodes, class S, int kWM, int kN>
int launch_tiles_for(const void* x, const void* codes, const S& scales, void* y, int n, int m,
                     int k, int gs, int sms, cudaStream_t stream) {
  if constexpr (Offsets<S>::kind == 2) {
    if (scales.mn != nullptr)
      return launch_tiles<kCodes, S, kWM, kN, true>(x, codes, scales, y, n, m, k, gs, sms, stream);
    return launch_tiles<kCodes, S, kWM, kN, false>(x, codes, scales, y, n, m, k, gs, sms, stream);
  } else {
    return launch_tiles<kCodes, S, kWM, kN, Offsets<S>::kind == 1>(x, codes, scales, y, n, m, k,
                                                                    gs, sms, stream);
  }
}

template <int kCodes, class S>
int launch(const void* x, const void* codes, const S& scales, void* y, int n, int m, int k,
           int gs, void* stream) {
  const bool gs_ok = kCodes == kNib   ? gs == 32 && k % 64 == 0
                    : kCodes == kLut ? gs == 64 && k % 64 == 0
                                     : gs == 16 || gs == 32 || gs == 128;
  if (m <= 0 || n <= 0 || k % 32 || k % gs || !gs_ok) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (n <= 8 && (size_t)n * k * sizeof(float) + 64 <= (size_t)kGemvSmem && (m + kGateRows - 1) / kGateRows < sms)
    return qgemv_dispatch<kCodes, true>(x, codes, scales, y, n, m, k, gs, stream);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 16) return launch_tiles_for<kCodes, S, 2, 16>(x, codes, scales, y, n, m, k, gs, sms, s);
  if (n <= 64) return launch_tiles_for<kCodes, S, 2, 64>(x, codes, scales, y, n, m, k, gs, sms, s);
  if (n <= 128) return launch_tiles_for<kCodes, S, 1, 64>(x, codes, scales, y, n, m, k, gs, sms, s);
  return launch_tiles_for<kCodes, S, 1, 128>(x, codes, scales, y, n, m, k, gs, sms, s);
}

}  // namespace

// Every entry: x bf16 [n, k] (16-byte aligned); codes 16-byte aligned; y
// f32 [n, m]; all contiguous. Returns the cudaError_t of the launch.

// codes u8 [m, k/2] split halves; sc6, mn6 u8 [m, k/32]; d8, dm8 f32
// [m, k/256]; k % 256 == 0.
extern "C" int q4k_gemm(const void* x, const void* codes, const void* sc6,
                        const void* mn6, const void* d8, const void* dm8,
                        void* y, int n, int m, int k, void* stream) {
  if (k % 256) return (int)cudaErrorInvalidValue;
  const NativeScales s{static_cast<const uint8_t*>(sc6), static_cast<const uint8_t*>(mn6),
                       static_cast<const float*>(d8), static_cast<const float*>(dm8), k / 32, 8};
  return launch<kNib>(x, codes, s, y, n, m, k, 32, stream);
}

// codes i8 [m, k]; q6s i8 [m, k/16]; q6d f32 [m, k/256]; k % 256 == 0.
extern "C" int q6k_gemm(const void* x, const void* codes, const void* q6s,
                        const void* q6d, void* y, int n, int m, int k,
                        void* stream) {
  if (k % 256) return (int)cudaErrorInvalidValue;
  const NominScales s{static_cast<const int8_t*>(q6s), static_cast<const float*>(q6d), k / 16, 16};
  return launch<kI8>(x, codes, s, y, n, m, k, 16, stream);
}

// Q5_K / Q2_K: codes u8 [m, k]; sc6, mn6 u8 [m, k/gs]; d8, dm8 f32
// [m, k/256]; k % 256 == 0; gs 32 (Q5_K) or 16 (Q2_K).
extern "C" int qkb_gemm(const void* x, const void* codes, const void* sc6,
                        const void* mn6, const void* d8, const void* dm8,
                        void* y, int n, int m, int k, int gs, void* stream) {
  if (k % 256 || (gs != 16 && gs != 32)) return (int)cudaErrorInvalidValue;
  const NativeScales s{static_cast<const uint8_t*>(sc6), static_cast<const uint8_t*>(mn6),
                       static_cast<const float*>(d8), static_cast<const float*>(dm8), k / gs,
                       256 / gs};
  return launch<kU8>(x, codes, s, y, n, m, k, gs, stream);
}

// f32 group scales: codes [m, k/2] u8 split-halves nibbles (code_kind 0) or
// [m, k] u8 (1) / i8 (2) bytes; scales f32 [m, k/gs]; mins f32 [m, k/gs] or
// null; gs 16, 32 or 128 (32 for nibbles); k % 32 == 0, k % gs == 0 (k % 64
// == 0 for nibbles). The engine's Int8: u8 codes, gs 128, mins = -mn.
extern "C" int qs_gemm(const void* x, const void* codes, const void* scales,
                       const void* mins, void* y, int n, int m, int k, int gs,
                       int code_kind, void* stream) {
  if (gs != 16 && gs != 32 && gs != 128) return (int)cudaErrorInvalidValue;
  const F32Scales s{static_cast<const float*>(scales), static_cast<const float*>(mins), k / gs};
  switch (code_kind) {
    case kNib: return launch<kNib>(x, codes, s, y, n, m, k, gs, stream);
    case kU8: return launch<kU8>(x, codes, s, y, n, m, k, gs, stream);
    case kI8: return launch<kI8>(x, codes, s, y, n, m, k, gs, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// NF4 / SF4: codes u8 [m, k/2] codebook indices in pair order; absmax f32
// [m, k/64]; lut f32 [16]; k % 64 == 0.
extern "C" int nf4_gemm(const void* x, const void* codes, const void* absmax,
                        const void* lut, void* y, int n, int m, int k, void* stream) {
  if (k % 64) return (int)cudaErrorInvalidValue;
  const LutScales s{static_cast<const float*>(absmax), static_cast<const float*>(lut), k / 64};
  return launch<kLut>(x, codes, s, y, n, m, k, 64, stream);
}
