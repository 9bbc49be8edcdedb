// What the chunk scans wkv6_scan.cu (V6/V5) and wkv7_scan.cu (V7) share,
// Hopper sm_90a: the placement of the state over threads and blocks, and
// the ring of staged token tiles that a producer warp keeps filled.
//
// The state of one (lane, head) is S[64 keys, 64 value columns], and each
// column evolves on its own in both versions (V7's sa = a^T S is per
// column too). So a (lane, head) is split by columns over `ncb` blocks
// (grid y), `ncb` chosen from B*H alone so that the grid reaches about
// kTargetBlocks blocks; and within a block each column is held by kKs
// consumer threads, each with kKpt of its keys in registers (one column a
// thread with 8 keys measured fastest: two or four columns a thread read
// each key value from shared memory fewer times, but their longer threads
// lost more). The sums over keys (y, and V7's sa) are kKs partial sums
// folded by xor-shuffles. The
// key split is fixed, so the arithmetic of a column never depends on B, H,
// T or the column split: a lane of 37 tokens ends in the same state bit
// for bit whether it runs at T = 37 or padded to T = 64.
//
// The per-token vectors (all 64 keys of r, k, w, and V7's a, b; the v
// row) are staged in shared memory a tile of kTile tokens at a time by the
// block's last warp, the producer: each vector's (lane, head) slice is a
// strided 2-D tile (T rows of 256 bytes, H * 256 bytes apart), so a tile
// of it is one TMA tensor box {64 keys, 1 head, kTile tokens}: one copy a
// vector a tile (one copy a row took ~3,400 cycles a tile to issue). The
// stages form a ring of kStages, each with a "full" mbarrier (the copies
// landed, and the producer's second arrival: the tile's mask flags are in
// place beside them) and an "empty" one (every consumer warp is done with
// it). So the consumers' token loop reads only shared memory and
// registers, and the producer runs up to kStages tiles ahead of them. The
// copies are issued before the mask is read, and a consumer gives a padded
// token w = 1 and k v = 0 (and V7's b sa = 0) by selects, as the TPU
// kernel's pre-masking does: S stays as it was, bit for bit, and y there is
// read from it.
// Every block of a (lane, head) stages the same rows: the second and later
// reads come from L2.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (the encoder comes through the runtime)
#include <cuda_runtime.h>
#include <stdint.h>

namespace wkv_scan {

constexpr int kHs = 64;             // head size the scans take (K = V = 64)
constexpr int kKpt = 8;             // keys of its column one thread holds
constexpr int kTile = 8;            // tokens a stage of the ring holds
constexpr int kStages = 3;          // stages of the ring
constexpr int kTargetBlocks = 132;  // the grid the column split aims for

constexpr int kKs = kHs / kKpt;         // threads that share a column
constexpr int kCpw = 32 / kKs;          // columns a warp holds
constexpr int kMaxSplit = kHs / kCpw;   // column blocks of a (lane, head), at most
constexpr int kMaxThreads = kHs * kKs + 32;  // a block's threads at a split of 1
constexpr int kBarBytes = ((16 + kTile) * kStages + 127) / 128 * 128;  // mbarriers, mask flags
constexpr int kRowBytes = kHs * 4;      // one staged row
static_assert(kKs >= 2 && kKs <= 32 && kKpt % 4 == 0, "key split");
static_assert(kMaxSplit >= 1, "column split");
static_assert(kTile == 8, "a tile's mask flags are read as one 8-byte word");

// The staged vectors' tensor maps: [B*T tokens, H heads, 64 keys] f32,
// read in boxes of one head's kTile tokens.
template <int NV>
struct Maps {
  CUtensorMap m[NV];
};

template <int NV>
__host__ __device__ constexpr int stage_floats() {
  return NV * kTile * kHs;
}

template <int NV>
__host__ __device__ constexpr size_t smem_bytes() {
  return kBarBytes + (size_t)kStages * stage_floats<NV>() * sizeof(float);
}

// The thread's place among the consumers (threads [0, consumers)): its key
// slice (keys kq * kKpt ...) and its column.
struct Slot {
  int kq, col;
};

__device__ __forceinline__ int consumers() { return (int)blockDim.x - 32; }

__device__ __forceinline__ Slot slot() {
  const int lane = threadIdx.x & 31;
  return {lane / kCpw, (int)blockIdx.y * (consumers() / kKs) + (int)(threadIdx.x >> 5) * kCpw +
                           lane % kCpw};
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
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

// A TMA copy of the box of head h, tokens [row, row + kTile) into shared
// memory, completing on bar.
__device__ __forceinline__ void copy_tile(void* dst, const CUtensorMap* map, uint64_t* bar, int h,
                                          int row) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(0), "r"(h), "r"(row)
      : "memory");
}

// The ring in the block's dynamic shared memory: kStages full and empty
// mbarriers and the tiles' mask flags, then the stages ([NV][kTile][64]
// floats each).
template <int NV>
struct Ring {
  uint64_t* full;
  uint64_t* empty;
  uint8_t* flags;  // [kStages][kTile], 8-byte aligned
  float* stage0;

  __device__ __forceinline__ explicit Ring(unsigned char* smem)
      : full(reinterpret_cast<uint64_t*>(smem)),
        empty(reinterpret_cast<uint64_t*>(smem) + kStages),
        flags(smem + 16 * kStages),
        stage0(reinterpret_cast<float*>(smem + kBarBytes)) {}

  __device__ __forceinline__ float* stage(int j) const {
    return stage0 + j % kStages * stage_floats<NV>();
  }

  // Thread 0 sets the barriers up; the whole block then synchronizes.
  __device__ __forceinline__ void init() const {
    if (threadIdx.x == 0) {
      for (int s = 0; s < kStages; ++s) {
        mbar_init(full + s, 2);  // the copies' arrival, then the flags'
        mbar_init(empty + s, consumers() / 32);
      }
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
  }

  // The producer warp: every tile of lane b, head h, in order, each into
  // its stage once every consumer warp has released the tile before it;
  // the vectors of `staged` (a bit each) are copied. The box of a tile
  // that ends past the lane's T reads on into the next lane's tokens (or
  // zeros past the last one), which no consumer uses.
  __device__ void produce(const Maps<NV>& maps, unsigned staged, const uint8_t* mask_row,
                          int b, int h, int T) const {
    const int lane = threadIdx.x & 31;
    const int tiles = (T + kTile - 1) / kTile;
    for (int j = 0; j < tiles; ++j) {
      const int s = j % kStages, t0 = j * kTile;
      if (j >= kStages) mbar_wait(empty + s, (j / kStages - 1) & 1);
      if (lane == 0) {
        mbar_expect_tx(full + s, (uint32_t)(__popc(staged) * kTile * kRowBytes));
#pragma unroll
        for (int vi = 0; vi < NV; ++vi)
          if (staged >> vi & 1)
            copy_tile(stage(j) + vi * kTile * kHs, &maps.m[vi], full + s, h, b * T + t0);
      }
      if (lane < kTile) flags[s * kTile + lane] = lane < T - t0 && mask_row[t0 + lane] != 0;
      __syncwarp();  // the flags before the arrival that publishes them
      if (lane == 0) mbar_arrive(full + s);
    }
  }

  // A consumer: wait for tile j to land (its stage and its mask flags) /
  // release it (one arrival a warp).
  __device__ __forceinline__ const float* wait(int j) const {
    mbar_wait(full + j % kStages, (j / kStages) & 1);
    return stage(j);
  }
  __device__ __forceinline__ const uint8_t* live(int j) const {
    return flags + j % kStages * kTile;
  }
  __device__ __forceinline__ void release(int j) const {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty + j % kStages);
  }
};

// The thread's share of S: its kKpt keys of its column.
using State = float[kKpt];

__device__ __forceinline__ void load4(float (&q)[4], const float* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  q[0] = v.x;
  q[1] = v.y;
  q[2] = v.z;
  q[3] = v.w;
}

// Fold the kKs partial sums of a column: every thread of it gets the sum.
__device__ __forceinline__ float key_sum(float x) {
#pragma unroll
  for (int o = kCpw; o < 32; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// sum_i x[i] * S[i] over the thread's keys, in four partial sums.
__device__ __forceinline__ float dot_keys(const float* x, const State& S) {
  float p[4] = {};
#pragma unroll
  for (int i = 0; i < kKpt; i += 4) {
    float q[4];
    load4(q, x + i);
#pragma unroll
    for (int e = 0; e < 4; ++e) p[e] = fmaf(q[e], S[i + e], p[e]);
  }
  return (p[0] + p[1]) + (p[2] + p[3]);
}

// The thread's share of S [B*H, 64, 64], block bh.
__device__ __forceinline__ void load_state(State& S, const float* state, int bh, Slot me) {
  const float* p = state + ((size_t)bh * kHs + me.kq * kKpt) * kHs + me.col;
#pragma unroll
  for (int i = 0; i < kKpt; ++i) S[i] = p[i * kHs];
}

__device__ __forceinline__ void store_state(const State& S, float* state, int bh, Slot me) {
  float* p = state + ((size_t)bh * kHs + me.kq * kKpt) * kHs + me.col;
#pragma unroll
  for (int i = 0; i < kKpt; ++i) p[i * kHs] = S[i];
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, looked up through the runtime (no -lcuda).
static EncodeTiled encode_tiled() {
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

// The map of a contiguous [B, T, H, 64] f32 vector (16-byte aligned), read
// in boxes of {64 keys, 1 head, kTile tokens}.
static bool token_map(CUtensorMap* map, const void* p, int B, int T, int H) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)kHs, (cuuint64_t)H, (cuuint64_t)B * T};
  const cuuint64_t strides[2] = {(cuuint64_t)kRowBytes, (cuuint64_t)H * kRowBytes};
  const cuuint32_t box[3] = {(cuuint32_t)kHs, 1, (cuuint32_t)kTile};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(p), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Column blocks per (lane, head) for B*H of them: depends on nothing else.
inline int column_split(int lanes_heads) {
  int ncb = 1;
  while (ncb < kMaxSplit && lanes_heads * ncb < kTargetBlocks) ncb *= 2;
  return ncb;
}

// Launch `kernel` over B*H (lane, head) pairs with `smem` bytes of ring:
// the consumers of 64 / ncb columns and the producer warp. Each kernel's
// shared-memory limit is raised once (static: the record is this
// library's own, not one object shared by every library that holds the
// same instance).
template <typename Kernel, typename... Args>
static cudaError_t launch(Kernel kernel, size_t smem, int B, int H, cudaStream_t stream,
                          Args... args) {
  static const void* raised[2] = {};
  if (smem > 48 * 1024 && raised[0] != (const void*)kernel && raised[1] != (const void*)kernel) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    raised[raised[0] != nullptr] = (const void*)kernel;
  }
  const int ncb = column_split(B * H);
  kernel<<<dim3(B * H, ncb), kHs / ncb * kKs + 32, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace wkv_scan
