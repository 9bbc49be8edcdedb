// Grouped dequant gemv for Hopper (sm_90a): the r, k and v projections of an
// RWKV-7 decode step at batch 1 in one launch. For each of three same-shape
// quantized matrices W_i [m, k], y[i, n, :] = xs[i, n, :] . W_i^T for n <= 8
// input rows of its own, each W_i held as its own code tensor with f32 group
// scale products s and signed offsets mn [3, m, k / gs] formed once at unroll
// time (models/loader.py, group_gemv_matrices): w = q * s - mn per group.
//
// Replaces: web_rwkv_gguf_tpu/ops/pallas/matmul.py::quant_gemv_grouped (def
// at line 1154, pallas_call at line 1192; kernel body _gemv_grouped_kernel at
// line 1078). The TPU kernel reads one row-concatenated copy of the three
// code tensors and position-interleaved scale rows; here each matrix's codes
// are read where the model keeps them (no copy), and the scales are plain
// [m, G] rows per matrix.
//
// Numerics, as the TPU kernel computes them: x rounded to bf16 (by the
// caller), codes exact, per 16-element step of a group the f32 sum of q * x
// (one tensor-core product from a zero accumulator: the codes are integers
// that bf16 holds exactly) times the f32 scale product s, minus the offset
// times the step's f32 sum of x (the factored form s * sum q x - mn * sum x;
// the int8 kind's added offset comes as mn = -min, exact), the steps added
// in f32 (stack_mma.cuh's class; groups are 16, 32 or 128 elements, so a
// step never straddles one). The group sums are taken in another order than
// the plain version's: f32 rounding only.
//
// Bound on this card: bytes. At n <= 8 each code byte feeds at most 16
// multiply-adds, far below the ~295 operations per byte where the H100 stops
// being memory-bound, so the least time is the three matrices' code and
// scale bytes over HBM bandwidth; at the main path's shapes (3 x [768, 768],
// n = 1: under a microsecond of bytes) the launch and one chain of loads
// are the time. Design: the tensor-core tile body of the whole-stack
// kernels (stack_mma.cuh's warp_tile, in the f32-scale byte and nibble slot
// forms): one block a 16-row tile of one matrix (3 * m / 16 blocks, one
// wave at m = 768). Its code rows, a K-slice of up to 2048 elements at a
// time, land in shared memory by cp.async (16 bytes a thread; two buffers:
// slice s + 2's copies go out when slice s's products are done); while
// they land the block stages the matrix's x once, as bf16 in the
// fragments' k order with each step's sum, and builds each slice's table
// of (s, mn) per row and step from the f32 scales; its 8 warps split the
// steps of every slice on the tensor cores (mma.sync m16n8k16), and their
// sums meet in shared memory in warp order. A K that is no multiple of the
// slice ends in a shorter slice: its positions past K stage zero and take
// zero factors.

#include "stack_mma.cuh"

namespace {

constexpr int kMats = 3;         // matrices one launch serves
constexpr int kSliceMax = 2048;  // elements of a K-slice

struct Grouped {
  const uint8_t* codes[kMats];  // each [m, k/2] split-halves nibbles or [m, k] bytes
  const float* scales;          // [kMats, m, G]
  const float* offsets;         // [kMats, m, G] or null
};

// A launch's geometry: the slice, the slices, and the shared-memory regions.
struct Geo {
  int ki, S, steps, nbuf, buf;
  int off_x, off_xsum, off_tab, off_red, smem;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(stk::smem_u32(dst)), "l"(src)
               : "memory");
}

__host__ __device__ inline int round_up(int v, int a) { return (v + a - 1) / a * a; }

// valid elements of slice s (nibbles: of each of its two ranges, in bytes
// of the row, times 2)
__device__ __forceinline__ int slice_len(int k, int ki, int s) {
  return min(ki, k - s * ki);
}

template <int NB>
__global__ void __launch_bounds__(kThreads)
gemv_grouped_kernel(const __nv_bfloat16* __restrict__ x, const Grouped g, float* __restrict__ y,
                    int m, int k, int gs, int kind, const Geo geo) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int mat = blockIdx.y, tile = blockIdx.x;
  const bool nib = kind == kNib;
  const int G = k / gs, ki = geo.ki, S = geo.S, steps = geo.steps;
  const int xstride = ki + stk::kXPad;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + geo.off_x);  // [S][NB][xstride]
  float* xsum = reinterpret_cast<float*>(smem + geo.off_xsum);          // [S][steps][NB]
  float2* tab = reinterpret_cast<float2*>(smem + geo.off_tab);          // [16][tab_stride]
  float* red = reinterpret_cast<float*>(smem + geo.off_red);            // [kWarps][16][NB]
  stk::Job j;
  j.w = QMat{g.codes[mat], nullptr, nullptr, nullptr, nullptr, nib ? kFormQSNib : kFormQS,
             kind == kI8, gs};
  j.K = k;
  j.ki = ki;
  j.S = S;
  j.steps = steps;
  j.nlo = nib ? ki / 32 : steps;
  j.code = kind == kI8 ? stk::kCodeI8 : stk::kCodeU8;
  j.offs = g.offsets != nullptr;
  const int half = ki / 2;  // a nibble slice's range
  const int cb = nib ? half : ki, cs = stk::code_stride(j.w.form, ki);
  const int row_cb = nib ? k / 2 : k;
  // slice s's code rows into buffer s % nbuf, 16 bytes a thread; one
  // commit group
  auto issue = [&](int s) {
    uint8_t* buf = smem + (s % geo.nbuf) * geo.buf;
    const int chunks = (nib ? slice_len(k, ki, s) / 2 : slice_len(k, ki, s)) / 16;  // a row's
    for (int i = threadIdx.x; i < stk::kRows * chunks; i += kThreads) {
      const int r = i / chunks, c = i - r * chunks;
      const size_t row = min(tile * stk::kRows + r, m - 1);
      cp_async16(buf + r * cs + 16 * c, j.w.codes + row * row_cb + (size_t)s * cb + 16 * c);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  for (int s = 0; s < geo.nbuf; ++s) issue(s);
  // slice s's (s, mn) of every row and step, zero past K: kBatch entries a
  // thread loaded at a time (f), then stored in the table
  const int ts = stk::tab_stride(steps), ents = stk::kRows * steps;
  constexpr int kBatch = 4;
  float2 f[kBatch];
  auto load_tab = [&](int s, int i0) {
    const int len = slice_len(k, ki, s);
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kThreads, r = i / steps, st = i - r * steps;
      const int off = nib ? (st < j.nlo ? 16 * st : 16 * (st - j.nlo)) : 16 * st;
      f[u] = make_float2(0.f, 0.f);
      if (i < ents && (nib ? 2 * off < len : off < len)) {
        const size_t at = ((size_t)mat * m + min(tile * stk::kRows + r, m - 1)) * G +
                          stk::step_elem(j, s, st) / gs;
        f[u] = make_float2(__ldg(g.scales + at),
                           g.offsets != nullptr ? __ldg(g.offsets + at) : 0.f);
      }
    }
  };
  auto store_tab = [&](int i0) {
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kThreads, r = i / steps;
      if (i < ents) tab[r * ts + (i - r * steps)] = f[u];
    }
  };
  load_tab(0, threadIdx.x);  // its loads in flight with x's
  // x of this matrix, once: position i of slice s of lane n as bf16 in the
  // staged order (runs of 4 as 0, 2, 1, 3), zero past K; each step's sum
  const __nv_bfloat16* xm = x + (size_t)mat * NB * k;
  const int runs = ki / 4, total = S * NB * runs;
  for (int q0 = 0; q0 < total; q0 += kThreads) {
    const int q = q0 + threadIdx.x;  // (s, n, run), run fastest
    uint2 u = make_uint2(0u, 0u);
    const int run = q % runs, sn = q / runs, n = sn % NB, s = sn / NB;
    if (q < total) {
      const int i = 4 * run, len = slice_len(k, ki, s);
      int e = -1;  // the element of position i, -1 past K
      if (nib) {
        const int r = i < half ? i : i - half;
        if (2 * r < len) e = (i < half ? 0 : k / 2) + s * half + r;
      } else if (i < len) {
        e = s * ki + i;
      }
      if (e >= 0) {
        const uint2 v = *reinterpret_cast<const uint2*>(xm + (size_t)n * k + e);
        u = make_uint2(__byte_perm(v.x, v.y, 0x5410), __byte_perm(v.x, v.y, 0x7632));
      }
      *reinterpret_cast<uint2*>(xs + ((size_t)s * NB + n) * xstride + i) = u;
    }
    // the step's 4 runs are neighbouring threads (runs % 4 == 0)
    float v = stk::bf16_sum4(u);
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    if (q < total && (run & 3) == 0) xsum[((size_t)s * steps + run / 4) * NB + n] = v;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3;
  float tot[4] = {0.f, 0.f, 0.f, 0.f};  // rows gq, gq + 8 by lanes 2t, 2t + 1
  for (int s = 0; s < S; ++s) {
    if (s > 0) __syncthreads();  // the previous slice's readers of tab are done
    for (int i0 = threadIdx.x; i0 < ents; i0 += kBatch * kThreads) {
      if (s > 0 || i0 != (int)threadIdx.x) load_tab(s, i0);
      store_tab(i0);
    }
    // slice s's copies (at most the next slice's still in flight)
    if (s + 1 < S) asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    else asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    const uint8_t* buf = smem + (s % geo.nbuf) * geo.buf;
    float acc[1][4];
    stk::warp_tile_by_mode<NB>(j, buf, tab, xs + (size_t)s * NB * xstride,
                               xsum + (size_t)s * steps * NB, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) tot[i] += acc[0][i];
    if (s + geo.nbuf < S) {
      __syncthreads();  // every warp is done with the buffer
      issue(s + geo.nbuf);
    }
  }
  // the warps' sums, in warp order
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = gq + 8 * (i >> 1), n = 2 * t + (i & 1);
    if (n < NB) red[(warp * stk::kRows + r) * NB + n] = tot[i];
  }
  __syncthreads();
  if ((int)threadIdx.x < stk::kRows * NB) {
    const int r = threadIdx.x / NB, n = threadIdx.x - r * NB;
    const int row = tile * stk::kRows + r;
    float v = 0.f;
    for (int w = 0; w < kWarps; ++w) v += red[(w * stk::kRows + r) * NB + n];
    if (row < m) y[((size_t)mat * NB + n) * m + row] = v;
  }
}

Geo geometry(int n, int k, bool nib) {
  Geo geo;
  geo.ki = k <= kSliceMax ? k : kSliceMax;
  geo.S = (k + geo.ki - 1) / geo.ki;
  geo.steps = geo.ki / 16;
  geo.nbuf = geo.S < 2 ? geo.S : 2;
  const int form = nib ? kFormQSNib : kFormQS;
  geo.buf = round_up(stk::kRows * stk::code_stride(form, geo.ki), 128);
  geo.off_x = geo.nbuf * geo.buf;
  geo.off_xsum = geo.off_x + round_up(geo.S * n * (geo.ki + stk::kXPad) * 2, 128);
  geo.off_tab = geo.off_xsum + round_up(geo.S * geo.steps * n * 4, 128);
  geo.off_red = geo.off_tab + round_up(stk::kRows * stk::tab_stride(geo.steps) * 8, 128);
  geo.smem = geo.off_red + kWarps * stk::kRows * n * 4;
  return geo;
}

template <int NB>
cudaError_t launch(const void* x, const Grouped& g, void* y, int m, int k, int gs, int kind,
                   cudaStream_t stream) {
  const Geo geo = geometry(NB, k, kind == kNib);
  if (geo.smem > kMaxSmem) return cudaErrorInvalidValue;
  if (geo.smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(gemv_grouped_kernel<NB>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, geo.smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((m + stk::kRows - 1) / stk::kRows, kMats);
  gemv_grouped_kernel<NB><<<grid, kThreads, geo.smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), g, static_cast<float*>(y), m, k, gs, kind, geo);
  return cudaGetLastError();
}

}  // namespace

// x bf16 [3, n, k]; codes_r, codes_k, codes_v [m, k/2] u8 split-halves
// nibbles (code_kind 0) or [m, k] u8 (1) / i8 (2) bytes, each 16-byte
// aligned; scales f32 [3, m, k/gs]; offsets f32 [3, m, k/gs] or null (w =
// q * s - offset); y f32 [3, n, m]. All contiguous; gs 16, 32 or 128 (32 for
// nibbles); k % 32 == 0 (k % 64 == 0 for nibbles); 1 <= n <= 8. Returns the
// cudaError_t of the launch.
extern "C" int quant_gemv_grouped(const void* x, const void* codes_r, const void* codes_k,
                                  const void* codes_v, const void* scales, const void* offsets,
                                  void* y, int n, int m, int k, int gs, int code_kind,
                                  void* stream) {
  if (m <= 0 || k <= 0 || k % 32 || (gs != 16 && gs != 32 && gs != 128) || k % gs ||
      (code_kind == kNib && (gs != 32 || k % 64)) ||
      (code_kind != kNib && code_kind != kU8 && code_kind != kI8))
    return (int)cudaErrorInvalidValue;
  const Grouped g{{static_cast<const uint8_t*>(codes_r), static_cast<const uint8_t*>(codes_k),
                   static_cast<const uint8_t*>(codes_v)},
                  static_cast<const float*>(scales), static_cast<const float*>(offsets)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 1: return (int)launch<1>(x, g, y, m, k, gs, code_kind, s);
    case 2: return (int)launch<2>(x, g, y, m, k, gs, code_kind, s);
    case 3: return (int)launch<3>(x, g, y, m, k, gs, code_kind, s);
    case 4: return (int)launch<4>(x, g, y, m, k, gs, code_kind, s);
    case 5: return (int)launch<5>(x, g, y, m, k, gs, code_kind, s);
    case 6: return (int)launch<6>(x, g, y, m, k, gs, code_kind, s);
    case 7: return (int)launch<7>(x, g, y, m, k, gs, code_kind, s);
    case 8: return (int)launch<8>(x, g, y, m, k, gs, code_kind, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
