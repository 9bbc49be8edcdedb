// RWKV-6 WKV scan over a chunk of T tokens, Hopper sm_90a; RWKV-5 through
// it, with its static decay read in place.
//
// Replaces: web_rwkv_gguf_tpu/ops/pallas/wkv456.py::wkv6_pallas (def at line
// 46, pallas_call at line 63; kernel body _wkv6_kernel at line 30), the WKV
// of V6 prefill chunks with 2 <= T < 128 (and, in the port, of a V6 token
// at T = 1 on the per-layer decode path); wkv5_pallas (line 88) through it.
//
// Per (batch lane b, head h), with head size K = V = 64, for each token:
//   y = S^T r + (sum_k r u k) v;  S <- diag(w) S + k v^T
// w is already activated (exp(-exp(w_raw))), u is the head's time_first.
// The bonus u k v^T enters y only, never S. A padded token (mask 0) is
// pre-masked as the TPU kernel does it: w <- 1, k <- 0, so S stays exactly
// as it was; y there is read from the unchanged state. f32 throughout.
//
// Bound on this card: the bytes (the state once in and once out, five
// 64-vectors per token) take 4.4 us at B=4, T=64, H=32; the update has no
// sum in it, so each element's chain is one FMA a token, and y's sum over
// keys is off the chain. Design (wkv_scan.cuh): a (lane, head) is split by
// value columns over up to 16 blocks; 8 threads hold a column, 8 keys each
// in registers; y is 4 partial sums a thread folded by 3 xor-shuffles. The
// bonus scalar sum_k r u k is the same for every column, so each consumer
// warp computes it once a token, for a whole tile as it lands (4 lanes a
// token), and the thread that writes y adds it. A producer warp stages r,
// k, w and v a tile of 8 tokens at a time, one TMA tensor copy a vector,
// into a 3-stage ring; a padded token gets w = 1, k v = 0 and no bonus by
// selects. V5's static decay, one [H, 64] tensor expanded over lanes and
// tokens (static_w), is read once into registers, never widened to
// [B, T, H, 64] nor staged. What bounds it now is each consumer warp's
// shared-memory reads and issue (at B=4, H=32 some 16 consumer warps share
// an SM). On an NVIDIA H100 80GB HBM3 at 700 W (scripts/torch_kernel_cases.py,
// in a CUDA graph): 21.0 us at B=4, T=64, H=32 (lengths 64, 40, 17, 0),
// 12.4 at B=1, T=64 (50 live), 5.5 at B=1, T=8, 5.0 at B=1, T=1; V5 (H=16)
// 14.3 at B=4, T=64, 4.8 at T=1. The parent kernel (one 64-thread block
// per (lane, head), each token's loads issued at its step, one 64-long FMA
// chain for y with the bonus redone in every column) took 65.8, 63.1,
// 11.9, 5.3, 64.5 and 5.2 in the same call.

#include "wkv_scan.cuh"

namespace {

using namespace wkv_scan;

enum { kR, kK, kW, kV, kNv };  // staged vectors, in stage order
constexpr int kVs = kTile * kHs;  // a vector's floats in a stage
static_assert(kTile == 8, "the bonus pass: 4 lanes a token");

// kStaticW: w is one [H, 64] decay for every lane and token (V5), held in
// registers; otherwise staged as a [B, T, H, 64] vector.
template <bool kStaticW>
__global__ void __launch_bounds__(kMaxThreads)
wkv6_scan_kernel(const float* __restrict__ state, const __grid_constant__ Maps<kNv> maps,
                 const float* __restrict__ u, const float* __restrict__ w_static,
                 const uint8_t* __restrict__ mask, float* __restrict__ y,
                 float* __restrict__ state_out, int T, int H) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Ring<kNv> ring(smem);
  const int bh = blockIdx.x, h = bh % H, b = bh / H;
  ring.init();
  if ((int)threadIdx.x >= consumers()) {
    ring.produce(maps, (1u << kNv) - 1 - (kStaticW ? 1u << kW : 0u), mask + (size_t)b * T, b, h,
                 T);
    return;
  }
  const Slot me = slot();
  // Every consumer warp takes the bonus sum_k r u k of a tile's tokens for
  // itself: lane (bt, bq) = (lane / 4, lane % 4) sums token bt's keys
  // 16 bq ..; it reads their four float4s starting at `rot`, so that the
  // 8 lanes of a shared-memory phase hit 8 different bank groups.
  const int lane = threadIdx.x & 31, bt = lane >> 2, bq = lane & 3;
  const int rot = (bq >> 1) + 2 * (bt & 1);
  float ur[16];  // u in the order read
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float* uj = u + h * kHs + 16 * bq + 4 * ((j + rot) & 3);
#pragma unroll
    for (int e = 0; e < 4; ++e) ur[4 * j + e] = uj[e];
  }
  float ws[kKpt];  // the static decay of the thread's keys
  if constexpr (kStaticW) {
#pragma unroll
    for (int i = 0; i < kKpt; ++i) ws[i] = w_static[h * kHs + me.kq * kKpt + i];
  }
  State S;
  load_state(S, state, bh, me);

  // token tt of a landed tile, given its bonus. A padded token (on = 0)
  // takes w = 1 and k v = 0, so S stays as it was, bit for bit, and no
  // bonus: selects, not a branch, so that the tile's tokens schedule as one
  // block.
  const auto step = [&](const float* tile, int tt, bool on, float bonus, float* yrow) {
    const float* keys = tile + tt * kHs + me.kq * kKpt;  // vector vi at keys + vi * kVs
    const float vc = tile[kV * kVs + tt * kHs + me.col], vu = on ? vc : 0.f;
    const float yo = dot_keys(keys + kR * kVs, S);  // the old state's share of y
#pragma unroll
    for (int i = 0; i < kKpt; i += 4) {
      float w[4], k[4];
      if constexpr (kStaticW) {
#pragma unroll
        for (int e = 0; e < 4; ++e) w[e] = ws[i + e];
      } else {
        load4(w, keys + kW * kVs + i);
      }
      load4(k, keys + kK * kVs + i);
#pragma unroll
      for (int e = 0; e < 4; ++e) S[i + e] = fmaf(on ? w[e] : 1.f, S[i + e], k[e] * vu);
    }
    const float yt = fmaf(on ? bonus : 0.f, vc, key_sum(yo));
    if (me.kq == 0) yrow[(size_t)tt * H * kHs] = yt;
  };

  const int tiles = (T + kTile - 1) / kTile;
  for (int j = 0; j < tiles; ++j) {
    const float* tile = ring.wait(j);
    const uint64_t on = *reinterpret_cast<const uint64_t*>(ring.live(j));  // a byte a token
    float part = 0.f;  // token bt's bonus, once folded over its 4 lanes
    {
      const float* row = tile + bt * kHs + 16 * bq;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int f = 4 * ((q + rot) & 3);
        const float4 r = *reinterpret_cast<const float4*>(row + kR * kVs + f);
        const float4 k = *reinterpret_cast<const float4*>(row + kK * kVs + f);
        part = fmaf(r.x * ur[4 * q], k.x, part);
        part = fmaf(r.y * ur[4 * q + 1], k.y, part);
        part = fmaf(r.z * ur[4 * q + 2], k.z, part);
        part = fmaf(r.w * ur[4 * q + 3], k.w, part);
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
    }
    const int t0 = j * kTile, n = min(kTile, T - t0);
    float* yrow = y + (((size_t)b * T + t0) * H + h) * kHs + me.col;
    if (n == kTile) {
#pragma unroll
      for (int tt = 0; tt < kTile; ++tt)
        step(tile, tt, (on >> 8 * tt) & 0xff, __shfl_sync(0xffffffffu, part, 4 * tt), yrow);
    } else {
      for (int tt = 0; tt < n; ++tt)
        step(tile, tt, (on >> 8 * tt) & 0xff, __shfl_sync(0xffffffffu, part, 4 * tt), yrow);
    }
    ring.release(j);
  }
  store_state(S, state_out, bh, me);
}

}  // namespace

// state f32 [B, H, 64, 64]; r, k f32 [B, T, H, 64]; v f32 [B, T, H, 64];
// u f32 [H, 64]; w f32 [B, T, H, 64], or with static_w one [H, 64] decay
// for every lane and token; mask u8 [B, T] (0 = padded token); y f32
// [B, T, H, 64]; state_out f32 [B, H, 64, 64] (must not alias state). All
// contiguous, the [B, T, H, 64] vectors 16-byte aligned. Returns the
// cudaError_t of the launch.
extern "C" int wkv6_scan(const void* state, const void* r, const void* k,
                         const void* v, const void* u, const void* w,
                         const void* mask, void* y, void* state_out, int B,
                         int T, int H, int hs, int static_w, void* stream) {
  if (hs != kHs || B <= 0 || T <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  Maps<kNv> maps = {};
  const void* src[kNv] = {r, k, w, v};  // stage order
  for (int i = 0; i < kNv; ++i)
    if (!(static_w && i == kW) && !token_map(&maps.m[i], src[i], B, T, H))
      return (int)cudaErrorInvalidValue;
  const auto run = [&](auto kernel) {
    return (int)launch(kernel, smem_bytes<kNv>(), B, H, static_cast<cudaStream_t>(stream),
                       static_cast<const float*>(state), maps, static_cast<const float*>(u),
                       static_cast<const float*>(w), static_cast<const uint8_t*>(mask),
                       static_cast<float*>(y), static_cast<float*>(state_out), T, H);
  };
  return static_w ? run(wkv6_scan_kernel<true>) : run(wkv6_scan_kernel<false>);
}
