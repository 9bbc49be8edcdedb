// RWKV-7 WKV scan over a chunk of T tokens, Hopper sm_90a.
//
// Replaces: web_rwkv_gguf_tpu/ops/pallas/wkv7.py::wkv7_pallas (def at line
// 176, pallas_call at line 206; kernel body _wkv7_kernel at line 46), the
// WKV of prefill chunks with 2 <= T < 128.
//
// Per (batch lane b, head h), with head size K = V = 64, for each token:
//   sa = a^T S;  S <- diag(w) S + k v^T + b sa^T;  y = S^T r
// w is already activated. A padded token (mask 0) is pre-masked as the
// TPU kernel does it: w <- 1, k <- 0, b <- 0, so S stays as it was, and y
// there is read from the unchanged state (r and v are not masked). f32
// throughout.
//
// Bound on this card: the bytes (the state once in and once out, six
// 64-vectors per token) take 2.1 us at B=4, T=64, H=12; the recurrence is
// a chain of T dependent steps per column (sa's sum over the keys, the
// update, the next token's sa). Design (wkv_scan.cuh): a (lane, head) is
// split by value columns over up to 16 blocks, so B*H = 48 (B=4) or 12
// (B=1) still reach most SMs; 8 threads hold a column, 8 keys each in
// registers, so a step's chain is 2 products deep, 3 xor-shuffles, and one
// FMA a key after sa (w S + k v is formed while the shuffles run); token
// t's y sum is off that chain. A producer warp stages r, w, k, a, b and v
// a tile of 8 tokens at a time, one TMA tensor copy a vector, into a
// 3-stage ring, so the token loop reads only shared memory and registers;
// a padded token gets w = 1, k v = 0 and sa = 0 by selects. What bounds it
// now is each consumer warp's shared-memory reads and issue, ~220-300
// cycles a token (block (0, 0)'s clock, scripts/torch_scan_probe.py
// trace). On an NVIDIA H100 80GB HBM3 at 700 W (scripts/torch_kernel_cases.py,
// in a CUDA graph): 17.0 us at B=4, T=64, H=12 (lengths 64, 40, 17, 0),
// 13.6 at B=1, T=64 (50 live), 5.4 at B=1, T=8; the parent kernel (one
// 64-thread block per (lane, head), each token's loads issued at its
// step, one 64-long FMA chain for sa and one for y) took 69.3, 68.2 and
// 12.2 in the same call.

#include "wkv_scan.cuh"

namespace {

using namespace wkv_scan;

enum { kR, kW, kK, kA, kB, kV, kNv };  // staged vectors, in stage order
constexpr int kVs = kTile * kHs;       // a vector's floats in a stage

__global__ void __launch_bounds__(kMaxThreads)
wkv7_scan_kernel(const float* __restrict__ state, const __grid_constant__ Maps<kNv> maps,
                 const uint8_t* __restrict__ mask, float* __restrict__ y,
                 float* __restrict__ state_out, int T, int H) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Ring<kNv> ring(smem);
  const int bh = blockIdx.x, h = bh % H, b = bh / H;
  ring.init();
  if ((int)threadIdx.x >= consumers()) {
    ring.produce(maps, (1u << kNv) - 1, mask + (size_t)b * T, b, h, T);
    return;
  }
  const Slot me = slot();
  State S;
  load_state(S, state, bh, me);

  // token tt of a landed tile. A padded token (on = 0) takes w = 1, k v = 0
  // and sa = 0, so S stays as it was, bit for bit, and y is read from it:
  // selects, not a branch, so that the tile's tokens schedule as one block.
  const auto step = [&](const float* tile, int tt, bool on, float* yrow) {
    const float* keys = tile + tt * kHs + me.kq * kKpt;  // vector vi at keys + vi * kVs
    const float v = tile[kV * kVs + tt * kHs + me.col];
    const float a = key_sum(dot_keys(keys + kA * kVs, S));  // sa, shuffled on every token
    const float vc = on ? v : 0.f, sa = on ? a : 0.f;
    // w S + k v does not wait for sa: one FMA a key after it
#pragma unroll
    for (int i = 0; i < kKpt; i += 4) {
      float w[4], k[4], bb[4];
      load4(w, keys + kW * kVs + i);
      load4(k, keys + kK * kVs + i);
      load4(bb, keys + kB * kVs + i);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        S[i + e] = fmaf(bb[e], sa, fmaf(on ? w[e] : 1.f, S[i + e], k[e] * vc));
    }
    const float yt = key_sum(dot_keys(keys + kR * kVs, S));
    if (me.kq == 0) yrow[(size_t)tt * H * kHs] = yt;
  };

  const int tiles = (T + kTile - 1) / kTile;
  for (int j = 0; j < tiles; ++j) {
    const float* tile = ring.wait(j);
    const uint64_t on = *reinterpret_cast<const uint64_t*>(ring.live(j));  // a byte a token
    const int t0 = j * kTile, n = min(kTile, T - t0);
    float* yrow = y + (((size_t)b * T + t0) * H + h) * kHs + me.col;
    if (n == kTile) {
#pragma unroll
      for (int tt = 0; tt < kTile; ++tt) step(tile, tt, (on >> 8 * tt) & 0xff, yrow);
    } else {
      for (int tt = 0; tt < n; ++tt) step(tile, tt, (on >> 8 * tt) & 0xff, yrow);
    }
    ring.release(j);
  }
  store_state(S, state_out, bh, me);
}

}  // namespace

// state f32 [B, H, 64, 64]; r, w, k, a, b f32 [B, T, H, 64]; v f32
// [B, T, H, 64]; mask u8 [B, T] (0 = padded token); y f32 [B, T, H, 64];
// state_out f32 [B, H, 64, 64] (must not alias state). All contiguous, the
// vectors 16-byte aligned. Returns the cudaError_t of the launch.
extern "C" int wkv7_scan(const void* state, const void* r, const void* w,
                         const void* k, const void* v, const void* a,
                         const void* b, const void* mask, void* y,
                         void* state_out, int B, int T, int H, int hs,
                         void* stream) {
  if (hs != kHs || B <= 0 || T <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  Maps<kNv> maps;
  const void* src[kNv] = {r, w, k, a, b, v};  // stage order
  for (int i = 0; i < kNv; ++i)
    if (!token_map(&maps.m[i], src[i], B, T, H)) return (int)cudaErrorInvalidValue;
  return (int)launch(wkv7_scan_kernel, smem_bytes<kNv>(), B, H, static_cast<cudaStream_t>(stream),
                     static_cast<const float*>(state), maps, static_cast<const uint8_t*>(mask),
                     static_cast<float*>(y), static_cast<float*>(state_out), T, H);
}
