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
// Q3_K, q * s - mn for the f32-scale byte and nibble forms; the gemv class of
// q4k_gemv.cu, qkb_gemv.cu, q6k_gemv.cu and qs_gemv.cu, for all six matrices
// at every B), a dense bf16 matrix multiplies it by its bf16 weight with f32
// sums (each matrix slot picks its row function by its form at run time,
// decode_common.cuh), the LoRA pairs take bf16 operands and accumulate in
// f32, everything else is f32.
//
// Design. The TPU kernel is a grid over layers whose steps Pallas pipelines;
// a GPU has no such sequential grid, so this is one cooperative launch of a
// persistent grid (every block resident, one or two per SM) that walks the
// layers itself and separates the five dependent phases of a layer with a
// grid-wide barrier (cooperative_groups grid.sync):
//   1. LN1 and the six token-shift mixes, computed by every block for all
//      lanes (one warp per lane) straight into its shared memory as bf16
//      (their only readers round them to bf16 anyway); then Wr, Wk, Wv (3C
//      rows) and the LoRA down-projections (D rows): one warp per output
//      row, all B lanes per decoded weight;
//   2. per (lane, head), one block of 256 threads, four per channel: the
//      LoRA up-projections of the head's 64 channels, the value residual,
//      then the attention core with a quarter of value column t of the
//      state in registers;
//   3. Wo and the residual add;
//   4. LN2 and the FFN mix (as in 1), then FFN key and relu^2;
//   5. FFN value, the residual add and the rescale.
// Each phase asks L2 to prefetch what a later phase reads from device
// memory (LoRA ups, state, the next matrices), so those phases find it
// on chip. Data produced inside the launch is read with ld.global.cg (L2,
// never a stale L1 line); weights and parameters are read-only and may use
// L1. Each gemv row streams its codes 16 bytes per lane as q4k_gemv.cu
// does. What this leaves on the table (later work): the barriers (60 per
// step at L = 12), the attention phase on B * H blocks, and gemv rows that
// are one warp's latency-bound walk.

#include <cooperative_groups.h>

#include "decode_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kHs = 64;             // head size the attention phase takes
constexpr int kParts = kThreads / kHs;  // threads per value column in phase 2

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
  __nv_bfloat16* y;                             // [B, C] scratch
  __nv_bfloat16* khid;                          // [B, hidden] scratch
  unsigned long long* phase_ns;                 // [1 + 5 L] or null: trace
  int L, B, C, H, hidden, D, dw, da, dg, dv, rescale, first_layer;
  float eps_ln, eps_gn, eps_l2;
};

// Phase 1: LN1, the att shift state (block 0 writes it) and the six mixed
// inputs into xs [6, B, C] bf16; then r, k, v and the LoRA
// down-projections with their inner activations (tanh for w, sigmoid for
// g), z stored bf16.
template <int NB>
__device__ void phase_proj(const Args& a, int l, unsigned char* smem) {
  const int C = a.C, B = a.B, D = a.D, H = a.H;
  // for phase 2: the LoRA ups and the WKV state of this layer; for phase
  // 3: Wo
  prefetch_l2(a.up + (size_t)l * C * D, (size_t)C * D * 2);
  prefetch_l2(a.wkv_in + (size_t)l * B * H * kHs * kHs, (size_t)B * H * kHs * kHs * 4);
  prefetch_mat(a.wo, l, C, C);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  float* rows = reinterpret_cast<float*>(smem + (size_t)6 * B * C * 2);
  layer_norm_rows(a.x, B, C, a.eps_ln, a.ln1_w + (size_t)l * C, a.ln1_b + (size_t)l * C,
                  rows);
  // one thread per channel, every lane: all loads issued before any use
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float mix[6], sh[NB];
#pragma unroll
    for (int s = 0; s < 6; ++s) mix[s] = __ldg(a.x_stack + ((size_t)l * 6 + s) * C + c);
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      sh[b] = b < B ? __ldg(a.ash_in + ((size_t)l * B + b) * C + c) : 0.f;
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      if (b < B) {
        const size_t i = (size_t)b * C + c;
        const float xx = rows[i];
        if (blockIdx.x == 0) a.ash_out[(size_t)l * B * C + i] = a.mask[b] == 0.f ? sh[b] : xx;
#pragma unroll
        for (int s = 0; s < 6; ++s) {
          xs[(size_t)s * B * C + i] = __float2bfloat16_rn(xx + mix[s] * (sh[b] - xx));
        }
      }
    }
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nrows = 3 * C + D;
  float acc[NB];
  for (int row = blockIdx.x * kWarps + warp; row < nrows; row += gridDim.x * kWarps) {
    if (row < 3 * C) {
      const int which = row / C, m = row - which * C;
      const QMat& w = which == 0 ? a.wr : (which == 1 ? a.wk : a.wv);
      const int s = which == 0 ? 0 : (which == 1 ? 2 : 3);  // r, k, v inputs
      mat_row<NB>(w, l, C, m, C, xs + (size_t)s * B * C, B, acc);
      if (lane == 0) {
        for (int t = 0; t < B; ++t) a.rkv[((size_t)which * B + t) * C + m] = acc[t];
      }
    } else {
      const int j = row - 3 * C;
      int s, act;  // input stream; 1 tanh, 2 sigmoid, 0 none
      if (j < a.dw) { s = 1; act = 1; }
      else if (j < a.dw + a.da) { s = 4; act = 0; }
      else if (j < a.dw + a.da + a.dg) { s = 5; act = 2; }
      else { s = 3; act = 0; }
      bf16_row<NB>(a.down + ((size_t)l * D + j) * C, C, xs + (size_t)s * B * C, B, acc);
      if (lane == 0) {
        for (int t = 0; t < B; ++t) {
          float v = acc[t];
          if (act == 1) v = tanhf(v);
          else if (act == 2) v = sigmoid_f32(v);
          a.z[(size_t)t * D + j] = __float2bfloat16_rn(v);
        }
      }
    }
  }
}

// Phase 2: one (lane, head) item per block at a time. Thread (part, t) =
// (threadIdx.x / 64, threadIdx.x % 64) serves channel / value column t of
// the head with a quarter of the work: LoRA-rank chunks part, part + 4, ...
// and the key rows [16 part, 16 part + 16) of the state; shared memory sums
// the four quarters.
__device__ void phase_att(const Args& a, int l, float* smem) {
  const int C = a.C, B = a.B, H = a.H, D = a.D;
  prefetch_mat(a.fk, l, a.hidden, C);  // for phases 4 and 5
  prefetch_mat(a.fv, l, C, a.hidden);
  const int part = threadIdx.x / kHs, t = threadIdx.x % kHs;
  float* red = smem;                      // kWarps
  float* s_z = red + kWarps;              // D
  float* s_up = s_z + D;                  // [kParts][4][kHs]: LoRA-up quarters
  float* s_w = s_up + kParts * 4 * kHs;   // per key row: w, k', -kk, kk * a, r
  float *s_k = s_w + kHs, *s_a = s_k + kHs, *s_b = s_a + kHs, *s_r = s_b + kHs;
  float* s_part = s_r + kHs;              // [kParts][kHs]: sums over key rows
  const int e0 = a.dw / 8, e1 = (a.dw + a.da) / 8, e2 = (a.dw + a.da + a.dg) / 8;
  for (int item = blockIdx.x; item < B * H; item += gridDim.x) {
    const int b = item / H, h = item % H;
    const int c = h * kHs + t;  // this thread's channel
    const size_t lc = (size_t)l * C + c;
    const size_t bc = (size_t)b * C + c;
#pragma unroll 2
    for (int j = threadIdx.x; j < D; j += kThreads) {
      s_z[j] = __bfloat162float(__ldcg(a.z + (size_t)b * D + j));
    }
    __syncthreads();
    {  // a quarter of channel c's four up-projections, 8 bf16 per load
      const uint4* u4 = reinterpret_cast<const uint4*>(a.up + lc * D);
      float p0 = 0.f, p1 = 0.f, p2 = 0.f, p3 = 0.f;
#pragma unroll 4
      for (int q = part; q < D / 8; q += kParts) {
        float w8[8];
        bf16x8(__ldg(u4 + q), w8);
        float p = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) p += w8[e] * s_z[8 * q + e];
        if (q < e0) p0 += p;
        else if (q < e1) p1 += p;
        else if (q < e2) p2 += p;
        else p3 += p;
      }
      float* up = s_up + part * 4 * kHs + t;
      up[0] = p0;
      up[kHs] = p1;
      up[2 * kHs] = p2;
      up[3 * kHs] = p3;
    }
    __syncthreads();
    float u[4];
#pragma unroll
    for (int sg = 0; sg < 4; ++sg) {
      u[sg] = 0.f;
#pragma unroll
      for (int q = 0; q < kParts; ++q) u[sg] += s_up[(q * 4 + sg) * kHs + t];
    }
    const float r = __ldcg(a.rkv + bc);
    const float k = __ldcg(a.rkv + (size_t)B * C + bc);
    float v = __ldcg(a.rkv + 2 * (size_t)B * C + bc);
    const float w_in = a.w0[lc] + u[0], a_in = a.a0[lc] + u[1], gate = u[2];
    if (a.first_layer + l == 0) {
      if (part == 0) a.vfirst[bc] = v;
    } else {
      const float vmix = sigmoid_f32(a.v0[lc] + u[3]);
      v = v + vmix * (__ldcg(a.vfirst + bc) - v);
    }
    // the attention core (att_core7.cu); the sums over the head's 64
    // channels count each channel once (part 0)
    const float kkr = k * a.k_k[lc];
    const float kk = kkr * rsqrtf(block_sum(part == 0 ? kkr * kkr : 0.f, red) + a.eps_l2);
    const float a2 = sigmoid_f32(a_in);
    const float k2 = k * (1.f + (a2 - 1.f) * a.k_a[lc]);
    if (part == 0) {
      s_w[t] = expf(-0.606531f * sigmoid_f32(w_in));
      s_k[t] = k2;
      s_a[t] = -kk;
      s_b[t] = kk * a2;
      s_r[t] = r;
    }
    // its barriers also publish s_*
    const float sb = block_sum(part == 0 ? r * k2 * a.r_k[lc] : 0.f, red);
    const size_t soff = ((((size_t)l * B + b) * H + h) * kHs) * kHs;
    const int row0 = part * (kHs / kParts);
    float col[kHs / kParts];
    float sa = 0.f;
#pragma unroll
    for (int i = 0; i < kHs / kParts; ++i) {
      col[i] = a.wkv_in[soff + (size_t)(row0 + i) * kHs + t];
      sa += s_a[row0 + i] * col[i];
    }
    s_part[part * kHs + t] = sa;
    __syncthreads();
    sa = s_part[t] + s_part[kHs + t] + s_part[2 * kHs + t] + s_part[3 * kHs + t];
    __syncthreads();  // s_part is rewritten below
    const bool keep = a.mask[b] == 0.f;
    float y0 = 0.f;
#pragma unroll
    for (int i = 0; i < kHs / kParts; ++i) {
      const int row = row0 + i;
      const float sn = s_w[row] * col[i] + s_k[row] * v + s_b[row] * sa;
      y0 += s_r[row] * sn;
      a.wkv_out[soff + (size_t)row * kHs + t] = keep ? col[i] : sn;
    }
    s_part[part * kHs + t] = y0;
    __syncthreads();
    y0 = s_part[t] + s_part[kHs + t] + s_part[2 * kHs + t] + s_part[3 * kHs + t];
    const float mu = block_sum(part == 0 ? y0 : 0.f, red) * (1.f / kHs);
    const float dv = y0 - mu;
    const float var = block_sum(part == 0 ? dv * dv : 0.f, red) * (1.f / kHs);
    if (part == 0) {
      const float yn = dv * rsqrtf(var + a.eps_gn) * a.gn_w[lc] + a.gn_b[lc];
      a.y[bc] = __float2bfloat16_rn((yn + sb * v) * gate);
    }
    __syncthreads();  // shared memory is rewritten by the next item
  }
}

// One quantized matrix over the bf16 input xs [B, k] in shared memory. mode 0:
// x += W in; mode 1: khid = bf16(relu(W in)^2); mode 2: x += W in, then the
// rescale.
template <int NB>
__device__ void gemv_rows(const Args& a, int l, const QMat& w, int M, int k,
                          const __nv_bfloat16* xs, int mode) {
  const int B = a.B, C = a.C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool half_x =
      mode == 2 && a.rescale > 0 && (a.first_layer + l + 1) % a.rescale == 0;
  float acc[NB];
  for (int m = blockIdx.x * kWarps + warp; m < M; m += gridDim.x * kWarps) {
    mat_row<NB>(w, l, M, m, k, xs, B, acc);
    if (lane == 0) {
      for (int t = 0; t < B; ++t) {
        if (mode == 1) {
          const float p = fmaxf(acc[t], 0.f);
          a.khid[(size_t)t * M + m] = __float2bfloat16_rn(p * p);
        } else {
          float* xp = a.x + (size_t)t * C + m;
          const float xn = __ldcg(xp) + acc[t];
          *xp = half_x ? xn * 0.5f : xn;
        }
      }
    }
  }
}

// Phase 3: Wo over y, the residual add.
template <int NB>
__device__ void phase_wo(const Args& a, int l, __nv_bfloat16* xs) {
  stage(xs, a.y, a.B * a.C);
  gemv_rows<NB>(a, l, a.wo, a.C, a.C, xs, 0);
}

// Phase 4: LN2, the FFN shift state (block 0 writes it) and the FFN key's
// input into xs [B, C] bf16; then the FFN key and relu^2.
template <int NB>
__device__ void phase_ffn_key(const Args& a, int l, unsigned char* smem) {
  const int C = a.C, B = a.B;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  float* rows = reinterpret_cast<float*>(smem + (size_t)B * C * 2);
  layer_norm_rows(a.x, B, C, a.eps_ln, a.ln2_w + (size_t)l * C, a.ln2_b + (size_t)l * C,
                  rows);
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const float mix = __ldg(a.ffn_xk + (size_t)l * C + c);
    float sh[NB];
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      sh[b] = b < B ? __ldg(a.fsh_in + ((size_t)l * B + b) * C + c) : 0.f;
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      if (b < B) {
        const size_t i = (size_t)b * C + c;
        const float xx = rows[i];
        if (blockIdx.x == 0) a.fsh_out[(size_t)l * B * C + i] = a.mask[b] == 0.f ? sh[b] : xx;
        xs[i] = __float2bfloat16_rn(xx + mix * (sh[b] - xx));
      }
    }
  }
  __syncthreads();
  gemv_rows<NB>(a, l, a.fk, a.hidden, C, xs, 1);
}

// Phase 5: the FFN value over khid, the residual add and the rescale.
template <int NB>
__device__ void phase_ffn_value(const Args& a, int l, __nv_bfloat16* xs) {
  if (l + 1 < a.L) {  // for the next layer's phase 1
    prefetch_mat(a.wr, l + 1, a.C, a.C);
    prefetch_mat(a.wk, l + 1, a.C, a.C);
    prefetch_mat(a.wv, l + 1, a.C, a.C);
    prefetch_l2(a.down + (size_t)(l + 1) * a.D * a.C, (size_t)a.D * a.C * 2);
  }
  stage(xs, a.khid, a.B * a.hidden);
  gemv_rows<NB>(a, l, a.fv, a.C, a.hidden, xs, 2);
}

template <int NB>
__global__ void __launch_bounds__(kThreads)
layer7_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
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
  for (int l = 0; l < a.L; ++l) {
    phase_proj<NB>(a, l, smem_raw);
    done();
    phase_att(a, l, smem);
    done();
    phase_wo<NB>(a, l, xs);
    done();
    phase_ffn_key<NB>(a, l, smem_raw);
    done();
    phase_ffn_value<NB>(a, l, xs);
    done();
  }
}

size_t smem_bytes(const Args& a) {
  size_t s = (size_t)6 * a.B * a.C * 2 + (size_t)a.B * a.C * 4;          // phase 1
  s = s > (size_t)a.B * a.hidden * 2 ? s : (size_t)a.B * a.hidden * 2;   // phase 5
  const size_t att = ((size_t)kWarps + a.D + (size_t)(4 * kParts + 5 + kParts) * kHs) * 4;
  return s > att ? s : att;
}

template <int NB>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(a);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      layer7_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, layer7_kernel<NB>, kThreads,
                                                           smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int blocks = sms * (per_sm < 2 ? per_sm : 2);
  void* params[] = {const_cast<Args*>(&a)};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(layer7_kernel<NB>), blocks,
                                    kThreads, params, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// ptrs: 60 device pointers in the order of the fields of Args above (ln1_w,
// ln1_b, ln2_w, ln2_b, x_stack, w0, a0, v0, k_k, k_a, ffn_xk, gn_w, gn_b,
// r_k, down, up, then the five pointers of Wr, Wk, Wv, Wo, FFN key, FFN
// value (codes, p1, p2, d8, dm8 of decode_common.cuh's QMat), then ash_in, fsh_in, wkv_in, ash_out, fsh_out, wkv_out, mask, x,
// then rkv, z, vfirst, y, khid (scratch, but vfirst holds layer 0's v after
// the launch and must hold it before one whose first_layer > 0), then
// phase_ns, null or u64 [1 + 5 L] that receives the %globaltimer at the
// start and after each phase's barrier); ints: L, B, C, H, hidden, D, dw,
// da, dg, dv, rescale (0 for none), first_layer, then the six matrices'
// descriptors (MatForm, decode_common.cuh); floats: eps_ln, eps_gn,
// eps_l2. Every array contiguous and 16-byte aligned, C and hidden
// multiples of 256, C == H * 64, every LoRA rank a multiple of 8,
// 1 <= B <= 16. Returns the cudaError_t of the launch.
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.B == 1) return (int)launch<1>(a, s);
  if (a.B == 2) return (int)launch<2>(a, s);
  if (a.B <= 4) return (int)launch<4>(a, s);
  if (a.B <= 8) return (int)launch<8>(a, s);
  return (int)launch<16>(a, s);
}
