// Native GGML block dequantizers / repackers.
//
// The hot path when loading multi-GB GGUF files: parallel (std::thread)
// block decoding to f32, and the load-time repack layouts (split-halves Q4_K
// nibbles, de-interleaved effective scales) described in
// quant/repack.py. Semantics are bit-identical to the numpy reference
// implementations in quant/ggml.py (ref: src/runtime/gguf.rs:9-423).
//
// Exposed as a plain C ABI for ctypes; built by native/__init__.py with
// `g++ -O3 -shared -fPIC`.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// minimal IEEE half -> float (round-trip exact)
inline float half_to_float(uint16_t h) {
  uint32_t sign = (uint32_t)(h & 0x8000u) << 16;
  uint32_t exp = (h >> 10) & 0x1F;
  uint32_t mant = h & 0x3FF;
  uint32_t bits;
  if (exp == 0) {
    if (mant == 0) {
      bits = sign;
    } else {  // subnormal
      int e = -1;
      do {
        e++;
        mant <<= 1;
      } while ((mant & 0x400) == 0);
      mant &= 0x3FF;
      bits = sign | ((uint32_t)(127 - 15 - e) << 23) | (mant << 13);
    }
  } else if (exp == 31) {
    bits = sign | 0x7F800000u | (mant << 13);
  } else {
    bits = sign | ((exp + 112) << 23) | (mant << 13);
  }
  float f;
  std::memcpy(&f, &bits, 4);
  return f;
}

inline float f16at(const uint8_t* p) {
  uint16_t h;
  std::memcpy(&h, p, 2);
  return half_to_float(h);
}

void get_scale_min_k4(int j, const uint8_t* s, uint8_t* d, uint8_t* m) {
  if (j < 4) {
    *d = s[j] & 63;
    *m = s[j + 4] & 63;
  } else {
    *d = (s[j + 4] & 0xF) | ((s[j - 4] >> 6) << 4);
    *m = (s[j + 4] >> 4) | ((s[j] >> 6) << 4);
  }
}

template <typename F>
void parallel_blocks(int64_t n_blocks, F&& fn) {
  unsigned n_thr = std::thread::hardware_concurrency();
  if (n_thr == 0) n_thr = 2;
  if (n_blocks < 1024 || n_thr <= 1) {
    fn((int64_t)0, n_blocks);
    return;
  }
  std::vector<std::thread> thr;
  int64_t per = (n_blocks + n_thr - 1) / n_thr;
  for (unsigned t = 0; t < n_thr; t++) {
    int64_t lo = t * per, hi = std::min<int64_t>(n_blocks, lo + per);
    if (lo >= hi) break;
    thr.emplace_back([lo, hi, &fn] { fn(lo, hi); });
  }
  for (auto& t : thr) t.join();
}

}  // namespace

extern "C" {

// Q8_0: 34B/32el = [d f16][qs i8*32]
void dequant_q8_0(const uint8_t* data, int64_t n_blocks, float* out) {
  parallel_blocks(n_blocks, [&](int64_t lo, int64_t hi) {
    for (int64_t b = lo; b < hi; b++) {
      const uint8_t* blk = data + b * 34;
      float d = f16at(blk);
      float* o = out + b * 32;
      for (int i = 0; i < 32; i++) o[i] = d * (float)(int8_t)blk[2 + i];
    }
  });
}

// Q4_0: 18B/32el, v = d * (nib - 8); ggml split-halves element order
// (element j = lo nibble of byte j, j+16 = hi), matching llama.cpp
// dequantize_row_q4_0 — NOT the reference's interleaved misread.
void dequant_q4_0(const uint8_t* data, int64_t n_blocks, float* out) {
  parallel_blocks(n_blocks, [&](int64_t lo_, int64_t hi_) {
    for (int64_t b = lo_; b < hi_; b++) {
      const uint8_t* blk = data + b * 18;
      float d = f16at(blk);
      float* o = out + b * 32;
      for (int i = 0; i < 16; i++) {
        o[i] = d * (float)((int)(blk[2 + i] & 0xF) - 8);
        o[i + 16] = d * (float)((int)(blk[2 + i] >> 4) - 8);
      }
    }
  });
}

// Q4_K: 144B/256el
void dequant_q4_k(const uint8_t* data, int64_t n_blocks, float* out) {
  parallel_blocks(n_blocks, [&](int64_t lo_, int64_t hi_) {
    for (int64_t b = lo_; b < hi_; b++) {
      const uint8_t* blk = data + b * 144;
      float d = f16at(blk), dmin = f16at(blk + 2);
      const uint8_t* sc = blk + 4;
      const uint8_t* qs = blk + 16;
      float* o = out + b * 256;
      int is = 0;
      for (int j = 0; j < 256; j += 64) {
        uint8_t s0, m0, s1, m1;
        get_scale_min_k4(is, sc, &s0, &m0);
        get_scale_min_k4(is + 1, sc, &s1, &m1);
        float d1 = d * s0, mv1 = dmin * m0, d2 = d * s1, mv2 = dmin * m1;
        const uint8_t* q = qs + j / 2;
        for (int l = 0; l < 32; l++) *o++ = d1 * (float)(q[l] & 0xF) - mv1;
        for (int l = 0; l < 32; l++) *o++ = d2 * (float)(q[l] >> 4) - mv2;
        is += 2;
      }
    }
  });
}

// Q5_K: 176B/256el
void dequant_q5_k(const uint8_t* data, int64_t n_blocks, float* out) {
  parallel_blocks(n_blocks, [&](int64_t lo_, int64_t hi_) {
    for (int64_t b = lo_; b < hi_; b++) {
      const uint8_t* blk = data + b * 176;
      float d = f16at(blk), dmin = f16at(blk + 2);
      const uint8_t* sc = blk + 4;
      const uint8_t* qh = blk + 16;
      const uint8_t* ql = blk + 48;
      float* o = out + b * 256;
      int is = 0;
      uint8_t u1 = 1, u2 = 2;
      for (int j = 0; j < 256; j += 64) {
        uint8_t s0, m0, s1, m1;
        get_scale_min_k4(is, sc, &s0, &m0);
        get_scale_min_k4(is + 1, sc, &s1, &m1);
        float d1 = d * s0, mv1 = dmin * m0, d2 = d * s1, mv2 = dmin * m1;
        const uint8_t* q = ql + j / 2;
        for (int l = 0; l < 32; l++)
          *o++ = d1 * (float)((q[l] & 0xF) + ((qh[l] & u1) ? 16 : 0)) - mv1;
        for (int l = 0; l < 32; l++)
          *o++ = d2 * (float)((q[l] >> 4) + ((qh[l] & u2) ? 16 : 0)) - mv2;
        is += 2;
        u1 <<= 2;
        u2 <<= 2;
      }
    }
  });
}

// Q6_K: 210B/256el
void dequant_q6_k(const uint8_t* data, int64_t n_blocks, float* out) {
  parallel_blocks(n_blocks, [&](int64_t lo_, int64_t hi_) {
    for (int64_t b = lo_; b < hi_; b++) {
      const uint8_t* blk = data + b * 210;
      const uint8_t* ql = blk;
      const uint8_t* qh = blk + 128;
      const int8_t* sc = (const int8_t*)(blk + 192);
      float d = f16at(blk + 208);
      float* o = out + b * 256;
      for (int half = 0; half < 2; half++) {
        const uint8_t* l_ = ql + 64 * half;
        const uint8_t* h_ = qh + 32 * half;
        const int8_t* s_ = sc + 8 * half;
        for (int l = 0; l < 32; l++) {
          int is = l / 16;
          int q1 = (int)((l_[l] & 0xF) | (((h_[l] >> 0) & 3) << 4)) - 32;
          o[l] = d * s_[is] * q1;
          int q2 = (int)((l_[l + 32] & 0xF) | (((h_[l] >> 2) & 3) << 4)) - 32;
          o[l + 32] = d * s_[is + 2] * q2;
          int q3 = (int)((l_[l] >> 4) | (((h_[l] >> 4) & 3) << 4)) - 32;
          o[l + 64] = d * s_[is + 4] * q3;
          int q4 = (int)((l_[l + 32] >> 4) | (((h_[l] >> 6) & 3) << 4)) - 32;
          o[l + 96] = d * s_[is + 6] * q4;
        }
        o += 128;
      }
    }
  });
}

// Q4_1: 20B/32el, v = d*nib + m; ggml split-halves element order
void dequant_q4_1(const uint8_t* data, int64_t n_blocks, float* out) {
  parallel_blocks(n_blocks, [&](int64_t lo_, int64_t hi_) {
    for (int64_t b = lo_; b < hi_; b++) {
      const uint8_t* blk = data + b * 20;
      float d = f16at(blk), m = f16at(blk + 2);
      const uint8_t* qs = blk + 4;
      float* o = out + b * 32;
      for (int i = 0; i < 16; i++) {
        o[i] = d * (float)(qs[i] & 0xF) + m;
        o[i + 16] = d * (float)(qs[i] >> 4) + m;
      }
    }
  });
}

static inline uint32_t le32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}

// Q5_0: 22B/32el, v = d*(q5-16); qh supplies bit 4 (llama.cpp order)
void dequant_q5_0(const uint8_t* data, int64_t n_blocks, float* out) {
  parallel_blocks(n_blocks, [&](int64_t lo_, int64_t hi_) {
    for (int64_t b = lo_; b < hi_; b++) {
      const uint8_t* blk = data + b * 22;
      float d = f16at(blk);
      uint32_t qh = le32(blk + 2);
      const uint8_t* qs = blk + 6;
      float* o = out + b * 32;
      for (int j = 0; j < 16; j++) {
        int x0 = (qs[j] & 0xF) | (((qh >> j) & 1) << 4);
        int x1 = (qs[j] >> 4) | (((qh >> (j + 16)) & 1) << 4);
        o[j] = d * (float)(x0 - 16);
        o[j + 16] = d * (float)(x1 - 16);
      }
    }
  });
}

// Q5_1: 24B/32el, v = d*q5 + m
void dequant_q5_1(const uint8_t* data, int64_t n_blocks, float* out) {
  parallel_blocks(n_blocks, [&](int64_t lo_, int64_t hi_) {
    for (int64_t b = lo_; b < hi_; b++) {
      const uint8_t* blk = data + b * 24;
      float d = f16at(blk), m = f16at(blk + 2);
      uint32_t qh = le32(blk + 4);
      const uint8_t* qs = blk + 8;
      float* o = out + b * 32;
      for (int j = 0; j < 16; j++) {
        int x0 = (qs[j] & 0xF) | (((qh >> j) & 1) << 4);
        int x1 = (qs[j] >> 4) | (((qh >> (j + 16)) & 1) << 4);
        o[j] = d * (float)x0 + m;
        o[j + 16] = d * (float)x1 + m;
      }
    }
  });
}

// Q3_K: 110B/256el = [hmask 32][qs 64][scales 12 packed][d f16];
// 3-bit = 2 low bits + 1 high bit, 16 6-bit scales via the aux-word
// scheme (matches quant/ggml.py::dequantize_q3_k)
void dequant_q3_k(const uint8_t* data, int64_t n_blocks, float* out) {
  parallel_blocks(n_blocks, [&](int64_t lo_, int64_t hi_) {
    for (int64_t b = lo_; b < hi_; b++) {
      const uint8_t* blk = data + b * 110;
      const uint8_t* hmask = blk;
      const uint8_t* qs = blk + 32;
      float d = f16at(blk + 108);
      uint32_t aux[3];
      memcpy(aux, blk + 96, 12);
      const uint32_t k1 = 0x03030303u, k2 = 0x0F0F0F0Fu;
      uint32_t a[4];
      a[0] = (aux[0] & k2) | (((aux[2] >> 0) & k1) << 4);
      a[1] = (aux[1] & k2) | (((aux[2] >> 2) & k1) << 4);
      a[2] = ((aux[0] >> 4) & k2) | (((aux[2] >> 4) & k1) << 4);
      a[3] = ((aux[1] >> 4) & k2) | (((aux[2] >> 6) & k1) << 4);
      int8_t sc[16];
      memcpy(sc, a, 16);
      float* o = out + b * 256;
      for (int h = 0; h < 2; h++) {
        const uint8_t* q = qs + 32 * h;
        for (int s = 0; s < 4; s++) {
          for (int l = 0; l < 32; l++) {
            int lo2 = (q[l] >> (2 * s)) & 3;
            int hb = (hmask[l] >> (4 * h + s)) & 1;
            float qv = (float)lo2 + (hb ? 0.0f : -4.0f);
            float scale = (float)sc[8 * h + 2 * s + l / 16] - 32.0f;
            *o++ = d * scale * qv;
          }
        }
      }
    }
  });
}

// Q2_K: 84B/256el = [scales 16][qs 64][d f16][dmin f16];
// v = d*(sc&0xF)*q - dmin*(sc>>4)
void dequant_q2_k(const uint8_t* data, int64_t n_blocks, float* out) {
  parallel_blocks(n_blocks, [&](int64_t lo_, int64_t hi_) {
    for (int64_t b = lo_; b < hi_; b++) {
      const uint8_t* blk = data + b * 84;
      const uint8_t* scales = blk;
      const uint8_t* qs = blk + 16;
      float d = f16at(blk + 80), dmin = f16at(blk + 82);
      float* o = out + b * 256;
      for (int h = 0; h < 2; h++) {
        const uint8_t* q = qs + 32 * h;
        for (int s = 0; s < 4; s++) {
          for (int l = 0; l < 32; l++) {
            int qv = (q[l] >> (2 * s)) & 3;
            uint8_t sub = scales[8 * h + 2 * s + l / 16];
            *o++ = d * (float)(sub & 0xF) * (float)qv -
                   dmin * (float)(sub >> 4);
          }
        }
      }
    }
  });
}

// Q4_K repack: split-halves nibble codes + effective f32 scales/mins.
// rows_cols: per-row blocks n_sb = K/256; codes out [M, K/2] u8,
// scales/mins out [M, K/32] f32 (row-major).
void repack_q4_k(const uint8_t* data, int64_t n_blocks, int64_t k,
                 uint8_t* codes, float* scales, float* mins) {
  // Super-blocks run over the FLAT element stream and may straddle row
  // boundaries when k is not a multiple of 256 (e.g. ffn hidden 2688).
  // Phase 1 decodes blocks into a flat element buffer and writes
  // scales/mins by flat 32-group index; phase 2 packs split-halves
  // nibbles per output row.
  int64_t half = k / 2;
  int64_t n_rows = n_blocks * 256 / k;
  std::vector<uint8_t> el((size_t)n_blocks * 256);

  parallel_blocks(n_blocks, [&](int64_t lo_, int64_t hi_) {
    for (int64_t b = lo_; b < hi_; b++) {
      const uint8_t* blk = data + b * 144;
      float d = f16at(blk), dmin = f16at(blk + 2);
      const uint8_t* sc = blk + 4;
      const uint8_t* qs = blk + 16;

      float* sdst = scales + b * 8;  // flat group index = b*8 + j
      float* mdst = mins + b * 8;
      for (int j = 0; j < 8; j++) {
        uint8_t s_, m_;
        get_scale_min_k4(j, sc, &s_, &m_);
        sdst[j] = d * s_;
        mdst[j] = dmin * m_;
      }

      uint8_t* e = el.data() + b * 256;
      for (int j = 0; j < 256; j += 64) {
        const uint8_t* q = qs + j / 2;
        for (int l = 0; l < 32; l++) *e++ = q[l] & 0xF;
        for (int l = 0; l < 32; l++) *e++ = q[l] >> 4;
      }
    }
  });

  parallel_blocks(n_rows, [&](int64_t row_lo, int64_t row_hi) {
    for (int64_t row = row_lo; row < row_hi; row++) {
      const uint8_t* erow = el.data() + row * k;
      uint8_t* crow = codes + row * half;
      for (int64_t j = 0; j < half; j++)
        crow[j] = (uint8_t)(erow[j] | (erow[j + half] << 4));
    }
  });
}

}  // extern "C"
