"""GGML block-quantization formats: parsing and vectorized numpy dequant.

The port's own copy of the formats its main path reads: F32 and F16
(plain arrays, read by the GGUF reader) and the K-quant super-blocks
Q4_K and Q6_K (the Q4_K_M placement: Q4_K layer matrices, Q6_K head).
Every dequantizer takes the raw little-endian block bytes and the
element count and returns ``float32`` values in the GGML (llama.cpp)
element order. Everything is vectorized over blocks: the byte stream is
viewed as ``[n_blocks, block_bytes]`` and whole columns are decoded.
"""

from __future__ import annotations

import enum

import numpy as np

from ..errors import UnsupportedTensorType

QK_K = 256  # super-block size for K-quants


class GgmlDType(enum.IntEnum):
    """GGML tensor type ids."""

    F32 = 0
    F16 = 1
    Q4_0 = 2
    Q4_1 = 3
    Q5_0 = 6
    Q5_1 = 7
    Q8_0 = 8
    Q8_1 = 9
    Q2_K = 10
    Q3_K = 11
    Q4_K = 12
    Q5_K = 13
    Q6_K = 14
    Q8_K = 15
    IQ2_XXS = 16
    IQ2_XS = 17
    IQ3_XXS = 18
    IQ1_S = 19
    IQ4_NL = 20
    IQ3_S = 21
    IQ2_S = 22
    IQ4_XS = 23
    I8 = 24
    I16 = 25
    I32 = 26
    I64 = 27
    F64 = 28
    IQ1_M = 29
    BF16 = 30
    TQ1_0 = 34
    TQ2_0 = 35


# bytes per block
GGML_TYPE_SIZES: dict[GgmlDType, int] = {
    GgmlDType.F32: 4,
    GgmlDType.F16: 2,
    GgmlDType.BF16: 2,
    GgmlDType.F64: 8,
    GgmlDType.I8: 1,
    GgmlDType.I16: 2,
    GgmlDType.I32: 4,
    GgmlDType.I64: 8,
    GgmlDType.Q4_0: 18,
    GgmlDType.Q4_1: 20,
    GgmlDType.Q5_0: 22,
    GgmlDType.Q5_1: 24,
    GgmlDType.Q8_0: 34,
    GgmlDType.Q8_1: 36,
    GgmlDType.Q2_K: 84,
    GgmlDType.Q3_K: 110,
    GgmlDType.Q4_K: 144,
    GgmlDType.Q5_K: 176,
    GgmlDType.Q6_K: 210,
    GgmlDType.Q8_K: 292,
}

# elements per block
GGML_BLOCK_SIZES: dict[GgmlDType, int] = {
    **{t: 1 for t in (GgmlDType.F32, GgmlDType.F16, GgmlDType.BF16, GgmlDType.F64,
                      GgmlDType.I8, GgmlDType.I16, GgmlDType.I32, GgmlDType.I64)},
    **{t: 32 for t in (GgmlDType.Q4_0, GgmlDType.Q4_1, GgmlDType.Q5_0, GgmlDType.Q5_1,
                       GgmlDType.Q8_0, GgmlDType.Q8_1)},
    **{t: QK_K for t in (GgmlDType.Q2_K, GgmlDType.Q3_K, GgmlDType.Q4_K, GgmlDType.Q5_K,
                         GgmlDType.Q6_K, GgmlDType.Q8_K)},
}

QUANTIZED_TYPES = frozenset(
    t for t, n in GGML_BLOCK_SIZES.items() if n > 1
)


def _blocks(data: bytes | np.ndarray, block_bytes: int) -> np.ndarray:
    """View raw bytes as ``[n_blocks, block_bytes]`` uint8."""
    buf = np.frombuffer(data, dtype=np.uint8) if not isinstance(data, np.ndarray) else data
    n = buf.size // block_bytes
    return buf[: n * block_bytes].reshape(n, block_bytes)


def _f16(b: np.ndarray) -> np.ndarray:
    """Interpret pairs of bytes (last axis of size 2) as little-endian f16 → f32."""
    return b.copy().view(np.float16)[..., 0].astype(np.float32)


def _unpack_scale_min_k4(scales: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Unpack the 12-byte 6-bit packed scale/min arrays of Q4_K/Q5_K.

    Returns ``(sc, m)`` each ``[n_blocks, 8]`` uint8 (values 0..63),
    following ggml's ``get_scale_min_k4``.
    """
    s = scales.astype(np.uint8)
    sc = np.empty(s.shape[:-1] + (8,), dtype=np.uint8)
    m = np.empty_like(sc)
    for j in range(4):
        sc[..., j] = s[..., j] & 63
        m[..., j] = s[..., j + 4] & 63
    for j in range(4, 8):
        sc[..., j] = (s[..., j + 4] & 0x0F) | ((s[..., j - 4] >> 6) << 4)
        m[..., j] = (s[..., j + 4] >> 4) | ((s[..., j] >> 6) << 4)
    return sc, m


def dequantize_q4_k(data, num_elements: int) -> np.ndarray:
    """Q4_K: 256 el/super-block = [d: f16][dmin: f16][scales: 12B][qs: 128B].

    8 sub-blocks of 32; v = d*sc[i] * q - dmin*m[i]. Element order: for each
    64-element group g (qs bytes 32g/2 .. +32): first 32 low nibbles
    (scale 2g), then 32 high nibbles (scale 2g+1).
    """
    b = _blocks(data, 144)
    n = b.shape[0]
    d = _f16(b[:, 0:2])
    dmin = _f16(b[:, 2:4])
    sc, mn = _unpack_scale_min_k4(b[:, 4:16])
    qs = b[:, 16:144].reshape(n, 4, 32)  # 4 groups of 32 bytes
    lo = (qs & 0x0F).astype(np.float32)
    hi = (qs >> 4).astype(np.float32)
    # [n, 4, 2, 32] → group-major, lo-sub then hi-sub
    q = np.stack([lo, hi], axis=2)
    scales = (d[:, None] * sc.astype(np.float32)).reshape(n, 4, 2)
    mins = (dmin[:, None] * mn.astype(np.float32)).reshape(n, 4, 2)
    out = scales[..., None] * q - mins[..., None]
    return out.reshape(-1)[:num_elements]


def dequantize_q6_k(data, num_elements: int) -> np.ndarray:
    """Q6_K: 256 el = [ql: 128B][qh: 64B][scales: i8*16][d: f16]; 6-bit = 4 low + 2 high."""
    b = _blocks(data, 210)
    n = b.shape[0]
    ql = b[:, 0:128].reshape(n, 2, 64)
    qh = b[:, 128:192].reshape(n, 2, 32)
    scales = b[:, 192:208].copy().view(np.int8).astype(np.float32)  # [n, 16]
    d = _f16(b[:, 208:210])  # [n]

    # per 128-element half: 4 output groups of 32
    lo = np.stack(
        [
            ql[:, :, 0:32] & 0x0F,
            ql[:, :, 32:64] & 0x0F,
            ql[:, :, 0:32] >> 4,
            ql[:, :, 32:64] >> 4,
        ],
        axis=2,
    ).astype(np.int16)  # [n, 2, 4, 32]
    shifts = np.array([0, 2, 4, 6], dtype=np.uint8)
    hi = ((qh[:, :, None, :] >> shifts[None, None, :, None]) & 3).astype(np.int16)
    q = (lo | (hi << 4)).astype(np.float32) - 32.0  # [n, 2, 4, 32]

    # scale index: half h, group g, element l → 8h + 2g + l//16
    sc = scales.reshape(n, 2, 8)  # [n, half, 8]
    sc_idx = (np.arange(4)[:, None] * 2 + (np.arange(32)[None, :] // 16))  # [4, 32]
    sub_scale = sc[:, :, sc_idx]  # [n, 2, 4, 32]
    out = d[:, None, None, None] * sub_scale * q
    return out.reshape(-1)[:num_elements]


_DEQUANTIZERS = {
    GgmlDType.Q4_K: dequantize_q4_k,
    GgmlDType.Q6_K: dequantize_q6_k,
}


def dequantize(dtype: GgmlDType, data, num_elements: int) -> np.ndarray:
    """Dequantize raw block bytes of the given ggml type to float32."""
    try:
        fn = _DEQUANTIZERS[dtype]
    except KeyError:
        raise UnsupportedTensorType(
            f"unsupported quantized ggml type: {dtype!r}"
        ) from None
    return fn(data, num_elements)


# ---------------------------------------------------------------------------
# Quantizers (for building test fixtures and synthetic models). Simple
# absmax/min fits, not llama.cpp's iterative ones; the bit layout
# round-trips through the dequantizers above.
# ---------------------------------------------------------------------------


def quantize_q4_k(values: np.ndarray) -> bytes:
    """Quantize f32 values (multiple of 256) to Q4_K super-blocks.

    Per 32-element sub-block compute scale/min, then 6-bit quantize
    those against per-super-block d/dmin. A valid Q4_K encoding
    (dequant is exact w.r.t. the stored bits).
    """
    v = np.asarray(values, np.float32).reshape(-1, QK_K)
    n = v.shape[0]
    sub = v.reshape(n, 8, 32)
    smin = np.minimum(sub.min(axis=2), 0.0)          # mins stored as positive offsets
    smax = sub.max(axis=2)
    scale = (smax - smin) / 15.0                     # per-sub scale
    neg_min = -smin                                  # >= 0
    d = (scale.max(axis=1) / 63.0).astype(np.float32)
    dmin = (neg_min.max(axis=1) / 63.0).astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv_d = np.where(d > 0, 1.0 / np.where(d > 0, d, 1), 0.0)
        inv_m = np.where(dmin > 0, 1.0 / np.where(dmin > 0, dmin, 1), 0.0)
    sc = np.clip(np.round(scale * inv_d[:, None]), 0, 63).astype(np.uint8)
    mn = np.clip(np.round(neg_min * inv_m[:, None]), 0, 63).astype(np.uint8)

    d16 = d.astype(np.float16)
    dmin16 = dmin.astype(np.float16)
    eff_scale = d16.astype(np.float32)[:, None] * sc
    eff_min = dmin16.astype(np.float32)[:, None] * mn
    with np.errstate(divide="ignore", invalid="ignore"):
        inv_s = np.where(eff_scale > 0, 1.0 / np.where(eff_scale > 0, eff_scale, 1), 0.0)
    q = np.clip(np.round((sub + eff_min[:, :, None]) * inv_s[:, :, None]), 0, 15).astype(np.uint8)

    # pack 12-byte scales (inverse of _unpack_scale_min_k4)
    scales = np.zeros((n, 12), np.uint8)
    for j in range(4):
        scales[:, j] = sc[:, j] | ((sc[:, j + 4] >> 4) << 6)
        scales[:, j + 4] = mn[:, j] | ((mn[:, j + 4] >> 4) << 6)
        scales[:, j + 8] = (sc[:, j + 4] & 0x0F) | ((mn[:, j + 4] & 0x0F) << 4)

    # pack nibbles: group g (64 el) = bytes 32g..32g+32; lo = sub 2g, hi = sub 2g+1
    qsub = q.reshape(n, 4, 2, 32)
    qs = (qsub[:, :, 0, :] | (qsub[:, :, 1, :] << 4)).reshape(n, 128)

    out = np.empty((n, 144), np.uint8)
    out[:, 0:2] = d16[:, None].view(np.uint8)
    out[:, 2:4] = dmin16[:, None].view(np.uint8)
    out[:, 4:16] = scales
    out[:, 16:144] = qs
    return out.tobytes()


def quantize_q6_k(values: np.ndarray) -> bytes:
    """Quantize f32 values (multiple of 256) to Q6_K super-blocks.

    Per 16-element group compute a float scale, 8-bit quantize those
    against a per-super-block d (signs alternate on every third group to
    exercise the signed-scale decode path). A valid Q6_K encoding
    (dequant is exact w.r.t. the stored bits).
    """
    v = np.asarray(values, np.float32).reshape(-1, QK_K)
    n = v.shape[0]
    groups = v.reshape(n, 16, 16)
    s = np.abs(groups).max(axis=2) / 31.0  # per-group scale >= 0
    sign = np.where(np.arange(16) % 3 == 2, -1.0, 1.0)[None, :]
    s = s * sign
    d = (np.abs(s).max(axis=1) / 127.0).astype(np.float16)
    ds = d.astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv_d = np.where(ds > 0, 1.0 / np.where(ds > 0, ds, 1), 0.0)
    sc8 = np.clip(np.round(s * inv_d[:, None]), -128, 127).astype(np.int8)
    eff = ds[:, None] * sc8.astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv_e = np.where(eff != 0, 1.0 / np.where(eff != 0, eff, 1), 0.0)
    q = np.clip(np.round(groups * inv_e[:, :, None]), -32, 31).astype(np.int8)

    qb = (q.reshape(n, 256) + 32).astype(np.uint8)  # 0..63
    half = qb.reshape(n, 2, 4, 32)  # [n, half, r, c]: e = 128h + 32r + c
    lo4 = half & 0x0F
    hi2 = half >> 4
    ql = np.empty((n, 2, 64), np.uint8)
    ql[:, :, 0:32] = lo4[:, :, 0] | (lo4[:, :, 2] << 4)
    ql[:, :, 32:64] = lo4[:, :, 1] | (lo4[:, :, 3] << 4)
    qh = (hi2[:, :, 0] | (hi2[:, :, 1] << 2) | (hi2[:, :, 2] << 4)
          | (hi2[:, :, 3] << 6)).astype(np.uint8)

    out = np.empty((n, 210), np.uint8)
    out[:, 0:128] = ql.reshape(n, 128)
    out[:, 128:192] = qh.reshape(n, 64)
    out[:, 192:208] = sc8.view(np.uint8)
    out[:, 208:210] = d[:, None].view(np.uint8)
    return out.tobytes()
