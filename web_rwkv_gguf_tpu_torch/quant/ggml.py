"""GGML block-quantization formats: parsing and vectorized numpy dequant.

The port's own copy of every block type it loads: F32 and F16 (plain
arrays, read by the GGUF reader), the legacy 32-element blocks Q8_0,
Q4_0, Q4_1, Q5_0 and Q5_1, and the K-quant super-blocks Q2_K, Q3_K,
Q4_K, Q5_K and Q6_K. Every dequantizer takes the raw little-endian block bytes and the
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


def dequantize_q8_0(data, num_elements: int) -> np.ndarray:
    """Q8_0: 32 el/block = [d: f16][qs: i8*32], v = d * q."""
    b = _blocks(data, 34)
    d = _f16(b[:, 0:2])[:, None]
    q = b[:, 2:34].copy().view(np.int8).astype(np.float32)
    return (d * q).reshape(-1)[:num_elements]


def dequantize_q4_0(data, num_elements: int) -> np.ndarray:
    """Q4_0: 32 el/block = [d: f16][qs: u4*32], v = d * (q - 8).

    Element order within a block follows ggml (llama.cpp
    ``dequantize_row_q4_0``): element j = low nibble of byte j, element
    j+16 = high nibble — SPLIT HALVES, the GGUF-era standard.
    """
    b = _blocks(data, 18)
    d = _f16(b[:, 0:2])[:, None]
    qs = b[:, 2:18]
    lo = (qs & 0x0F).astype(np.int8) - 8
    hi = (qs >> 4).astype(np.int8) - 8
    q = np.concatenate([lo, hi], axis=-1).astype(np.float32)
    return (d * q).reshape(-1)[:num_elements]


def dequantize_q4_1(data, num_elements: int) -> np.ndarray:
    """Q4_1: 32 el/block = [d: f16][m: f16][qs: u4*32], v = d * q + m.

    ggml split-halves block order (llama.cpp ``dequantize_row_q4_1``):
    element j = low nibble of byte j, element j+16 = high nibble.
    """
    b = _blocks(data, 20)
    d = _f16(b[:, 0:2])[:, None]
    mm = _f16(b[:, 2:4])[:, None]
    qs = b[:, 4:20]
    q = np.concatenate([qs & 0x0F, qs >> 4], axis=-1).astype(np.float32)
    return (d * q + mm).reshape(-1)[:num_elements]


def q5_codes(qs: np.ndarray, qh_bytes: np.ndarray) -> np.ndarray:
    """5-bit codes ``[n, 32]`` (values 0..31, split-halves element
    order) from Q5_0/Q5_1 nibble bytes ``qs [n, 16]`` and the 32-bit
    high-bit word ``qh_bytes [n, 4]``: element j = lo nibble of byte j
    | (qh bit j << 4); element j+16 = hi nibble | (qh bit j+16 << 4)
    (llama.cpp ``dequantize_row_q5_0/q5_1``)."""
    qh = np.ascontiguousarray(qh_bytes).view(np.uint32).astype(np.uint64)
    j = np.arange(16, dtype=np.uint64)
    lo = (qs & 0x0F).astype(np.uint64) | (((qh >> j) & 1) << 4)
    hi = (qs >> 4).astype(np.uint64) | (((qh >> (j + 16)) & 1) << 4)
    return np.concatenate([lo, hi], axis=-1).astype(np.uint8)


def dequantize_q5_0(data, num_elements: int) -> np.ndarray:
    """Q5_0: 32 el/block = [d: f16][qh: u32][qs: u4*32],
    v = d * (q5 - 16) with the 5th bit from ``qh`` (see
    :func:`q5_codes`)."""
    b = _blocks(data, 22)
    d = _f16(b[:, 0:2])[:, None]
    q = q5_codes(b[:, 6:22], b[:, 2:6]).astype(np.float32) - 16.0
    return (d * q).reshape(-1)[:num_elements]


def dequantize_q5_1(data, num_elements: int) -> np.ndarray:
    """Q5_1: 32 el/block = [d: f16][m: f16][qh: u32][qs: u4*32],
    v = d * q5 + m."""
    b = _blocks(data, 24)
    d = _f16(b[:, 0:2])[:, None]
    mm = _f16(b[:, 2:4])[:, None]
    q = q5_codes(b[:, 8:24], b[:, 4:8]).astype(np.float32)
    return (d * q + mm).reshape(-1)[:num_elements]


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


def dequantize_q5_k(data, num_elements: int) -> np.ndarray:
    """Q5_K: 256 el = [d][dmin][scales: 12B][qh: 32B][ql: 128B]; 5-bit = 4 low + 1 high."""
    b = _blocks(data, 176)
    n = b.shape[0]
    d = _f16(b[:, 0:2])
    dmin = _f16(b[:, 2:4])
    sc, mn = _unpack_scale_min_k4(b[:, 4:16])
    qh = b[:, 16:48]  # [n, 32]
    ql = b[:, 48:176].reshape(n, 4, 32)
    lo = (ql & 0x0F).astype(np.float32)
    hi = (ql >> 4).astype(np.float32)
    # high bit for sub-block s (0..7) of element l: (qh[l] >> s) & 1
    shifts = np.arange(8, dtype=np.uint8)
    hbits = ((qh[:, None, :] >> shifts[None, :, None]) & 1).astype(np.float32) * 16.0
    hbits = hbits.reshape(n, 4, 2, 32)
    q = np.stack([lo, hi], axis=2) + hbits
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


def dequantize_q3_k(data, num_elements: int) -> np.ndarray:
    """Q3_K: 256 el = [hmask: 32B][qs: 64B][scales: 12B packed][d: f16]; 3-bit = 2 low + 1 high."""
    b = _blocks(data, 110)
    n = b.shape[0]
    hmask = b[:, 0:32]
    qs = b[:, 32:96].reshape(n, 2, 32)
    scales_raw = b[:, 96:108]
    d_all = _f16(b[:, 108:110])

    # unpack 16 6-bit scales (aux-word scheme)
    aux = scales_raw.copy().view("<u4")  # [n, 3]
    kmask1, kmask2 = np.uint32(0x03030303), np.uint32(0x0F0F0F0F)
    tmp = aux[:, 2].copy()
    a0 = (aux[:, 0] & kmask2) | (((tmp >> np.uint32(0)) & kmask1) << np.uint32(4))
    a1 = (aux[:, 1] & kmask2) | (((tmp >> np.uint32(2)) & kmask1) << np.uint32(4))
    a2 = ((aux[:, 0] >> np.uint32(4)) & kmask2) | (((tmp >> np.uint32(4)) & kmask1) << np.uint32(4))
    a3 = ((aux[:, 1] >> np.uint32(4)) & kmask2) | (((tmp >> np.uint32(6)) & kmask1) << np.uint32(4))
    packed = np.stack([a0, a1, a2, a3], axis=1).copy().view(np.uint8).view(np.int8)
    scales = packed.reshape(n, 16).astype(np.float32) - 32.0

    # low 2 bits: half h (qs row), shift s (0,2,4,6), elements 0..31
    shifts = np.array([0, 2, 4, 6], dtype=np.uint8)
    lo = ((qs[:, :, None, :] >> shifts[None, None, :, None]) & 3).astype(np.float32)
    # high bit: mask bit index m = 4h + s applied to hmask elements
    bitidx = (np.arange(2)[:, None] * 4 + np.arange(4)[None, :]).astype(np.uint8)  # [2, 4]
    hbit = (hmask[:, None, None, :] >> bitidx[None, :, :, None]) & 1  # [n, 2, 4, 32]
    q = lo + np.where(hbit != 0, 0.0, -4.0)
    # scale index: half h, shift s, element l → is = 8h + 2s_row... layout: for each
    # (h, s): sub-blocks of 16 use scales[8h + 2s + l//16]
    sc = scales.reshape(n, 2, 8)
    sc_idx = (np.arange(4)[:, None] * 2 + (np.arange(32)[None, :] // 16))
    sub_scale = sc[:, :, sc_idx]
    out = d_all[:, None, None, None] * sub_scale * q
    return out.reshape(-1)[:num_elements]


def dequantize_q2_k(data, num_elements: int) -> np.ndarray:
    """Q2_K: 256 el = [scales: 16B][qs: 64B][d: f16][dmin: f16]; v = d*(sc&0xF)*q - dmin*(sc>>4)."""
    b = _blocks(data, 84)
    n = b.shape[0]
    scales = b[:, 0:16]
    qs = b[:, 16:80].reshape(n, 2, 32)
    d = _f16(b[:, 80:82])
    dmin = _f16(b[:, 82:84])

    shifts = np.array([0, 2, 4, 6], dtype=np.uint8)
    q = ((qs[:, :, None, :] >> shifts[None, None, :, None]) & 3).astype(np.float32)
    sc = scales.reshape(n, 2, 8)
    sc_idx = (np.arange(4)[:, None] * 2 + (np.arange(32)[None, :] // 16))
    sub = sc[:, :, sc_idx]  # [n, 2, 4, 32] uint8
    dl = d[:, None, None, None] * (sub & 0x0F).astype(np.float32)
    ml = dmin[:, None, None, None] * (sub >> 4).astype(np.float32)
    out = dl * q - ml
    return out.reshape(-1)[:num_elements]


_DEQUANTIZERS = {
    GgmlDType.Q8_0: dequantize_q8_0,
    GgmlDType.Q4_0: dequantize_q4_0,
    GgmlDType.Q4_1: dequantize_q4_1,
    GgmlDType.Q5_0: dequantize_q5_0,
    GgmlDType.Q5_1: dequantize_q5_1,
    GgmlDType.Q4_K: dequantize_q4_k,
    GgmlDType.Q5_K: dequantize_q5_k,
    GgmlDType.Q6_K: dequantize_q6_k,
    GgmlDType.Q3_K: dequantize_q3_k,
    GgmlDType.Q2_K: dequantize_q2_k,
}
# the block types this module dequantizes and quantizes: the ones the GGUF
# writer targets and a matrix loads from directly (models/matrix.py)
DIRECT_TYPES = frozenset(_DEQUANTIZERS)


def dequantize(dtype: GgmlDType, data, num_elements: int) -> np.ndarray:
    """Dequantize raw block bytes of the given ggml type to float32: in
    C++ (``native``, threaded), or by the numpy dequantizers above, which
    give the same bits, where the machine has no g++."""
    try:
        fn = _DEQUANTIZERS[dtype]
    except KeyError:
        raise UnsupportedTensorType(
            f"unsupported quantized ggml type: {dtype!r}"
        ) from None
    from .. import native

    out = native.dequantize(dtype.name.lower(), data, num_elements)
    return fn(data, num_elements) if out is None else out


# ---------------------------------------------------------------------------
# Quantizers (for building test fixtures and synthetic models): the legacy
# types follow llama.cpp's simple reference quantizers, the K-quants are
# simple absmax/min fits, not llama.cpp's iterative ones; the bit layout
# round-trips through the dequantizers above.
# ---------------------------------------------------------------------------


def quantize_q8_0(values: np.ndarray) -> bytes:
    """Quantize f32 values (multiple of 32) to Q8_0 blocks."""
    v = np.asarray(values, np.float32).reshape(-1, 32)
    amax = np.abs(v).max(axis=1)
    d = (amax / 127.0).astype(np.float16)
    ds = d.astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = np.where(ds > 0, 1.0 / np.where(ds > 0, ds, 1.0), 0.0)
    q = np.clip(np.round(v * inv[:, None]), -128, 127).astype(np.int8)
    out = np.empty((v.shape[0], 34), np.uint8)
    out[:, 0:2] = d[:, None].view(np.uint8)
    out[:, 2:34] = q.view(np.uint8)
    return out.tobytes()


def quantize_q4_0(values: np.ndarray) -> bytes:
    """Quantize f32 values (multiple of 32) to Q4_0 blocks
    (llama.cpp ``quantize_row_q4_0_ref``: d = signed-absmax / −8,
    q = trunc(v/d + 8.5) clipped to 15, split-halves element order)."""
    v = np.asarray(values, np.float32).reshape(-1, 32)
    mx = v[np.arange(v.shape[0]), np.abs(v).argmax(axis=1)]
    d = mx / -8.0  # id from the UNROUNDED f32 d (llama.cpp does the same)
    inv = np.where(d != 0, 1.0 / np.where(d != 0, d, 1.0), 0.0)
    q = np.clip(np.floor(v * inv[:, None] + 8.5), 0, 15).astype(np.uint8)
    out = np.empty((v.shape[0], 18), np.uint8)
    out[:, 0:2] = d.astype(np.float16)[:, None].view(np.uint8)
    out[:, 2:18] = q[:, :16] | (q[:, 16:] << 4)
    return out.tobytes()


def quantize_q4_1(values: np.ndarray) -> bytes:
    """Quantize f32 values (multiple of 32) to Q4_1 blocks
    (llama.cpp ``quantize_row_q4_1_ref``: d = (max−min)/15, m = min)."""
    v = np.asarray(values, np.float32).reshape(-1, 32)
    mn, mx = v.min(axis=1), v.max(axis=1)
    d = (mx - mn) / 15.0
    inv = np.where(d != 0, 1.0 / np.where(d != 0, d, 1.0), 0.0)
    q = np.clip(np.floor((v - mn[:, None]) * inv[:, None] + 0.5), 0, 15)
    q = q.astype(np.uint8)
    out = np.empty((v.shape[0], 20), np.uint8)
    out[:, 0:2] = d.astype(np.float16)[:, None].view(np.uint8)
    out[:, 2:4] = mn.astype(np.float16)[:, None].view(np.uint8)
    out[:, 4:20] = q[:, :16] | (q[:, 16:] << 4)
    return out.tobytes()


def _q5_pack(q: np.ndarray, out: np.ndarray, qh_off: int, qs_off: int):
    """Pack 5-bit codes ``q [n, 32]`` into nibble bytes + high-bit word."""
    out[:, qs_off : qs_off + 16] = (q[:, :16] & 0x0F) | ((q[:, 16:] & 0x0F) << 4)
    bits = ((q >> 4) & 1).astype(np.uint64)
    qh = (bits << np.arange(32, dtype=np.uint64)).sum(axis=1).astype(np.uint32)
    out[:, qh_off : qh_off + 4] = qh[:, None].view(np.uint8)


def quantize_q5_0(values: np.ndarray) -> bytes:
    """Quantize f32 values (multiple of 32) to Q5_0 blocks
    (llama.cpp ``quantize_row_q5_0_ref``: d = signed-absmax / −16)."""
    v = np.asarray(values, np.float32).reshape(-1, 32)
    mx = v[np.arange(v.shape[0]), np.abs(v).argmax(axis=1)]
    d = mx / -16.0  # id from the UNROUNDED f32 d (llama.cpp does the same)
    inv = np.where(d != 0, 1.0 / np.where(d != 0, d, 1.0), 0.0)
    q = np.clip(np.floor(v * inv[:, None] + 16.5), 0, 31).astype(np.uint8)
    out = np.empty((v.shape[0], 22), np.uint8)
    out[:, 0:2] = d.astype(np.float16)[:, None].view(np.uint8)
    _q5_pack(q, out, 2, 6)
    return out.tobytes()


def quantize_q5_1(values: np.ndarray) -> bytes:
    """Quantize f32 values (multiple of 32) to Q5_1 blocks
    (llama.cpp ``quantize_row_q5_1_ref``: d = (max−min)/31, m = min)."""
    v = np.asarray(values, np.float32).reshape(-1, 32)
    mn, mx = v.min(axis=1), v.max(axis=1)
    d = (mx - mn) / 31.0
    inv = np.where(d != 0, 1.0 / np.where(d != 0, d, 1.0), 0.0)
    q = np.clip(np.floor((v - mn[:, None]) * inv[:, None] + 0.5), 0, 31)
    q = q.astype(np.uint8)
    out = np.empty((v.shape[0], 24), np.uint8)
    out[:, 0:2] = d.astype(np.float16)[:, None].view(np.uint8)
    out[:, 2:4] = mn.astype(np.float16)[:, None].view(np.uint8)
    _q5_pack(q, out, 4, 8)
    return out.tobytes()


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


def quantize_q5_k(values: np.ndarray) -> bytes:
    """Quantize f32 values (multiple of 256) to Q5_K super-blocks — the
    Q4_K scheme (6-bit sub-scales/mins vs per-super d/dmin) with 5-bit
    codes. Valid encoding; dequant exact w.r.t. stored bits."""
    v = np.asarray(values, np.float32).reshape(-1, QK_K)
    n = v.shape[0]
    sub = v.reshape(n, 8, 32)
    smin = np.minimum(sub.min(axis=2), 0.0)
    smax = sub.max(axis=2)
    scale = (smax - smin) / 31.0
    neg_min = -smin
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
    q = np.clip(np.round((sub + eff_min[:, :, None]) * inv_s[:, :, None]),
                0, 31).astype(np.uint8)

    scales = np.zeros((n, 12), np.uint8)
    for j in range(4):
        scales[:, j] = sc[:, j] | ((sc[:, j + 4] >> 4) << 6)
        scales[:, j + 4] = mn[:, j] | ((mn[:, j + 4] >> 4) << 6)
        scales[:, j + 8] = (sc[:, j + 4] & 0x0F) | ((mn[:, j + 4] & 0x0F) << 4)

    # element e = 64g + 32h + c (g super-sub pair, h lo/hi nibble, c col)
    qe = q.reshape(n, 4, 2, 32)
    lo4 = qe & 0x0F
    hb = (qe >> 4).astype(np.uint8)  # 0/1 fifth bit
    ql = (lo4[:, :, 0, :] | (lo4[:, :, 1, :] << 4)).reshape(n, 128)
    j_idx = np.arange(8).reshape(4, 2)
    qh = np.zeros((n, 32), np.uint8)
    for g in range(4):
        for h in range(2):
            qh |= (hb[:, g, h, :] << j_idx[g, h]).astype(np.uint8)

    out = np.empty((n, 176), np.uint8)
    out[:, 0:2] = d16[:, None].view(np.uint8)
    out[:, 2:4] = dmin16[:, None].view(np.uint8)
    out[:, 4:16] = scales
    out[:, 16:48] = qh
    out[:, 48:176] = ql
    return out.tobytes()


# Q2_K/Q3_K element order: e = 128h + 32s + c (h half, s shift, c column);
# 16-element sub-block index = 8h + 2s + c//16 (see dequantize_q2_k).
def _k2k3_subblocks(v: np.ndarray) -> np.ndarray:
    """[n, 256] → [n, 16, 16] grouped by the Q2/Q3 sub-block index."""
    n = v.shape[0]
    hsc = v.reshape(n, 2, 4, 2, 16)  # [n, h, s, c//16, c%16]
    return hsc.reshape(n, 16, 16)


def _k2k3_elements(q: np.ndarray) -> np.ndarray:
    """[n, 16, 16] sub-block codes → [n, 2, 4, 32] (h, s, c) layout."""
    n = q.shape[0]
    return q.reshape(n, 2, 4, 2, 16).reshape(n, 2, 4, 32)


def quantize_q2_k(values: np.ndarray) -> bytes:
    """Quantize f32 values (multiple of 256) to Q2_K super-blocks.

    Simple absmax/min variant per 16-element sub-block (4-bit sc/mn vs
    per-super d/dmin, 2-bit codes). Not llama.cpp's iterative fit, but a
    valid Q2_K encoding (dequant exact w.r.t. stored bits)."""
    v = np.asarray(values, np.float32).reshape(-1, QK_K)
    n = v.shape[0]
    sub = _k2k3_subblocks(v)  # [n, 16, 16]
    smin = np.minimum(sub.min(axis=2), 0.0)
    smax = sub.max(axis=2)
    scale = (smax - smin) / 3.0
    neg_min = -smin
    d = (scale.max(axis=1) / 15.0).astype(np.float32)
    dmin = (neg_min.max(axis=1) / 15.0).astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv_d = np.where(d > 0, 1.0 / np.where(d > 0, d, 1), 0.0)
        inv_m = np.where(dmin > 0, 1.0 / np.where(dmin > 0, dmin, 1), 0.0)
    sc = np.clip(np.round(scale * inv_d[:, None]), 0, 15).astype(np.uint8)
    mn = np.clip(np.round(neg_min * inv_m[:, None]), 0, 15).astype(np.uint8)

    d16 = d.astype(np.float16)
    dmin16 = dmin.astype(np.float16)
    eff_scale = d16.astype(np.float32)[:, None] * sc
    eff_min = dmin16.astype(np.float32)[:, None] * mn
    with np.errstate(divide="ignore", invalid="ignore"):
        inv_s = np.where(eff_scale > 0,
                         1.0 / np.where(eff_scale > 0, eff_scale, 1), 0.0)
    q = np.clip(np.round((sub + eff_min[:, :, None]) * inv_s[:, :, None]),
                0, 3).astype(np.uint8)

    qe = _k2k3_elements(q)  # [n, 2, 4, 32]
    qs = (qe[:, :, 0] | (qe[:, :, 1] << 2) | (qe[:, :, 2] << 4)
          | (qe[:, :, 3] << 6)).astype(np.uint8)  # [n, 2, 32]

    out = np.empty((n, 84), np.uint8)
    out[:, 0:16] = (mn << 4) | sc
    out[:, 16:80] = qs.reshape(n, 64)
    out[:, 80:82] = d16[:, None].view(np.uint8)
    out[:, 82:84] = dmin16[:, None].view(np.uint8)
    return out.tobytes()


def quantize_q3_k(values: np.ndarray) -> bytes:
    """Quantize f32 values (multiple of 256) to Q3_K super-blocks.

    Simple absmax variant per 16-element sub-block (6-bit signed scales in
    the aux-word packing vs per-super d, 3-bit signed codes -4..3). Valid
    encoding; dequant exact w.r.t. stored bits."""
    v = np.asarray(values, np.float32).reshape(-1, QK_K)
    n = v.shape[0]
    sub = _k2k3_subblocks(v)  # [n, 16, 16]
    s = np.abs(sub).max(axis=2) / 4.0  # codes span -4..3
    d = (s.max(axis=1) / 31.0).astype(np.float16)
    ds = d.astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv_d = np.where(ds > 0, 1.0 / np.where(ds > 0, ds, 1), 0.0)
    sc6 = np.clip(np.round(s * inv_d[:, None]), -32, 31).astype(np.int8)
    eff = ds[:, None] * sc6.astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv_e = np.where(eff != 0, 1.0 / np.where(eff != 0, eff, 1), 0.0)
    q = np.clip(np.round(sub * inv_e[:, :, None]), -4, 3).astype(np.int8)

    enc = (_k2k3_elements(q).astype(np.int16) + 4).astype(np.uint8)  # 0..7
    lo = enc & 3
    hbit = enc >> 2  # [n, 2, 4, 32]
    qs = (lo[:, :, 0] | (lo[:, :, 1] << 2) | (lo[:, :, 2] << 4)
          | (lo[:, :, 3] << 6)).astype(np.uint8)  # [n, 2, 32]
    # hmask bit index = 4h + s of byte c
    hmask = np.zeros((n, 32), np.uint8)
    for h in range(2):
        for sh in range(4):
            hmask |= (hbit[:, h, sh, :] << (4 * h + sh)).astype(np.uint8)

    # inverse of the aux-word scale unpack (see dequantize_q3_k)
    u = (sc6.astype(np.int16) + 32).astype(np.uint8)  # [n, 16] 0..63
    lo4 = u & 0x0F
    hi2 = u >> 4
    aux = np.zeros((n, 3), np.uint32)
    for b in range(4):
        aux[:, 0] |= (lo4[:, b].astype(np.uint32) << (8 * b)) | (
            lo4[:, 8 + b].astype(np.uint32) << (8 * b + 4)
        )
        aux[:, 1] |= (lo4[:, 4 + b].astype(np.uint32) << (8 * b)) | (
            lo4[:, 12 + b].astype(np.uint32) << (8 * b + 4)
        )
        aux[:, 2] |= (
            (hi2[:, b].astype(np.uint32) << (8 * b))
            | (hi2[:, 4 + b].astype(np.uint32) << (8 * b + 2))
            | (hi2[:, 8 + b].astype(np.uint32) << (8 * b + 4))
            | (hi2[:, 12 + b].astype(np.uint32) << (8 * b + 6))
        )

    out = np.empty((n, 110), np.uint8)
    out[:, 0:32] = hmask
    out[:, 32:96] = qs.reshape(n, 64)
    out[:, 96:108] = aux.view(np.uint8).reshape(n, 12)
    out[:, 108:110] = d[:, None].view(np.uint8)
    return out.tobytes()
