"""Load-time repackers: GGML block streams → the port's logical arrays.

Codes are stored in plain element order (4-bit codes of Q4_K, Q4_0 and
Q4_1 two to a byte in split halves, every other kind one to a byte) and
the packed scale fields are unpacked into row-aligned integer factor
arrays plus per-super-block f32 super-scales (the K-quants at whole
super-blocks), or into f32 group scales and mins (the legacy kinds, and
the K-quants whose rows do not hold whole super-blocks), so a kernel
reads each row's codes and factors as contiguous runs.

All repackers take the raw byte stream of a row-major ``[M, K]`` tensor
(blocks run along K) and return arrays shaped ``[M, ...]``.
"""

from __future__ import annotations

import numpy as np

from .ggml import _blocks, _f16, _unpack_scale_min_k4, q5_codes


def _check(kind: str, elements: int, m: int, k: int, k_multiple: int = 1):
    """Raise unless a ``kind`` stream of ``elements`` holds ``[m, k]``
    (with k a multiple of ``k_multiple``)."""
    if elements != m * k or k % k_multiple:
        raise ValueError(f"{kind} stream of {elements} elements does not hold [{m}, {k}]"
                         + (f" with K a multiple of {k_multiple}" if k_multiple > 1 else ""))


def repack_q4_k(raw, m: int, k: int):
    """→ (codes u8 [M, K/2] split-halves-packed, scales f32 [M, K/32],
    mins f32 [M, K/32]).

    Split-halves packing: byte ``j`` of a row holds element ``j`` in its
    low nibble and element ``j + K/2`` in its high nibble (contraction
    over K is order-invariant, and the per-32-group scales stay aligned
    because K/2 is a multiple of 32).
    """
    b = _blocks(raw, 144)
    n = b.shape[0]
    if n * 256 != m * k:
        raise ValueError(f"Q4_K stream of {n} blocks does not hold [{m}, {k}]")
    d = _f16(b[:, 0:2])
    dmin = _f16(b[:, 2:4])
    sc, mn = _unpack_scale_min_k4(b[:, 4:16])
    scales = (d[:, None] * sc.astype(np.float32)).reshape(m, k // 32)
    mins = (dmin[:, None] * mn.astype(np.float32)).reshape(m, k // 32)

    qs = b[:, 16:144].reshape(n, 4, 32)
    lo = qs & 0x0F
    hi = qs >> 4
    codes = np.stack([lo, hi], axis=2).reshape(n, 256).reshape(m, k)  # element order
    half = k // 2
    packed = (codes[:, :half] | (codes[:, half:] << 4)).astype(np.uint8)
    return packed, scales, mins


def q4k_scale_factors(raw, m: int, k: int):
    """Exact native scale factorization for Q4_K: per-32-group 6-bit
    codes plus per-super-block f16 super-scales, row-aligned —
    ``(sc u8 [M, K/32], mn u8 [M, K/32], d f32 [M, K/256],
    dmin f32 [M, K/256])`` with ``scales == d.repeat(8) * sc`` and
    ``mins == dmin.repeat(8) * mn`` bit-exactly. Returns None when
    super-blocks straddle rows (k % 256 != 0)."""
    if k % 256:
        return None
    b = _blocks(raw, 144)
    if b.shape[0] * 256 != m * k:
        raise ValueError(f"Q4_K stream of {b.shape[0]} blocks does not hold [{m}, {k}]")
    d = _f16(b[:, 0:2]).astype(np.float32)
    dmin = _f16(b[:, 2:4]).astype(np.float32)
    sc, mn = _unpack_scale_min_k4(b[:, 4:16])
    return (
        sc.astype(np.uint8).reshape(m, k // 32),
        mn.astype(np.uint8).reshape(m, k // 32),
        d.reshape(m, k // 256),
        dmin.reshape(m, k // 256),
    )


def repack_q6_k(raw, m: int, k: int):
    """→ (codes i8 [M, K] values -32..31, scales f32 [M, K/16])."""
    b = _blocks(raw, 210)
    n = b.shape[0]
    if n * 256 != m * k:
        raise ValueError(f"Q6_K stream of {n} blocks does not hold [{m}, {k}]")
    ql = b[:, 0:128].reshape(n, 2, 64)
    qh = b[:, 128:192].reshape(n, 2, 32)
    sc8 = b[:, 192:208].copy().view(np.int8).astype(np.float32)
    d = _f16(b[:, 208:210])

    lo = np.stack(
        [ql[:, :, 0:32] & 0x0F, ql[:, :, 32:64] & 0x0F, ql[:, :, 0:32] >> 4, ql[:, :, 32:64] >> 4],
        axis=2,
    ).astype(np.int16)
    shifts = np.array([0, 2, 4, 6], dtype=np.uint8)
    hi = ((qh[:, :, None, :] >> shifts[None, None, :, None]) & 3).astype(np.int16)
    codes = ((lo | (hi << 4)) - 32).astype(np.int8).reshape(n, 256)
    scales = (d[:, None] * sc8).reshape(m, k // 16)
    return codes.reshape(m, k), scales


def q6k_scale_factors(raw, m: int, k: int):
    """Exact native scale factorization for Q6_K: per-16-group signed
    8-bit scale codes plus per-super-block f16 super-scales —
    ``(sc i8 [M, K/16], d f32 [M, K/256])`` with
    ``scales == d.repeat(16) * sc`` bit-exactly. None when super-blocks
    straddle rows (k % 256 != 0)."""
    if k % 256:
        return None
    b = _blocks(raw, 210)
    if b.shape[0] * 256 != m * k:
        raise ValueError(f"Q6_K stream of {b.shape[0]} blocks does not hold [{m}, {k}]")
    sc8 = b[:, 192:208].copy().view(np.int8)
    d = _f16(b[:, 208:210]).astype(np.float32)
    return sc8.reshape(m, k // 16), d.reshape(m, k // 256)


def repack_q5_k(raw, m: int, k: int):
    """→ (codes u8 [M, K] values 0..31, scales f32 [M, K/32], mins f32 [M, K/32])."""
    b = _blocks(raw, 176)
    n = b.shape[0]
    _check("Q5_K", n * 256, m, k)
    d = _f16(b[:, 0:2])
    dmin = _f16(b[:, 2:4])
    sc, mn = _unpack_scale_min_k4(b[:, 4:16])
    scales = (d[:, None] * sc.astype(np.float32)).reshape(m, k // 32)
    mins = (dmin[:, None] * mn.astype(np.float32)).reshape(m, k // 32)

    qh = b[:, 16:48]
    ql = b[:, 48:176].reshape(n, 4, 32)
    lo = ql & 0x0F
    hi = ql >> 4
    shifts = np.arange(8, dtype=np.uint8)
    hbits = (((qh[:, None, :] >> shifts[None, :, None]) & 1) << 4).astype(np.uint8)
    hbits = hbits.reshape(n, 4, 2, 32)
    codes = (np.stack([lo, hi], axis=2) | hbits).reshape(n, 256)
    return codes.reshape(m, k), scales, mins


def q5k_scale_factors(raw, m: int, k: int):
    """Native scale factorization for Q5_K — same contract as
    :func:`q4k_scale_factors` (6-bit scale/min codes + f16 super-scales,
    per-32 groups, 8 per super-block), block size 176."""
    if k % 256:
        return None
    b = _blocks(raw, 176)
    _check("Q5_K", b.shape[0] * 256, m, k)
    d = _f16(b[:, 0:2]).astype(np.float32)
    dmin = _f16(b[:, 2:4]).astype(np.float32)
    sc, mn = _unpack_scale_min_k4(b[:, 4:16])
    return (
        sc.astype(np.uint8).reshape(m, k // 32),
        mn.astype(np.uint8).reshape(m, k // 32),
        d.reshape(m, k // 256),
        dmin.reshape(m, k // 256),
    )


def q2k_scale_factors(raw, m: int, k: int):
    """Native scale factorization for Q2_K: per-16-group 4-bit scale/min
    codes (one byte each: lo nibble scale, hi nibble min) + f16
    super-scales — (sc u8, mn u8 [M, K/16], d, dmin f32 [M, K/256])."""
    if k % 256:
        return None
    b = _blocks(raw, 84)
    _check("Q2_K", b.shape[0] * 256, m, k)
    scb = b[:, 0:16]
    d = _f16(b[:, 80:82]).astype(np.float32)
    dmin = _f16(b[:, 82:84]).astype(np.float32)
    return (
        (scb & 0x0F).reshape(m, k // 16),
        (scb >> 4).reshape(m, k // 16),
        d.reshape(m, k // 256),
        dmin.reshape(m, k // 256),
    )


def repack_q8_0(raw, m: int, k: int):
    """→ (codes i8 [M, K], scales f32 [M, K/32])."""
    b = _blocks(raw, 34)
    n = b.shape[0]
    _check("Q8_0", n * 32, m, k)
    d = _f16(b[:, 0:2])
    codes = b[:, 2:34].copy().view(np.int8)
    return codes.reshape(m, k), d.reshape(m, k // 32)


def repack_q4_0(raw, m: int, k: int):
    """→ (codes u8 [M, K/2] split-halves-packed, scales f32 [M, K/32],
    mins f32 [M, K/32]).

    Q4_0 dequantizes as ``d·(nib − 8)`` — exactly the Q4_K group form
    ``s·nib − mn`` with ``mn = 8·d``, so the repack emits the same
    split-halves nibble layout as :func:`repack_q4_k` and Q4_0 takes
    the "qk" kind (0.5 B/weight of codes instead of byte codes at
    twice the bytes). Requires k % 64 == 0 (both split halves must stay 32-group-aligned);
    callers fall back to :func:`repack_q4_0_bytes` otherwise.

    Block element order is ggml's split halves (element j = lo nibble
    of byte j, j+16 = hi — see ``ggml.dequantize_q4_0``)."""
    b = _blocks(raw, 18)
    n = b.shape[0]
    _check("Q4_0", n * 32, m, k, 64)
    d = _f16(b[:, 0:2]).astype(np.float32)
    qs = b[:, 2:18]
    lo = qs & 0x0F
    hi = qs >> 4
    codes = np.concatenate([lo, hi], axis=-1).reshape(m, k)
    half = k // 2
    packed = (codes[:, :half] | (codes[:, half:] << 4)).astype(np.uint8)
    scales = d.reshape(m, k // 32)
    return packed, scales, 8.0 * scales


def repack_q4_0_bytes(raw, m: int, k: int):
    """→ (codes i8 [M, K] values -8..7, scales f32 [M, K/32]) — the
    byte-code fallback for k % 64 != 0."""
    b = _blocks(raw, 18)
    n = b.shape[0]
    _check("Q4_0", n * 32, m, k)
    d = _f16(b[:, 0:2])
    qs = b[:, 2:18]
    lo = (qs & 0x0F).astype(np.int8) - 8
    hi = (qs >> 4).astype(np.int8) - 8
    codes = np.concatenate([lo, hi], axis=-1)  # ggml split-halves order
    return codes.reshape(m, k), d.reshape(m, k // 32)


def repack_q4_1(raw, m: int, k: int):
    """→ (codes u8 [M, K/2] split-halves-packed, scales f32 [M, K/32],
    mins f32 [M, K/32]).

    Q4_1 dequantizes as ``d·nib + m`` — the Q4_K group form
    ``s·nib − mn`` with ``mn = −m``, so it takes the "qk" kind like
    Q4_0 (requires k % 64 == 0; callers fall back to
    :func:`repack_q4_1_bytes`)."""
    b = _blocks(raw, 20)
    n = b.shape[0]
    _check("Q4_1", n * 32, m, k, 64)
    d = _f16(b[:, 0:2]).astype(np.float32)
    mm = _f16(b[:, 2:4]).astype(np.float32)
    qs = b[:, 4:20]
    codes = np.concatenate([qs & 0x0F, qs >> 4], axis=-1).reshape(m, k)
    half = k // 2
    packed = (codes[:, :half] | (codes[:, half:] << 4)).astype(np.uint8)
    return packed, d.reshape(m, k // 32), -mm.reshape(m, k // 32)


def repack_q4_1_bytes(raw, m: int, k: int):
    """→ (codes u8 [M, K] values 0..15, scales, mins) — the qk_b byte
    fallback for k % 64 != 0 (``mn = −m``)."""
    b = _blocks(raw, 20)
    n = b.shape[0]
    _check("Q4_1", n * 32, m, k)
    d = _f16(b[:, 0:2]).astype(np.float32)
    mm = _f16(b[:, 2:4]).astype(np.float32)
    qs = b[:, 4:20]
    codes = np.concatenate([qs & 0x0F, qs >> 4], axis=-1).astype(np.uint8)
    return codes.reshape(m, k), d.reshape(m, k // 32), -mm.reshape(m, k // 32)


def repack_q5_0(raw, m: int, k: int):
    """→ (codes u8 [M, K] values 0..31, scales f32 [M, K/32], mins
    f32 [M, K/32]).

    Q5_0 dequantizes as ``d·(q5 − 16)`` = ``s·q − mn`` with
    ``mn = 16·d`` — the same qk_b byte form as Q5_K, group size 32."""
    b = _blocks(raw, 22)
    n = b.shape[0]
    _check("Q5_0", n * 32, m, k)
    d = _f16(b[:, 0:2]).astype(np.float32)
    codes = q5_codes(b[:, 6:22], b[:, 2:6]).reshape(m, k)
    scales = d.reshape(m, k // 32)
    return codes, scales, 16.0 * scales


def repack_q5_1(raw, m: int, k: int):
    """→ (codes u8 [M, K] values 0..31, scales, mins) — qk_b with
    ``mn = −m`` (Q5_1: ``v = d·q5 + m``)."""
    b = _blocks(raw, 24)
    n = b.shape[0]
    _check("Q5_1", n * 32, m, k)
    d = _f16(b[:, 0:2]).astype(np.float32)
    mm = _f16(b[:, 2:4]).astype(np.float32)
    codes = q5_codes(b[:, 8:24], b[:, 4:8]).reshape(m, k)
    return codes, d.reshape(m, k // 32), -mm.reshape(m, k // 32)


def repack_q3_k(raw, m: int, k: int):
    """→ (codes i8 [M, K] values -4..3, scales f32 [M, K/16]).

    Effective per-16-group scale d·(6bit−32) precomputed in f32, values
    reconstructed exactly as ``ggml.dequantize_q3_k`` does; the flat
    sub-group order 8h+2s+l//16 equals the flat element-group order, so
    the [M, K/16] scale layout is a plain reshape."""
    b = _blocks(raw, 110)
    n = b.shape[0]
    _check("Q3_K", n * 256, m, k, 16)
    hmask = b[:, 0:32]
    qs = b[:, 32:96].reshape(n, 2, 32)
    scales_raw = b[:, 96:108]
    d = _f16(b[:, 108:110])

    aux = scales_raw.copy().view("<u4")
    kmask1, kmask2 = np.uint32(0x03030303), np.uint32(0x0F0F0F0F)
    tmp = aux[:, 2].copy()
    a0 = (aux[:, 0] & kmask2) | (((tmp >> np.uint32(0)) & kmask1) << np.uint32(4))
    a1 = (aux[:, 1] & kmask2) | (((tmp >> np.uint32(2)) & kmask1) << np.uint32(4))
    a2 = ((aux[:, 0] >> np.uint32(4)) & kmask2) | (((tmp >> np.uint32(4)) & kmask1) << np.uint32(4))
    a3 = ((aux[:, 1] >> np.uint32(4)) & kmask2) | (((tmp >> np.uint32(6)) & kmask1) << np.uint32(4))
    packed = np.stack([a0, a1, a2, a3], axis=1).copy().view(np.uint8).view(np.int8)
    scales6 = packed.reshape(n, 16).astype(np.float32) - 32.0

    shifts = np.array([0, 2, 4, 6], dtype=np.uint8)
    lo = ((qs[:, :, None, :] >> shifts[None, None, :, None]) & 3).astype(np.int16)
    bitidx = (np.arange(2)[:, None] * 4 + np.arange(4)[None, :]).astype(np.uint8)
    hbit = (hmask[:, None, None, :] >> bitidx[None, :, :, None]) & 1
    codes = (lo + np.where(hbit != 0, 0, -4)).astype(np.int8).reshape(n, 256)
    scales = (d[:, None] * scales6).reshape(m, k // 16)
    return codes.reshape(m, k), scales


def q3k_scale_factors(raw, m: int, k: int):
    """Native scale factorization for Q3_K — same (sc i8 [M, K/16],
    d f32 [M, K/256]) contract as :func:`q6k_scale_factors` (signed
    6-bit scale codes, per-super-block f16 super-scale)."""
    if k % 256:
        return None
    b = _blocks(raw, 110)
    n = b.shape[0]
    _check("Q3_K", n * 256, m, k)
    aux = b[:, 96:108].copy().view("<u4")
    kmask1, kmask2 = np.uint32(0x03030303), np.uint32(0x0F0F0F0F)
    tmp = aux[:, 2].copy()
    a0 = (aux[:, 0] & kmask2) | (((tmp >> np.uint32(0)) & kmask1) << np.uint32(4))
    a1 = (aux[:, 1] & kmask2) | (((tmp >> np.uint32(2)) & kmask1) << np.uint32(4))
    a2 = ((aux[:, 0] >> np.uint32(4)) & kmask2) | (((tmp >> np.uint32(4)) & kmask1) << np.uint32(4))
    a3 = ((aux[:, 1] >> np.uint32(4)) & kmask2) | (((tmp >> np.uint32(6)) & kmask1) << np.uint32(4))
    packed = np.stack([a0, a1, a2, a3], axis=1).copy().view(np.uint8)
    sc = (packed.reshape(n, 16).astype(np.int16) - 32).astype(np.int8)
    d = _f16(b[:, 108:110]).astype(np.float32)
    return sc.reshape(m, k // 16), d.reshape(m, k // 256)


def repack_q2_k(raw, m: int, k: int):
    """→ (codes u8 [M, K] values 0..3, scales f32 [M, K/16],
    mins f32 [M, K/16]): v = scale·q − min per 16-element group
    (``ggml.dequantize_q2_k``)."""
    b = _blocks(raw, 84)
    n = b.shape[0]
    _check("Q2_K", n * 256, m, k, 16)
    sc = b[:, 0:16]
    qs = b[:, 16:80].reshape(n, 2, 32)
    d = _f16(b[:, 80:82])
    dmin = _f16(b[:, 82:84])

    shifts = np.array([0, 2, 4, 6], dtype=np.uint8)
    codes = (
        ((qs[:, :, None, :] >> shifts[None, None, :, None]) & 3)
        .astype(np.uint8)
        .reshape(n, 256)
    )
    scales = (d[:, None] * (sc & 0x0F).astype(np.float32)).reshape(m, k // 16)
    mins = (dmin[:, None] * (sc >> 4).astype(np.float32)).reshape(m, k // 16)
    return codes.reshape(m, k), scales, mins
