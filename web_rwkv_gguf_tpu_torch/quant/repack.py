"""Load-time repackers: GGML block streams → the port's logical arrays.

Codes are stored in plain element order and the packed scale fields are
unpacked into row-aligned integer factor arrays plus per-super-block f32
super-scales, so a gemv kernel reads each row's codes and factors as
contiguous runs and forms ``d·sc`` in registers.

All repackers take the raw byte stream of a row-major ``[M, K]`` tensor
(blocks run along K) and return arrays shaped ``[M, ...]``.
"""

from __future__ import annotations

import numpy as np

from .ggml import _blocks, _f16, _unpack_scale_min_k4


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
