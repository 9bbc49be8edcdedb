"""web-rwkv requantization formats: Int8 (block min/max), NF4 and SF4.

These are the engine-side weight-only quantization options applied when
loading an unquantized (F16/F32) model, mirroring the reference's
``Quant::{Int8, NF4, SF4}`` (ref: src/tensor/matrix.rs:211-271,
src/shaders/quant_mat_int8.wgsl, src/shaders/quant_mat_nf4.wgsl).

The port's own copy of the JAX package's ``quant/formats.py``, numpy
only, with the same draws and roundings; ``models/matrix.Matrix.from_f16``
turns their output into the port's arrays:
  Int8: ``codes`` uint8, ``mn``/``mx`` float per 128-element block.
  NF4/SF4: ``codes`` uint8 (two 4-bit codes per byte, low nibble = even
  element), ``absmax`` float per 64-element block, ``lut`` the 16-entry
  codebook.
"""

from __future__ import annotations

import enum
import functools
import math

import numpy as np

INT8_BLOCK_SIZE = 128  # ref: src/tensor/ops.rs:292
NF4_BLOCK_SIZE = 64  # ref: src/tensor/ops.rs:291

# normal-distribution 4-bit codebook (ref: src/tensor/matrix.rs:50-67)
NF4_QUANTILES = np.array(
    [
        -1.0,
        -0.6961928009986877,
        -0.5250730514526367,
        -0.39491748809814453,
        -0.28444138169288635,
        -0.18477343022823334,
        -0.09105003625154495,
        0.0,
        0.07958029955625534,
        0.16093020141124725,
        0.24611230194568634,
        0.33791524171829224,
        0.44070982933044434,
        0.5626170039176941,
        0.7229568362236023,
        1.0,
    ],
    dtype=np.float32,
)


class QuantScheme(enum.Enum):
    """Engine requantization options (ref: src/runtime/model.rs Quant enum)."""

    NONE = "none"
    INT8 = "int8"
    NF4 = "nf4"
    SF4 = "sf4"


def _student_t_inverse_cdf(p: np.ndarray, nu: float) -> np.ndarray:
    """Inverse CDF of Student's t via the incomplete-beta inverse.

    Small-n bisection implementation (no scipy dependency); accurate to
    ~1e-10 which is far below f32 resolution.
    """

    def cdf(x):
        # CDF via regularized incomplete beta: slow but exact enough
        from math import lgamma

        def betainc_reg(a, b, z, terms=200):
            # continued fraction (Lentz) for I_z(a,b)
            if z <= 0:
                return 0.0
            if z >= 1:
                return 1.0
            lbeta = lgamma(a) + lgamma(b) - lgamma(a + b)
            front = math.exp(a * math.log(z) + b * math.log(1 - z) - math.log(a) - lbeta)
            f, c, d = 1.0, 1.0, 0.0
            for i in range(terms):
                m = i // 2
                if i == 0:
                    num = 1.0
                elif i % 2 == 0:
                    num = (m * (b - m) * z) / ((a + 2 * m - 1) * (a + 2 * m))
                else:
                    num = -((a + m) * (a + b + m) * z) / ((a + 2 * m) * (a + 2 * m + 1))
                d = 1.0 + num * d
                d = 1.0 / (d if abs(d) > 1e-300 else 1e-300)
                c = 1.0 + num / (c if abs(c) > 1e-300 else 1e-300)
                f *= c * d
                if abs(1.0 - c * d) < 1e-15:
                    break
            if z < (a + 1) / (a + b + 2):
                return front * (f - 1.0)
            return 1.0 - betainc_reg(b, a, 1.0 - z)

        ib = betainc_reg(nu / 2.0, 0.5, nu / (nu + x * x))
        return 1.0 - 0.5 * ib if x >= 0 else 0.5 * ib

    out = np.empty_like(p, dtype=np.float64)
    for i, pi in enumerate(np.atleast_1d(p)):
        lo, hi = -1e3, 1e3
        for _ in range(200):
            mid = 0.5 * (lo + hi)
            if cdf(mid) < pi:
                lo = mid
            else:
                hi = mid
        out[i] = 0.5 * (lo + hi)
    return out


def sf4_quantiles(nu: float = 5.0) -> np.ndarray:
    """Student's-t 4-bit codebook (ref: src/tensor/matrix.rs:29-44). The
    bisection is pure Python (about a second), so each ``nu``'s codebook
    is computed once; every call returns a fresh copy."""
    return _sf4_quantiles(float(nu)).copy()


@functools.cache
def _sf4_quantiles(nu: float) -> np.ndarray:
    delta = (1.0 / 32.0 + 1.0 / 30.0) / 2.0
    probs = []
    step = (0.5 - delta) / 7.0
    probs.extend(delta + step * i for i in range(7))
    step = (1.0 - delta - 0.5) / 8.0
    probs.extend(0.5 + step * i for i in range(9))
    quant = _student_t_inverse_cdf(np.array(probs), nu)
    return (quant / quant.max()).astype(np.float32)


def quantize_int8(w: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Quantize flat-major matrix values to u8 codes with per-128 block min/max.

    Follows the shader formula ``u8 = round(saturate((v-min)/(max-min))*255)``
    (ref: src/shaders/quant_mat_int8.wgsl:55-58); min/max are stored as f16
    like the reference's ``m`` tensor.
    """
    flat = np.asarray(w, np.float32).reshape(-1)
    pad = (-flat.size) % INT8_BLOCK_SIZE
    if pad:
        flat = np.concatenate([flat, np.zeros(pad, np.float32)])
    blocks = flat.reshape(-1, INT8_BLOCK_SIZE)
    mn = blocks.min(axis=1).astype(np.float16)
    mx = blocks.max(axis=1).astype(np.float16)
    rng = mx.astype(np.float32) - mn.astype(np.float32)
    rng = np.where(rng == 0, 1.0, rng)
    x = np.clip((blocks - mn.astype(np.float32)[:, None]) / rng[:, None], 0.0, 1.0)
    codes = np.floor(x * 255.0 + 0.5).astype(np.uint8)
    return codes.reshape(-1)[: w.size].reshape(w.shape), mn, mx


def dequantize_int8(codes: np.ndarray, mn: np.ndarray, mx: np.ndarray) -> np.ndarray:
    """Inverse of :func:`quantize_int8` (values only, not bit-exact to input)."""
    flat = codes.reshape(-1).astype(np.float32) / 255.0
    pad = (-flat.size) % INT8_BLOCK_SIZE
    if pad:
        flat = np.concatenate([flat, np.zeros(pad, np.float32)])
    blocks = flat.reshape(-1, INT8_BLOCK_SIZE)
    lo = mn.astype(np.float32)[:, None]
    hi = mx.astype(np.float32)[:, None]
    out = lo + blocks * (hi - lo)
    return out.reshape(-1)[: codes.size].reshape(codes.shape)


def quantize_nf4(
    w: np.ndarray, lut: np.ndarray | None = None
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Quantize to 4-bit codebook indices with per-64 block absmax.

    Returns ``(packed, absmax, lut)`` where ``packed`` holds two codes per
    byte, low nibble = even element (ref nibble order,
    src/shaders/matmul_vec_nf4.wgsl:52-79).
    """
    lut = NF4_QUANTILES if lut is None else np.asarray(lut, np.float32)
    flat = np.asarray(w, np.float32).reshape(-1)
    pad = (-flat.size) % NF4_BLOCK_SIZE
    if pad:
        flat = np.concatenate([flat, np.zeros(pad, np.float32)])
    blocks = flat.reshape(-1, NF4_BLOCK_SIZE)
    absmax = np.abs(blocks).max(axis=1).astype(np.float16)
    scale = absmax.astype(np.float32)
    scale = np.where(scale == 0, 1.0, scale)
    x = blocks / scale[:, None]
    idx = np.abs(x[..., None] - lut[None, None, :]).argmin(axis=-1).astype(np.uint8)
    pairs = idx.reshape(-1, 2)
    packed = (pairs[:, 0] | (pairs[:, 1] << 4)).astype(np.uint8)
    return packed, absmax, lut


def dequantize_nf4(packed: np.ndarray, absmax: np.ndarray, lut: np.ndarray) -> np.ndarray:
    """Expand packed NF4 codes back to float32 values."""
    lo = lut[(packed & 0x0F).astype(np.int32)]
    hi = lut[(packed >> 4).astype(np.int32)]
    vals = np.stack([lo, hi], axis=-1).reshape(-1, NF4_BLOCK_SIZE)
    return (vals * absmax.astype(np.float32)[:, None]).reshape(-1)


def matrix_statistics(values: np.ndarray) -> dict:
    """Quantile summary of a weight matrix: min, q_005, q_25, q_50, q_75,
    q_995, max (ref: src/tensor/matrix.rs:274-297 MatrixStatistics)."""
    v = np.sort(np.asarray(values, np.float32).reshape(-1))
    n = len(v) - 1
    idx = {
        "min": 0,
        "q_005": int(n * 0.005),
        "q_25": n // 2 // 2,
        "q_50": n // 2,
        "q_75": (n // 2 + n) // 2,
        "q_995": int(n * 0.995),
        "max": n,
    }
    return {k: float(v[i]) for k, i in idx.items()}
