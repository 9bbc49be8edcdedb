"""Quantized matmul kernels and their plain PyTorch versions.

Each computes ``y[n, m] = Σ_k x[n, k]·W[m, k]`` with W held as the
loader's logical arrays of one quantized form (``models/matrix.py``) and
returns f32 ``[n, m]``; x is rounded to bf16 first, as the model's
quantized matmul defines it. The forms, by the kernels that take them:

- ``q4k_*``: Q4_K native factors (split-halves nibbles, 6-bit scale and
  min codes per 32, f32 super-scales per 256);
- ``q6k_*``: Q6_K and Q3_K native factors (i8 codes, i8 scale codes per
  16, f32 super-scales);
- ``qkb_*``: Q5_K and Q2_K native factors (u8 byte codes, u8 scale and
  min codes per 32 or 16, f32 super-scales);
- ``qs_*``: f32 group scales (and optional offsets) over split-halves
  nibbles, u8 or i8 bytes: Q8_0, the legacy Q4_0/Q4_1/Q5_0/Q5_1,
  K-quant rows that do not hold whole 256-element super-blocks, and the
  engine's Int8 requantization (u8 codes in groups of 128);
- ``nf4_*``: the engine's NF4 / SF4 requantization (4-bit codebook
  indices in pair order, f32 absmax per 64, a 16-entry f32 codebook);
- ``quant_gemv_grouped``: three same-shape matrices of the kinds ``qk``,
  ``qk_b``, ``qk_nomin`` or ``int8`` (each its own codes, f32 group scale
  products and signed offsets formed at unroll time) against three
  inputs of their own, in one launch: the r, k and v projections of an
  RWKV-7 decode step at batch 1.

Two numerics classes, as in the JAX package's ``quant_matmul``
(``models/matrix.py`` picks between them):

- the gemvs (n ≤ 8) compute with the exact f32 weight ``q·s − mn``
  (NF4: ``bf16(lut[idx])·absmax``, exact in f32, as the JAX kernel rounds
  its codebook values to bf16 and scales its group sums):
  ``csrc/qkb_gemv.cu``, ``csrc/qs_gemv.cu`` and ``csrc/nf4_gemv.cu``
  (``qgemv.cuh``: rows of lanes on the CUDA cores) form it per element;
  ``csrc/q4k_gemv.cu`` and ``csrc/q6k_gemv.cu`` (``qgemv_mma.cuh``) and
  ``csrc/gemv_grouped.cu`` take the JAX kernel's factored form
  ``s·Σq·x − mn·Σx`` per group, the first two with each group's exact
  code products on the tensor cores (one ``mma.sync`` m16n8k16 per
  16 codes, from a zero accumulator) and the scales applied in f32;
- the dequant-GEMMs (``csrc/qk_gemm.cu``: weights decoded to bf16 in
  shared memory beside ``wgmma``; rows of lanes on the CUDA cores at
  n ≤ 8 where M/64 tiles would leave SMs idle) multiply by
  ``bf16(q·s)`` (NF4: ``bf16(lut[idx]·absmax)``) with f32 accumulation
  and subtract the offset term in f32 as ``Σ_g mn[m, g]·xs[n, g]``, xs
  the f32 group sums of the bf16-rounded x.

On a CUDA tensor each wrapper launches its kernel or raises; only a
tensor on the CPU takes the plain version, which computes the same
function (the gemvs' plain versions have no limit on n).
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from . import build

MAX_GEMV_ROWS = 8  # input rows (batch lanes) one kernel launch takes
_MAX_SMEM = 232448  # bytes of shared memory a block may use (x is staged there)


def q4k_codes(codes) -> torch.Tensor:
    """The f32 4-bit codes ``[M, K]`` of split-halves Q4_K code bytes."""
    return torch.cat([codes & 0x0F, codes >> 4], dim=1).float()


def q4k_scale_products(sc6, mn6, d8, dm8):
    """f32 group scales ``d·sc`` and offsets ``dmin·mn`` ``[M, G]`` of
    native factors (Q4_K: G = K/32; Q5_K and Q2_K the same way, G = K/32
    or K/16), each super-scale repeated over its ``G / (K/256)`` groups."""
    reps = sc6.shape[-1] // d8.shape[-1]
    return (d8.repeat_interleave(reps, dim=-1) * sc6.float(),
            dm8.repeat_interleave(reps, dim=-1) * mn6.float())


def q4k_dequantize(codes, sc6, mn6, d8, dm8) -> torch.Tensor:
    """Dense f32 ``[M, K]`` weight of a Q4_K matrix (split-halves codes)."""
    return qs_dequantize(codes, *q4k_scale_products(sc6, mn6, d8, dm8), k=2 * codes.shape[-1])


def q6k_scale_products(q6s, q6d):
    """f32 group scales ``d·sc`` ``[M, G]`` of Q6_K / Q3_K factors."""
    return q6d.repeat_interleave(q6s.shape[-1] // q6d.shape[-1], dim=-1) * q6s.float()


def q6k_dequantize(codes, q6s, q6d) -> torch.Tensor:
    """Dense f32 ``[M, K]`` weight of a Q6_K / Q3_K matrix."""
    return qs_dequantize(codes, q6k_scale_products(q6s, q6d))


def qs_codes(codes, k: int) -> torch.Tensor:
    """The f32 codes ``[M, K]`` of split-halves nibbles (``codes`` of K/2
    bytes a row) or of u8 / i8 bytes (K a row)."""
    return q4k_codes(codes) if codes.shape[-1] * 2 == k else codes.float()


def qs_dequantize(codes, scales, mins=None, k=None) -> torch.Tensor:
    """Dense f32 ``[M, K]`` weight ``q·s − mn`` of codes (nibbles or
    bytes; K given, or bytes assumed) and f32 group scales and offsets
    ``[M, G]``."""
    m = codes.shape[0]
    k = k or codes.shape[-1]
    g = scales.shape[-1]
    w = qs_codes(codes, k).view(m, g, k // g) * scales[..., None]
    if mins is not None:
        w = w - mins[..., None]
    return w.view(m, k)


def qkb_dequantize(codes, sc6, mn6, d8, dm8) -> torch.Tensor:
    """Dense f32 ``[M, K]`` weight of a Q5_K / Q2_K matrix (byte codes)."""
    return qs_dequantize(codes, *q4k_scale_products(sc6, mn6, d8, dm8))


def nf4_dequantize(codes, absmax, lut) -> torch.Tensor:
    """Dense f32 ``[M, K]`` weight ``lut[idx]·absmax`` of an NF4 / SF4
    matrix: pair-order nibbles (low nibble of byte j is element 2j, high
    nibble element 2j + 1), absmax per 64 elements."""
    idx = torch.stack([codes & 0x0F, codes >> 4], dim=-1).flatten(-2).long()
    v = lut.float()[idx]
    m, k = v.shape
    g = absmax.shape[-1]
    return (v.view(m, g, k // g) * absmax[..., None]).view(m, k)


def q4k_gemv_plain(x, codes, sc6, mn6, d8, dm8) -> torch.Tensor:
    """Plain version of :func:`q4k_gemv`."""
    w = q4k_dequantize(codes, sc6, mn6, d8, dm8)
    return x.to(torch.bfloat16).float() @ w.T


def q6k_gemv_plain(x, codes, q6s, q6d) -> torch.Tensor:
    """Plain version of :func:`q6k_gemv`."""
    w = q6k_dequantize(codes, q6s, q6d)
    return x.to(torch.bfloat16).float() @ w.T


def qkb_gemv_plain(x, codes, sc6, mn6, d8, dm8) -> torch.Tensor:
    """Plain version of :func:`qkb_gemv`."""
    return x.to(torch.bfloat16).float() @ qkb_dequantize(codes, sc6, mn6, d8, dm8).T


def qs_gemv_plain(x, codes, scales, mins=None) -> torch.Tensor:
    """Plain version of :func:`qs_gemv`."""
    w = qs_dequantize(codes, scales, mins, k=x.shape[-1])
    return x.to(torch.bfloat16).float() @ w.T


def nf4_gemv_plain(x, codes, absmax, lut) -> torch.Tensor:
    """Plain version of :func:`nf4_gemv`: the codebook rounded to bf16,
    times absmax (exact in f32: 8 by 11 significant bits)."""
    w = nf4_dequantize(codes, absmax, lut.to(torch.bfloat16).float())
    return x.to(torch.bfloat16).float() @ w.T


def slab_matmul_plain(x, q, scales, offsets=None) -> torch.Tensor:
    """The dequant-GEMM's function over f32 codes ``q`` ``[M, K]`` and f32
    group scales (and offsets) ``[M, G]``: ``bf16(x) @ bf16(q·s)ᵀ`` minus
    ``Σ_g off[m, g]·Σ_{k∈g} bf16(x)[n, k]`` where there are offsets, in
    f32, each weight's offset subtracted before the sum: on same-signed
    inputs (relu², the FFN value's) the two sums are each 15-27 times
    max|y|, and their difference would carry their rounding into y."""
    m, k = q.shape
    g = scales.shape[-1]
    w = (q.view(m, g, k // g) * scales[..., None]).to(torch.bfloat16).float()
    if offsets is not None:
        w = w - offsets[..., None]
    return x.to(torch.bfloat16).float() @ w.view(m, k).T


def q4k_gemm_plain(x, codes, sc6, mn6, d8, dm8) -> torch.Tensor:
    """Plain version of :func:`q4k_gemm`."""
    return slab_matmul_plain(x, q4k_codes(codes), *q4k_scale_products(sc6, mn6, d8, dm8))


def q6k_gemm_plain(x, codes, q6s, q6d) -> torch.Tensor:
    """Plain version of :func:`q6k_gemm`."""
    return slab_matmul_plain(x, codes.float(), q6k_scale_products(q6s, q6d))


def qkb_gemm_plain(x, codes, sc6, mn6, d8, dm8) -> torch.Tensor:
    """Plain version of :func:`qkb_gemm`."""
    return slab_matmul_plain(x, codes.float(), *q4k_scale_products(sc6, mn6, d8, dm8))


def qs_gemm_plain(x, codes, scales, mins=None) -> torch.Tensor:
    """Plain version of :func:`qs_gemm`."""
    return slab_matmul_plain(x, qs_codes(codes, x.shape[-1]), scales, mins)


def nf4_gemm_plain(x, codes, absmax, lut) -> torch.Tensor:
    """Plain version of :func:`nf4_gemm`: ``bf16(x) @ bf16(lut[idx]·absmax)ᵀ``
    in f32, the codebook value and absmax multiplied in f32 first."""
    w = nf4_dequantize(codes, absmax, lut).to(torch.bfloat16).float()
    return x.to(torch.bfloat16).float() @ w.T


def _check(name, x, arrays: dict, shapes: dict, dtypes: dict, max_rows=None, k_multiple=256):
    """Validate what the kernel takes (K a multiple of ``k_multiple``);
    returns x rounded to bf16, contiguous and 16-byte aligned."""
    if x.dim() != 2:
        raise ValueError(f"{name}: x must be [n, K], got {tuple(x.shape)}")
    n, k = x.shape
    if n < 1 or (max_rows is not None and n > max_rows):
        raise ValueError(f"{name}: the kernel takes 1..{max_rows or 'any'} "
                         f"input rows, got {n}")
    if k % k_multiple:
        raise ValueError(f"{name}: K must be a multiple of {k_multiple}, got {k}")
    if max_rows is not None and n * k * 4 > _MAX_SMEM:
        raise ValueError(f"{name}: x of [{n}, {k}] does not fit shared memory")
    xb = x.to(torch.bfloat16).contiguous()
    if xb.data_ptr() % 16:
        xb = xb.clone()
    for key, a in {"x": xb, **arrays}.items():
        if a.device != x.device:
            raise ValueError(f"{name}: {key} on {a.device}, x on {x.device}")
        if not a.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    for key, a in arrays.items():
        want = dtypes[key] if isinstance(dtypes[key], tuple) else (dtypes[key],)
        if tuple(a.shape) != shapes[key] or a.dtype not in want:
            raise ValueError(
                f"{name}: {key} must be {' or '.join(map(str, want))} {shapes[key]}, got "
                f"{a.dtype} {tuple(a.shape)}")
    if arrays["codes"].data_ptr() % 16:
        raise ValueError(f"{name}: codes must be 16-byte aligned")
    return xb


@functools.cache
def _q4k_fn():
    fn = build.load("q4k_gemv").q4k_gemv
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _q6k_fn():
    fn = build.load("q6k_gemv").q6k_gemv
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def q4k_gemv(x, codes, sc6, mn6, d8, dm8) -> torch.Tensor:
    """Q4_K gemv: x ``[n, K]``; codes u8 ``[M, K/2]``; sc6, mn6 u8
    ``[M, K/32]``; d8, dm8 f32 ``[M, K/256]`` → f32 ``[n, M]``."""
    if not x.is_cuda:
        return q4k_gemv_plain(x, codes, sc6, mn6, d8, dm8)
    m = codes.shape[0]
    k = x.shape[-1]
    arrays = {"codes": codes, "sc6": sc6, "mn6": mn6, "d8": d8, "dm8": dm8}
    xb = _check("q4k_gemv", x, arrays,
                {"codes": (m, k // 2), "sc6": (m, k // 32), "mn6": (m, k // 32),
                 "d8": (m, k // 256), "dm8": (m, k // 256)},
                {"codes": torch.uint8, "sc6": torch.uint8, "mn6": torch.uint8,
                 "d8": torch.float32, "dm8": torch.float32}, MAX_GEMV_ROWS)
    if sc6.data_ptr() % 4 or mn6.data_ptr() % 4:
        raise ValueError("q4k_gemv: sc6 and mn6 must be 4-byte aligned")
    n = x.shape[0]
    y = torch.empty(n, m, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _q4k_fn()(xb.data_ptr(), codes.data_ptr(), sc6.data_ptr(),
                        mn6.data_ptr(), d8.data_ptr(), dm8.data_ptr(),
                        y.data_ptr(), n, m, k, stream)
    q4k_gemv.launches += 1
    q4k_gemv.shapes[(n, m, k)] += 1
    if err:
        raise RuntimeError(f"q4k_gemv launch failed: CUDA error {err}")
    return y


q4k_gemv.launches = 0
q4k_gemv.shapes = collections.Counter()  # launches by (n, M, K)


def q6k_gemv(x, codes, q6s, q6d) -> torch.Tensor:
    """Q6_K gemv: x ``[n, K]``; codes i8 ``[M, K]`` (Q6_K −32..31, Q3_K
    −4..3); q6s i8 ``[M, K/16]``; q6d f32 ``[M, K/256]`` → f32 ``[n, M]``."""
    if not x.is_cuda:
        return q6k_gemv_plain(x, codes, q6s, q6d)
    m = codes.shape[0]
    k = x.shape[-1]
    arrays = {"codes": codes, "q6s": q6s, "q6d": q6d}
    xb = _check("q6k_gemv", x, arrays,
                {"codes": (m, k), "q6s": (m, k // 16), "q6d": (m, k // 256)},
                {"codes": torch.int8, "q6s": torch.int8, "q6d": torch.float32},
                MAX_GEMV_ROWS)
    if q6s.data_ptr() % 8:
        raise ValueError("q6k_gemv: q6s must be 8-byte aligned")
    n = x.shape[0]
    y = torch.empty(n, m, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _q6k_fn()(xb.data_ptr(), codes.data_ptr(), q6s.data_ptr(),
                        q6d.data_ptr(), y.data_ptr(), n, m, k, stream)
    q6k_gemv.launches += 1
    q6k_gemv.shapes[(n, m, k)] += 1
    if err:
        raise RuntimeError(f"q6k_gemv launch failed: CUDA error {err}")
    return y


q6k_gemv.launches = 0
q6k_gemv.shapes = collections.Counter()  # launches by (n, M, K)


@functools.cache
def _gemm_fn(kind: str):
    fn = getattr(build.load("qk_gemm"), f"{kind}_gemm")
    n_ptrs = 7 if kind == "q4k" else 5
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch_gemm(wrapper, kind, xb, arrays, m, k):
    n = xb.shape[0]
    y = torch.empty(n, m, dtype=torch.float32, device=xb.device)
    with torch.cuda.device(xb.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _gemm_fn(kind)(xb.data_ptr(), *(a.data_ptr() for a in arrays),
                             y.data_ptr(), n, m, k, stream)
    wrapper.launches += 1
    wrapper.shapes[(n, m, k)] += 1
    if err:
        raise RuntimeError(f"{kind}_gemm launch failed: CUDA error {err}")
    return y


def q4k_gemm(x, codes, sc6, mn6, d8, dm8) -> torch.Tensor:
    """Q4_K dequant-GEMM at any row count: x ``[n, K]``; the arrays as for
    :func:`q4k_gemv` → f32 ``[n, M]`` in the bf16-weight class."""
    if not x.is_cuda:
        return q4k_gemm_plain(x, codes, sc6, mn6, d8, dm8)
    m = codes.shape[0]
    k = x.shape[-1]
    arrays = {"codes": codes, "sc6": sc6, "mn6": mn6, "d8": d8, "dm8": dm8}
    xb = _check("q4k_gemm", x, arrays,
                {"codes": (m, k // 2), "sc6": (m, k // 32), "mn6": (m, k // 32),
                 "d8": (m, k // 256), "dm8": (m, k // 256)},
                {"codes": torch.uint8, "sc6": torch.uint8, "mn6": torch.uint8,
                 "d8": torch.float32, "dm8": torch.float32})
    return _launch_gemm(q4k_gemm, "q4k", xb, arrays.values(), m, k)


q4k_gemm.launches = 0
q4k_gemm.shapes = collections.Counter()  # launches by (n, M, K)


def q6k_gemm(x, codes, q6s, q6d) -> torch.Tensor:
    """Q6_K dequant-GEMM at any row count: x ``[n, K]``; the arrays as for
    :func:`q6k_gemv` → f32 ``[n, M]`` in the bf16-weight class."""
    if not x.is_cuda:
        return q6k_gemm_plain(x, codes, q6s, q6d)
    m = codes.shape[0]
    k = x.shape[-1]
    arrays = {"codes": codes, "q6s": q6s, "q6d": q6d}
    xb = _check("q6k_gemm", x, arrays,
                {"codes": (m, k), "q6s": (m, k // 16), "q6d": (m, k // 256)},
                {"codes": torch.int8, "q6s": torch.int8, "q6d": torch.float32})
    return _launch_gemm(q6k_gemm, "q6k", xb, arrays.values(), m, k)


q6k_gemm.launches = 0
q6k_gemm.shapes = collections.Counter()  # launches by (n, M, K)


# code storage of the f32-scale kernels (csrc/qs_gemv.cu, csrc/qk_gemm.cu)
_CODE_KIND = {"nibbles": 0, torch.uint8: 1, torch.int8: 2}


def _qs_form(name, x, codes, scales, mins, max_rows=None):
    """Check the f32-scale operands; returns (bf16 x, group size, code
    kind)."""
    m, k = codes.shape[0], x.shape[-1]
    nib = codes.shape[-1] * 2 == k
    g = scales.shape[-1]
    gs = k // g if g else 0
    if gs not in (16, 32, 128) or g * gs != k or (nib and (gs != 32 or codes.dtype != torch.uint8)):
        raise ValueError(f"{name}: groups of 16, 32 or 128 elements (32 for nibbles) over "
                         f"K={k}, got scales {tuple(scales.shape)}, codes {codes.dtype} "
                         f"{tuple(codes.shape)}")
    arrays = {"codes": codes, "scales": scales}
    shapes = {"codes": (m, k // 2 if nib else k), "scales": (m, g), "mins": (m, g)}
    dtypes = {"codes": (torch.uint8, torch.int8), "scales": torch.float32,
              "mins": torch.float32}
    if mins is not None:
        arrays["mins"] = mins
    xb = _check(name, x, arrays, shapes, dtypes, max_rows, k_multiple=64 if nib else 32)
    return xb, gs, _CODE_KIND["nibbles" if nib else codes.dtype]


@functools.cache
def _qs_fn(op: str):
    fn = getattr(build.load("qs_gemv" if op == "gemv" else "qk_gemm"), f"qs_{op}")
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch_qs(wrapper, op, xb, codes, scales, mins, m, gs, kind):
    n, k = xb.shape
    y = torch.empty(n, m, dtype=torch.float32, device=xb.device)
    with torch.cuda.device(xb.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _qs_fn(op)(xb.data_ptr(), codes.data_ptr(), scales.data_ptr(),
                         0 if mins is None else mins.data_ptr(), y.data_ptr(),
                         n, m, k, gs, kind, stream)
    wrapper.launches += 1
    wrapper.shapes[(n, m, k)] += 1
    if err:
        raise RuntimeError(f"qs_{op} launch failed: CUDA error {err}")
    return y


def qs_gemv(x, codes, scales, mins=None) -> torch.Tensor:
    """Gemv over f32 group scales: x ``[n, K]`` (n ≤ 8); codes u8 ``[M,
    K/2]`` split-halves nibbles, or u8 / i8 ``[M, K]`` bytes; scales and
    the optional mins f32 ``[M, G]`` (groups of 16, 32 or 128; 32 for
    nibbles) → f32 ``[n, M]`` = x·Wᵀ with W = q·s − mn, the exact f32
    weight."""
    if not x.is_cuda:
        return qs_gemv_plain(x, codes, scales, mins)
    xb, gs, kind = _qs_form("qs_gemv", x, codes, scales, mins, MAX_GEMV_ROWS)
    return _launch_qs(qs_gemv, "gemv", xb, codes, scales, mins, codes.shape[0], gs, kind)


qs_gemv.launches = 0
qs_gemv.shapes = collections.Counter()  # launches by (n, M, K)


def qs_gemm(x, codes, scales, mins=None) -> torch.Tensor:
    """Dequant-GEMM over f32 group scales at any row count; the arrays as
    for :func:`qs_gemv` → f32 ``[n, M]`` in the bf16-weight class."""
    if not x.is_cuda:
        return qs_gemm_plain(x, codes, scales, mins)
    xb, gs, kind = _qs_form("qs_gemm", x, codes, scales, mins)
    return _launch_qs(qs_gemm, "gemm", xb, codes, scales, mins, codes.shape[0], gs, kind)


qs_gemm.launches = 0
qs_gemm.shapes = collections.Counter()  # launches by (n, M, K)


def _qkb_check(name, x, codes, sc6, mn6, d8, dm8, max_rows=None):
    """Check the Q5_K / Q2_K operands; returns (bf16 x, group size)."""
    m, k = codes.shape[0], x.shape[-1]
    g = sc6.shape[-1]
    gs = k // g if g else 0
    if gs not in (16, 32) or g * gs != k:
        raise ValueError(f"{name}: groups of 16 or 32 elements over K={k}, got sc6 "
                         f"{tuple(sc6.shape)}")
    arrays = {"codes": codes, "sc6": sc6, "mn6": mn6, "d8": d8, "dm8": dm8}
    xb = _check(name, x, arrays,
                {"codes": (m, k), "sc6": (m, g), "mn6": (m, g), "d8": (m, k // 256),
                 "dm8": (m, k // 256)},
                {"codes": torch.uint8, "sc6": torch.uint8, "mn6": torch.uint8,
                 "d8": torch.float32, "dm8": torch.float32}, max_rows)
    return xb, gs


@functools.cache
def _qkb_fn(op: str):
    fn = getattr(build.load("qkb_gemv" if op == "gemv" else "qk_gemm"), f"qkb_{op}")
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch_qkb(wrapper, op, xb, arrays, gs):
    n, k = xb.shape
    m = arrays[0].shape[0]
    y = torch.empty(n, m, dtype=torch.float32, device=xb.device)
    with torch.cuda.device(xb.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _qkb_fn(op)(xb.data_ptr(), *(a.data_ptr() for a in arrays), y.data_ptr(),
                          n, m, k, gs, stream)
    wrapper.launches += 1
    wrapper.shapes[(n, m, k)] += 1
    if err:
        raise RuntimeError(f"qkb_{op} launch failed: CUDA error {err}")
    return y


def qkb_gemv(x, codes, sc6, mn6, d8, dm8) -> torch.Tensor:
    """Q5_K / Q2_K gemv: x ``[n, K]`` (n ≤ 8); codes u8 ``[M, K]``; sc6,
    mn6 u8 ``[M, G]`` (G = K/32 for Q5_K, K/16 for Q2_K); d8, dm8 f32
    ``[M, K/256]`` → f32 ``[n, M]`` on the exact f32 weight."""
    if not x.is_cuda:
        return qkb_gemv_plain(x, codes, sc6, mn6, d8, dm8)
    xb, gs = _qkb_check("qkb_gemv", x, codes, sc6, mn6, d8, dm8, MAX_GEMV_ROWS)
    return _launch_qkb(qkb_gemv, "gemv", xb, (codes, sc6, mn6, d8, dm8), gs)


qkb_gemv.launches = 0
qkb_gemv.shapes = collections.Counter()  # launches by (n, M, K)


def qkb_gemm(x, codes, sc6, mn6, d8, dm8) -> torch.Tensor:
    """Q5_K / Q2_K dequant-GEMM at any row count; the arrays as for
    :func:`qkb_gemv` → f32 ``[n, M]`` in the bf16-weight class."""
    if not x.is_cuda:
        return qkb_gemm_plain(x, codes, sc6, mn6, d8, dm8)
    xb, gs = _qkb_check("qkb_gemm", x, codes, sc6, mn6, d8, dm8)
    return _launch_qkb(qkb_gemm, "gemm", xb, (codes, sc6, mn6, d8, dm8), gs)


qkb_gemm.launches = 0
qkb_gemm.shapes = collections.Counter()  # launches by (n, M, K)


def _nf4_check(name, x, codes, absmax, lut, max_rows=None):
    m, k = codes.shape[0], x.shape[-1]
    return _check(name, x, {"codes": codes, "absmax": absmax, "lut": lut},
                  {"codes": (m, k // 2), "absmax": (m, k // 64), "lut": (16,)},
                  {"codes": torch.uint8, "absmax": torch.float32, "lut": torch.float32},
                  max_rows, k_multiple=64)


@functools.cache
def _nf4_fn(op: str):
    fn = getattr(build.load("nf4_gemv" if op == "gemv" else "qk_gemm"), f"nf4_{op}")
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch_nf4(wrapper, op, xb, codes, absmax, lut):
    n, k = xb.shape
    m = codes.shape[0]
    y = torch.empty(n, m, dtype=torch.float32, device=xb.device)
    with torch.cuda.device(xb.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _nf4_fn(op)(xb.data_ptr(), codes.data_ptr(), absmax.data_ptr(), lut.data_ptr(),
                          y.data_ptr(), n, m, k, stream)
    wrapper.launches += 1
    wrapper.shapes[(n, m, k)] += 1
    if err:
        raise RuntimeError(f"nf4_{op} launch failed: CUDA error {err}")
    return y


def nf4_gemv(x, codes, absmax, lut) -> torch.Tensor:
    """NF4 / SF4 gemv: x ``[n, K]`` (n ≤ 8); codes u8 ``[M, K/2]`` in pair
    order; absmax f32 ``[M, K/64]``; lut f32 ``[16]`` → f32 ``[n, M]`` =
    x·Wᵀ with W = bf16(lut[idx])·absmax, exact in f32."""
    if not x.is_cuda:
        return nf4_gemv_plain(x, codes, absmax, lut)
    xb = _nf4_check("nf4_gemv", x, codes, absmax, lut, MAX_GEMV_ROWS)
    return _launch_nf4(nf4_gemv, "gemv", xb, codes, absmax, lut)


nf4_gemv.launches = 0
nf4_gemv.shapes = collections.Counter()  # launches by (n, M, K)


def nf4_gemm(x, codes, absmax, lut) -> torch.Tensor:
    """NF4 / SF4 dequant-GEMM at any row count; the arrays as for
    :func:`nf4_gemv` → f32 ``[n, M]`` in the bf16-weight class, W =
    bf16(lut[idx]·absmax)."""
    if not x.is_cuda:
        return nf4_gemm_plain(x, codes, absmax, lut)
    xb = _nf4_check("nf4_gemm", x, codes, absmax, lut)
    return _launch_nf4(nf4_gemm, "gemm", xb, codes, absmax, lut)


nf4_gemm.launches = 0
nf4_gemm.shapes = collections.Counter()  # launches by (n, M, K)


GROUPED_MATS = 3  # matrices one grouped launch serves (r, k, v)


def quant_gemv_grouped_plain(xs, kind, grouped, m, k) -> torch.Tensor:
    """Plain version of :func:`quant_gemv_grouped`: per matrix and group,
    the f32 sum of q·bf16(x) times the scale product, minus the offset
    times the group's f32 sum of bf16(x)."""
    xb = xs.to(torch.bfloat16).float()
    n = xb.shape[1]
    offsets = grouped.get("offsets")
    out = []
    for i, codes in enumerate(grouped["codes"]):
        s = grouped["scales"][i]
        g = s.shape[-1]
        xg = xb[i].reshape(n, g, k // g)
        q = qs_codes(codes, k).view(m, g, k // g)
        y = (torch.einsum("ngs,mgs->nmg", xg, q) * s).sum(-1)
        if offsets is not None:
            y = y - xg.sum(-1) @ offsets[i].T
        out.append(y)
    return torch.stack(out)


@functools.cache
def _grouped_fn():
    fn = build.load("gemv_grouped").quant_gemv_grouped
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def quant_gemv_grouped(xs, kind, grouped, m, k) -> torch.Tensor:
    """Three same-shape gemvs in one launch: xs ``[3, n, K]`` (n ≤ 8), each
    matrix i's input rows ``xs[i]``; ``grouped`` (``models.loader.
    group_gemv_matrices``) holds ``codes``, the three matrices' own code
    tensors (u8 ``[M, K/2]`` split-halves nibbles for ``kind`` "qk", u8 or
    i8 ``[M, K]`` bytes otherwise), ``scales`` f32 ``[3, M, G]`` and
    ``offsets`` f32 ``[3, M, G]`` or None (w = q·s − offset; groups of 16,
    32 or 128, 32 for nibbles) → f32 ``[3, n, M]``."""
    if not xs.is_cuda:
        return quant_gemv_grouped_plain(xs, kind, grouped, m, k)
    codes, scales, offsets = grouped["codes"], grouped["scales"], grouped.get("offsets")
    nib = kind == "qk"
    g = scales.shape[-1]
    gs = k // g if g else 0
    if (xs.dim() != 3 or xs.shape[0] != GROUPED_MATS or xs.shape[-1] != k
            or not 1 <= xs.shape[1] <= MAX_GEMV_ROWS or len(codes) != GROUPED_MATS):
        raise ValueError(f"quant_gemv_grouped: xs must be [{GROUPED_MATS}, 1..{MAX_GEMV_ROWS}, "
                         f"{k}] with {GROUPED_MATS} matrices, got {tuple(xs.shape)} and "
                         f"{len(codes)}")
    if gs not in (16, 32, 128) or g * gs != k or k % (64 if nib else 32) or (nib and gs != 32):
        raise ValueError(f"quant_gemv_grouped: groups of 16, 32 or 128 elements (32 for "
                         f"nibbles) over K={k}, got scales {tuple(scales.shape)}")
    n = xs.shape[1]
    if n * k * 4 > _MAX_SMEM:
        raise ValueError(f"quant_gemv_grouped: x of [{n}, {k}] does not fit shared memory")
    dtype = codes[0].dtype
    want = (m, k // 2 if nib else k)
    for key, a, shape, dts in (
            *((f"codes[{i}]", c, want, (dtype,)) for i, c in enumerate(codes)),
            ("scales", scales, (GROUPED_MATS, m, g), (torch.float32,)),
            *((("offsets", offsets, (GROUPED_MATS, m, g), (torch.float32,)),)
              if offsets is not None else ())):
        if (tuple(a.shape) != shape or a.dtype not in dts or a.device != xs.device
                or not a.is_contiguous()):
            raise ValueError(f"quant_gemv_grouped: {key} must be contiguous "
                             f"{' or '.join(map(str, dts))} {shape} on {xs.device}, got "
                             f"{a.dtype} {tuple(a.shape)} on {a.device}")
    if dtype not in ((torch.uint8,) if nib else (torch.uint8, torch.int8)):
        raise ValueError(f"quant_gemv_grouped: codes of kind {kind} cannot be {dtype}")
    if any(c.data_ptr() % 16 for c in codes):
        raise ValueError("quant_gemv_grouped: codes must be 16-byte aligned")
    xb = xs.to(torch.bfloat16).contiguous()
    y = torch.empty(GROUPED_MATS, n, m, dtype=torch.float32, device=xs.device)
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _grouped_fn()(xb.data_ptr(), *(c.data_ptr() for c in codes), scales.data_ptr(),
                            0 if offsets is None else offsets.data_ptr(), y.data_ptr(),
                            n, m, k, gs, _CODE_KIND["nibbles" if nib else dtype], stream)
    quant_gemv_grouped.launches += 1
    quant_gemv_grouped.shapes[(n, m, k)] += 1
    if err:
        raise RuntimeError(f"quant_gemv_grouped launch failed: CUDA error {err}")
    return y


quant_gemv_grouped.launches = 0
quant_gemv_grouped.shapes = collections.Counter()  # launches by (n, M, K)
