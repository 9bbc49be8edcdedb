"""Quantized matmul kernels (Q4_K, Q6_K) and their plain PyTorch versions.

Each computes ``y[n, m] = Σ_k x[n, k]·W[m, k]`` with W held as the
loader's logical K-quant arrays (``models/matrix.py``) and returns f32
``[n, m]``; x is rounded to bf16 first, as the model's quantized matmul
defines it. Two numerics classes, as in the JAX package's
``quant_matmul`` (``models/matrix.py`` picks between them):

- the gemvs ``q4k_gemv`` / ``q6k_gemv`` (``csrc/q4k_gemv.cu``,
  ``csrc/q6k_gemv.cu``: one warp per output row, n ≤ 8) multiply by the
  exact f32 weight ``q·(d·sc) − dmin·mn``;
- the dequant-GEMMs ``q4k_gemm`` / ``q6k_gemm`` (``csrc/qk_gemm.cu``:
  bf16 tensor-core tiles, any n) multiply by ``bf16(q·(d·sc))`` with f32
  accumulation and subtract the Q4_K offset term in f32 as
  ``Σ_g (dmin·mn)[m, g]·xs[n, g]``, xs the f32 group sums of the
  bf16-rounded x.

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
    """f32 group scales ``d·sc`` and offsets ``dmin·mn`` ``[M, K/32]``."""
    return (d8.repeat_interleave(8, dim=1) * sc6.float(),
            dm8.repeat_interleave(8, dim=1) * mn6.float())


def q4k_dequantize(codes, sc6, mn6, d8, dm8) -> torch.Tensor:
    """Dense f32 ``[M, K]`` weight of a Q4_K matrix (split-halves codes)."""
    q = q4k_codes(codes)
    m, k = q.shape
    s, mn = q4k_scale_products(sc6, mn6, d8, dm8)
    return (q.view(m, k // 32, 32) * s[..., None] - mn[..., None]).view(m, k)


def q6k_dequantize(codes, q6s, q6d) -> torch.Tensor:
    """Dense f32 ``[M, K]`` weight of a Q6_K matrix."""
    m, k = codes.shape
    s = q6d.repeat_interleave(16, dim=1) * q6s.float()
    return (codes.float().view(m, k // 16, 16) * s[..., None]).view(m, k)


def q4k_gemv_plain(x, codes, sc6, mn6, d8, dm8) -> torch.Tensor:
    """Plain version of :func:`q4k_gemv`."""
    w = q4k_dequantize(codes, sc6, mn6, d8, dm8)
    return x.to(torch.bfloat16).float() @ w.T


def q6k_gemv_plain(x, codes, q6s, q6d) -> torch.Tensor:
    """Plain version of :func:`q6k_gemv`."""
    w = q6k_dequantize(codes, q6s, q6d)
    return x.to(torch.bfloat16).float() @ w.T


def slab_matmul_plain(x, q, scales, offsets=None) -> torch.Tensor:
    """The dequant-GEMM's function over f32 codes ``q`` ``[M, K]`` and f32
    group scales (and offsets) ``[M, G]``: ``bf16(x) @ bf16(q·s)ᵀ`` in f32,
    minus ``Σ_g off[m, g]·Σ_{k∈g} bf16(x)[n, k]`` where there are offsets."""
    m, k = q.shape
    g = scales.shape[-1]
    w = (q.view(m, g, k // g) * scales[..., None]).to(torch.bfloat16).float()
    xb = x.to(torch.bfloat16).float()
    y = xb @ w.view(m, k).T
    if offsets is not None:
        y = y - xb.view(-1, g, k // g).sum(-1) @ offsets.T
    return y


def q4k_gemm_plain(x, codes, sc6, mn6, d8, dm8) -> torch.Tensor:
    """Plain version of :func:`q4k_gemm`."""
    return slab_matmul_plain(x, q4k_codes(codes), *q4k_scale_products(sc6, mn6, d8, dm8))


def q6k_gemm_plain(x, codes, q6s, q6d) -> torch.Tensor:
    """Plain version of :func:`q6k_gemm`."""
    s = q6d.repeat_interleave(16, dim=1) * q6s.float()
    return slab_matmul_plain(x, codes.float(), s)


def _check(name, x, arrays: dict, shapes: dict, dtypes: dict, max_rows=None):
    """Validate what the kernel takes; returns x rounded to bf16,
    contiguous and 16-byte aligned."""
    if x.dim() != 2:
        raise ValueError(f"{name}: x must be [n, K], got {tuple(x.shape)}")
    n, k = x.shape
    if n < 1 or (max_rows is not None and n > max_rows):
        raise ValueError(f"{name}: the kernel takes 1..{max_rows or 'any'} "
                         f"input rows, got {n}")
    if k % 256:
        raise ValueError(f"{name}: K must be a multiple of 256, got {k}")
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
        if tuple(a.shape) != shapes[key] or a.dtype != dtypes[key]:
            raise ValueError(
                f"{name}: {key} must be {dtypes[key]} {shapes[key]}, got "
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
    """Q6_K gemv: x ``[n, K]``; codes i8 ``[M, K]``; q6s i8 ``[M, K/16]``;
    q6d f32 ``[M, K/256]`` → f32 ``[n, M]``."""
    if not x.is_cuda:
        return q6k_gemv_plain(x, codes, q6s, q6d)
    m = codes.shape[0]
    k = x.shape[-1]
    arrays = {"codes": codes, "q6s": q6s, "q6d": q6d}
    xb = _check("q6k_gemv", x, arrays,
                {"codes": (m, k), "q6s": (m, k // 16), "q6d": (m, k // 256)},
                {"codes": torch.int8, "q6s": torch.int8, "q6d": torch.float32},
                MAX_GEMV_ROWS)
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
