"""Weight matrices over their storage formats: dense and every GGML block
type the loader reads directly.

Layout is output-major ``[M, K]`` (row = output feature), as in GGUF, so
the quantization blocks run along K. A matrix may carry a leading layer
axis ``[L, M, ...]``; :meth:`Matrix.layer` takes one layer's view.

Kinds and their arrays (the JAX package's ``Matrix.from_gguf_blocks``
keys, without the arrays that only lay weights out for the TPU):

- ``dense``: ``w`` ``[M, K]`` in the model dtype (f32 or bf16).
- ``qk``: ``codes`` u8 ``[M, K/2]`` in split halves (byte j = el(j) |
  el(j+K/2) << 4). Q4_K: ``sc6``, ``mn6`` u8 ``[M, K/32]``, ``d8``,
  ``dm8`` f32 ``[M, K/256]``; Q4_K rows that do not hold whole
  256-element super-blocks, and Q4_0 / Q4_1 at K % 64 == 0: the f32
  group products ``scales``, ``mins`` ``[M, K/32]`` instead.
- ``qk_b`` (u8 byte codes ``[M, K]``, offsets): Q5_K and Q2_K with
  ``sc6``, ``mn6`` u8 ``[M, K/32]`` (Q5_K) or ``[M, K/16]`` (Q2_K) and
  ``d8``, ``dm8`` f32 ``[M, K/256]``; Q5_0, Q5_1 and Q4_1 at K % 64 != 0
  (and Q5_K / Q2_K without whole super-blocks) with f32 ``scales``,
  ``mins``.
- ``qk_nomin`` (byte codes ``[M, K]``, no offsets): Q6_K and Q3_K (i8)
  with ``q6s`` i8 ``[M, K/16]`` and ``q6d`` f32 ``[M, K/256]``; Q8_0 and
  Q4_0 at K % 64 != 0 (i8, per 32), and Q6_K / Q3_K without whole
  super-blocks (per 16), with f32 ``scales``.

The engine's requantization of dense weights (:meth:`Matrix.from_f16`,
``quant/formats.py``) adds two kinds:

- ``int8``: ``codes`` u8 ``[M, K]``, ``mn`` / ``mx`` f32 ``[M, K/128]``
  (f16 values); a weight is ``mn + u·(mx − mn)/255``.
- ``nf4`` (NF4 and SF4): ``codes`` u8 ``[M, K/2]`` in pairs (byte j =
  el(2j) | el(2j+1) << 4), ``absmax`` f32 ``[M, K/64]`` (f16 values),
  ``lut`` f32 ``[16]`` (``[L, 16]`` layer-stacked), the codebook; a
  weight is ``lut[idx]·absmax``.

Each form has its gemv and dequant-GEMM kernel (``ops/cuda/matmul.py``):
``q4k_*`` for the Q4_K factors, ``q6k_*`` for the Q6_K / Q3_K factors,
``qkb_*`` for the Q5_K / Q2_K factors, ``qs_*`` for every form with f32
``scales`` and for ``int8`` (scales ``(mx − mn)/255``, offsets ``−mn``),
``nf4_*`` for ``nf4``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..errors import LoaderError, UnsupportedTensorType
from ..ops.cuda.matmul import (
    MAX_GEMV_ROWS, nf4_dequantize, nf4_gemm, nf4_gemv, q4k_gemm, q4k_gemv,
    q4k_scale_products, q6k_gemm, q6k_gemv, q6k_scale_products, qkb_gemm, qkb_gemv,
    qs_dequantize, qs_gemm, qs_gemv,
)
from ..quant import formats as qf
from ..quant import repack
from ..quant.ggml import GgmlDType

# the kinds whose codes pack two elements a byte
_NIBBLE_KINDS = ("qk", "nf4")


def gemv_block_m(m: int, kdim: int) -> int | None:
    """The M tile of the JAX package's gemv for a matrix of m rows of kdim
    code bytes (``ops/pallas/matmul.py::_gemv_block_m``): the largest of
    4096, 2048, 1024 and 512 that divides m within 2 MiB of codes, else
    the whole m where that is a multiple of 8 within 4096 rows and 2 MiB,
    else None (no tiling)."""
    for c in (4096, 2048, 1024, 512):
        if m % c == 0 and c * kdim <= (2 << 20):
            return c
    if m % 8 == 0 and m <= 4096 and m * kdim <= (2 << 20):
        return m
    return None


def takes_gemv(kind: str, n: int, m: int, k: int, groups: int) -> bool:
    """The JAX package's ``quant_matmul`` gate (ops/pallas/matmul.py:
    1281-1287): n rows of x go to the gemv (exact f32 weights) only at a
    small n·groups; every other call goes to the dequant-GEMM
    (bf16-rounded weights). ``groups`` is the matrix's own group count per
    row (:meth:`Matrix.groups`), kdim its code bytes per row. Following it
    keeps the port in the JAX package's numerics class at every n."""
    nibbles = kind in _NIBBLE_KINDS
    kdim = k // 2 if nibbles else k
    return (n <= MAX_GEMV_ROWS and n * groups <= 256 and gemv_block_m(m, kdim) is not None
            and (not nibbles or groups % 2 == 0) and n * groups * kdim * 2 <= (4 << 20))


def scale_products(a: dict):
    """Per-group f32 ``(scales, mins or None)`` of a quantized matrix's
    arrays: the stored f32 arrays, or the products formed from the native
    factors (bit-exact: the repackers form the stored products as
    ``d·sc`` in f32 too). Works on layer-stacked arrays."""
    if "scales" in a:
        return a["scales"].float(), (a["mins"].float() if "mins" in a else None)
    if "sc6" in a:
        return q4k_scale_products(a["sc6"], a["mn6"], a["d8"], a["dm8"])
    if "q6s" in a:
        return q6k_scale_products(a["q6s"], a["q6d"]), None
    raise LoaderError(f"no scale arrays among {sorted(a)}")


def int8_operands(a: dict, gemm: bool):
    """The f32 group scales and offsets ``(s, −mn)`` ``[M, K/128]`` over
    which an ``int8`` matrix's codes multiply in the ``qs_*`` kernels (w =
    u·s − (−mn), the negation exact). ``s`` is (mx − mn)/255 for the gemv
    class (the JAX package's gemv operands and whole-stack prep divide)
    and (mx − mn)·(1/255) for the GEMM's (its slab branch multiplies): the
    two differ by about one ulp."""
    mn, mx = a["mn"].float(), a["mx"].float()
    s = (mx - mn) * (1.0 / 255.0) if gemm else (mx - mn) / 255.0
    return s, -mn


def gemv_scales(mat: "Matrix"):
    """The f32 group scales and signed offsets ``(s, mn or None)`` ``[...,
    M, G]`` of a quantized matrix in the gemv class, w = q·s − mn:
    :func:`scale_products`, and for ``int8`` :func:`int8_operands` (−mn,
    the added offset negated)."""
    if mat.kind == "int8":
        return int8_operands(mat.arrays, gemm=False)
    return scale_products(mat.arrays)


# the native factor arrays' keys, by their count
_FACTOR_KEYS = {2: ("q6s", "q6d"), 4: ("sc6", "mn6", "d8", "dm8")}
# block type -> (kind, repacker, native factorization or None)
_REPACK = {
    GgmlDType.Q4_K: ("qk", "repack_q4_k", "q4k_scale_factors"),
    GgmlDType.Q5_K: ("qk_b", "repack_q5_k", "q5k_scale_factors"),
    GgmlDType.Q2_K: ("qk_b", "repack_q2_k", "q2k_scale_factors"),
    GgmlDType.Q6_K: ("qk_nomin", "repack_q6_k", "q6k_scale_factors"),
    GgmlDType.Q3_K: ("qk_nomin", "repack_q3_k", "q3k_scale_factors"),
    GgmlDType.Q8_0: ("qk_nomin", "repack_q8_0", None),
    GgmlDType.Q4_0: ("qk", "repack_q4_0", None),  # split-halves nibbles: the Q4_K group form
    GgmlDType.Q4_1: ("qk", "repack_q4_1", None),
    GgmlDType.Q5_0: ("qk_b", "repack_q5_0", None),
    GgmlDType.Q5_1: ("qk_b", "repack_q5_1", None),
}
# the byte-code form of the 4-bit legacy types where K % 64 != 0 (the
# split halves would not stay 32-group aligned)
_BYTES_REPACK = {GgmlDType.Q4_0: ("qk_nomin", "repack_q4_0_bytes"),
                 GgmlDType.Q4_1: ("qk_b", "repack_q4_1_bytes")}


@dataclass
class Matrix:
    kind: str  # "dense" | "qk" | "qk_b" | "qk_nomin" | "int8" | "nf4"
    shape: tuple[int, int]  # logical (M, K), without a layer axis
    arrays: dict[str, torch.Tensor]

    @classmethod
    def dense(cls, w: torch.Tensor) -> "Matrix":
        return cls("dense", tuple(w.shape[-2:]), {"w": w})

    @classmethod
    def from_f16(cls, w: np.ndarray, scheme, dtype=torch.bfloat16,
                 device="cuda") -> "Matrix":
        """A dense ``[M, K]`` weight (f16 values) requantized by ``scheme``
        (``quant.QuantScheme``), as the JAX package's ``Matrix.from_f16``
        makes it (without its TPU operands): NONE keeps it dense in
        ``dtype``; INT8 quantizes per 128 elements of a row, NF4 and SF4
        per 64 (SF4 is NF4 with the Student-t codebook). A K that the
        block does not divide stays dense."""
        m, k = w.shape

        def dev(a):
            return torch.from_numpy(np.require(a, requirements="CW")).to(device)

        block = qf.INT8_BLOCK_SIZE if scheme == qf.QuantScheme.INT8 else qf.NF4_BLOCK_SIZE
        if scheme == qf.QuantScheme.NONE or k % block:
            return cls.dense(dev(np.asarray(w, np.float16)).to(dtype))
        w32 = np.asarray(w, np.float32)
        if scheme == qf.QuantScheme.INT8:
            codes, mn, mx = qf.quantize_int8(w32)
            g = k // block
            return cls("int8", (m, k), {
                "codes": dev(codes.reshape(m, k)),
                "mn": dev(mn.astype(np.float32).reshape(m, g)),
                "mx": dev(mx.astype(np.float32).reshape(m, g))})
        if scheme in (qf.QuantScheme.NF4, qf.QuantScheme.SF4):
            lut = qf.NF4_QUANTILES if scheme == qf.QuantScheme.NF4 else qf.sf4_quantiles()
            packed, absmax, lut = qf.quantize_nf4(w32, lut)
            return cls("nf4", (m, k), {
                "codes": dev(packed.reshape(m, k // 2)),
                "absmax": dev(absmax.astype(np.float32).reshape(m, k // block)),
                "lut": dev(np.asarray(lut, np.float32))})
        raise LoaderError(f"unsupported scheme {scheme}")

    @classmethod
    def from_gguf_blocks(cls, dtype: GgmlDType, raw: np.ndarray, shape,
                         device="cuda") -> "Matrix":
        """Repack raw GGML blocks into the kind's arrays on ``device``
        (the kinds and keys of the module docstring)."""
        m, k = int(shape[0]), int(shape[1])
        if dtype not in _REPACK:
            raise UnsupportedTensorType(f"no direct-quantized repack for {dtype!r}")
        kind, repack_fn, factors_fn = _REPACK[dtype]
        if dtype in _BYTES_REPACK and k % 64:
            kind, repack_fn = _BYTES_REPACK[dtype]
        codes, *scales = getattr(repack, repack_fn)(raw, m, k)
        factors = getattr(repack, factors_fn)(raw, m, k) if factors_fn else None
        if factors is not None:  # native factors: the f32 products are not kept
            arrays = {"codes": codes, **dict(zip(_FACTOR_KEYS[len(factors)], factors))}
        else:
            arrays = {"codes": codes, **dict(zip(("scales", "mins"), scales))}
        return cls(kind, (m, k), {
            key: torch.from_numpy(np.require(a, requirements="CW")).to(device)
            for key, a in arrays.items()})

    def layer(self, i: int) -> "Matrix":
        """Layer ``i`` of a layer-stacked matrix (views, no copies)."""
        return Matrix(self.kind, self.shape, {k: a[i] for k, a in self.arrays.items()})

    def dims(self) -> tuple[int, int]:
        """Logical (M, K) from the array shapes."""
        a = self.arrays
        if self.kind == "dense":
            return tuple(a["w"].shape[-2:])
        m, kc = a["codes"].shape[-2:]
        return (m, kc * 2) if self.kind in _NIBBLE_KINDS else (m, kc)

    def groups(self) -> int:
        """Quantization groups per row that the gemv gate counts: the
        matrix's scale arrays' width; for ``nf4`` twice its absmax count,
        the per-64 absmax tiled over the JAX kernel's two nibble planes
        (JAX ``quant_matmul``: groups of 32 in its de-interleaved x)."""
        a = self.arrays
        if self.kind == "nf4":
            return 2 * a["absmax"].shape[-1]
        return next(a[key].shape[-1] for key in ("scales", "sc6", "q6s", "mn") if key in a)

    def takes_gemv(self, n: int) -> bool:
        """Whether a single-layer quantized matrix multiplies n rows of x
        on its gemv (else on its dequant-GEMM): :func:`takes_gemv`."""
        m, k = self.dims()
        return takes_gemv(self.kind, n, m, k, self.groups())

    def dequantize(self) -> torch.Tensor:
        """The dense f32 ``[M, K]`` weight of a single-layer matrix."""
        a = self.arrays
        if self.kind == "dense":
            return a["w"].float()
        if self.kind == "int8":  # the JAX package's formula, bit for bit
            m, k = self.dims()
            g = a["mn"].shape[-1]
            u = (a["codes"].float() / 255.0).view(m, g, k // g)
            mn, mx = a["mn"][..., None], a["mx"][..., None]
            return (mn + u * (mx - mn)).view(m, k)
        if self.kind == "nf4":
            return nf4_dequantize(a["codes"], a["absmax"], a["lut"])
        if self.kind not in ("qk", "qk_b", "qk_nomin"):
            raise LoaderError(f"unknown matrix kind {self.kind}")
        return qs_dequantize(a["codes"], *scale_products(a), k=self.dims()[1])

    def matmul(self, x: torch.Tensor) -> torch.Tensor:
        """``y[..., m] = Σ_k x[..., k] W[m, k]``, f32 result, for a
        single-layer matrix.

        Dense weights multiply in f32 after rounding x to the weight's
        dtype (a bf16 weight gives bf16 operands and an f32 product, not
        a bf16 one: on the card one ``torch.mm`` with an f32 output, as
        the JAX package's ``preferred_element_type``). Quantized kinds go through their form's gemv where
        :meth:`takes_gemv` says so and through its dequant-GEMM otherwise
        (``ops/cuda/matmul.py``), as the JAX package's ``quant_matmul``
        dispatches: native Q4_K factors → ``q4k_*``, native Q5_K / Q2_K →
        ``qkb_*``, native Q6_K / Q3_K → ``q6k_*``, f32 scales and ``int8``
        → ``qs_*``, ``nf4`` → ``nf4_*``. On the CPU those take their plain
        versions.
        """
        m, k = self.dims()
        lead = x.shape[:-1]
        x2 = x.reshape(-1, k).contiguous()
        a = self.arrays
        if self.kind == "dense":
            w = a["w"]
            if w.dtype == torch.float32:
                y = x2.float() @ w.T
            elif w.is_cuda:  # bf16 operands on the tensor cores, f32 out
                y = torch.mm(x2.to(w.dtype), w.T, out_dtype=torch.float32)
            else:
                y = x2.to(w.dtype).float() @ w.float().T
            return y.reshape(lead + (m,))
        gemv = self.takes_gemv(x2.shape[0])
        if self.kind == "int8":
            y = (qs_gemv if gemv else qs_gemm)(x2, a["codes"], *int8_operands(a, not gemv))
        elif self.kind == "nf4":
            y = (nf4_gemv if gemv else nf4_gemm)(x2, a["codes"], a["absmax"], a["lut"])
        elif "sc6" in a:
            family = (q4k_gemv, q4k_gemm) if self.kind == "qk" else (qkb_gemv, qkb_gemm)
            y = family[0 if gemv else 1](x2, a["codes"], a["sc6"], a["mn6"], a["d8"], a["dm8"])
        elif "q6s" in a:
            y = (q6k_gemv if gemv else q6k_gemm)(x2, a["codes"], a["q6s"], a["q6d"])
        else:
            y = (qs_gemv if gemv else qs_gemm)(x2, a["codes"], a["scales"], a.get("mins"))
        return y.reshape(lead + (m,))
