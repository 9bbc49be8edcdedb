"""Weight matrices over their storage formats: dense, Q4_K and Q6_K.

Layout is output-major ``[M, K]`` (row = output feature), as in GGUF, so
the quantization blocks run along K. A matrix may carry a leading layer
axis ``[L, M, ...]``; :meth:`Matrix.layer` takes one layer's view.

Kinds and their arrays:

- ``dense``: ``w`` ``[M, K]`` in the model dtype (f32 or bf16).
- ``qk`` (Q4_K): ``codes`` u8 ``[M, K/2]`` in split halves (byte j =
  el(j) | el(j+K/2) << 4), ``sc6``, ``mn6`` u8 ``[M, K/32]``, ``d8``,
  ``dm8`` f32 ``[M, K/256]``. A matrix whose K is not a multiple of 256
  has no such factors and keeps the f32 group products ``scales``,
  ``mins`` ``[M, K/32]`` instead; only the CPU runs it.
- ``qk_nomin`` (Q6_K): ``codes`` i8 ``[M, K]``, ``q6s`` i8 ``[M, K/16]``,
  ``q6d`` f32 ``[M, K/256]`` (or ``scales`` ``[M, K/16]``, as above).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..errors import LoaderError, UnsupportedTensorType
from ..ops.cuda.matmul import (
    MAX_GEMV_ROWS, q4k_codes, q4k_dequantize, q4k_gemm, q4k_gemv,
    q6k_dequantize, q6k_gemm, q6k_gemv, slab_matmul_plain,
)
from ..quant import repack
from ..quant.ggml import GgmlDType


def _gemv_tiles(m: int, kdim: int) -> bool:
    """Whether the JAX package's gemv finds an M tiling for the matrix
    (``ops/pallas/matmul.py::_gemv_block_m``; kdim = code bytes per row)."""
    if any(m % c == 0 and c * kdim <= (2 << 20) for c in (4096, 2048, 1024, 512)):
        return True
    return m % 8 == 0 and m <= 4096 and m * kdim <= (2 << 20)


def takes_gemv(kind: str, n: int, m: int, k: int) -> bool:
    """The JAX package's ``quant_matmul`` gate (ops/pallas/matmul.py:
    1281-1287) for the port's kinds: n rows of x go to the gemv (exact
    f32 weights) only at a small n·groups; every other call goes to the
    dequant-GEMM (bf16-rounded weights). Following it keeps the port in
    the JAX package's numerics class at every n."""
    g = k // (32 if kind == "qk" else 16)
    kdim = k // 2 if kind == "qk" else k
    return (n <= MAX_GEMV_ROWS and n * g <= 256 and _gemv_tiles(m, kdim)
            and (kind != "qk" or g % 2 == 0) and n * g * kdim * 2 <= (4 << 20))


@dataclass
class Matrix:
    kind: str  # "dense" | "qk" | "qk_nomin"
    shape: tuple[int, int]  # logical (M, K), without a layer axis
    arrays: dict[str, torch.Tensor]

    @classmethod
    def dense(cls, w: torch.Tensor) -> "Matrix":
        return cls("dense", tuple(w.shape[-2:]), {"w": w})

    @classmethod
    def from_gguf_blocks(cls, dtype: GgmlDType, raw: np.ndarray, shape,
                         device="cuda") -> "Matrix":
        """Repack raw GGML blocks into the kind's arrays on ``device``."""
        m, k = int(shape[0]), int(shape[1])
        if dtype == GgmlDType.Q4_K:
            codes, scales, mins = repack.repack_q4_k(raw, m, k)
            factors = repack.q4k_scale_factors(raw, m, k)
            if factors is not None:
                sc6, mn6, d8, dm8 = factors
                arrays = {"codes": codes, "sc6": sc6, "mn6": mn6, "d8": d8,
                          "dm8": dm8}
            else:
                arrays = {"codes": codes, "scales": scales, "mins": mins}
            kind = "qk"
        elif dtype == GgmlDType.Q6_K:
            codes, scales = repack.repack_q6_k(raw, m, k)
            factors = repack.q6k_scale_factors(raw, m, k)
            if factors is not None:
                arrays = {"codes": codes, "q6s": factors[0], "q6d": factors[1]}
            else:
                arrays = {"codes": codes, "scales": scales}
            kind = "qk_nomin"
        else:
            raise UnsupportedTensorType(f"no direct-quantized repack for {dtype!r}")
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
        return (m, kc * 2) if self.kind == "qk" else (m, kc)

    def dequantize(self) -> torch.Tensor:
        """The dense f32 ``[M, K]`` weight of a single-layer matrix."""
        a = self.arrays
        if self.kind == "dense":
            return a["w"].float()
        m, k = self.dims()
        if self.kind == "qk" and "sc6" in a:
            return q4k_dequantize(a["codes"], a["sc6"], a["mn6"], a["d8"], a["dm8"])
        if self.kind == "qk_nomin" and "q6s" in a:
            return q6k_dequantize(a["codes"], a["q6s"], a["q6d"])
        if self.kind in ("qk", "qk_nomin"):
            g = a["scales"].shape[-1]
            w = self._codes().view(m, g, k // g) * a["scales"][..., None]
            if "mins" in a:
                w = w - a["mins"][..., None]
            return w.view(m, k)
        raise LoaderError(f"unknown matrix kind {self.kind}")

    def _codes(self) -> torch.Tensor:
        """The f32 codes ``[M, K]`` of a quantized single-layer matrix."""
        codes = self.arrays["codes"]
        return q4k_codes(codes) if self.kind == "qk" else codes.float()

    def matmul(self, x: torch.Tensor) -> torch.Tensor:
        """``y[..., m] = Σ_k x[..., k] W[m, k]``, f32 result, for a
        single-layer matrix.

        Dense weights multiply in f32 after rounding x to the weight's
        dtype (a bf16 weight gives bf16 operands and an f32 product, not
        a bf16 one). Quantized kinds go through the gemv kernels where
        :func:`takes_gemv` says so and through the dequant-GEMM kernels
        otherwise (``ops/cuda/matmul.py``); on the CPU those take their
        plain versions.
        """
        m, k = self.dims()
        lead = x.shape[:-1]
        x2 = x.reshape(-1, k).contiguous()
        a = self.arrays
        if self.kind == "dense":
            w = a["w"]
            if w.dtype == torch.float32:
                y = x2.float() @ w.T
            else:
                y = x2.to(w.dtype).float() @ w.float().T
        else:
            gemv = takes_gemv(self.kind, x2.shape[0], m, k)
            if self.kind == "qk" and "sc6" in a:
                y = (q4k_gemv if gemv else q4k_gemm)(
                    x2, a["codes"], a["sc6"], a["mn6"], a["d8"], a["dm8"])
            elif self.kind == "qk_nomin" and "q6s" in a:
                y = (q6k_gemv if gemv else q6k_gemm)(
                    x2, a["codes"], a["q6s"], a["q6d"])
            elif x.is_cuda:
                raise UnsupportedTensorType(
                    f"{self.kind} matrix [{m}, {k}]: K-quant rows that do not "
                    "hold whole 256-element super-blocks have no CUDA kernel yet")
            elif gemv:
                y = x2.to(torch.bfloat16).float() @ self.dequantize().T
            else:
                y = slab_matmul_plain(x2, self._codes(), a["scales"], a.get("mins"))
        return y.reshape(lead + (m,))
