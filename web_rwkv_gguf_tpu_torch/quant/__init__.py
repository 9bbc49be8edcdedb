"""Quantization block formats: numpy dequantization references, the
repackers that turn GGML block streams into the port's logical arrays,
and the engine's requantization schemes (Int8, NF4, SF4)."""

from .formats import (  # noqa: F401
    INT8_BLOCK_SIZE,
    NF4_BLOCK_SIZE,
    NF4_QUANTILES,
    QuantScheme,
    dequantize_int8,
    dequantize_nf4,
    matrix_statistics,
    quantize_int8,
    quantize_nf4,
    sf4_quantiles,
)
from .ggml import (  # noqa: F401
    GGML_BLOCK_SIZES,
    GGML_TYPE_SIZES,
    GgmlDType,
    dequantize,
    dequantize_q4_k,
    dequantize_q6_k,
    quantize_q4_k,
    quantize_q6_k,
)
