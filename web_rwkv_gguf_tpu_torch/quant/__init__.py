"""Quantization block formats: numpy dequantization references and the
repackers that turn GGML block streams into the port's logical arrays."""

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
