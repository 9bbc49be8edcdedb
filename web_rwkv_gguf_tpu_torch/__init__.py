"""PyTorch/CUDA port of the RWKV GGUF inference engine, for NVIDIA Hopper.

Beside the JAX package ``web_rwkv_gguf_tpu`` (the reference it is checked
against) and importing nothing of it: the port keeps its own copies of
the GGUF reader and writer, the quant formats and the model metadata.
Every kernel on its path is written by hand in CUDA C++ for ``sm_90a``
(``ops/cuda/csrc``), with a plain PyTorch version beside it that the CPU
runs. Entry points default to ``device="cuda"``; pass ``device="cpu"``
to run the plain versions.

Layer map:
  gguf/      GGUF parsing, tensor-name mapping, writer
  quant/     block formats, numpy dequant, repack into logical arrays
  ops/       plain ops (basic, wkv) and the CUDA kernels (ops/cuda)
  models/    metadata, matrices, loader, forward, generation
  runtime/   chunk scheduler, the inference Engine and EnginePool
  io/        model snapshots, state files, safetensors
  utils/     synthetic model files
"""

__version__ = "0.1.0"

from .errors import (  # noqa: E402,F401
    GgufError,
    InvalidVersion,
    LoaderError,
    TensorNotFound,
    UnsupportedFeature,
    UnsupportedTensorType,
    WebRwkvError,
)
