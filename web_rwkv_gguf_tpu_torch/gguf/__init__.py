"""GGUF v2/v3 container support: mmap reader, metadata, tensor-name mapping.

Ref: src/runtime/gguf.rs (parser 1331-1537, name map 1160-1329, reader
trait impl 1540-1795).
"""

from .reader import GgufFile, GgufTensorInfo, gguf_to_model_name  # noqa: F401
from .writer import GgufWriter  # noqa: F401
