"""Minimal GGUF v3 writer.

Used by the synthetic-model builders and by tests to build model
files. Writes metadata KVs, tensor infos, and aligned tensor
data; dims are stored on disk in GGUF order (fastest-varying first), so
pass arrays in model convention and they are reversed here.
"""

from __future__ import annotations

import struct
from io import BytesIO

import numpy as np

from ..quant import ggml as _ggml
from ..quant.ggml import GgmlDType
from .reader import GGUF_DEFAULT_ALIGNMENT, GGUF_MAGIC
from ..errors import UnsupportedTensorType

_NUMPY_TO_GGML = {
    np.dtype(np.float32): GgmlDType.F32,
    np.dtype(np.float16): GgmlDType.F16,
    np.dtype(np.int32): GgmlDType.I32,
    np.dtype(np.int64): GgmlDType.I64,
}


def _write_string(buf, s: str):
    b = s.encode("utf-8")
    buf.write(struct.pack("<Q", len(b)))
    buf.write(b)


def _write_value(buf, v):
    if isinstance(v, bool):
        buf.write(struct.pack("<I", 7))
        buf.write(struct.pack("<B", int(v)))
    elif isinstance(v, int):
        if v < 0:
            buf.write(struct.pack("<I", 11))
            buf.write(struct.pack("<q", v))
        else:
            buf.write(struct.pack("<I", 4 if v < 2**32 else 10))
            buf.write(struct.pack("<I" if v < 2**32 else "<Q", v))
    elif isinstance(v, float):
        buf.write(struct.pack("<I", 6))
        buf.write(struct.pack("<f", v))
    elif isinstance(v, str):
        buf.write(struct.pack("<I", 8))
        _write_string(buf, v)
    elif isinstance(v, (list, tuple)):
        buf.write(struct.pack("<I", 9))
        if not v:
            buf.write(struct.pack("<I", 4))
            buf.write(struct.pack("<Q", 0))
            return
        first = v[0]
        if isinstance(first, str):
            etype = 8
        elif isinstance(first, bool):
            etype = 7
        elif isinstance(first, int):
            etype = 5 if any(x < 0 for x in v) else 4
        elif isinstance(first, float):
            etype = 6
        else:
            raise TypeError(f"unsupported array element: {type(first)}")
        buf.write(struct.pack("<I", etype))
        buf.write(struct.pack("<Q", len(v)))
        for x in v:
            if etype == 8:
                _write_string(buf, x)
            elif etype == 7:
                buf.write(struct.pack("<B", int(x)))
            elif etype == 4:
                buf.write(struct.pack("<I", x))
            elif etype == 5:
                buf.write(struct.pack("<i", x))
            elif etype == 6:
                buf.write(struct.pack("<f", x))
    else:
        raise TypeError(f"unsupported metadata value: {type(v)}")


class GgufWriter:
    def __init__(self, alignment: int = GGUF_DEFAULT_ALIGNMENT):
        self.alignment = alignment
        self.metadata: dict[str, object] = {}
        self._tensors: list[tuple[str, tuple[int, ...], GgmlDType, bytes]] = []

    def add_metadata(self, key: str, value):
        self.metadata[key] = value

    def add_tensor(
        self,
        name: str,
        array: np.ndarray,
        *,
        quantize: GgmlDType | None = None,
    ):
        """Add a tensor given in model convention ([out, in] for 2-D)."""
        array = np.ascontiguousarray(array)
        dims_gguf = tuple(reversed(array.shape)) if array.ndim > 1 else tuple(array.shape)
        if quantize is None:
            ggml = _NUMPY_TO_GGML[array.dtype]
            data = array.tobytes()
        elif quantize in _ggml.DIRECT_TYPES:  # every type quant/ggml.py quantizes
            ggml = quantize
            fn = getattr(_ggml, f"quantize_{quantize.name.lower()}")
            data = fn(array.astype(np.float32).reshape(-1))
        else:
            raise UnsupportedTensorType(f"unsupported quantization target: {quantize!r}")
        self._tensors.append((name, dims_gguf, ggml, data))

    def add_raw_tensor(self, name: str, dims_gguf: tuple[int, ...], ggml: GgmlDType, data: bytes):
        self._tensors.append((name, tuple(dims_gguf), ggml, data))

    def tobytes(self) -> bytes:
        buf = BytesIO()
        buf.write(struct.pack("<I", GGUF_MAGIC))
        buf.write(struct.pack("<I", 3))
        buf.write(struct.pack("<Q", len(self._tensors)))
        meta = dict(self.metadata)
        meta.setdefault("general.alignment", self.alignment)
        buf.write(struct.pack("<Q", len(meta)))
        for k, v in meta.items():
            _write_string(buf, k)
            _write_value(buf, v)

        offset = 0
        offsets = []
        for _, dims, ggml, data in self._tensors:
            offsets.append(offset)
            offset += len(data)
            offset = -(-offset // self.alignment) * self.alignment

        for (name, dims, ggml, data), off in zip(self._tensors, offsets):
            _write_string(buf, name)
            buf.write(struct.pack("<I", len(dims)))
            for d in dims:
                buf.write(struct.pack("<Q", d))
            buf.write(struct.pack("<I", int(ggml)))
            buf.write(struct.pack("<Q", off))

        pos = buf.tell()
        pad = -(-pos // self.alignment) * self.alignment - pos
        buf.write(b"\x00" * pad)
        for (name, dims, ggml, data), off in zip(self._tensors, offsets):
            cur = buf.tell()
            buf.write(data)
            nxt = buf.tell()
            pad = -(-nxt // self.alignment) * self.alignment - nxt
            buf.write(b"\x00" * pad)
        return buf.getvalue()

    def write(self, path):
        with open(path, "wb") as f:
            f.write(self.tobytes())
