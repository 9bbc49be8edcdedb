"""SafeTensors files: a reader with ``GgufFile``'s interface, and a writer.

The reference's other weight format (src/runtime/loader.rs reads it
through the safetensors crate). :class:`SafetensorsFile` maps the file
and answers ``names`` / ``contains`` / ``shape`` / ``tensor`` /
``quantized_tensor`` as ``gguf.GgufFile`` does, so ``models.load_model``
loads a file that holds model-convention names (``blocks.0.att.key.weight``
…); every tensor loads through the f32 path (nothing is direct-quantized).
F32, F16 and BF16 tensors are converted to the asked dtype on read; BF16
goes through a torch view, so no bf16 numpy type is needed.
"""

from __future__ import annotations

import json
import mmap
import struct
from pathlib import Path

import numpy as np
import torch

_DTYPES = {
    "F64": np.float64,
    "F32": np.float32,
    "F16": np.float16,
    "I64": np.int64,
    "I32": np.int32,
    "I16": np.int16,
    "I8": np.int8,
    "U8": np.uint8,
    "BOOL": np.bool_,
}


class SafetensorsFile:
    """A parsed ``.safetensors`` file (a path, mapped, or bytes)."""

    def __init__(self, data):
        self._own = None
        if isinstance(data, (str, Path)):
            with open(data, "rb") as f:
                self._own = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
            data = memoryview(self._own)
        elif isinstance(data, (bytes, bytearray)):
            data = memoryview(data)
        self.data = data
        (hlen,) = struct.unpack("<Q", bytes(data[:8]))
        header = json.loads(bytes(data[8 : 8 + hlen]).decode("utf-8"))
        header.pop("__metadata__", None)
        self.header = header
        self._base = 8 + hlen

    def names(self) -> list[str]:
        return list(self.header)

    def contains(self, name: str) -> bool:
        return name in self.header

    def shape(self, name: str) -> tuple[int, ...]:
        return tuple(self.header[name]["shape"])

    def tensor(self, name: str, dtype=np.float16) -> np.ndarray:
        """The tensor in ``dtype``, in stored (model) convention."""
        ent = self.header[name]
        lo, hi = ent["data_offsets"]
        raw = np.frombuffer(self.data, np.uint8, hi - lo, self._base + lo)
        if ent["dtype"] == "BF16":
            bits = torch.from_numpy(raw.view(np.int16).copy()).view(torch.bfloat16)
            return bits.float().numpy().reshape(ent["shape"]).astype(dtype, copy=False)
        np_dtype = _DTYPES.get(ent["dtype"])
        if np_dtype is None:
            raise ValueError(f"unsupported safetensors dtype {ent['dtype']}")
        return raw.view(np_dtype).reshape(ent["shape"]).astype(dtype, copy=False)

    def quantized_tensor(self, name: str):
        return None


def _encode(arr) -> tuple[str, tuple[int, ...], bytes]:
    """(safetensors dtype, shape, bytes) of a numpy array or a tensor."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().contiguous().cpu()
        if t.dtype == torch.bfloat16:
            return "BF16", tuple(t.shape), t.view(torch.int16).numpy().tobytes()
        arr = t.numpy()
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":  # a bf16 numpy type (ml_dtypes)
        return "BF16", arr.shape, arr.tobytes()
    code = {v: k for k, v in _DTYPES.items()}.get(arr.dtype.type)
    if code is None:
        raise ValueError(f"unsupported dtype {arr.dtype}")
    return code, arr.shape, arr.tobytes()


def write_safetensors(path, tensors: dict):
    """Write ``tensors`` (numpy arrays or torch tensors, bf16 included) as
    a ``.safetensors`` file, byte for byte as the JAX package's writer
    writes the same dict."""
    header, blobs, offset = {}, [], 0
    for name, arr in tensors.items():
        code, shape, blob = _encode(arr)
        header[name] = {"dtype": code, "shape": list(shape),
                        "data_offsets": [offset, offset + len(blob)]}
        blobs.append(blob)
        offset += len(blob)
    hjson = json.dumps(header).encode("utf-8")
    hjson += b" " * ((-len(hjson)) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hjson)))
        f.write(hjson)
        for blob in blobs:
            f.write(blob)
