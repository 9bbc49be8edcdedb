"""GGUF v2/v3 binary reader with RWKV tensor-name mapping.

Pure numpy + mmap: the port's own copy of the reader, with the RWKV
tensor-name mapping and the virtual fused-lerp tensor slicing.

Conventions:
  * Tensor shapes are returned in "model convention" — the reverse of the
    on-disk GGUF dims for 2-D+ tensors, i.e. ``[out_features,
    in_features]`` for matrices (ref: gguf.rs:1642-1647).
  * 1-D tensors are reported as ``[n]`` by :meth:`GgufFile.shape` and
    materialized as ``[n]`` arrays.
  * ``blocks.N.att.r_k`` stored 1-D is reshaped to ``[num_head,
    head_size]`` using ``rwkv{6,7}.wkv.head_size`` metadata
    (ref: gguf.rs:1623-1640).
  * v7 GGUF files that fuse the six token-shift lerp vectors into
    ``time_mix_lerp_fused.weight`` expose virtual tensors
    ``blocks.N.att.x_{r,w,k,v,a,g}`` served as slices (ref:
    gguf.rs:1545-1571).
"""

from __future__ import annotations

import mmap
import struct
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from ..quant.ggml import (
    DIRECT_TYPES,
    GGML_BLOCK_SIZES,
    GGML_TYPE_SIZES,
    GgmlDType,
    QUANTIZED_TYPES,
    dequantize,
)
from ..errors import GgufError, TensorNotFound

GGUF_MAGIC = 0x46554747  # "GGUF" little-endian (ref: gguf.rs:857)
GGUF_DEFAULT_ALIGNMENT = 32

# metadata value type ids → struct formats (ref: gguf.rs:1509-1536)
_SCALAR_FMT = {
    0: "<B",  # uint8
    1: "<b",  # int8
    2: "<H",  # uint16
    3: "<h",  # int16
    4: "<I",  # uint32
    5: "<i",  # int32
    6: "<f",  # float32
    10: "<Q",  # uint64
    11: "<q",  # int64
    12: "<d",  # float64
}
_T_BOOL = 7
_T_STRING = 8
_T_ARRAY = 9



@dataclass
class GgufTensorInfo:
    name: str
    dims: tuple[int, ...]  # raw GGUF dims (fastest-varying first)
    dtype: GgmlDType
    offset: int  # relative to tensor data section

    @property
    def num_elements(self) -> int:
        n = 1
        for d in self.dims:
            n *= d
        return n

    @property
    def data_size(self) -> int:
        block = GGML_BLOCK_SIZES.get(self.dtype, 1)
        tsize = GGML_TYPE_SIZES.get(self.dtype, 0)
        if block == 1:
            return self.num_elements * tsize
        return (self.num_elements // block) * tsize


class _Cursor:
    def __init__(self, buf):
        self.buf = buf
        self.pos = 0

    def read(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise GgufError("unexpected end of file")
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def scalar(self, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.read(size))[0]

    def string(self) -> str:
        n = self.scalar("<Q")
        return bytes(self.read(n)).decode("utf-8")

    def value(self, vtype: int | None = None):
        if vtype is None:
            vtype = self.scalar("<I")
        if vtype in _SCALAR_FMT:
            return self.scalar(_SCALAR_FMT[vtype])
        if vtype == _T_BOOL:
            return self.scalar("<B") != 0
        if vtype == _T_STRING:
            return self.string()
        if vtype == _T_ARRAY:
            etype = self.scalar("<I")
            n = self.scalar("<Q")
            return [self.value(etype) for _ in range(n)]
        raise GgufError(f"invalid metadata value type: {vtype}")


# --- tensor-name mapping (GGUF llama.cpp names → model param names) -------

_TOP_LEVEL_MAP = {
    "token_embd.weight": "emb.weight",
    "output_norm.weight": "ln_out.weight",
    "output_norm.bias": "ln_out.bias",
    "output.weight": "head.weight",
    "token_embd_norm.weight": "blocks.0.ln0.weight",
    "token_embd_norm.bias": "blocks.0.ln0.bias",
}

# per-block suffix map; "{n}" is the block number (ref: gguf.rs:1198-1323)
_BLOCK_SUFFIX_MAP = {
    "attn_norm.weight": "ln1.weight",
    "attn_norm.bias": "ln1.bias",
    "attn_norm_2.weight": "ln2.weight",
    "attn_norm_2.bias": "ln2.bias",
    "ffn_norm.weight": "ln2.weight",
    "ffn_norm.bias": "ln2.bias",
    "attn_k.weight": "att.key.weight",
    "attn_v.weight": "att.value.weight",
    "attn_r.weight": "att.receptance.weight",
    "attn_g.weight": "att.gate.weight",
    "attn_output.weight": "att.output.weight",
    "attn_time_decay": "att.time_decay",
    "attn_time_first": "att.time_first",
    "attn_time_mix_k": "att.time_mix_k",
    "attn_time_mix_v": "att.time_mix_v",
    "attn_time_mix_r": "att.time_mix_r",
    "attn_time_mix_g": "att.time_mix_g",
    "attn_time_mix_x": "att.time_mix_x",
    "attn_time_mix_w": "att.time_mix_w",
    # V6
    "attn_time_mix_w1": "att.time_mix_w1",
    "attn_time_mix_w2": "att.time_mix_w2",
    "attn_time_decay_w1": "att.time_decay_w1",
    "attn_time_decay_w2": "att.time_decay_w2",
    "time_maa_w1": "att.time_mix_w1",
    "time_maa_w2": "att.time_mix_w2",
    "time_decay_w1": "att.time_decay_w1",
    "time_decay_w2": "att.time_decay_w2",
    "attn_ln_x.weight": "att.ln_x.weight",
    "attn_ln_x.bias": "att.ln_x.bias",
    "attn_time_state": "att.time_state",
    "ffn_k.weight": "ffn.key.weight",
    "ffn_v.weight": "ffn.value.weight",
    "ffn_r.weight": "ffn.receptance.weight",
    "ffn_time_mix_k": "ffn.time_mix_k",
    "ffn_time_mix_r": "ffn.time_mix_r",
    # V7 ffn dialects
    "ffn.key.weight": "ffn.key.weight",
    "ffn.value.weight": "ffn.value.weight",
    "ffn.receptance.weight": "ffn.receptance.weight",
    "channel_mix_key.weight": "ffn.key.weight",
    "channel_mix_value.weight": "ffn.value.weight",
    "channel_mix_receptance.weight": "ffn.receptance.weight",
    "channel_mix_lerp_k.weight": "ffn.x_k",
    # V7 "time_mix_" dialect
    "time_mix_key.weight": "att.key.weight",
    "time_mix_value.weight": "att.value.weight",
    "time_mix_receptance.weight": "att.receptance.weight",
    "time_mix_gate.weight": "att.gate.weight",
    "time_mix_output.weight": "att.output.weight",
    "time_mix_lerp_fused.weight": "att.time_maa",
    "time_mix_w0.weight": "att.w0",
    "time_mix_w1.weight": "att.w1",
    "time_mix_w2.weight": "att.w2",
    "time_mix_a0.weight": "att.a0",
    "time_mix_a1.weight": "att.a1",
    "time_mix_a2.weight": "att.a2",
    "time_mix_g1.weight": "att.g1",
    "time_mix_g2.weight": "att.g2",
    "time_mix_v0.weight": "att.v0",
    "time_mix_v1.weight": "att.v1",
    "time_mix_v2.weight": "att.v2",
    "time_mix_r_k.weight": "att.r_k",
    "time_mix_k_k.weight": "att.k_k",
    "time_mix_k_a.weight": "att.k_a",
    "time_mix_ln.weight": "att.ln_x.weight",
    "time_mix_ln.bias": "att.ln_x.bias",
    "ffn_x_k": "ffn.x_k",
}

# V7 "attn_"/"att_" dialects share a suffix list (ref: gguf.rs:1277-1320)
_V7_SHORT = [
    "x_r", "x_w", "x_k", "x_v", "x_a", "x_g",
    "w0", "w1", "w2", "a0", "a1", "a2", "g1", "g2",
    "v0", "v1", "v2", "r_k", "k_k", "k_a",
]
for _s in _V7_SHORT:
    _BLOCK_SUFFIX_MAP[f"attn_{_s}"] = f"att.{_s}"
    _BLOCK_SUFFIX_MAP[f"att_{_s}"] = f"att.{_s}"

_FUSED_LERP_SLICES = {
    ".att.x_r": 0,
    ".att.x_w": 1,
    ".att.x_k": 2,
    ".att.x_v": 3,
    ".att.x_a": 4,
    ".att.x_g": 5,
}


def gguf_to_model_name(gguf_name: str) -> str | None:
    """Map a GGUF tensor name to the model ("safetensors") param name.

    Returns None for unrecognized names (they stay addressable under their
    raw GGUF name). Ref: gguf.rs:1173-1329.
    """
    if gguf_name in _TOP_LEVEL_MAP:
        return _TOP_LEVEL_MAP[gguf_name]
    if gguf_name.startswith("blk."):
        rest = gguf_name[4:]
        dot = rest.find(".")
        if dot > 0:
            block, suffix = rest[:dot], rest[dot + 1 :]
            mapped = _BLOCK_SUFFIX_MAP.get(suffix)
            if mapped is not None:
                return f"blocks.{block}.{mapped}"
    return None


_GGML_TO_NUMPY = {
    GgmlDType.F32: np.float32,
    GgmlDType.F16: np.float16,
    GgmlDType.F64: np.float64,
    GgmlDType.I8: np.int8,
    GgmlDType.I16: np.int16,
    GgmlDType.I32: np.int32,
    GgmlDType.I64: np.int64,
}


def _bf16_to_f32(raw: np.ndarray) -> np.ndarray:
    """BF16 bytes (llama.cpp-converted files) → f32: a bf16 is the top
    half of an f32, so widening is a 16-bit shift."""
    return (raw.view(np.uint16).astype(np.uint32) << 16).view(np.float32)


class GgufFile:
    """Parsed GGUF file backed by an mmap (or bytes).

    API mirrors the reference ``Reader`` trait: ``names`` / ``contains`` /
    ``shape`` / ``tensor`` / ``quantized_tensor`` plus metadata access.
    ``allow_quantized_direct=False`` makes ``quantized_tensor`` return
    None, so every matrix loads through dequantization (dense, or by the
    loader's scheme), as ``apps/ppl.py --compare-f16`` of the JAX package
    loads its f16 reference.
    """

    def __init__(self, data, *, allow_quantized_direct: bool = True):
        self._own_mmap = None
        if isinstance(data, (str, Path)):
            f = open(data, "rb")
            self._own_mmap = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
            f.close()
            data = memoryview(self._own_mmap)
        elif isinstance(data, (bytes, bytearray)):
            data = memoryview(data)
        self.data = data
        self.allow_quantized_direct = allow_quantized_direct

        cur = _Cursor(data)
        magic = cur.scalar("<I")
        if magic != GGUF_MAGIC:
            raise GgufError(f"invalid magic number: 0x{magic:08X}")
        self.version = cur.scalar("<I")
        if not (2 <= self.version <= 3):
            raise GgufError(f"unsupported gguf version: {self.version}")
        tensor_count = cur.scalar("<Q")
        kv_count = cur.scalar("<Q")

        self.metadata: dict[str, object] = {}
        for _ in range(kv_count):
            key = cur.string()
            self.metadata[key] = cur.value()

        alignment = int(self.metadata.get("general.alignment", GGUF_DEFAULT_ALIGNMENT))
        # spec: alignment must be a positive power of two (llama.cpp
        # asserts this); a zero/garbage value would otherwise crash the
        # offset rounding below with a bare ZeroDivisionError
        if alignment <= 0 or alignment & (alignment - 1):
            raise GgufError(f"invalid general.alignment: {alignment}")

        self.tensors: dict[str, GgufTensorInfo] = {}
        for _ in range(tensor_count):
            name = cur.string()
            ndim = cur.scalar("<I")
            dims = tuple(cur.scalar("<Q") for _ in range(ndim))
            ttype = GgmlDType(cur.scalar("<I"))
            offset = cur.scalar("<Q")
            self.tensors[name] = GgufTensorInfo(name, dims, ttype, offset)

        self.tensor_data_offset = -(-cur.pos // alignment) * alignment

        # model-name → gguf-name (plus identity entries), ref: gguf.rs:1160-1171
        self.name_map: dict[str, str] = {}
        for gname in self.tensors:
            mapped = gguf_to_model_name(gname)
            if mapped is not None:
                self.name_map[mapped] = gname
            self.name_map[gname] = gname

    def close(self):
        if self._own_mmap is not None:
            self.data.release() if hasattr(self.data, "release") else None
            self._own_mmap.close()
            self._own_mmap = None

    # -- Reader API --------------------------------------------------------

    def names(self) -> list[str]:
        """All addressable names, including virtual fused-lerp slices."""
        out = list(self.name_map)
        for key in self.name_map:
            if key.endswith(".att.time_maa"):
                prefix = key[: -len(".att.time_maa")]
                for s in ("x_r", "x_w", "x_k", "x_v", "x_a", "x_g"):
                    virtual = f"{prefix}.att.{s}"
                    if virtual not in self.name_map:
                        out.append(virtual)
        return out

    def contains(self, name: str) -> bool:
        return name in self.name_map or self._fused_slice(name) is not None

    def _fused_slice(self, name: str) -> tuple[str, int] | None:
        if not name.startswith("blocks.") or ".att.x_" not in name:
            return None
        for suffix, index in _FUSED_LERP_SLICES.items():
            if name.endswith(suffix):
                fused = name[: -len(suffix)] + ".att.time_maa"
                if fused in self.name_map:
                    return fused, index
        return None

    def _info(self, name: str) -> GgufTensorInfo:
        gname = self.name_map.get(name)
        if gname is None:
            raise TensorNotFound(f"tensor not found: {name}")
        return self.tensors[gname]

    def _head_size(self) -> int | None:
        for key in ("rwkv7.wkv.head_size", "rwkv6.wkv.head_size"):
            v = self.metadata.get(key)
            if isinstance(v, int):
                return v
        return None

    def shape(self, name: str) -> tuple[int, ...]:
        """Model-convention shape (2-D+ dims reversed vs on-disk)."""
        fused = self._fused_slice(name)
        if fused is not None:
            info = self._info(fused[0])
            return (info.dims[0],)
        info = self._info(name)
        shape = tuple(int(d) for d in info.dims)
        if len(shape) == 1 and name.endswith(".att.r_k"):
            hs = self._head_size()
            if hs:
                return (shape[0] // hs, hs)
        if len(shape) > 1:
            return tuple(reversed(shape))
        return shape

    def _raw(self, info: GgufTensorInfo) -> np.ndarray:
        start = self.tensor_data_offset + info.offset
        if start + info.data_size > len(self.data):
            raise GgufError(
                f"tensor {info.name!r} data [{start}, {start + info.data_size})"
                f" exceeds file size {len(self.data)}"
            )
        return np.frombuffer(self.data, dtype=np.uint8, count=info.data_size, offset=start)

    def tensor(self, name: str, dtype=np.float16) -> np.ndarray:
        """Materialize a tensor as numpy in model convention.

        Quantized tensors are dequantized through f32 then cast to
        ``dtype`` (the reference casts to f16; pass ``np.float16`` for
        bit-identical values, ref: gguf.rs:1692-1734).
        """
        fused = self._fused_slice(name)
        if fused is not None:
            fused_name, index = fused
            info = self._info(fused_name)
            emb = int(info.dims[0])
            whole = self._plain(info)
            return whole[index * emb : (index + 1) * emb].astype(dtype)

        info = self._info(name)
        shape = self.shape(name)
        if info.dtype in QUANTIZED_TYPES:
            raw = self._raw(info)
            block = GGML_BLOCK_SIZES[info.dtype]
            actual = (raw.size // GGML_TYPE_SIZES[info.dtype]) * block
            values = dequantize(info.dtype, raw, min(actual, info.num_elements))
            if dtype == np.float16 or dtype == np.dtype(np.float16):
                values = values.astype(np.float16)
            out = np.zeros(info.num_elements, dtype=dtype)
            out[: values.size] = values[: info.num_elements]
            return out.reshape(shape)
        return self._plain(info).astype(dtype, copy=False).reshape(shape)

    def _plain(self, info: GgufTensorInfo) -> np.ndarray:
        """A non-block tensor's elements, flat, in their stored numpy type
        (BF16 widened to f32)."""
        raw = self._raw(info)
        if info.dtype == GgmlDType.BF16:
            return _bf16_to_f32(raw)
        np_dtype = _GGML_TO_NUMPY.get(info.dtype)
        if np_dtype is None:
            raise GgufError(f"unsupported tensor type: {info.dtype!r}")
        return raw.view(np_dtype)

    def quantized_tensor(self, name: str) -> tuple[GgmlDType, np.ndarray] | None:
        """Raw quantized blocks for direct-quantized load, or None.

        Every block type that ``Matrix.from_gguf_blocks`` repacks
        (:data:`DIRECT_TYPES`: Q8_0, Q4_0, Q4_1, Q5_0, Q5_1 and Q2_K to
        Q6_K) comes back as ``(dtype, raw bytes)``; any other type, and a
        slice of a fused tensor, returns None and loads through
        dequantization; so does every tensor of a file opened with
        ``allow_quantized_direct=False``.
        """
        if not self.allow_quantized_direct:
            return None
        if self._fused_slice(name) is not None:
            return None
        gname = self.name_map.get(name)
        if gname is None:
            return None
        info = self.tensors[gname]
        if info.dtype not in DIRECT_TYPES:
            return None
        return info.dtype, self._raw(info)
