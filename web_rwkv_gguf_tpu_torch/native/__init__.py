"""Native (C++) host code: GGML block dequantization, the Q4_K repack and
the tokenizer's encode loop.

``dequant.cpp`` and ``tokenizer.cpp`` are compiled on first use with g++
into one shared library in ``_build/`` beside them (named after the
sources' hash, so an edit builds anew) and loaded through ctypes. This is
host code for the load path and the tokenizer, not a device kernel. Every
entry point has a numpy or Python counterpart (``quant/ggml.py``,
``quant/repack.py``, ``utils/tokenizer.py``), bit for bit the same, which
the tests hold the C++ against; a machine without g++ falls back to them
with a logged warning. Any other build failure raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

log = logging.getLogger(__name__)

_HERE = Path(__file__).parent
_SRCS = [_HERE / "dequant.cpp", _HERE / "tokenizer.cpp"]
BUILD_DIR = _HERE / "_build"
# -ffp-contract=off: no fused multiply-adds (g++ fuses them by default on
# aarch64), so every host rounds as numpy does
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread", "-ffp-contract=off")
_DEQUANT_KINDS = ("q8_0", "q4_0", "q4_1", "q5_0", "q5_1", "q4_k", "q5_k", "q6_k", "q3_k",
                  "q2_k")
_lib = None
_tried = False


def library_path(build_dir: Path = BUILD_DIR) -> Path:
    """Where the library for the current sources lives."""
    src = "".join(p.read_text() for p in _SRCS) + " ".join(FLAGS)
    tag = hashlib.sha256(src.encode()).hexdigest()[:16]
    return Path(build_dir) / f"native_{tag}.so"


def build(build_dir: Path = BUILD_DIR) -> Path:
    """Compile the sources into ``build_dir`` unless the library for them
    is there already; returns its path. The library is written to a
    temporary file in ``build_dir`` and moved into place in one
    ``os.replace``, so processes that build at once each leave a whole
    library and the last one wins."""
    so = library_path(build_dir)
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".native_", suffix=".so", dir=so.parent)
    os.close(fd)
    try:
        out = subprocess.run(["g++", *FLAGS, *map(str, _SRCS), "-o", tmp],
                             capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(f"g++ failed to build the native library:\n{out.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    for kind in _DEQUANT_KINDS:
        fn = getattr(lib, f"dequant_{kind}")
        fn.restype = None
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
    lib.repack_q4_k.restype = None
    lib.repack_q4_k.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.tok_build.restype = ctypes.c_void_p
    lib.tok_build.argtypes = [ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
                              ctypes.c_void_p]
    lib.tok_free.restype = None
    lib.tok_free.argtypes = [ctypes.c_void_p]
    lib.tok_encode.restype = ctypes.c_int64
    lib.tok_encode.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                               ctypes.c_void_p, ctypes.c_int64]
    return lib


def get_lib() -> ctypes.CDLL | None:
    """The loaded library, built at the first call; None (with a logged
    warning) only where there is no g++."""
    global _lib, _tried
    if _tried:
        return _lib
    if shutil.which("g++") is None:
        log.warning("no g++ on this machine: the native dequant, repack and tokenizer "
                    "are not built; numpy and Python run in their place")
        _tried = True
        return None
    _lib = _bind(ctypes.CDLL(str(build())))
    _tried = True
    return _lib


_BLOCK_BYTES = {"q8_0": 34, "q4_0": 18, "q4_1": 20, "q5_0": 22, "q5_1": 24,
                "q4_k": 144, "q5_k": 176, "q6_k": 210, "q3_k": 110, "q2_k": 84}
_BLOCK_ELEMS = {"q8_0": 32, "q4_0": 32, "q4_1": 32, "q5_0": 32, "q5_1": 32,
                "q4_k": 256, "q5_k": 256, "q6_k": 256, "q3_k": 256, "q2_k": 256}


def dequantize(kind: str, data, num_elements: int) -> np.ndarray | None:
    """Dequantize ``kind`` blocks (``"q4_k"`` ...) to f32 in C++; None
    where there is no library or no C++ dequantizer for ``kind``."""
    lib = get_lib()
    if lib is None or kind not in _BLOCK_BYTES:
        return None
    buf = np.ascontiguousarray(np.frombuffer(data, np.uint8))
    n_blocks = buf.size // _BLOCK_BYTES[kind]
    if n_blocks * _BLOCK_ELEMS[kind] < num_elements:
        raise ValueError(f"{n_blocks} {kind} blocks hold fewer than {num_elements} elements")
    out = np.empty(n_blocks * _BLOCK_ELEMS[kind], np.float32)
    getattr(lib, f"dequant_{kind}")(buf.ctypes.data, n_blocks, out.ctypes.data)
    return out[:num_elements]


class NativeVocab:
    """Handle to a C++-side vocabulary table (see tokenizer.cpp)."""

    def __init__(self, lib, handle):
        self._lib = lib
        self._handle = handle

    def __del__(self):  # interpreter shutdown may have torn down ctypes
        try:
            if self._handle:
                self._lib.tok_free(self._handle)
                self._handle = None
        except Exception:
            pass

    def encode(self, data: bytes) -> np.ndarray:
        """Greedy longest-match encode of raw bytes to int32 token ids.
        Raises ValueError at the byte offset where the Python encoder
        would."""
        n = len(data)
        cap = max(16, n)  # tokens never outnumber bytes
        out = np.empty(cap, np.int32)
        buf = np.frombuffer(data, np.uint8) if n else np.empty(0, np.uint8)
        count = self._lib.tok_encode(self._handle, buf.ctypes.data if n else None, n,
                                     out.ctypes.data, cap)
        if count < 0:
            pos = -count - 1
            raise ValueError(f"no matching token at byte offset {pos} ({data[pos:pos+8]!r})")
        return out[:count].copy()


def build_vocab(entries) -> NativeVocab | None:
    """The native vocabulary of ``[(bytes, id), ...]``; None where there
    is no library."""
    lib = get_lib()
    if lib is None:
        return None
    blob = b"".join(b for b, _ in entries)
    offsets = np.zeros(len(entries) + 1, np.int64)
    np.cumsum([len(b) for b, _ in entries], out=offsets[1:])
    ids = np.asarray([tid for _, tid in entries], np.int32)
    handle = lib.tok_build(len(entries), blob if blob else None, offsets.ctypes.data,
                           ids.ctypes.data)
    if not handle:
        raise RuntimeError("tok_build returned no vocabulary")
    return NativeVocab(lib, handle)


def repack_q4_k(data, m: int, k: int):
    """The split-halves Q4_K repack in C++ (``quant.repack.repack_q4_k``'s
    arrays), or None where there is no library."""
    lib = get_lib()
    if lib is None:
        return None
    buf = np.ascontiguousarray(np.frombuffer(data, np.uint8))
    n_blocks = buf.size // 144
    if n_blocks * 256 != m * k:
        raise ValueError(f"Q4_K stream of {n_blocks} blocks does not hold [{m}, {k}]")
    codes = np.empty((m, k // 2), np.uint8)
    scales = np.empty((m, k // 32), np.float32)
    mins = np.empty((m, k // 32), np.float32)
    lib.repack_q4_k(buf.ctypes.data, n_blocks, k, codes.ctypes.data, scales.ctypes.data,
                    mins.ctypes.data)
    return codes, scales, mins
