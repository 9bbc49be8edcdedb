"""Build the port's CUDA kernels from ``csrc/`` and bind them with ctypes.

Each source compiles with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds,
not minutes). A library is named after the content hash of its source
and of the shared headers (``csrc/*.cuh``), and
lands in ``_build/`` beside this file (listed in ``.gitignore``), so a
changed source rebuilds and an unchanged one loads at once. Nothing is
built when the module is imported: :func:`build` runs on first use, or
ahead of time from ``chip_smoke.py``, with one ``nvcc`` per source, all
started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("_build")
KERNELS = ("q4k_gemv", "q6k_gemv", "qs_gemv", "qkb_gemv", "nf4_gemv", "gemv_grouped",
           "att_core7", "qk_gemm", "wkv7_scan", "layer7", "wkv6_scan", "layer56",
           "wkv4_scan")  # csrc/<name>.cu
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler; raises when there is none."""
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.access(path, os.X_OK):
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "where the CUDA toolkit is installed")
    return path


def library_path(name: str) -> Path:
    """Where the library of kernel ``name`` lives once built."""
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names=KERNELS) -> dict[str, str]:
    """Compile every kernel in ``names`` whose library is missing, all in
    parallel. Returns each compiled kernel's compiler report (registers,
    shared memory, spills from ``-Xptxas -v``); raises with the
    compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)  # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build((name,))
        lib = _loaded[name] = ctypes.CDLL(str(path))
    return lib
