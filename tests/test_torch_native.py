"""The port's native (C++) host library against numpy, on the CPU.

Bit for bit: each of the ten ``dequant_*`` entries against the port's
numpy dequantizer and the JAX package's, on blocks from the port's
quantizers and on random blocks; ``repack_q4_k`` against the numpy
repack. The library builds into the gitignored ``native/_build/``, two
processes building at once leave one loadable library, and the load path
(``quant.ggml.dequantize``, ``quant.repack.repack_q4_k``) goes through it;
only a machine without g++ falls back to numpy, with a warning.
"""

import logging
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import web_rwkv_gguf_tpu.quant.ggml as jax_ggml
from web_rwkv_gguf_tpu_torch import native
from web_rwkv_gguf_tpu_torch.quant import ggml, repack

ROOT = Path(__file__).resolve().parents[1]
KINDS = ("q8_0", "q4_0", "q4_1", "q5_0", "q5_1", "q4_k", "q5_k", "q6_k", "q3_k", "q2_k")


def test_library_is_built_into_the_ignored_directory():
    lib = native.get_lib()
    assert lib is not None  # this machine has g++
    path = Path(lib._name)
    assert path.parent == ROOT / "web_rwkv_gguf_tpu_torch" / "native" / "_build"
    assert path == native.library_path()
    ignored = (ROOT / ".gitignore").read_text().splitlines()
    assert "web_rwkv_gguf_tpu_torch/native/_build/" in ignored


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _random_blocks(kind, n_blocks=48, seed=0):
    """Random block bytes with sane f16 scale fields (as tests/test_native.py
    makes them)."""
    block_bytes = native._BLOCK_BYTES[kind]
    rng = np.random.default_rng(seed)
    b = bytearray(rng.integers(0, 256, n_blocks * block_bytes, dtype=np.uint8).tobytes())
    for blk in range(n_blocks):
        for off in (0, 2, 208, 80, 82, 108):
            if off + 2 <= block_bytes:
                b[blk * block_bytes + off:blk * block_bytes + off + 2] = np.float16(
                    rng.uniform(0.001, 0.1)).tobytes()
    return bytes(b)


@pytest.mark.parametrize("kind", KINDS)
def test_native_dequant_bit_for_bit(kind):
    dtype = ggml.GgmlDType[kind.upper()]
    rng = np.random.default_rng(KINDS.index(kind))
    w = (rng.normal(size=256 * 24) * 0.1).astype(np.float32)
    w[:256] *= 40.0  # a wide super-block beside narrow ones
    for raw in (getattr(ggml, f"quantize_{kind}")(w), _random_blocks(kind)):
        n = len(raw) // native._BLOCK_BYTES[kind] * native._BLOCK_ELEMS[kind]
        got = native.dequantize(kind, raw, n)
        assert got.dtype == np.float32 and got.shape == (n,)
        want = ggml._DEQUANTIZERS[dtype](raw, n)
        np.testing.assert_array_equal(_bits(got), _bits(want))
        jax_want = jax_ggml._DEQUANTIZERS[jax_ggml.GgmlDType[kind.upper()]](raw, n)
        np.testing.assert_array_equal(_bits(got), _bits(jax_want))
        # the load path's entry point takes the C++ result
        np.testing.assert_array_equal(_bits(ggml.dequantize(dtype, raw, n - 7)),
                                      _bits(want[:n - 7]))


def test_native_dequant_refuses_short_data():
    raw = ggml.quantize_q8_0(np.ones(64, np.float32))
    with pytest.raises(ValueError, match="fewer than"):
        native.dequantize("q8_0", raw, 65)


@pytest.mark.parametrize("M,K", [(16, 512), (8, 2688), (32, 768)])
def test_native_repack_q4k_bit_for_bit(M, K):
    rng = np.random.default_rng(1)
    # K=2688 is not a multiple of 256: super-blocks straddle rows
    w = (rng.normal(size=(M, K)) * 0.1).astype(np.float32)
    raw = np.frombuffer(ggml.quantize_q4_k(w.reshape(-1)), np.uint8)
    got = native.repack_q4_k(raw, M, K)
    want = repack.repack_q4_k_numpy(raw, M, K)
    for g, w_ in zip(got, want):
        assert g.dtype == w_.dtype and g.shape == w_.shape
        np.testing.assert_array_equal(g, w_)
    for g, w_ in zip(repack.repack_q4_k(raw, M, K), want):
        np.testing.assert_array_equal(g, w_)
    with pytest.raises(ValueError, match="does not hold"):
        repack.repack_q4_k(raw, M + 1, K)


def test_concurrent_builds_leave_one_library(tmp_path):
    """Two processes build into one empty directory at once: one library,
    no temporary file left, and it loads and dequantizes."""
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r})\n"
            "from web_rwkv_gguf_tpu_torch import native\n"
            f"print(native.build({str(tmp_path)!r}))\n")
    procs = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    files = sorted(tmp_path.iterdir())
    assert [f.name for f in files] == [native.library_path(tmp_path).name]
    assert {o.strip() for o, _ in outs} == {str(files[0])}
    lib = native._bind(__import__("ctypes").CDLL(str(files[0])))
    raw = ggml.quantize_q8_0(np.linspace(-1, 1, 64, dtype=np.float32))
    out = np.empty(64, np.float32)
    lib.dequant_q8_0(np.frombuffer(raw, np.uint8).ctypes.data, 2, out.ctypes.data)
    np.testing.assert_array_equal(out, ggml.dequantize_q8_0(raw, 64))


def test_without_gpp_numpy_runs_with_a_warning(monkeypatch, caplog):
    """No g++: get_lib warns and returns None, and the load path's entry
    points give numpy's results; no other failure falls back."""
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with caplog.at_level(logging.WARNING, logger=native.__name__):
        assert native.get_lib() is None
    assert "no g++" in caplog.text
    raw = ggml.quantize_q4_k(np.linspace(-1, 1, 512, dtype=np.float32))
    assert native.dequantize("q4_k", raw, 512) is None
    np.testing.assert_array_equal(ggml.dequantize(ggml.GgmlDType.Q4_K, raw, 512),
                                  ggml.dequantize_q4_k(raw, 512))
    got = repack.repack_q4_k(raw, 2, 256)
    for g, w_ in zip(got, repack.repack_q4_k_numpy(raw, 2, 256)):
        np.testing.assert_array_equal(g, w_)


def test_build_failure_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "FLAGS", native.FLAGS + ("-fno-such-flag",))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build(tmp_path)
    assert list(tmp_path.iterdir()) == []
