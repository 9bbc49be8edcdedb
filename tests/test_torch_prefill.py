"""The prefill slice of the port against the JAX package, on the CPU, on
the same numpy inputs: the routing of quantized matmuls between the gemv
and the dequant-GEMM, the dequant-GEMMs' plain versions against the slab
branch of ``quant_matmul``, the WKV scan's plain version against
``wkv7_pallas`` and the chunk-parallel WKV against the JAX one.

The JAX side runs its Pallas kernels in interpret mode, as
tests/test_torch_kernels.py does. Tolerances: the matmuls sum the same
f32 terms (the gemv) or the same bf16 products (the GEMM) in another
order, atol = 1e-4·max|y|; the WKV scan composes the same f32 ops,
atol = 2e-5; the chunk-parallel WKV runs the same algorithm through
another library's matmuls, atol = 1e-4·max|y|. The largest errors seen
are recorded beside each test.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import web_rwkv_gguf_tpu.ops.pallas.matmul as jax_mm
from web_rwkv_gguf_tpu.models.matrix import Matrix as JaxMatrix
from web_rwkv_gguf_tpu.ops.pallas import config as pcfg
from web_rwkv_gguf_tpu.ops.pallas.wkv7 import wkv7_pallas
from web_rwkv_gguf_tpu.ops.wkv_chunked import wkv7_chunked as jax_wkv7_chunked
from web_rwkv_gguf_tpu.quant.ggml import GgmlDType as JaxGgmlDType
import web_rwkv_gguf_tpu_torch.models.matrix as port_matrix
from web_rwkv_gguf_tpu_torch.ops.cuda import matmul as mm
from web_rwkv_gguf_tpu_torch.ops.cuda import wkv7 as core
from web_rwkv_gguf_tpu_torch.ops.wkv_chunked import wkv7_chunked
from web_rwkv_gguf_tpu_torch.quant import ggml

JAX_GEMVS = ("_quant_gemv2_native", "_quant_gemv2_nomin_native", "_quant_gemv2",
             "_quant_gemv")


@pytest.fixture(autouse=True)
def _interpret_mode():
    pcfg.interpret = True
    yield
    pcfg.interpret = False


@pytest.fixture
def jax_gemv_calls(monkeypatch):
    """Names of the JAX package's gemv functions called (none: the slab
    branch ran)."""
    calls = []
    for name in JAX_GEMVS:
        real = getattr(jax_mm, name)

        def wrapped(*a, _real=real, _name=name, **k):
            calls.append(_name)
            return _real(*a, **k)

        monkeypatch.setattr(jax_mm, name, wrapped)
    return calls


@pytest.fixture
def port_calls(monkeypatch):
    """Names of the port's kernel wrappers ``Matrix.matmul`` called."""
    calls = []
    for name in ("q4k_gemv", "q4k_gemm", "q6k_gemv", "q6k_gemm"):
        real = getattr(port_matrix, name)

        def wrapped(*a, _real=real, _name=name, **k):
            calls.append(_name)
            return _real(*a, **k)

        monkeypatch.setattr(port_matrix, name, wrapped)
    return calls


def _raw(m, k, kind, seed):
    w = (np.random.default_rng(seed).normal(size=(m, k)) * 0.05).astype(np.float32)
    quantize = ggml.quantize_q4_k if kind == "qk" else ggml.quantize_q6_k
    return np.frombuffer(quantize(w.reshape(-1)), np.uint8)


def _x(n, k, seed):
    return (np.random.default_rng(seed).normal(size=(n, k)) * 0.5).astype(np.float32)


def _dtype(kind, pkg):
    return getattr(pkg, "Q4_K" if kind == "qk" else "Q6_K")


def _assert_close_to_max(got, want, rel):
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


@pytest.mark.parametrize("kind,m,k,n,gemv", [
    ("qk", 256, 3072, 2, True),
    ("qk", 256, 3072, 3, False),  # gemv-only routing is 3.1e-3 off here
    ("qk", 256, 3072, 8, False),
    ("qk", 256, 768, 8, True),
    ("qk", 256, 768, 9, False),
    ("qk", 256, 768, 64, False),
    ("qk_nomin", 256, 768, 5, True),
    ("qk_nomin", 256, 768, 6, False),
])
def test_matmul_routes_as_quant_matmul(jax_gemv_calls, port_calls, kind, m, k, n, gemv):
    """``Matrix.matmul`` takes the gemv exactly where JAX ``quant_matmul``
    does and matches it in either class (largest error seen: 2.0e-6 of
    max|y| on the gemv, 4.7e-7 on the GEMM). Sending every n ≤ 8 to the
    gemv, as the port did before it had the GEMM, is 3.1e-3 off at Q4_K
    [256, 3072] n=3, 4.2e-3 at n=8 and 1.8e-3 at Q6_K n=6."""
    raw = _raw(m, k, kind, seed=m + k + n)
    x = _x(n, k, seed=n)
    jm = JaxMatrix.from_gguf_blocks(_dtype(kind, JaxGgmlDType), raw, (m, k))
    want = np.asarray(jax_mm.quant_matmul(jnp.asarray(x), kind, jm.arrays, m, k))
    assert bool(jax_gemv_calls) == gemv
    pm = port_matrix.Matrix.from_gguf_blocks(_dtype(kind, ggml.GgmlDType), raw, (m, k),
                                             device="cpu")
    assert pm.takes_gemv(n) == gemv
    got = pm.matmul(torch.from_numpy(x)).numpy()
    family = "q4k" if kind == "qk" else "q6k"
    assert port_calls == [f"{family}_{'gemv' if gemv else 'gemm'}"]
    _assert_close_to_max(got, want, 1e-4)


@pytest.mark.parametrize("n", [9, 48])
@pytest.mark.parametrize("kind", ["qk", "qk_nomin"])
def test_gemm_plain_matches_slab(jax_gemv_calls, kind, n):
    """``q4k_gemm_plain`` / ``q6k_gemm_plain`` against the slab branch of
    JAX ``quant_matmul`` (largest error seen: 5.1e-7 of max|y|)."""
    m, k = 256, 768
    raw = _raw(m, k, kind, seed=7 * n)
    x = _x(n, k, seed=100 + n)
    jm = JaxMatrix.from_gguf_blocks(_dtype(kind, JaxGgmlDType), raw, (m, k))
    want = np.asarray(jax_mm.quant_matmul(jnp.asarray(x), kind, jm.arrays, m, k))
    assert jax_gemv_calls == []
    pm = port_matrix.Matrix.from_gguf_blocks(_dtype(kind, ggml.GgmlDType), raw, (m, k),
                                             device="cpu")
    if kind == "qk":
        a = pm.arrays
        plain, args = mm.q4k_gemm_plain, (a["codes"], a["sc6"], a["mn6"], a["d8"], a["dm8"])
        wrapper = mm.q4k_gemm
    else:
        a = pm.arrays
        plain, args = mm.q6k_gemm_plain, (a["codes"], a["q6s"], a["q6d"])
        wrapper = mm.q6k_gemm
    before = wrapper.launches
    got = wrapper(torch.from_numpy(x), *args)
    assert wrapper.launches == before  # CPU tensors: the plain version
    np.testing.assert_array_equal(got.numpy(), plain(torch.from_numpy(x), *args).numpy())
    _assert_close_to_max(got.numpy(), want, 1e-4)


def test_gemm_without_native_factors_matches_slab(jax_gemv_calls):
    """A Q4_K matrix with K = 384 (no native factors) at n = 16 runs the
    GEMM's plain version from its f32 group products on the CPU and
    matches the slab branch (largest error seen: 4.3e-7 of max|y|)."""
    m, k, n = 256, 384, 16
    raw = _raw(m, k, "qk", seed=9)
    x = _x(n, k, seed=3)
    jm = JaxMatrix.from_gguf_blocks(JaxGgmlDType.Q4_K, raw, (m, k))
    want = np.asarray(jax_mm.quant_matmul(jnp.asarray(x), "qk", jm.arrays, m, k))
    assert jax_gemv_calls == []
    pm = port_matrix.Matrix.from_gguf_blocks(ggml.GgmlDType.Q4_K, raw, (m, k), device="cpu")
    assert "sc6" not in pm.arrays
    _assert_close_to_max(pm.matmul(torch.from_numpy(x)).numpy(), want, 1e-4)


def _wkv_inputs(B, T, H, K, lens, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.normal(size=s) * 0.5).astype(np.float32)  # noqa: E731
    sig = lambda a: 1 / (1 + np.exp(-a))  # noqa: E731
    kk = f(B, T, H, K)
    kk = (kk / np.linalg.norm(kk, axis=-1, keepdims=True)).astype(np.float32)
    w = np.exp(-0.606531 * sig(f(B, T, H, K))).astype(np.float32)
    b = (kk * sig(f(B, T, H, K))).astype(np.float32)
    mask = np.arange(T)[None, :] < np.asarray(lens)[:, None]
    return [f(B, H, K, K), f(B, T, H, K), w, f(B, T, H, K), f(B, T, H, K), -kk, b, mask]


@pytest.mark.parametrize("T,lens", [(2, (2, 1, 0)), (7, (7, 3, 0)), (33, (33, 20, 1))])
def test_wkv7_scan_plain_matches_pallas(T, lens):
    """``wkv7_scan`` (plain) against ``wkv7_pallas`` (interpret) on ragged
    masks: y at every position, padded ones included, and the state; a
    zero-length lane keeps its state exactly (largest error seen:
    7.2e-7)."""
    ins = _wkv_inputs(3, T, 2, 16, lens, seed=T)
    jy, js = wkv7_pallas(*(jnp.asarray(a) for a in ins))
    before = core.wkv7_scan.launches
    y, s = core.wkv7_scan(*(torch.from_numpy(a) for a in ins))
    assert core.wkv7_scan.launches == before
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=2e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=0, atol=2e-5)
    if 0 in lens:
        np.testing.assert_array_equal(s.numpy()[lens.index(0)], ins[0][lens.index(0)])


@pytest.mark.parametrize("T", [128, 130])
def test_wkv7_chunked_matches_jax(T):
    """The port's ``wkv7_chunked`` against the JAX one on ragged lengths:
    y at the valid positions and the state (largest error seen: 2.1e-7 of
    max|y|, 1.9e-7 of max|state|)."""
    lens = (T, T - 37)
    ins = _wkv_inputs(2, T, 2, 16, lens, seed=T + 1)
    jy, js = jax_wkv7_chunked(*(jnp.asarray(a) for a in ins))
    y, s = wkv7_chunked(*(torch.from_numpy(a) for a in ins))
    mask = ins[-1]
    _assert_close_to_max(y.numpy()[mask], np.asarray(jy)[mask], 1e-4)
    _assert_close_to_max(s.numpy(), np.asarray(js), 1e-4)
