"""Each kernel module of the port against the JAX package's Pallas kernel
it replaces, on the same numpy inputs, on the CPU.

The JAX side runs its Pallas kernels in interpret mode (as
tests/test_pallas.py does); the port's wrappers, given CPU tensors, run
their plain versions. tests/test_torch_cuda.py holds each CUDA kernel
against its plain version on the card.

Tolerances: the gemvs sum the same f32 terms in another order (the TPU
kernel also folds a +16 code bias into its group sums), so
atol = 1e-4·max|y|; the attention core composes the same f32 ops,
atol = 2e-5. The largest errors seen are recorded beside each test.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import web_rwkv_gguf_tpu.ops.pallas.matmul as jax_mm
from web_rwkv_gguf_tpu.models.matrix import Matrix as JaxMatrix
from web_rwkv_gguf_tpu.ops.pallas import config as pcfg
from web_rwkv_gguf_tpu.ops.pallas.wkv7 import att_core7_step as jax_att_core7_step
from web_rwkv_gguf_tpu.quant.ggml import GgmlDType as JaxGgmlDType
from web_rwkv_gguf_tpu_torch.models.matrix import Matrix as PortMatrix
from web_rwkv_gguf_tpu_torch.ops.cuda import matmul as mm
from web_rwkv_gguf_tpu_torch.ops.cuda import wkv7 as core
from web_rwkv_gguf_tpu_torch.quant import ggml, repack

GEMV_SHAPES = [(256, 512), (512, 256)]


@pytest.fixture(autouse=True)
def _interpret_mode():
    pcfg.interpret = True
    yield
    pcfg.interpret = False


def _spy(monkeypatch, name):
    """Count calls of the JAX package's kernel function ``name``."""
    calls = []
    real = getattr(jax_mm, name)

    def wrapped(*a, **k):
        calls.append(name)
        return real(*a, **k)

    monkeypatch.setattr(jax_mm, name, wrapped)
    return calls


def _weights(m, k, quantize, seed):
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(m, k)) * 0.05).astype(np.float32)
    return np.frombuffer(quantize(w.reshape(-1)), np.uint8)


def _x(n, k, seed):
    return (np.random.default_rng(seed).normal(size=(n, k)) * 0.5).astype(np.float32)


def _q4k_port_arrays(raw, m, k):
    codes = repack.repack_q4_k(raw, m, k)[0]
    return [torch.from_numpy(np.ascontiguousarray(a))
            for a in (codes, *repack.q4k_scale_factors(raw, m, k))]


def _q6k_port_arrays(raw, m, k):
    codes = repack.repack_q6_k(raw, m, k)[0]
    return [torch.from_numpy(np.ascontiguousarray(a))
            for a in (codes, *repack.q6k_scale_factors(raw, m, k))]


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("m,k", GEMV_SHAPES)
def test_q4k_gemv_matches_pallas(monkeypatch, m, k, n):
    """Port Q4_K gemv == JAX quant_matmul through _quant_gemv2_native
    (largest error seen: 1.2e-6 of max|y|)."""
    raw = _weights(m, k, ggml.quantize_q4_k, seed=m + k)
    x = _x(n, k, seed=n)
    jm = JaxMatrix.from_gguf_blocks(JaxGgmlDType.Q4_K, raw, (m, k))
    calls = _spy(monkeypatch, "_quant_gemv2_native")
    want = np.asarray(jax_mm.quant_matmul(jnp.asarray(x), "qk", jm.arrays, m, k))
    assert calls == ["_quant_gemv2_native"]
    before = mm.q4k_gemv.launches
    got = mm.q4k_gemv(torch.from_numpy(x), *_q4k_port_arrays(raw, m, k)).numpy()
    assert mm.q4k_gemv.launches == before  # CPU tensors: the plain version
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("m,k", GEMV_SHAPES)
def test_q6k_gemv_matches_pallas(monkeypatch, m, k, n):
    """Port Q6_K gemv == JAX quant_matmul through
    _quant_gemv2_nomin_native (largest error seen: 1.9e-6 of max|y|)."""
    raw = _weights(m, k, ggml.quantize_q6_k, seed=m * k)
    x = _x(n, k, seed=10 + n)
    jm = JaxMatrix.from_gguf_blocks(JaxGgmlDType.Q6_K, raw, (m, k))
    calls = _spy(monkeypatch, "_quant_gemv2_nomin_native")
    want = np.asarray(jax_mm.quant_matmul(jnp.asarray(x), "qk_nomin", jm.arrays, m, k))
    assert calls == ["_quant_gemv2_nomin_native"]
    before = mm.q6k_gemv.launches
    got = mm.q6k_gemv(torch.from_numpy(x), *_q6k_port_arrays(raw, m, k)).numpy()
    assert mm.q6k_gemv.launches == before
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("kind", ["q4k", "q6k"])
def test_dequantize_matches_jax(kind):
    """The plain versions' f32 weights are the JAX Matrix's, bit for bit."""
    m, k = 16, 512
    if kind == "q4k":
        raw = _weights(m, k, ggml.quantize_q4_k, seed=1)
        got = mm.q4k_dequantize(*_q4k_port_arrays(raw, m, k))
        jm = JaxMatrix.from_gguf_blocks(JaxGgmlDType.Q4_K, raw, (m, k))
    else:
        raw = _weights(m, k, ggml.quantize_q6_k, seed=2)
        got = mm.q6k_dequantize(*_q6k_port_arrays(raw, m, k))
        jm = JaxMatrix.from_gguf_blocks(JaxGgmlDType.Q6_K, raw, (m, k))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jm.dequantize(jnp.float32)))


@pytest.mark.parametrize("n", [1, 2])
def test_q4k_without_native_factors_matches_pallas(monkeypatch, n):
    """A Q4_K matrix whose rows do not hold whole 256-element super-blocks
    (K = 384) has no native factors: the port's CPU path multiplies by the
    weight dequantized from the f32 group products (bit-exact with the
    JAX Matrix), and matches JAX quant_matmul, which takes the packed-pair
    gemv _quant_gemv2 for it (largest error seen: 9.2e-7 of max|y|)."""
    m, k = 256, 384
    raw = _weights(m, k, ggml.quantize_q4_k, seed=5)
    port = PortMatrix.from_gguf_blocks(ggml.GgmlDType.Q4_K, raw, (m, k), device="cpu")
    jm = JaxMatrix.from_gguf_blocks(JaxGgmlDType.Q4_K, raw, (m, k))
    assert "sc6" not in port.arrays
    np.testing.assert_array_equal(port.dequantize().numpy(),
                                  np.asarray(jm.dequantize(jnp.float32)))
    x = _x(n, k, seed=20 + n)
    calls = _spy(monkeypatch, "_quant_gemv2")
    want = np.asarray(jax_mm.quant_matmul(jnp.asarray(x), "qk", jm.arrays, m, k))
    assert calls == ["_quant_gemv2"]
    got = port.matmul(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def _att_inputs(seed, B=3, H=4, K=16):
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.normal(size=s) * 0.5).astype(np.float32)  # noqa: E731
    ins = dict(state=f(B, H, K, K), r=f(B, H, K), w_raw=f(B, H, K), k_raw=f(B, H, K),
               v=f(B, H, K), a_raw=f(B, H, K),
               g=(1 / (1 + np.exp(-f(B, H, K)))).astype(np.float32),
               k_k=f(H, K), k_a=f(H, K), gn_w=1 + 0.1 * f(H, K), gn_b=0.1 * f(H, K),
               r_k=f(H, K))
    mask = np.array([True, False, True][:B])
    return ins, mask


@pytest.mark.parametrize("seed", [1, 2])
def test_att_core7_matches_pallas(seed):
    """Port attention core == JAX att_core7_step (interpret) on active
    lanes; the masked lane keeps its state (largest error seen: 2.4e-7)."""
    ins, mask = _att_inputs(seed)
    eps, l2_eps = 64e-5, 1e-12
    jy, js = jax_att_core7_step(*(jnp.asarray(a) for a in ins.values()),
                                jnp.asarray(mask), eps, l2_eps)
    before = core.att_core7_step.launches
    y, s = core.att_core7_step(*(torch.from_numpy(a) for a in ins.values()),
                               torch.from_numpy(mask), eps, l2_eps)
    assert core.att_core7_step.launches == before
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=0, atol=2e-5)
    np.testing.assert_array_equal(s.numpy()[1], ins["state"][1])
    np.testing.assert_allclose(y.numpy()[mask], np.asarray(jy)[mask], rtol=0, atol=2e-5)
