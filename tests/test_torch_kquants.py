"""Every GGML block type the JAX loader takes, in the port, against the
JAX package on the CPU, on the same numpy inputs: the quantizers,
dequantizers, repackers and native scale factorizations; the loaded
matrices and whole models; the gemv/GEMM gate; and the plain versions of
the scaled-code gemv (``qs_gemv``), the Q5_K/Q2_K gemv (``qkb_gemv``) and
their dequant-GEMMs (``qs_gemm``, ``qkb_gemm``) against the JAX kernels
they replace.

The JAX side runs its Pallas kernels in interpret mode, as
tests/test_torch_kernels.py does, and a spy on the JAX kernel function
proves the route it took. Tolerances: the quantizers, dequantizers,
repackers and loaders are bit-exact; the matmuls sum the same f32 terms
(the gemvs) or the same bf16 products (the GEMMs) in another order, and
the TPU gemvs fold a code bias into their group sums, atol = 1e-4·max|y|.
The largest errors seen are recorded beside each test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import web_rwkv_gguf_tpu.ops.pallas.matmul as jax_mm
from web_rwkv_gguf_tpu.gguf import GgufFile as JaxGgufFile
from web_rwkv_gguf_tpu.models import load_model as jax_load_model
from web_rwkv_gguf_tpu.models.matrix import Matrix as JaxMatrix
from web_rwkv_gguf_tpu.ops.pallas import config as pcfg
from web_rwkv_gguf_tpu.quant import ggml as jax_ggml
from web_rwkv_gguf_tpu.quant import repack as jax_repack
from web_rwkv_gguf_tpu.quant.ggml import GgmlDType as JaxGgmlDType
import web_rwkv_gguf_tpu_torch.models.matrix as port_matrix
from web_rwkv_gguf_tpu_torch.gguf import GgufFile
from web_rwkv_gguf_tpu_torch.models import Matrix, load_model, params_from_numpy
from web_rwkv_gguf_tpu_torch.ops.cuda import matmul as mm
from web_rwkv_gguf_tpu_torch.quant import ggml, repack
from web_rwkv_gguf_tpu_torch.quant.ggml import GgmlDType
from web_rwkv_gguf_tpu_torch.utils.synthetic import make_v6_gguf, make_v7_gguf

MATMUL_TOL = 1e-4
KINDS = ("Q8_0", "Q4_0", "Q4_1", "Q5_0", "Q5_1", "Q2_K", "Q3_K", "Q4_K", "Q5_K", "Q6_K")
JAX_GEMVS = ("_quant_gemv2_native", "_quant_gemv2_nomin_native", "_quant_gemv2_b_native",
             "_quant_gemv2", "_quant_gemv")
PORT_KERNELS = ("q4k_gemv", "q4k_gemm", "q6k_gemv", "q6k_gemm", "qkb_gemv", "qkb_gemm",
                "qs_gemv", "qs_gemm")


@pytest.fixture(autouse=True)
def _interpret_mode():
    pcfg.interpret = True
    yield
    pcfg.interpret = False


def _spy(monkeypatch, module, names):
    """Names of ``module``'s functions ``names`` called, in order."""
    calls = []
    for name in names:
        real = getattr(module, name)

        def wrapped(*a, _real=real, _name=name, **k):
            calls.append(_name)
            return _real(*a, **k)

        monkeypatch.setattr(module, name, wrapped)
    return calls


@pytest.fixture
def jax_calls(monkeypatch):
    return _spy(monkeypatch, jax_mm, JAX_GEMVS)


@pytest.fixture
def port_calls(monkeypatch):
    return _spy(monkeypatch, port_matrix, PORT_KERNELS)


def _values(n, seed):
    """Weights with a few all-zero and constant 32-blocks (the quantizers'
    zero-scale branches)."""
    v = (np.random.default_rng(seed).normal(size=n) * 0.05).astype(np.float32)
    v[:32] = 0.0
    v[64:96] = 0.01
    return v


def _raw(kind, m, k, seed):
    q = getattr(ggml, f"quantize_{kind.lower()}")
    return np.frombuffer(q(_values(m * k, seed)), np.uint8)


def _x(n, k, seed):
    return (np.random.default_rng(seed).normal(size=(n, k)) * 0.5).astype(np.float32)


def _close_to_max(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=rel * np.abs(want).max())


@pytest.mark.parametrize("kind", KINDS)
def test_quantizer_bytes_match_jax(kind):
    v = _values(8 * 512, seed=1)
    name = f"quantize_{kind.lower()}"
    assert getattr(ggml, name)(v) == getattr(jax_ggml, name)(v)


@pytest.mark.parametrize("kind", KINDS)
def test_dequantizer_bits_match_jax(kind):
    raw = _raw(kind, 8, 512, seed=2)
    got = ggml.dequantize(GgmlDType[kind], raw, 8 * 512)
    want = jax_ggml._DEQUANTIZERS[JaxGgmlDType[kind]](raw, 8 * 512)
    assert got.dtype == want.dtype  # f32; f64 for Q3_K, as the JAX package's
    np.testing.assert_array_equal(got, want)


REPACKERS = [
    ("repack_q4_k", "Q4_K"), ("q4k_scale_factors", "Q4_K"), ("repack_q5_k", "Q5_K"),
    ("q5k_scale_factors", "Q5_K"), ("repack_q6_k", "Q6_K"), ("q6k_scale_factors", "Q6_K"),
    ("repack_q3_k", "Q3_K"), ("q3k_scale_factors", "Q3_K"), ("repack_q2_k", "Q2_K"),
    ("q2k_scale_factors", "Q2_K"), ("repack_q8_0", "Q8_0"), ("repack_q4_0", "Q4_0"),
    ("repack_q4_0_bytes", "Q4_0"), ("repack_q4_1", "Q4_1"), ("repack_q4_1_bytes", "Q4_1"),
    ("repack_q5_0", "Q5_0"), ("repack_q5_1", "Q5_1"),
]


@pytest.mark.parametrize("m,k", [(8, 512), (16, 384)])
@pytest.mark.parametrize("fn,kind", REPACKERS)
def test_repacker_matches_jax(fn, kind, m, k):
    """Every output array equal in values, dtype and shape (the scale
    factorizations are None for rows without whole super-blocks)."""
    raw = _raw(kind, m, k, seed=m + k)
    got, want = getattr(repack, fn)(raw, m, k), getattr(jax_repack, fn)(raw, m, k)
    if want is None:
        assert got is None
        return
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_repacker_rejects_a_stream_of_another_size():
    with pytest.raises(ValueError, match="Q8_0 stream"):
        repack.repack_q8_0(_raw("Q8_0", 8, 64, seed=0), 8, 96)


# (kind, M, K): every kind at whole super-blocks, the K-quants also at K
# % 256 != 0 (f32 group scales), the legacy 4-bit kinds also at K % 64 !=
# 0 (byte codes)
MATRIX_CASES = ([(k, 256, 512) for k in KINDS]
                + [(k, 256, 384) for k in ("Q2_K", "Q3_K", "Q4_K", "Q5_K", "Q6_K")]
                + [(k, 256, 96) for k in ("Q4_0", "Q4_1")])


def _matrices(kind, m, k, seed):
    raw = _raw(kind, m, k, seed)
    jm = JaxMatrix.from_gguf_blocks(JaxGgmlDType[kind], raw, (m, k))
    pm = Matrix.from_gguf_blocks(GgmlDType[kind], raw, (m, k), device="cpu")
    return jm, pm


@pytest.mark.parametrize("kind,m,k", MATRIX_CASES)
def test_from_gguf_blocks_matches_jax(kind, m, k):
    """The port's matrix equals params_from_numpy of the JAX one: kind,
    keys (the JAX ones that survive the TPU-operand drop) and arrays."""
    jm, pm = _matrices(kind, m, k, seed=3)
    ref = params_from_numpy(jax.device_get(jm), device="cpu")
    assert (pm.kind, pm.shape) == (ref.kind, ref.shape)
    assert set(pm.arrays) == set(ref.arrays)
    for key, a in ref.arrays.items():
        assert pm.arrays[key].dtype == a.dtype and torch.equal(pm.arrays[key], a), key
    np.testing.assert_array_equal(
        pm.dequantize().numpy(), np.asarray(jm.dequantize(jnp.float32)))


# the JAX kernel each form's gemv replaces, by (kind, K)
def _jax_gemv(kind, k):
    if kind == "Q4_K" and k % 256 == 0:
        return "_quant_gemv2_native"
    if kind in ("Q6_K", "Q3_K") and k % 256 == 0:
        return "_quant_gemv2_nomin_native"
    if kind in ("Q5_K", "Q2_K") and k % 256 == 0:
        return "_quant_gemv2_b_native"
    return "_quant_gemv2"


def _port_family(pm):
    a = pm.arrays
    if "sc6" in a:
        return "q4k" if pm.kind == "qk" else "qkb"
    return "q6k" if "q6s" in a else "qs"


@pytest.mark.parametrize("n", [1, 2, 8])
@pytest.mark.parametrize("kind,m,k", MATRIX_CASES)
def test_gemv_plain_matches_jax_gemv(monkeypatch, jax_calls, port_calls, kind, m, k, n):
    """``Matrix.matmul`` at n ≤ 8 takes its form's gemv where JAX
    ``quant_matmul`` takes the kernel it replaces, and matches it (largest
    error seen: 6.3e-5 of max|y|, Q2_K at K=384 with f32 scales, n=1: the
    JAX kernel folds a +272·s bias into 2-bit codes and cancels it after
    its sums). The JAX gemvs run their
    narrow (group-expansion) form at every n here: above n = 2 they may
    take their wide form, which rounds the bias-folded weight (q + 272)·s
    to two bf16 halves, and on 2- and 3-bit codes the fold's cancellation
    leaves 2.6e-3 of max|y| (Q2_K and Q3_K at K=384, n=8); the narrow form
    is the exact f32 class that the port computes."""
    monkeypatch.setattr(pcfg, "wide_batch", 8)
    jm, pm = _matrices(kind, m, k, seed=m + k + n)
    x = _x(n, k, seed=n)
    want = np.asarray(jax_mm.quant_matmul(jnp.asarray(x), jm.kind, jm.arrays, m, k))
    assert jax_calls == [_jax_gemv(kind, k)]
    got = pm.matmul(torch.from_numpy(x)).numpy()
    assert port_calls == [f"{_port_family(pm)}_gemv"]
    _close_to_max(got, want, MATMUL_TOL)


@pytest.mark.parametrize("n", [9, 48])
@pytest.mark.parametrize("kind,m,k", MATRIX_CASES)
def test_gemm_plain_matches_jax_slab(jax_calls, port_calls, kind, m, k, n):
    """Past the gate: the port's dequant-GEMM of the form against the slab
    branch of JAX ``quant_matmul`` (largest error seen: 6.5e-7 of
    max|y|, Q5_0 at n=48)."""
    jm, pm = _matrices(kind, m, k, seed=7 * n + k)
    x = _x(n, k, seed=100 + n)
    want = np.asarray(jax_mm.quant_matmul(jnp.asarray(x), jm.kind, jm.arrays, m, k))
    assert jax_calls == []
    got = pm.matmul(torch.from_numpy(x)).numpy()
    assert port_calls == [f"{_port_family(pm)}_gemm"]
    _close_to_max(got, want, MATMUL_TOL)


class _Routed(Exception):
    pass


@pytest.fixture
def jax_route(monkeypatch):
    """JAX ``quant_matmul`` stopped where it picks its kernel: raises
    _Routed("gemv") in any gemv, _Routed("gemm") at the slab branch's
    pallas_call, so the gate shows at full shapes without the compute."""
    def stop(route):
        def raise_(*a, **k):
            raise _Routed(route)
        return raise_

    for name in JAX_GEMVS:
        monkeypatch.setattr(jax_mm, name, stop("gemv"))
    monkeypatch.setattr(jax_mm.pl, "pallas_call", stop("gemm"))

    def route(kind, arrays, m, k, n):
        x = jnp.zeros((n, k), jnp.bfloat16)
        with pytest.raises(_Routed) as e:
            jax_mm.quant_matmul(x, kind, arrays, m, k)
        return str(e.value) == "gemv"
    return route


def _full_matrix(kind, m, k):
    """A matrix of ``kind``'s form at [m, k] with zero arrays (the gate
    reads only shapes): the keys and per-row widths of a small loaded one,
    scaled to k."""
    k_small = 512 if k % 512 == 0 else 256
    small = Matrix.from_gguf_blocks(GgmlDType[kind], _raw(kind, 8, k_small, seed=0),
                                    (8, k_small), device="cpu")
    arrays = {key: torch.zeros(m, a.shape[1] * k // k_small, dtype=a.dtype)
              for key, a in small.arrays.items()}
    return Matrix(small.kind, (m, k), arrays)


# the driven shapes: RWKV-7 0.1B and RWKV-6 1.6B layer matrices, the heads
GATE_CASES = ([(kind, m, k) for kind in KINDS
               for m, k in ((768, 768), (3072, 768), (768, 3072), (2048, 2048),
                            (7168, 2048), (2048, 7168))]
              + [(kind, 65536, k) for kind in ("Q6_K", "Q8_0") for k in (768, 2048)])


@pytest.mark.parametrize("kind,m,k", GATE_CASES)
def test_takes_gemv_is_the_jax_gate(jax_route, kind, m, k):
    """``Matrix.takes_gemv`` equals JAX ``quant_matmul``'s gate at every n
    from 1 to 9; e.g. Q5_K [768, 3072] and Q8_0 [2048, 7168] go to the
    GEMM at n = 1 (their codes do not tile the gemv)."""
    pm = _full_matrix(kind, m, k)
    arrays = {key: jnp.asarray(a.numpy()) for key, a in pm.arrays.items()}
    for n in range(1, 10):
        assert pm.takes_gemv(n) == jax_route(pm.kind, arrays, m, k, n), n
    if (kind, m, k) in (("Q5_K", 768, 3072), ("Q8_0", 2048, 7168)):
        assert not pm.takes_gemv(1)


def test_takes_gemv_reads_the_groups_from_the_matrix(jax_calls):
    """Q8_0 [256, 1024] at n = 5: 32 groups of 32 a row (160 group rows:
    the gemv). A per-16 count, the Q6_K layout that the gate once assumed
    for every byte-code kind, would make it 320 and send it to the GEMM
    (largest error seen: 1.6e-5 of max|y|, the JAX gemv's signed-code
    fold; the GEMM class would be 1.6e-3 off)."""
    jm, pm = _matrices("Q8_0", 256, 1024, seed=5)
    assert pm.groups() == 32 and pm.takes_gemv(5)
    assert port_matrix.takes_gemv("qk_nomin", 5, 256, 1024, 1024 // 16) is False
    x = _x(5, 1024, seed=6)
    want = np.asarray(jax_mm.quant_matmul(jnp.asarray(x), jm.kind, jm.arrays, 256, 1024))
    assert jax_calls == ["_quant_gemv2"]
    _close_to_max(pm.matmul(torch.from_numpy(x)).numpy(), want, MATMUL_TOL)
    # the GEMM the per-16 count chose is out of the gemv's class here
    old = mm.qs_gemm(torch.from_numpy(x), pm.arrays["codes"], pm.arrays["scales"]).numpy()
    assert np.abs(old - want).max() > MATMUL_TOL * np.abs(want).max()


@pytest.mark.parametrize("kind", ["Q4_K", "Q6_K"])
def test_kquant_rows_without_whole_super_blocks_take_the_qs_kernels(port_calls, kind):
    """A Q4_K / Q6_K matrix at K % 256 != 0 keeps f32 group scales and
    multiplies through ``qs_gemv`` / ``qs_gemm`` (on the card their
    kernels; here their plain versions), against the dense weight."""
    m, k = 256, 384
    pm = Matrix.from_gguf_blocks(GgmlDType[kind], _raw(kind, m, k, seed=9), (m, k),
                                 device="cpu")
    assert "scales" in pm.arrays
    w = pm.dequantize()
    for n in (1, 64):
        x = torch.from_numpy(_x(n, k, seed=n))
        want = x.to(torch.bfloat16).float() @ w.T
        _close_to_max(pm.matmul(x).numpy(), want.numpy(), 1e-2)
    assert port_calls == ["qs_gemv", "qs_gemm"]


def test_q8_0_sign_extends_its_codes():
    """Codes −128 and −127 (a Q8_0 file may hold −128 though llama.cpp
    writes −127..127) dequantize and multiply as signed, on the gemv and
    on the GEMM."""
    m, k = 8, 64
    raw = np.frombuffer(ggml.quantize_q8_0(_values(m * k, seed=4)), np.uint8).copy()
    blocks = raw.reshape(-1, 34)
    blocks[0, 2] = 0x80  # −128
    blocks[0, 3] = 0x81  # −127
    pm = Matrix.from_gguf_blocks(GgmlDType.Q8_0, raw, (m, k), device="cpu")
    codes = pm.arrays["codes"]
    assert codes.dtype == torch.int8 and codes[0, 0] == -128 and codes[0, 1] == -127
    want = torch.from_numpy(ggml.dequantize(GgmlDType.Q8_0, raw, m * k).reshape(m, k))
    assert torch.equal(pm.dequantize(), want)
    x = torch.zeros(1, k)
    x[0, 0], x[0, 1] = 1.0, 2.0
    expect = want[0, 0] + 2 * want[0, 1]
    assert mm.qs_gemv(x, codes, pm.arrays["scales"])[0, 0] == expect
    assert mm.qs_gemm(x, codes, pm.arrays["scales"])[0, 0] == expect


def _assert_same_tree(mine, ref, path="params"):
    if isinstance(ref, dict):
        assert set(mine) == set(ref), (path, set(mine) ^ set(ref))
        for key in ref:
            _assert_same_tree(mine[key], ref[key], f"{path}.{key}")
    elif isinstance(ref, Matrix):
        assert isinstance(mine, Matrix), path
        assert (mine.kind, mine.shape) == (ref.kind, ref.shape), path
        _assert_same_tree(mine.arrays, ref.arrays, path)
    else:
        assert (mine.dtype, mine.shape) == (ref.dtype, ref.shape), path
        assert torch.equal(mine, ref), path


# Q5_K_M (Q5_K layers, Q6_K head) and Q8_0 files, V7 and V6, at widths
# whose rows hold whole super-blocks
LOADS = {
    "v7_q5km": (make_v7_gguf, dict(n_layer=2, n_emb=256, head_size=64, n_vocab=512,
                                   n_hidden=1024, quantize=GgmlDType.Q5_K,
                                   head_quantize=GgmlDType.Q6_K, seed=40)),
    "v7_q8_0": (make_v7_gguf, dict(n_layer=2, n_emb=256, head_size=64, n_vocab=512,
                                   n_hidden=1024, quantize=GgmlDType.Q8_0, seed=41)),
    "v6_q5km": (make_v6_gguf, dict(n_layer=2, n_emb=256, head_size=64, n_vocab=512,
                                   n_hidden=512, rank_tm=8, rank_td=8,
                                   quantize=GgmlDType.Q5_K, head_quantize=GgmlDType.Q6_K,
                                   seed=50)),
    "v6_q8_0": (make_v6_gguf, dict(n_layer=2, n_emb=256, head_size=64, n_vocab=512,
                                   n_hidden=512, rank_tm=8, rank_td=8,
                                   quantize=GgmlDType.Q8_0, seed=51)),
}


@pytest.mark.parametrize("name", sorted(LOADS))
def test_load_model_matches_jax(name):
    """The port's load_model == params_from_numpy(JAX load_model) exactly,
    and the layer matrices and head take the placement's kinds."""
    make, kw = LOADS[name]
    raw = make(**kw)
    info, params = load_model(GgufFile(raw), device="cpu")
    _, jparams = jax_load_model(JaxGgufFile(raw))
    _assert_same_tree(params, params_from_numpy(jax.device_get(jparams), device="cpu"))
    layer_kind = "qk_b" if "q5km" in name else "qk_nomin"
    assert params["blocks"]["att"]["Wk"].kind == layer_kind
    assert params["blocks"]["ffn"]["Wv"].kind == layer_kind
    assert params["head"].kind == "qk_nomin"
    assert ("q6s" in params["head"].arrays) == ("q5km" in name)


def test_direct_types_are_one_set():
    """The block types the reader hands over raw, the writer quantizes to
    and a matrix repacks are one set (quant/ggml.DIRECT_TYPES)."""
    from web_rwkv_gguf_tpu_torch.gguf import reader
    from web_rwkv_gguf_tpu_torch.models import matrix
    from web_rwkv_gguf_tpu_torch.quant import ggml

    assert reader.DIRECT_TYPES is ggml.DIRECT_TYPES
    assert set(matrix._REPACK) == ggml.DIRECT_TYPES
    assert all(hasattr(ggml, f"quantize_{t.name.lower()}") for t in ggml.DIRECT_TYPES)
