"""The engine's requantization of dense weights (Int8, NF4, SF4:
``load_model(quant=)``) in the port against the JAX package on the CPU,
on the same numpy inputs: the quantizers and codebooks
(``quant/formats.py``), ``Matrix.from_f16``, the gemv/GEMM gate, the
plain versions of the Int8 forms of ``qs_gemv`` / ``qs_gemm`` and of
``nf4_gemv`` / ``nf4_gemm`` against the JAX kernels they replace, and the
loaded models (tests/test_torch_requant_decode.py drives them).

The JAX side runs its Pallas kernels in interpret mode (its quantized
matmuls through ``quant_matmul``, the branch its ``Matrix.matmul`` takes
on a TPU), and a spy on the JAX kernel function proves the route it
took. Tolerances: the quantizers, codebooks, matrices and loaders are
bit-exact; the matmuls sum the same f32 terms (the gemvs) or the same
bf16 products (the GEMMs) in another order, and the JAX Int8 gemv folds a
code bias into its group sums, atol = 1e-4·max|y|. The largest errors
seen are recorded beside each test.
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
from web_rwkv_gguf_tpu.quant import formats as jax_formats
import web_rwkv_gguf_tpu_torch.models.matrix as port_matrix
from web_rwkv_gguf_tpu_torch.gguf import GgufFile
from web_rwkv_gguf_tpu_torch.models import Matrix, load_model, params_from_numpy
from web_rwkv_gguf_tpu_torch.models.matrix import int8_operands
from web_rwkv_gguf_tpu_torch.ops.cuda import matmul as mm
from web_rwkv_gguf_tpu_torch.ops.cuda.layer7 import stack_matrix
from web_rwkv_gguf_tpu_torch.quant import formats
from web_rwkv_gguf_tpu_torch.quant.formats import QuantScheme
from web_rwkv_gguf_tpu_torch.quant.ggml import GgmlDType
from web_rwkv_gguf_tpu_torch.utils.synthetic import make_v6_gguf, make_v7_gguf

SCHEMES = ("INT8", "NF4", "SF4")
MATMUL_TOL = 1e-4
JAX_GEMVS = ("_quant_gemv2", "_quant_gemv")
PORT_KERNELS = ("qs_gemv", "qs_gemm", "nf4_gemv", "nf4_gemm")


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
    monkeypatch.setattr(pcfg, "interpret", True)
    # the JAX gemv's narrow (group-expansion) form at every n: the exact
    # f32 class the port computes (tests/test_torch_kquants.py)
    monkeypatch.setattr(pcfg, "wide_batch", 8)
    return _spy(monkeypatch, jax_mm, JAX_GEMVS)


@pytest.fixture
def port_calls(monkeypatch):
    return _spy(monkeypatch, port_matrix, PORT_KERNELS)


def _values(n, seed):
    """Weights with an all-zero and a constant block (the quantizers'
    zero-range and zero-absmax branches)."""
    v = (np.random.default_rng(seed).normal(size=n) * 0.05).astype(np.float32)
    v[:128] = 0.0
    v[128:256] = 0.01
    return v


def _x(n, k, seed):
    return (np.random.default_rng(seed).normal(size=(n, k)) * 0.5).astype(np.float32)


def _close_to_max(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=rel * np.abs(want).max())


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# quant/formats.py
# ---------------------------------------------------------------------------


def test_format_constants_match_jax():
    assert formats.INT8_BLOCK_SIZE == jax_formats.INT8_BLOCK_SIZE == 128
    assert formats.NF4_BLOCK_SIZE == jax_formats.NF4_BLOCK_SIZE == 64
    _equal(formats.NF4_QUANTILES, jax_formats.NF4_QUANTILES)
    assert [s.value for s in QuantScheme] == [s.value for s in jax_formats.QuantScheme]


def test_sf4_quantiles_are_bit_equal_and_fresh():
    """The Student-t codebook, bit for bit; computed once per nu (a pure-
    Python bisection), each call a copy the caller may change."""
    got = formats.sf4_quantiles()
    _equal(got, jax_formats.sf4_quantiles())
    got[:] = 0
    _equal(formats.sf4_quantiles(), jax_formats.sf4_quantiles())
    _equal(formats.sf4_quantiles(3.0), jax_formats.sf4_quantiles(3.0))


@pytest.mark.parametrize("n", [8 * 512, 8 * 512 + 77])
def test_quantize_int8_matches_jax(n):
    """Codes and f16 block bounds byte-equal, the values back bit-equal
    (a length off the block size pads the last block)."""
    v = _values(n, seed=1)
    got, want = formats.quantize_int8(v), jax_formats.quantize_int8(v)
    for a, b in zip(got, want):
        _equal(a, b)
    _equal(formats.dequantize_int8(*got), jax_formats.dequantize_int8(*want))


@pytest.mark.parametrize("lut", ["NF4", "SF4"])
def test_quantize_nf4_matches_jax(lut):
    v = _values(8 * 512, seed=2)
    codebook = formats.NF4_QUANTILES if lut == "NF4" else formats.sf4_quantiles()
    got = formats.quantize_nf4(v, codebook)
    want = jax_formats.quantize_nf4(v, np.array(codebook))
    for a, b in zip(got, want):
        _equal(a, b)
    _equal(formats.dequantize_nf4(*got), jax_formats.dequantize_nf4(*want))


def test_matrix_statistics_match_jax():
    v = _values(4097, seed=3)
    assert formats.matrix_statistics(v) == jax_formats.matrix_statistics(v)


# ---------------------------------------------------------------------------
# Matrix.from_f16
# ---------------------------------------------------------------------------


def _w16(m, k, seed):
    return _values(m * k, seed).reshape(m, k).astype(np.float16)


def _pair(scheme, m, k, seed):
    w = _w16(m, k, seed)
    jm = JaxMatrix.from_f16(w, jax_formats.QuantScheme[scheme], device=False)
    return jm, Matrix.from_f16(w, QuantScheme[scheme], device="cpu")


@pytest.mark.parametrize("m,k", [(256, 512), (64, 320), (32, 96)])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_from_f16_matches_jax(scheme, m, k):
    """Kind, keys (the JAX ones that survive the TPU-operand drop) and
    arrays equal to params_from_numpy of the JAX matrix, and the dense
    weight bit-equal; K=320 stays dense under Int8 (128 does not divide
    it), K=96 under every scheme."""
    jm, pm = _pair(scheme, m, k, seed=m + k)
    ref = params_from_numpy(jax.device_get(jm), device="cpu")
    assert (pm.kind, pm.shape) == (ref.kind, ref.shape)
    assert pm.kind == ("dense" if k == 96 or (scheme == "INT8" and k == 320)
                       else "int8" if scheme == "INT8" else "nf4")
    assert set(pm.arrays) == set(ref.arrays)
    for key, a in ref.arrays.items():
        assert pm.arrays[key].dtype == a.dtype and torch.equal(pm.arrays[key], a), key
    np.testing.assert_array_equal(pm.dequantize().numpy(),
                                  np.asarray(jm.dequantize(jnp.float32)))


# ---------------------------------------------------------------------------
# the gate
# ---------------------------------------------------------------------------


class _Routed(Exception):
    pass


@pytest.fixture
def jax_route(monkeypatch):
    """JAX ``quant_matmul`` stopped where it picks its kernel: _Routed
    ("gemv") in a gemv, _Routed("gemm") at the slab branch's pallas_call."""
    def stop(route):
        def raise_(*a, **k):
            raise _Routed(route)
        return raise_

    for name in JAX_GEMVS:
        monkeypatch.setattr(jax_mm, name, stop("gemv"))
    monkeypatch.setattr(jax_mm.pl, "pallas_call", stop("gemm"))

    def route(kind, arrays, m, k, n):
        with pytest.raises(_Routed) as e:
            jax_mm.quant_matmul(jnp.zeros((n, k), jnp.bfloat16), kind, arrays, m, k)
        return str(e.value) == "gemv"
    return route


def _full_matrix(kind, m, k):
    """An ``int8`` or ``nf4`` matrix at [m, k] with zero arrays (the gate
    reads only shapes)."""
    if kind == "int8":
        arrays = {"codes": torch.zeros(m, k, dtype=torch.uint8),
                  "mn": torch.zeros(m, k // 128), "mx": torch.zeros(m, k // 128)}
    else:
        arrays = {"codes": torch.zeros(m, k // 2, dtype=torch.uint8),
                  "absmax": torch.zeros(m, k // 64), "lut": torch.zeros(16)}
    return Matrix(kind, (m, k), arrays)


# RWKV-7 0.1B and RWKV-6 1.6B layer shapes
GATE_SHAPES = ((768, 768), (3072, 768), (768, 3072), (2048, 2048), (7168, 2048), (2048, 7168))


@pytest.mark.parametrize("m,k", GATE_SHAPES)
@pytest.mark.parametrize("kind", ["int8", "nf4"])
def test_takes_gemv_is_the_jax_gate(jax_route, kind, m, k):
    """``Matrix.takes_gemv`` equals JAX ``quant_matmul``'s gate at every n
    from 1 to 9. NF4 counts its per-64 absmax twice (the JAX kernel's two
    nibble planes): at C=768 and n=4 the K=768 matrices take the gemv (4 ·
    24 groups) and the FFN value (K=3072) the GEMM (4 · 96), so a B=4 NF4
    decode step runs both kernels."""
    pm = _full_matrix(kind, m, k)
    arrays = {key: jnp.asarray(a.numpy()) for key, a in pm.arrays.items()}
    for n in range(1, 10):
        assert pm.takes_gemv(n) == jax_route(kind, arrays, m, k, n), n
    if kind == "nf4" and (m, k) == (768, 768):
        assert pm.groups() == 24 and pm.takes_gemv(4)
    if kind == "nf4" and (m, k) == (768, 3072):
        assert pm.groups() == 96 and pm.takes_gemv(2) and not pm.takes_gemv(4)


# ---------------------------------------------------------------------------
# the plain kernels against the JAX kernels
# ---------------------------------------------------------------------------

MATMUL_SHAPES = [(256, 512), (128, 1024)]


@pytest.mark.parametrize("n", [1, 3, 8])
@pytest.mark.parametrize("m,k", MATMUL_SHAPES)
@pytest.mark.parametrize("scheme", SCHEMES)
def test_gemv_plain_matches_jax_gemv(jax_calls, port_calls, scheme, m, k, n):
    """``Matrix.matmul`` at n ≤ 8 takes ``qs_gemv`` (Int8) or ``nf4_gemv``
    where JAX ``quant_matmul`` takes ``_quant_gemv2`` or ``_quant_gemv``,
    and matches it (largest error seen: 1.1e-6 of max|y|)."""
    jm, pm = _pair(scheme, m, k, seed=m + n)
    x = _x(n, k, seed=n)
    want = np.asarray(jax_mm.quant_matmul(jnp.asarray(x), jm.kind, jm.arrays, m, k))
    assert jax_calls == ["_quant_gemv2" if scheme == "INT8" else "_quant_gemv"]
    got = pm.matmul(torch.from_numpy(x)).numpy()
    assert port_calls == ["qs_gemv" if scheme == "INT8" else "nf4_gemv"]
    _close_to_max(got, want, MATMUL_TOL)


@pytest.mark.parametrize("n", [9, 40])
@pytest.mark.parametrize("m,k", MATMUL_SHAPES)
@pytest.mark.parametrize("scheme", SCHEMES)
def test_gemm_plain_matches_jax_slab(jax_calls, port_calls, scheme, m, k, n):
    """Past the gate: ``qs_gemm`` (Int8) and ``nf4_gemm`` against the slab
    branch of JAX ``quant_matmul``, on signed and on all-positive inputs
    (largest error seen: 7.8e-6 of max|y|, on the positive inputs)."""
    jm, pm = _pair(scheme, m, k, seed=7 * n + k)
    x = _x(n, k, seed=100 + n)
    if n == 40:
        x = x * x  # the FFN value's relu² inputs: the offset term cancels most of y
    want = np.asarray(jax_mm.quant_matmul(jnp.asarray(x), jm.kind, jm.arrays, m, k))
    assert jax_calls == []
    got = pm.matmul(torch.from_numpy(x)).numpy()
    assert port_calls == ["qs_gemm" if scheme == "INT8" else "nf4_gemm"]
    _close_to_max(got, want, MATMUL_TOL)


@pytest.mark.parametrize("scheme", ["NF4", "SF4"])
def test_nf4_gemv_rounds_its_codebook_as_the_jax_kernel(jax_calls, scheme):
    """The JAX LUT gemv multiplies bf16(x) by bf16(lut[idx]) and scales its
    group sums by the absmax; its GEMM rounds lut[idx]·absmax to bf16. The
    plain gemv with the f32 codebook (the GEMM's weight before rounding)
    is outside the tolerance of the JAX gemv (seen: 4.0e-4 of max|y|), the
    bf16 one inside (1.4e-7)."""
    m, k = 256, 512
    jm, pm = _pair(scheme, m, k, seed=9)
    x = _x(4, k, seed=9)
    want = np.asarray(jax_mm.quant_matmul(jnp.asarray(x), jm.kind, jm.arrays, m, k))
    assert jax_calls == ["_quant_gemv"]
    a = pm.arrays
    xb = torch.from_numpy(x).to(torch.bfloat16).float()
    f32_lut = (xb @ mm.nf4_dequantize(a["codes"], a["absmax"], a["lut"]).T).numpy()
    assert _rel(f32_lut, want) > MATMUL_TOL
    _close_to_max(mm.nf4_gemv_plain(torch.from_numpy(x), a["codes"], a["absmax"],
                                    a["lut"]).numpy(), want, MATMUL_TOL)


def test_int8_scales_follow_each_class():
    """The gemv class forms s = (mx − mn)/255, as the JAX gemv operands and
    whole-stack prep do; the GEMM class (mx − mn)·(1/255), as the JAX slab
    branch does; the two differ by an ulp on some groups. The offsets are
    −mn for both (the JAX weight adds mn; the port's kernels subtract)."""
    _, pm = _pair("INT8", 256, 512, seed=4)
    a = pm.arrays
    mn, mx = a["mn"], a["mx"]
    s_gemv, neg = int8_operands(a, gemm=False)
    s_gemm, _ = int8_operands(a, gemm=True)
    assert torch.equal(s_gemv, (mx - mn) / 255.0) and torch.equal(neg, -mn)
    assert torch.equal(s_gemm, (mx - mn) * np.float32(1.0 / 255.0))
    assert not torch.equal(s_gemv, s_gemm)
    assert torch.equal(stack_matrix(pm)[1][1], s_gemv)


# ---------------------------------------------------------------------------
# load_model(quant=)
# ---------------------------------------------------------------------------


def _assert_same_tree(mine, ref, path="params"):
    if isinstance(ref, dict):
        assert set(mine) == set(ref), (path, set(mine) ^ set(ref))
        for key in ref:
            _assert_same_tree(mine[key], ref[key], f"{path}.{key}")
    elif isinstance(ref, list):
        assert isinstance(mine, list) and len(mine) == len(ref), path
        for i, (a, b) in enumerate(zip(mine, ref)):
            _assert_same_tree(a, b, f"{path}[{i}]")
    elif isinstance(ref, Matrix):
        assert isinstance(mine, Matrix), path
        assert (mine.kind, mine.shape) == (ref.kind, ref.shape), path
        _assert_same_tree(mine.arrays, ref.arrays, path)
    else:
        assert (mine.dtype, mine.shape) == (ref.dtype, ref.shape), path
        assert torch.equal(mine, ref), path


VOCAB = 512
WIDTHS = {"v7": (make_v7_gguf, dict(n_layer=2, n_emb=256, head_size=64, n_vocab=VOCAB,
                                    n_hidden=512)),
          "v6": (make_v6_gguf, dict(n_layer=2, n_emb=256, head_size=64, n_vocab=VOCAB,
                                    n_hidden=512, rank_tm=8, rank_td=8))}
SEEDS = {"v7": 60, "v6": 80}
# (file, quant, rescale): one scheme; one per layer (the layers load as a
# list); a Q4_K file, whose matrices load direct-quantized whatever the
# scheme, alone and with rescale=1 (then layer 1's discounted output and
# FFN value matrices are requantized, layer 0's stay Q4_K: a list)
LOADS = ([(v, s, None) for v in WIDTHS for s in SCHEMES]
         + [(v, {0: "INT8", 1: "NF4"}, None) for v in WIDTHS]
         + [("v7q4k", "INT8", None), ("v7q4k", "INT8", 1), ("v6", "SF4", 1)])


def _file(name):
    if name == "v7q4k":
        make, kw = WIDTHS["v7"]
        return make(**kw, quantize=GgmlDType.Q4_K, head_quantize=GgmlDType.Q6_K, seed=61)
    make, kw = WIDTHS[name]
    return make(**kw, seed=SEEDS[name])


def _quant(q, schemes):
    if isinstance(q, dict):
        return {i: schemes[s] for i, s in q.items()}
    return None if q is None else schemes[q]


@pytest.mark.parametrize("name,quant,rescale", LOADS,
                         ids=[f"{n}-{q}-{r}" for n, q, r in LOADS])
def test_load_model_matches_jax(name, quant, rescale):
    """The port's load_model(quant=) == params_from_numpy(JAX
    load_model(quant=)) exactly: kinds, keys (the stacked codebook [L, 16]
    included; the JAX gemv operands dropped) and arrays; the head stays
    dense (it loads with no layer, JAX loader.py:169)."""
    raw = _file(name)
    info, params = load_model(GgufFile(raw), quant=_quant(quant, QuantScheme),
                              rescale=rescale, device="cpu")
    _, jparams = jax_load_model(JaxGgufFile(raw), quant=_quant(quant, jax_formats.QuantScheme),
                                rescale=rescale)
    _assert_same_tree(params, params_from_numpy(jax.device_get(jparams), device="cpu"))
    assert params["head"].kind == ("qk_nomin" if name == "v7q4k" else "dense")
    blocks = params["blocks"]
    ragged = isinstance(quant, dict) or rescale == 1 and name == "v7q4k"
    assert isinstance(blocks, list) == ragged
    first = blocks[0] if ragged else blocks
    if name == "v7q4k":
        assert first["att"]["Wo"].kind == "qk"
        if rescale:
            assert blocks[1]["att"]["Wo"].kind == "int8" and blocks[1]["att"]["Wk"].kind == "qk"
    elif not ragged:
        kind = "int8" if quant == "INT8" else "nf4"
        assert first["att"]["Wk"].kind == kind and first["ffn"]["Wv"].kind == kind
        if kind == "nf4":
            assert tuple(first["att"]["Wk"].arrays["lut"].shape) == (info.num_layer, 16)
