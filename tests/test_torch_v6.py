"""The port's RWKV-6 path against the JAX package's, on the CPU, from the
same GGUF bytes: the synthetic file, the loader, the WKV scan's plain
version (against ``wkv6_pallas`` in interpret mode), the chunk-parallel
WKV, ``forward_chunk`` / ``logits_head`` at T = 1, 37 and 128, and the
Engine.

Tolerances:

- loader: bit-exact (the same numpy arithmetic on the same bytes);
- the WKV scan: atol = 2e-5 on y and the state (the same f32 ops summed
  in another order; values of order 1-10);
- the chunk-parallel WKV: atol = 1e-4·max|y| (the same function through
  another formulation and library's matmuls);
- f32 dense forward and Engine: logits at rtol = atol = 2e-4, as
  tests/test_oracle.py:228 holds the JAX forward to its scalar oracle;
  the residual x and the states at atol = 2e-4·max (random weights
  drive x to ~10³ at this width, where f32 sums in another order differ
  by ~10⁻³ absolute);
- Q4_K_M logits: atol = 3e-2·max|logit|, as tests/test_torch_forward.py,
  against the JAX forward with its quantized matmuls in the class the
  port follows (``quant_matmul``, in interpret mode, as the JAX package
  runs them on a TPU). Its CPU path rounds every dequantized Q4_K weight
  to bf16 instead, which on this model's V6 layers lands 2-5e-2 of
  max|logit| away from both.

The largest errors seen are recorded beside each test.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import web_rwkv_gguf_tpu.models.forward as jax_forward_mod
import web_rwkv_gguf_tpu.models.matrix as jax_matrix_mod
from web_rwkv_gguf_tpu.gguf import GgufFile as JaxGgufFile
from web_rwkv_gguf_tpu.models import forward_chunk as jax_forward_chunk
from web_rwkv_gguf_tpu.models import init_state as jax_init_state
from web_rwkv_gguf_tpu.models import load_model as jax_load_model
from web_rwkv_gguf_tpu.models import logits_head as jax_logits_head
from web_rwkv_gguf_tpu.ops.pallas import config as pcfg
from web_rwkv_gguf_tpu.ops.pallas.matmul import quant_matmul
from web_rwkv_gguf_tpu.ops.pallas.wkv456 import wkv6_pallas
from web_rwkv_gguf_tpu.ops.wkv_chunked import wkv6_chunked as jax_wkv6_chunked
from web_rwkv_gguf_tpu.quant.ggml import GgmlDType as JaxGgmlDType
from web_rwkv_gguf_tpu.runtime import Engine as JaxEngine
from web_rwkv_gguf_tpu.utils.synthetic import make_v6_gguf as jax_make_v6_gguf
from web_rwkv_gguf_tpu_torch.gguf import GgufFile
from web_rwkv_gguf_tpu_torch.models import (
    Matrix, forward_chunk, init_state, load_model, logits_head, params_from_numpy,
)
from web_rwkv_gguf_tpu_torch.ops.cuda.wkv6 import wkv6_scan, wkv6_scan_plain
from web_rwkv_gguf_tpu_torch.ops.wkv_chunked import wkv6_chunked
from web_rwkv_gguf_tpu_torch.quant.ggml import GgmlDType
from web_rwkv_gguf_tpu_torch.runtime import Engine, RnnInput, RnnInputBatch, RnnOption
from web_rwkv_gguf_tpu_torch.utils.synthetic import make_v6_gguf

F32_TOL = 2e-4
Q4KM_LOGITS_TOL = 3e-2
SCAN_TOL = 2e-5
CHUNKED_TOL = 1e-4
VOCAB = 300
# the slice's small shape: 3 layers, C = 256 (4 heads of 64), ranks 8/8
SMALL = dict(n_layer=3, n_emb=256, head_size=64, n_vocab=VOCAB, n_hidden=512, rank_tm=8,
             rank_td=8)
FILES = {"f32": dict(seed=3), "q4k": dict(seed=4, quantize="Q4_K")}


def _kw(kw, dtype_enum):
    kw = dict(kw)
    if "quantize" in kw:
        kw["quantize"] = dtype_enum[kw["quantize"]]
    return kw


@pytest.fixture
def interpret_mode():
    """The JAX package's Pallas kernels in interpret mode, as its own CPU
    tests run them."""
    pcfg.interpret = True
    yield
    pcfg.interpret = False


@pytest.fixture(scope="module")
def f32_file():
    return make_v6_gguf(**SMALL, seed=11)


@pytest.fixture(scope="module")
def f32_models(f32_file):
    return (jax_load_model(JaxGgufFile(f32_file), dtype=jnp.float32),
            load_model(GgufFile(f32_file), dtype=torch.float32, device="cpu"))


@pytest.fixture(scope="module")
def q4km_models():
    raw = make_v6_gguf(**SMALL, seed=12, quantize=GgmlDType.Q4_K,
                       head_quantize=GgmlDType.Q6_K)
    return jax_load_model(JaxGgufFile(raw)), load_model(GgufFile(raw), device="cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


def _close_to_max(got, want, rel):
    """|got - want| <= rel·max|want| everywhere."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=rel * np.abs(want).max())


@pytest.mark.parametrize("name", sorted(FILES))
def test_make_v6_gguf_bytes_match_jax(name):
    kw = {**SMALL, **FILES[name]}
    assert make_v6_gguf(**_kw(kw, GgmlDType)) == jax_make_v6_gguf(**_kw(kw, JaxGgmlDType))


def test_head_quantize_writes_q4km():
    raw = make_v6_gguf(**SMALL, seed=1, quantize=GgmlDType.Q4_K,
                       head_quantize=GgmlDType.Q6_K)
    f = GgufFile(raw)
    assert f.tensors["output.weight"].dtype == GgmlDType.Q6_K
    assert f.tensors["blk.0.attn_g.weight"].dtype == GgmlDType.Q4_K
    assert f.tensors["blk.0.attn_time_mix_w1"].dtype == GgmlDType.F32


def _assert_same_tree(mine, ref, path="params"):
    if isinstance(ref, dict):
        assert set(mine) == set(ref), (path, set(mine) ^ set(ref))
        for k in ref:
            _assert_same_tree(mine[k], ref[k], f"{path}.{k}")
    elif isinstance(ref, Matrix):
        assert isinstance(mine, Matrix), path
        assert (mine.kind, mine.shape) == (ref.kind, ref.shape), path
        ref_arrays = dict(ref.arrays)
        if "scales" in ref_arrays and "q6s" in mine.arrays:
            # the JAX package keeps the f32 group scales beside the native
            # factors where its TPU gemv finds no row tiling (M = 300); the
            # port derives them from the factors, the same f32 products
            a = mine.arrays
            derived = a["q6d"].repeat_interleave(16, dim=-1) * a["q6s"].float()
            assert torch.equal(derived, ref_arrays.pop("scales")), path
        _assert_same_tree(mine.arrays, ref_arrays, path)
    else:
        assert mine.dtype == ref.dtype, (path, mine.dtype, ref.dtype)
        assert mine.shape == ref.shape, (path, mine.shape, ref.shape)
        assert torch.equal(mine, ref), path


LOADS = {
    "f32_dense": (dict(seed=7), dict(dtype=jnp.float32), dict(dtype=torch.float32)),
    "q4km": (dict(seed=8, quantize=GgmlDType.Q4_K, head_quantize=GgmlDType.Q6_K), {}, {}),
}


@pytest.mark.parametrize("name", sorted(LOADS))
def test_load_model_matches_jax(name):
    """The port's load_model == params_from_numpy(JAX load_model) exactly:
    every array (values, dtype, shape) and ModelInfo."""
    file_kw, jax_kw, port_kw = LOADS[name]
    raw = make_v6_gguf(**SMALL, **file_kw)
    info, params = load_model(GgufFile(raw), device="cpu", **port_kw)
    jinfo, jparams = jax_load_model(JaxGgufFile(raw), **jax_kw)
    _assert_same_tree(params, params_from_numpy(jax.device_get(jparams), device="cpu"))
    mine, ref = dataclasses.asdict(info), dataclasses.asdict(jinfo)
    mine["version"], ref["version"] = mine["version"].value, ref["version"].value
    assert mine == ref and mine["version"] == "v6"
    att = params["blocks"]["att"]
    assert att["time_mix"].shape == (3, 5, 256) and att["time_first"].shape == (3, 4, 64)
    if name == "q4km":
        assert params["head"].kind == "qk_nomin"
        assert {att[k].kind for k in ("Wk", "Wv", "Wr", "Wg", "Wo")} == {"qk"}
        assert att["tm_w2"].dtype == torch.bfloat16


def test_params_from_numpy_drops_mega56():
    out = params_from_numpy({"mega56": {"x": np.zeros(3)}, "emb": np.ones(2, np.float32)},
                            device="cpu")
    assert set(out) == {"emb"}


def _wkv_inputs(B, T, lens, seed, decay_mu=0.0, H=4, K=64):
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.normal(size=s) * 0.5).astype(np.float32)  # noqa: E731
    w = np.exp(-np.exp(rng.normal(size=(B, T, H, K)) * 0.5 + decay_mu)).astype(np.float32)
    mask = np.arange(T)[None, :] < np.array(lens)[:, None]
    return f(B, H, K, K), f(B, T, H, K), f(B, T, H, K), f(B, T, H, K), f(H, K), w, mask


def test_wkv6_scan_plain_matches_pallas(interpret_mode):
    """Ragged lengths (40, 23, 0) at T = 40, y at every position (padded
    ones included: both pre-mask w and k) and the state (largest error
    seen: 1.9e-6)."""
    args = _wkv_inputs(3, 40, (40, 23, 0), seed=1)
    jy, js = wkv6_pallas(*(jnp.asarray(a) for a in args))
    y, s = wkv6_scan(*(_t(a) for a in args))  # a CPU tensor takes the plain version
    _close(y, jy, SCAN_TOL)
    _close(s, js, SCAN_TOL)
    assert torch.equal(s[2], _t(args[0])[2])  # the empty lane keeps its state


def test_wkv6_chunked_matches_jax():
    """T = 150 (sub-chunks of 16 with a padded tail), ragged lengths:
    valid y and the state against JAX's ``wkv6_chunked`` (largest error
    seen: 2.7e-7 of max|y|)."""
    args = _wkv_inputs(3, 150, (150, 100, 7), seed=2)
    jy, js = jax_wkv6_chunked(*(jnp.asarray(a) for a in args))
    y, s = wkv6_chunked(*(_t(a) for a in args))
    valid = args[-1]
    _close_to_max(y.numpy()[valid], np.asarray(jy)[valid], CHUNKED_TOL)
    _close_to_max(s, js, CHUNKED_TOL)


def test_wkv6_chunked_stays_finite_under_strong_decay():
    """Decays exp(-exp(N(1.5, 0.5))) underflow the JAX formulation's 1/P
    (it returns NaN); the port's log-space ratios keep the scan's values
    (largest error seen: 3.0e-7 of max|y|)."""
    args = _wkv_inputs(2, 128, (128, 77), seed=3, decay_mu=1.5)
    jy, _ = jax_wkv6_chunked(*(jnp.asarray(a) for a in args))
    assert not np.isfinite(np.asarray(jy)).all()
    y, s = wkv6_chunked(*(_t(a) for a in args))
    y0, s0 = wkv6_scan_plain(*(_t(a) for a in args))
    valid = torch.from_numpy(args[-1])
    _close_to_max(y[valid], y0[valid], CHUNKED_TOL)
    _close_to_max(s, s0, CHUNKED_TOL)


def _run_both(jax_model, port_model, chunks, batch):
    """Feed the same (tokens, lengths) chunks to both; yield per chunk
    (jax x, port x, jax state, port state)."""
    (jinfo, jparams), (info, params) = jax_model, port_model
    jst, st = jax_init_state(jinfo, batch), init_state(info, batch, device="cpu")
    for toks, lens in chunks:
        jx, jst = jax_forward_chunk(jinfo, jparams, jst, jnp.asarray(toks, jnp.int32),
                                    jnp.asarray(lens, jnp.int32))
        x, st = forward_chunk(info, params, st, _t(toks), _t(lens))
        yield jx, x, jst, st


def _chunks(seed):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, VOCAB, (2, 37)), np.array([37, 20])),
            (rng.integers(0, VOCAB, (2, 1)), np.array([1, 1])),
            (rng.integers(0, VOCAB, (2, 1)), np.array([1, 0])),  # lane 1 frozen
            (rng.integers(0, VOCAB, (2, 128)), np.array([128, 90]))]


@pytest.fixture
def jax_scan_wkv6(monkeypatch):
    """The JAX forward with its chunk-parallel WKV moved out of reach, so
    its T = 128 chunk runs the scan: its ``wkv6_chunked`` overflows on
    this model's decays (see test_wkv6_chunked_stays_finite_under_strong_decay)."""
    monkeypatch.setattr(jax_forward_mod, "WKV7_CHUNKED_MIN_T", 1 << 30)


def test_forward_f32_matches_jax(f32_models, jax_scan_wkv6):
    """A ragged T = 37 chunk, two T = 1 steps (one lane frozen), a ragged
    T = 128 chunk (the port's chunk-parallel WKV against the JAX scan):
    x at valid positions, last logits and every state array (largest
    errors seen: 4.0e-6 of max on x and the states, 5.5e-5 on logits)."""
    jax_model, port_model = f32_models
    chunks = _chunks(5)
    for (toks, lens), (jx, x, jst, st) in zip(chunks, _run_both(jax_model, port_model,
                                                                 chunks, 2)):
        valid = np.arange(toks.shape[1])[None, :] < lens[:, None]
        _close_to_max(x.numpy()[valid], np.asarray(jx)[valid], F32_TOL)
        live, last = lens > 0, np.maximum(lens - 1, 0)  # a frozen lane's x is unspecified
        _close(logits_head(port_model[1], x[np.arange(2), last])[live],
               np.asarray(jax_logits_head(jax_model[1], jx[np.arange(2), last]))[live],
               F32_TOL)
        for key in jst:
            _close_to_max(st[key], jst[key], F32_TOL)


@pytest.fixture
def jax_quant_matmul(monkeypatch, interpret_mode):
    """The JAX package's quantized matmuls through ``quant_matmul`` (the
    branch its ``Matrix.matmul`` takes on a TPU: 2-D codes, M divisible
    by 8), in interpret mode."""
    real = jax_matrix_mod.Matrix.matmul

    def matmul(self, x):
        m, k = self.dims()
        if self.kind in ("qk", "qk_nomin") and self.arrays["codes"].ndim == 2 and m % 8 == 0:
            lead = x.shape[:-1]
            y = quant_matmul(x.reshape(-1, k), self.kind, self.arrays, m, k)
            return y.reshape(lead + (m,))
        return real(self, x)

    monkeypatch.setattr(jax_matrix_mod.Matrix, "matmul", matmul)


def test_forward_q4km_matches_jax(q4km_models, jax_scan_wkv6, jax_quant_matmul):
    """Q4_K_M: a ragged T = 37 chunk, a T = 1 step and a ragged T = 128
    chunk; last logits at the stated tolerance (largest error seen:
    6.0e-3 of max|logit|)."""
    jax_model, port_model = q4km_models
    chunks = [_chunks(6)[i] for i in (0, 1, 3)]
    for (toks, lens), (jx, x, _, _) in zip(chunks, _run_both(jax_model, port_model,
                                                             chunks, 2)):
        live = lens > 0
        last = np.maximum(lens - 1, 0)
        _close_to_max(logits_head(port_model[1], x[np.arange(2), last])[live],
                      np.asarray(jax_logits_head(jax_model[1], jx[np.arange(2), last]))[live],
                      Q4KM_LOGITS_TOL)


def test_engine_matches_jax(f32_models, jax_scan_wkv6):
    """The Engine on f32 dense: chunked ``infer`` with a LAST and a FULL
    lane, the states of both lanes, then greedy ``generate`` (largest
    errors seen: 7.5e-5 on logits, 3.3e-6 of max|state|; tokens equal)."""
    (jinfo, jparams), (info, params) = f32_models
    jeng = JaxEngine(jinfo, jparams, 2, token_chunk_size=32)
    eng = Engine(info, params, 2, token_chunk_size=32, device="cpu")
    rng = np.random.default_rng(9)
    lanes = [([int(t) for t in rng.integers(0, VOCAB, 45)], "last"),
             ([int(t) for t in rng.integers(0, VOCAB, 20)], "full")]
    from web_rwkv_gguf_tpu.runtime import scheduler as jsched

    jinp = jsched.RnnInput([jsched.RnnInputBatch(list(t), jsched.RnnOption(o))
                            for t, o in lanes], 32)
    inp = RnnInput([RnnInputBatch(list(t), RnnOption(o)) for t, o in lanes], 32)
    while inp.num_token:
        jout, out = jeng.infer(jinp), eng.infer(inp)
        assert [o.shape for o in out] == [o.shape for o in jout]
        for o, jo in zip(out, jout):
            _close(o, jo, F32_TOL)
    for b in range(2):
        for key, want in jeng.back_state(b).items():
            _close_to_max(eng.back_state(b)[key], want, F32_TOL)
    prompts = [[int(t) for t in rng.integers(0, VOCAB, n)] for n in (40, 9)]
    jeng.reset_state()
    eng.reset_state()
    assert eng.generate(prompts, 6, segment=4) == jeng.generate(prompts, 6, segment=4)
    for b in range(2):
        for key, want in jeng.back_state(b).items():
            _close_to_max(eng.back_state(b)[key], want, F32_TOL)
