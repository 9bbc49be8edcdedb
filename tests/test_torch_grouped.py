"""The grouped r/k/v decode gemv and the unrolled decode params that run
it, through the port against the JAX package on the CPU:

- ``ops/cuda/matmul.quant_gemv_grouped_plain`` (what the wrapper runs on
  a CPU tensor) against JAX ``quant_gemv_grouped`` (Pallas in interpret
  mode) for every kind it takes, at 1e-4·max|y|: the same f32 group sums
  times the same f32 scale products, summed in another order;
- the port's copy of the JAX gemv tiling rule (``matrix.gemv_block_m``)
  and ``loader.unroll_params``: the same layers grouped in both
  packages;
- three B=1 decode steps through ``forward_chunk`` on the port's
  unrolled params against the JAX package's (its kernels in interpret
  mode): the logits at 3e-2·max and layer 0's state at the tolerances of
  tests/test_torch_kquants_decode.py (att_shift and WKV state 1e-5·max,
  the same f32 function; ffn_shift 2^-8·max, one bf16 step of Wo's input
  flipped by the other summation order); the port's unrolled params
  against its whole-stack step at 1e-5·max, with the launches of each
  kernel wrapper counted exactly;
- ``prepare_decode``'s fallback to ``unroll_params`` where no whole-stack
  block attaches, with the JAX package's outcome.
"""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import web_rwkv_gguf_tpu.models.matrix as jax_matrix_mod
import web_rwkv_gguf_tpu.ops.pallas.matmul as jax_mm
from web_rwkv_gguf_tpu.gguf import GgufFile as JaxGgufFile
from web_rwkv_gguf_tpu.models import forward_chunk as jax_forward_chunk
from web_rwkv_gguf_tpu.models import init_state as jax_init_state
from web_rwkv_gguf_tpu.models import load_model as jax_load_model
from web_rwkv_gguf_tpu.models import logits_head as jax_logits_head
from web_rwkv_gguf_tpu.models.loader import group_gemv_matrices as jax_group_gemv_matrices
from web_rwkv_gguf_tpu.models.loader import prepare_decode as jax_prepare_decode
from web_rwkv_gguf_tpu.models.loader import unroll_params as jax_unroll_params
from web_rwkv_gguf_tpu.models.matrix import Matrix as JaxMatrix
from web_rwkv_gguf_tpu.ops.pallas import config as pcfg
from web_rwkv_gguf_tpu.quant import formats as jax_formats
from web_rwkv_gguf_tpu.quant.ggml import GgmlDType as JaxGgmlDType
import web_rwkv_gguf_tpu_torch.models.forward as port_forward
import web_rwkv_gguf_tpu_torch.models.matrix as port_matrix
from web_rwkv_gguf_tpu_torch.gguf import GgufFile
from web_rwkv_gguf_tpu_torch.models import (
    Matrix, forward_chunk, group_gemv_matrices, init_state, load_model, logits_head,
    prepare_decode, unroll_params,
)
from web_rwkv_gguf_tpu_torch.models.matrix import gemv_block_m
from web_rwkv_gguf_tpu_torch.ops.cuda.layer7 import MAX_SCAN_BATCH
from web_rwkv_gguf_tpu_torch.ops.cuda.matmul import quant_gemv_grouped, quant_gemv_grouped_plain
from web_rwkv_gguf_tpu_torch.quant import ggml
from web_rwkv_gguf_tpu_torch.quant.formats import QuantScheme
from web_rwkv_gguf_tpu_torch.quant.ggml import GgmlDType
from web_rwkv_gguf_tpu_torch.utils.synthetic import make_v7_gguf

GROUPED_TOL = 1e-4
LOGITS_TOL = 3e-2
LAYER0_TOL = {"att_shift": 1e-5, "wkv": 1e-5, "ffn_shift": 2.0 ** -8}
STACK_TOL = 1e-5
VOCAB = 64
M, K = 128, 256
# the block types of the grouped kinds: qk (native Q4_K factors; Q4_0's f32
# scales over nibbles), qk_b (Q5_K), qk_nomin (Q6_K; Q8_0's f32 scales), and
# the engine's Int8
KINDS = ("Q4_K", "Q4_0", "Q5_K", "Q6_K", "Q8_0", "INT8")


def _values(n, seed):
    return (np.random.default_rng(seed).normal(size=n) * 0.05).astype(np.float32)


def _matrices(kind, seed):
    """Three [M, K] matrices of ``kind`` in both packages."""
    jms, pms = [], []
    for i in range(3):
        w = _values(M * K, seed + i)
        if kind == "INT8":
            w16 = w.reshape(M, K).astype(np.float16)
            jms.append(JaxMatrix.from_f16(w16, jax_formats.QuantScheme.INT8, device=False))
            pms.append(Matrix.from_f16(w16, QuantScheme.INT8, device="cpu"))
        else:
            raw = np.frombuffer(getattr(ggml, f"quantize_{kind.lower()}")(w), np.uint8)
            jms.append(JaxMatrix.from_gguf_blocks(JaxGgmlDType[kind], raw, (M, K)))
            pms.append(Matrix.from_gguf_blocks(GgmlDType[kind], raw, (M, K), device="cpu"))
    return jms, pms


def _close_to_max(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=rel * np.abs(want).max())


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("kind", KINDS)
def test_grouped_gemv_matches_jax(kind, n, monkeypatch):
    """The port's plain version against the JAX kernel in interpret mode,
    three matrices with an input of their own each (largest error seen:
    4.4e-7 of max|y|)."""
    jms, pms = _matrices(kind, seed=100 + KINDS.index(kind))
    jg, pg = jax_group_gemv_matrices(jms), group_gemv_matrices(pms)
    assert jg is not None and pg is not None
    assert (pg["offsets"] is None) == ("mnt" not in jg)
    xs = (np.random.default_rng(n).normal(size=(3, n, K)) * 0.5).astype(np.float32)
    monkeypatch.setattr(pcfg, "interpret", True)
    want = jax_mm.quant_gemv_grouped(jnp.asarray(xs), jms[0].kind, jg, M, K)
    got = quant_gemv_grouped(torch.from_numpy(xs), pms[0].kind, pg, M, K)
    assert tuple(got.shape) == (3, n, M)
    _close_to_max(got, want, GROUPED_TOL)
    # each matrix's product alone, through the matrix's own gemv class
    for i, pm in enumerate(pms):
        _close_to_max(got[i], pm.matmul(torch.from_numpy(xs[i])), GROUPED_TOL)


def test_grouped_gemv_plain_is_what_a_cpu_tensor_takes():
    """On a CPU tensor the wrapper is its plain version and counts no
    launch."""
    _, pms = _matrices("Q4_K", seed=7)
    pg = group_gemv_matrices(pms)
    xs = torch.from_numpy(np.random.default_rng(0).normal(size=(3, 2, K)).astype(np.float32))
    before = quant_gemv_grouped.launches
    assert torch.equal(quant_gemv_grouped(xs, "qk", pg, M, K),
                       quant_gemv_grouped_plain(xs, "qk", pg, M, K))
    assert quant_gemv_grouped.launches == before


@pytest.mark.parametrize("kdim", [64, 128, 384, 512, 768, 1024, 1536, 2048, 3584, 7168])
def test_gemv_block_m_matches_jax(kdim):
    for m in (8, 64, 96, 128, 256, 512, 768, 1000, 1024, 2048, 2688, 3072, 4096, 5120, 7168,
              8192, 65536):
        assert gemv_block_m(m, kdim) == jax_mm._gemv_block_m(m, kdim), (m, kdim)


def test_group_gemv_matrices_declines_as_jax():
    """Mixed kinds, mixed dims, dense and NF4 matrices are not grouped."""
    jq, pq = _matrices("Q4_K", seed=11)
    j8, p8 = _matrices("Q8_0", seed=12)
    w16 = _values(M * 2 * K, 13).reshape(M, 2 * K).astype(np.float16)
    jn = JaxMatrix.from_f16(w16, jax_formats.QuantScheme.NF4, device=False)
    pn = Matrix.from_f16(w16, QuantScheme.NF4, device="cpu")
    jd = JaxMatrix.from_f16(w16, jax_formats.QuantScheme.NONE, device=False)
    pd = Matrix.from_f16(w16, QuantScheme.NONE, device="cpu")
    for jmats, pmats in (([jq[0], j8[1], jq[2]], [pq[0], p8[1], pq[2]]),
                         ([jn] * 3, [pn] * 3), ([jd] * 3, [pd] * 3)):
        assert jax_group_gemv_matrices(jmats) is None
        assert group_gemv_matrices(pmats) is None
    _, pq2 = _matrices("Q4_K", seed=14)
    wide = Matrix.from_gguf_blocks(
        GgmlDType.Q4_K, np.frombuffer(ggml.quantize_q4_k(_values(M * 2 * K, 15)), np.uint8),
        (M, 2 * K), device="cpu")
    assert group_gemv_matrices([pq2[0], wide, pq2[2]]) is None


# (placement, widths): a small Q4_K model, whose r, k and v group at every
# layer, and one at C=2048 in Q8_0, whose byte codes tile the JAX gemv's M
# (2048·2048 bytes is past one 2 MiB tile), so neither package groups them
UNROLL_CASES = {
    "q4k": dict(n_layer=2, n_emb=256, head_size=64, n_vocab=VOCAB, n_hidden=512,
                quantize=GgmlDType.Q4_K, head_quantize=GgmlDType.Q6_K),
    "q8_0-c2048": dict(n_layer=1, n_emb=2048, head_size=64, n_vocab=VOCAB, n_hidden=256,
                       lora_w=8, lora_a=8, lora_g=8, lora_v=8, quantize=GgmlDType.Q8_0),
}


@pytest.mark.parametrize("case", list(UNROLL_CASES))
def test_unroll_params_groups_the_layers_jax_groups(case):
    raw = make_v7_gguf(**UNROLL_CASES[case], seed=21)
    _, jparams = jax_load_model(JaxGgufFile(raw))
    _, params = load_model(GgufFile(raw), device="cpu")
    jun, un = jax_unroll_params(jparams), unroll_params(params)
    assert isinstance(un["blocks"], list) and len(un["blocks"]) == len(jun["blocks"])
    got = ["Wrkv_g" in blk["att"] for blk in un["blocks"]]
    assert got == ["Wrkv_g" in blk["att"] for blk in jun["blocks"]]
    assert all(got) == (case == "q4k") and any(got) == (case == "q4k")
    assert unroll_params(un) is un  # list-form blocks come back unchanged
    # the per-layer blocks are views of the stacked ones
    last = len(un["blocks"]) - 1
    assert (un["blocks"][last]["att"]["Wr"].arrays["codes"].data_ptr()
            == params["blocks"]["att"]["Wr"].layer(last).arrays["codes"].data_ptr())


@pytest.fixture(scope="module")
def q4km():
    raw = make_v7_gguf(**UNROLL_CASES["q4k"], seed=22)
    return raw, load_model(GgufFile(raw), device="cpu")


@pytest.fixture
def jax_quant_matmul(monkeypatch):
    """The JAX package's quantized matmuls through ``quant_matmul`` (the
    branch its ``Matrix.matmul`` takes on a TPU), in interpret mode."""
    real = jax_matrix_mod.Matrix.matmul

    def matmul(self, x, precision=None):
        m, k = self.dims()
        if (self.kind in ("qk", "qk_b", "qk_nomin") and self.arrays["codes"].ndim == 2
                and m % 8 == 0):
            y = jax_mm.quant_matmul(x.reshape(-1, k), self.kind, self.arrays, m, k)
            return y.reshape(x.shape[:-1] + (m,))
        return real(self, x, precision)

    monkeypatch.setattr(jax_matrix_mod.Matrix, "matmul", matmul)
    monkeypatch.setattr(pcfg, "interpret", True)


def _count_launches(monkeypatch):
    """Count each kernel wrapper's calls where the forward and the matrix
    module call them (on the CPU the wrappers take their plain versions
    and count nothing themselves)."""
    calls = collections.Counter()

    def spy(module, name):
        fn = getattr(module, name)

        def counted(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)

        monkeypatch.setattr(module, name, counted)

    for name in ("quant_gemv_grouped", "att_core7_step", "layer_scan7", "wkv7_scan"):
        spy(port_forward, name)
    for name in ("q4k_gemv", "q4k_gemm", "q6k_gemv", "q6k_gemm", "qs_gemv", "qs_gemm"):
        spy(port_matrix, name)
    return calls


def test_unrolled_decode_matches_jax(q4km, jax_quant_matmul, monkeypatch):
    """Three B=1 decode steps from a zero state: per step and layer one
    grouped r/k/v launch, the attention core, and Wo and the FFN on their
    Q4_K gemvs; the Q6_K head gemv (largest errors seen: logits 6.3e-4 of
    max, layer 0's states 6.8e-7)."""
    raw, (info, params) = q4km
    jinfo, jparams = jax_load_model(JaxGgufFile(raw))
    un, jun = unroll_params(params), jax_unroll_params(jparams)
    assert all("Wrkv_g" in blk["att"] for blk in jun["blocks"])
    calls = _count_launches(monkeypatch)
    st, jst = init_state(info, 1, device="cpu"), jax_init_state(jinfo, 1)
    L = info.num_layer
    for step in range(3):
        tok = np.array([[3 + 7 * step]])
        x, st = forward_chunk(info, un, st, torch.from_numpy(tok), torch.tensor([1]))
        logits = logits_head(un, x[:, 0])
        jx, jst = jax_forward_chunk(jinfo, jun, jst, jnp.asarray(tok, jnp.int32),
                                    jnp.asarray([1], jnp.int32))
        _close_to_max(logits, jax_logits_head(jun, jx[:, 0]), LOGITS_TOL)
        for key, tol in LAYER0_TOL.items():
            assert _rel(st[key][0], jst[key][0]) <= tol, (step, key)
    assert calls == {"quant_gemv_grouped": 3 * L, "att_core7_step": 3 * L,
                     "q4k_gemv": 3 * 3 * L, "q6k_gemv": 3}


@pytest.mark.parametrize("rescale", [None, 1])
def test_unrolled_decode_matches_the_whole_stack_step(q4km, monkeypatch, rescale):
    """The same three steps on the unrolled params and on the whole-stack
    blocks, both in the gemv class at these widths (largest error seen:
    3.7e-7 of max on the state, 0 on x)."""
    _, (info, params) = q4km
    un, stacked = unroll_params(params), prepare_decode(params, info, 1)
    assert "mega7" in stacked
    calls = _count_launches(monkeypatch)
    st_u, st_s = init_state(info, 1, device="cpu"), init_state(info, 1, device="cpu")
    for step in range(3):
        tok = torch.tensor([[5 + 11 * step]])
        xu, st_u = forward_chunk(info, un, st_u, tok, torch.tensor([1]), rescale=rescale)
        xs, st_s = forward_chunk(info, stacked, st_s, tok, torch.tensor([1]), rescale=rescale)
        _close_to_max(xu, xs, STACK_TOL)
        for key in st_s:
            _close_to_max(st_u[key], st_s[key], STACK_TOL)
    L = info.num_layer
    assert calls == {"quant_gemv_grouped": 3 * L, "att_core7_step": 3 * L,
                     "q4k_gemv": 3 * 3 * L, "layer_scan7": 3}


def test_grouped_path_needs_one_lane_and_one_token(q4km, monkeypatch):
    """At two lanes, or a chunk of two tokens, r, k and v go through their
    own matrices, as the JAX package's ``_fused_att_core_ok`` gate has it."""
    _, (info, params) = q4km
    un = unroll_params(params)
    calls = _count_launches(monkeypatch)
    forward_chunk(info, un, init_state(info, 2, device="cpu"), torch.tensor([[1], [2]]),
                  torch.tensor([1, 1]))
    forward_chunk(info, un, init_state(info, 1, device="cpu"), torch.tensor([[1, 2]]),
                  torch.tensor([2]))
    assert calls["quant_gemv_grouped"] == 0
    assert calls["q4k_gemv"] == 2 * 6 * info.num_layer


def _outcome(prepared):
    """What prepare_decode arranged: the whole-stack key or the per-layer
    list with the layers that carry grouped r/k/v operands."""
    blocks = prepared["blocks"]
    return (sorted({"mega7", "mega56"} & set(prepared)), isinstance(blocks, list),
            ["Wrkv_g" in blk["att"] for blk in blocks] if isinstance(blocks, list) else None)


@pytest.mark.parametrize("case", ["q4k-b1", "q4k-b17", "nf4-b1", "list-b1"])
def test_prepare_decode_falls_back_to_unroll_as_jax(q4km, case, monkeypatch):
    """Where no whole-stack block attaches, both packages unroll: a batch
    above ``MAX_SCAN_BATCH`` gets per-layer blocks with the grouped r/k/v
    operands, an NF4 model (no whole-stack form, no grouped kind) per-layer
    blocks without them; per-layer (list) params come back unchanged."""
    raw, (info, params) = q4km
    kind, b = case.split("-b")
    B = int(b)
    if kind == "nf4":
        raw = make_v7_gguf(**{**UNROLL_CASES["q4k"], "quantize": None,
                              "head_quantize": None}, dtype=np.float16, seed=23)
        info, params = load_model(GgufFile(raw), quant=QuantScheme.NF4, device="cpu")
        jinfo, jparams = jax_load_model(JaxGgufFile(raw), quant=jax_formats.QuantScheme.NF4)
    else:
        jinfo, jparams = jax_load_model(JaxGgufFile(raw))
    if kind == "list":
        params, jparams = unroll_params(params), jax_unroll_params(jparams)
    monkeypatch.setattr(pcfg, "interpret", True)  # the JAX package's kernels "on"
    jprep, prep = jax_prepare_decode(jparams, jinfo, B), prepare_decode(params, info, B)
    assert _outcome(prep) == _outcome(jprep)
    want = {"q4k-b1": (["mega7"], False, None),
            "q4k-b17": ([], True, [True] * info.num_layer),
            "nf4-b1": ([], True, [False] * info.num_layer),
            "list-b1": ([], True, [True] * info.num_layer)}[case]
    assert _outcome(prep) == want
    if kind == "list":
        assert prep is params
    assert B <= MAX_SCAN_BATCH or "mega7" not in prep
