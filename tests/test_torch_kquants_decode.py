"""RWKV-7 and RWKV-6 models in the Q5_K_M placement (Q5_K layers, Q6_K
head) and in Q8_0, through the port against the JAX package on the CPU:
the whole-stack decode step's plain version (``layer_scan7_plain``,
``layer_scan56_plain``) on Q5_K and Q8_0 stacks against JAX
``layer_scan7`` / ``layer_scan56`` (Pallas in interpret mode) and
against the port's per-layer path; ``forward_chunk``, ``logits_head`` and
the Engine against the JAX package's.

The JAX side multiplies through ``quant_matmul`` (its TPU kernels, in
interpret mode; its CPU default for these kinds is an XLA form in
another numerics class at prefill).

Tolerances, those of tests/test_torch_decode.py and
tests/test_torch_forward.py: against JAX, layer 0's att_shift and WKV
state at 1e-5·max (the same f32 function summed in another order) and
every output at 3e-2·max (a bf16 operand rounding flipped in layer 0
carries into later layers). Layer 0's ffn_shift comes after the bf16
rounding of Wo's input, where a rounding flipped by the other summation
order moves it by that element's bf16 step through Wo (seen: up to
7.8e-4 of max, V6 Q8_0; 8.4e-5 on a Q4_K file of these widths, seed
64): it is held at 2^-8·max, one bf16 step, as chip_smoke.py holds a
whole-stack layer. Against the port's per-layer path,
1e-6·max: at these widths (C=256, FFN 512) every matrix of the per-layer
path takes its gemv at B ≤ 5, the class the whole-stack step runs at
every B, so both sides compute the same function (at the 0.1B and 1.6B
widths the FFN value goes to the GEMM even at B=1; chip_smoke.py holds
the kernel against this plain version, not against the per-layer path).
The largest errors seen are recorded beside each test.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from web_rwkv_gguf_tpu.gguf import GgufFile as JaxGgufFile
from web_rwkv_gguf_tpu.models import forward_chunk as jax_forward_chunk
from web_rwkv_gguf_tpu.models import init_state as jax_init_state
from web_rwkv_gguf_tpu.models import load_model as jax_load_model
from web_rwkv_gguf_tpu.models import logits_head as jax_logits_head
from web_rwkv_gguf_tpu.models.forward import embed_tokens as jax_embed
import web_rwkv_gguf_tpu.models.matrix as jax_matrix_mod
from web_rwkv_gguf_tpu.ops.pallas import config as pcfg
from web_rwkv_gguf_tpu.ops.pallas.matmul import quant_matmul
from web_rwkv_gguf_tpu.ops.pallas.layer7 import layer_scan7 as jax_layer_scan7
from web_rwkv_gguf_tpu.ops.pallas.layer7 import prep_decode7 as jax_prep_decode7
from web_rwkv_gguf_tpu.ops.pallas.layer56 import layer_scan56 as jax_layer_scan56
from web_rwkv_gguf_tpu.ops.pallas.layer56 import prep_decode56 as jax_prep_decode56
from web_rwkv_gguf_tpu.runtime import Engine as JaxEngine
from web_rwkv_gguf_tpu.runtime import scheduler as jax_sched
from web_rwkv_gguf_tpu_torch.gguf import GgufFile
from web_rwkv_gguf_tpu_torch.models import (
    embed_tokens, forward_chunk, init_state, load_model, logits_head, prepare_decode,
)
from web_rwkv_gguf_tpu_torch.models.forward import GN_EPS, L2_EPS, LN_EPS
from web_rwkv_gguf_tpu_torch.ops.cuda.layer7 import (
    FORM_Q6K, FORM_QKB, FORM_QS, descriptor, layer_scan7, stack_matrix,
)
from web_rwkv_gguf_tpu_torch.ops.cuda.layer56 import layer_scan56
from web_rwkv_gguf_tpu_torch.quant.ggml import GgmlDType
from web_rwkv_gguf_tpu_torch.runtime import Engine, RnnInput, RnnInputBatch
from web_rwkv_gguf_tpu_torch.utils.synthetic import make_v6_gguf, make_v7_gguf

VOCAB = 512
WIDTHS = {"v7": (make_v7_gguf, dict(n_layer=3, n_emb=256, head_size=64, n_vocab=VOCAB,
                                    n_hidden=512)),
          "v6": (make_v6_gguf, dict(n_layer=3, n_emb=256, head_size=64, n_vocab=VOCAB,
                                    n_hidden=512, rank_tm=8, rank_td=8))}
PLACEMENTS = {"q5km": dict(quantize=GgmlDType.Q5_K, head_quantize=GgmlDType.Q6_K),
              "q8_0": dict(quantize=GgmlDType.Q8_0)}
CASES = [(v, p) for v in WIDTHS for p in PLACEMENTS]
SEEDS = {("v7", "q5km"): 40, ("v7", "q8_0"): 41, ("v6", "q5km"): 50, ("v6", "q8_0"): 51}
LOGITS_TOL = 3e-2
LAYER0_TOL = {"att_shift": 1e-5, "wkv": 1e-5, "ffn_shift": 2.0 ** -8}


@pytest.fixture(scope="module", params=CASES, ids=[f"{v}-{p}" for v, p in CASES])
def case(request):
    version, placement = request.param
    make, widths = WIDTHS[version]
    raw = make(**widths, **PLACEMENTS[placement], seed=SEEDS[request.param])
    return version, placement, raw, load_model(GgufFile(raw), device="cpu")


def _tokens(B, step):
    return (np.arange(B)[:, None] * 5 + 3 + 4 * step) % VOCAB


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


def _close_to_max(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=rel * np.abs(want).max())


@pytest.fixture
def jax_quant_matmul(monkeypatch):
    """The JAX package's quantized matmuls through ``quant_matmul`` (the
    branch its ``Matrix.matmul`` takes on a TPU), in interpret mode."""
    real = jax_matrix_mod.Matrix.matmul

    def matmul(self, x, precision=None):
        m, k = self.dims()
        if (self.kind in ("qk", "qk_b", "qk_nomin") and self.arrays["codes"].ndim == 2
                and m % 8 == 0):
            y = quant_matmul(x.reshape(-1, k), self.kind, self.arrays, m, k)
            return y.reshape(x.shape[:-1] + (m,))
        return real(self, x, precision)

    monkeypatch.setattr(jax_matrix_mod.Matrix, "matmul", matmul)
    monkeypatch.setattr(pcfg, "interpret", True)


def _mega(version, params, info, B):
    return prepare_decode(params, info, B)["mega7" if version == "v7" else "mega56"]


def test_stacks_take_their_form(case):
    """Q5_K layer stacks take the native byte-kind slot, Q8_0 stacks the
    f32-scale slot over signed bytes, in per-32 groups; the Q6_K head of
    the Q5_K_M placement is a slot form too (the native Q6_K slot, signed
    codes in 16-groups), as the Q8_0 head is (the f32-scale one)."""
    version, placement, _, (info, params) = case
    mega = _mega(version, params, info, 2)
    form = FORM_QKB if placement == "q5km" else FORM_QS
    signed = 0 if placement == "q5km" else 1
    assert set(mega["forms"].values()) == {descriptor(form, signed, 32)}
    head = stack_matrix(params["head"])
    want = descriptor(FORM_Q6K, 1, 16) if placement == "q5km" else descriptor(FORM_QS, 1, 32)
    assert head is not None and head[0] == want


@pytest.mark.parametrize("B", [1, 5])
def test_layer_scan_matches_jax(case, B):
    """Two decode steps from a zero state, all lanes live (largest errors
    seen: layer 0's att_shift and WKV state 1.9e-6 of max, its ffn_shift
    7.8e-4, every output 1.4e-2)."""
    version, _, raw, (info, params) = case
    mega = _mega(version, params, info, B)
    jinfo, jparams = jax_load_model(JaxGgufFile(raw))
    v7 = version == "v7"
    jmega = (jax_prep_decode7 if v7 else jax_prep_decode56)(jparams, jinfo)
    eps = (LN_EPS, GN_EPS, L2_EPS) if v7 else (LN_EPS, GN_EPS)
    scan, jscan = (layer_scan7, jax_layer_scan7) if v7 else (layer_scan56, jax_layer_scan56)
    st, jst = init_state(info, B, device="cpu"), jax_init_state(jinfo, B)
    pcfg.interpret = True
    try:
        for step in range(2):
            tok = _tokens(B, step)
            x = embed_tokens(params, torch.tensor(tok))[:, 0]
            xo, st = scan(mega, st, x, torch.ones(B), None, *eps)
            jx = jax_embed(jparams, jnp.asarray(tok))[:, 0]
            jxo, jst = jscan(jmega, jst, jx, jnp.ones((B,), jnp.float32), None, *eps)
            assert _rel(xo, jxo) <= LOGITS_TOL
            for key in jst:
                assert _rel(st[key][0], jst[key][0]) <= LAYER0_TOL[key], key
                assert _rel(st[key], jst[key]) <= LOGITS_TOL, key
    finally:
        pcfg.interpret = False


@pytest.mark.parametrize("B,rescale", [(1, None), (5, 2)])
def test_layer_scan_matches_the_per_layer_path(case, B, rescale):
    """Three steps through ``forward_chunk`` with and without the decode
    blocks, both in the gemv class at these widths (module docstring); at
    B=5 lane 2 is frozen on the second step (largest error seen: 0)."""
    version, _, _, (info, params) = case
    prepared = prepare_decode(params, info, B)
    assert {"mega7", "mega56"} & set(prepared)
    st_a, st_b = init_state(info, B, device="cpu"), init_state(info, B, device="cpu")
    for step in range(3):
        tok = torch.tensor(_tokens(B, step))
        lens = torch.ones(B, dtype=torch.long)
        if step == 1 and B > 2:
            lens[2] = 0
        xa, st_a = forward_chunk(info, params, st_a, tok, lens, rescale=rescale)
        xb, new_b = forward_chunk(info, prepared, st_b, tok, lens, rescale=rescale)
        if step == 1 and B > 2:
            for key in st_b:
                assert torch.equal(new_b[key][:, 2], st_b[key][:, 2])
        st_b = new_b
        live = lens > 0
        assert _rel(xb[live], xa[live]) <= 1e-6
        for key in st_a:
            assert _rel(st_b[key], st_a[key]) <= 1e-6, key


def test_forward_matches_jax(case, jax_quant_matmul):
    """A ragged T=37 chunk (the dequant-GEMMs), then two T=1 steps (the
    gemvs), lane 1 frozen on the last: the live lanes' last logits at the
    Q4_K_M tolerance (largest error seen: 6.4e-3 of max|logit|)."""
    _, _, raw, (info, params) = case
    jinfo, jparams = jax_load_model(JaxGgufFile(raw))
    rng = np.random.default_rng(3)
    chunks = [(rng.integers(0, VOCAB, (2, 37)), np.array([37, 20])),
              (rng.integers(0, VOCAB, (2, 1)), np.array([1, 1])),
              (rng.integers(0, VOCAB, (2, 1)), np.array([1, 0]))]
    st, jst = init_state(info, 2, device="cpu"), jax_init_state(jinfo, 2)
    for toks, lens in chunks:
        x, st = forward_chunk(info, params, st, torch.from_numpy(toks), torch.from_numpy(lens))
        jx, jst = jax_forward_chunk(jinfo, jparams, jst, jnp.asarray(toks, jnp.int32),
                                    jnp.asarray(lens, jnp.int32))
        live = lens > 0
        last = np.maximum(lens - 1, 0)
        _close_to_max(logits_head(params, x[np.arange(2), last])[live],
                      np.asarray(jax_logits_head(jparams, jx[np.arange(2), last]))[live],
                      LOGITS_TOL)


def test_engine_matches_jax(case, jax_quant_matmul):
    """The Engine: two prompts of 45 and 9 tokens in chunks of 32, then a
    decode token on each lane (the Engine's whole-stack step): LAST
    logits at the Q4_K_M tolerance (largest error seen: 8.1e-3 of
    max|logit|)."""
    _, _, raw, (info, params) = case
    jinfo, jparams = jax_load_model(JaxGgufFile(raw))
    jeng = JaxEngine(jinfo, jparams, 2, token_chunk_size=32)
    eng = Engine(info, params, 2, token_chunk_size=32, device="cpu")
    rng = np.random.default_rng(9)
    prompts = [[int(t) for t in rng.integers(0, VOCAB, n)] for n in (45, 9)]
    jinp = jax_sched.RnnInput([jax_sched.RnnInputBatch(list(p)) for p in prompts], 32)
    inp = RnnInput([RnnInputBatch(list(p)) for p in prompts], 32)
    pushed = False
    while inp.num_token or not pushed:
        if not inp.num_token:
            for b, t in enumerate((17, 300)):
                jinp.batches[b].push(t)
                inp.batches[b].push(t)
            pushed = True
        jout, out = jeng.infer(jinp), eng.infer(inp)
        assert [o.shape for o in out] == [o.shape for o in jout]
        for o, jo in zip(out, jout):
            if len(jo):
                _close_to_max(o, jo, LOGITS_TOL)
    assert "mega7" in eng.params or "mega56" in eng.params


@pytest.mark.parametrize("seed", [41, 42])
def test_q5km_compare_model_against_jax(seed, jax_quant_matmul):
    """chip_smoke.py's card-vs-CPU decode check on its Q5_K_M compare model
    (RWKV-7 at the 0.1B widths, two layers, three decode steps at B=3),
    with the JAX package's kernels in interpret mode in the card's place: a
    second implementation of the same numerics class, and no kernel of the
    port. Seed 41's model reads past chip_smoke's limits here too (chunk 0:
    logits 1.15e-2 of max, layer 1's WKV state 3.79e-2, against 1e-2 and
    3e-2; seed 42's at most 6.2e-3 and 2.0e-2): the excess it shows on the
    card is this model's sensitivity to the order of f32 sums, not a wrong
    product (PERF.md, Findings PR 5), and chip_smoke's compare model is seed
    42's. Held: the logits at the Q4_K_M tolerance, layer 0's WKV state at
    1e-5·max, and chip_smoke's compare seed within its card-vs-CPU limits."""
    import chip_smoke as cs
    from web_rwkv_gguf_tpu_torch import models

    raw, _ = cs.build_file("v7q5", cs.COMPARE_LAYERS, seed)
    info, params = load_model(GgufFile(raw), device="cpu")
    jinfo, jparams = jax_load_model(JaxGgufFile(raw))
    decode = [(np.array(t)[:, None], np.array(n)) for t, n in cs.COMPARE_STEPS]
    port = cs.run_chunks(torch, models, info, params, decode, "cpu")
    jst, jax_out = jax_init_state(jinfo, len(decode[0][1])), []
    for toks, lens in decode:
        jx, jst = jax_forward_chunk(jinfo, jparams, jst, jnp.asarray(toks, jnp.int32),
                                    jnp.asarray(lens, jnp.int32))
        live = np.nonzero(lens > 0)[0]
        jax_out.append({"logits": torch.tensor(np.asarray(
                            jax_logits_head(jparams, jx[live, lens[live] - 1]))),
                        **{k: torch.tensor(np.asarray(v)) for k, v in jst.items()}})
    rel = cs.rel_diff(port, jax_out)
    for i, r in enumerate(rel):
        print(f"seed {seed}, chunk {i}: " + ", ".join(f"{k} {v:.3e}" for k, v in r.items()))
    assert all(r["logits"] <= LOGITS_TOL and r["wkv.0"] <= 1e-5 for r in rel)
    if seed == cs.MODELS["v7q5"]["compare_seed"]:
        assert all(v <= cs.card_cpu_limit(k) for r in rel for k, v in r.items())


def test_staged_excess_holds_each_bf16_element():
    """chip_smoke.staged_excess, through which a whole-stack layer's x may
    pass on its staged operands: every bf16 element one rounding flip from
    its replay passes; khid with its elements below 16 zeroed does not, nor
    y two steps away, nor an f32 product off by more than one bf16 step of
    its max; a masked lane is not held."""
    import chip_smoke as cs

    g = torch.Generator().manual_seed(0)
    B, C, hidden = 3, 64, 256
    rep = {"y": torch.randn(B, C, generator=g).to(torch.bfloat16),
           "khid": (torch.randn(B, hidden, generator=g) * 50).relu().square().to(torch.bfloat16)}
    st_p = {"rkvg": torch.randn(4, B, C, generator=g), "rf": torch.randn(B, C, generator=g)}
    live = torch.tensor([True, False, True])

    def up(t):  # every nonzero element one bf16 step further from 0
        return (t.view(torch.int16) + (t != 0).to(torch.int16)).view(torch.bfloat16)

    def shares(**kw):
        return cs.staged_excess({**st_p, **rep, **kw}, st_p, rep, 6, live)

    got, steps = shares(y=up(rep["y"]), khid=up(rep["khid"]))
    assert max(got.values()) <= 1.0 and steps["y"][0] == steps["khid"][0] == 0
    small = rep["khid"].float() < 16
    assert (rep["khid"].float() > 0).logical_and(small).any()
    assert shares(khid=rep["khid"].masked_fill(small, 0))[0]["khid"] > 1.0
    assert shares(y=up(up(rep["y"])))[0]["y"] > 1.0
    assert shares(rf=st_p["rf"] * (1 + 2 * cs.MEGA_LAYER_TOL))[0]["rf"] > 1.0
    masked = rep["y"].clone()
    masked[1] = 0
    assert shares(y=masked)[0]["y"] == 0


@pytest.mark.parametrize("placement,B", [("q5km", 1), ("q8_0", 5)])
def test_replay_staged_reproduces_the_staged_operands(placement, B):
    """layer56.replay_staged on the operands the plain version stages
    gives them back (y, khid bit for bit, x at 1e-6·max): the replay that
    chip_smoke.py holds the kernel's staged operands against computes what
    the plain version computes (largest error seen: 0)."""
    from web_rwkv_gguf_tpu_torch.ops.cuda.layer56 import mega_layers, replay_staged

    make, widths = WIDTHS["v6"]
    raw = make(**widths, **PLACEMENTS[placement], seed=SEEDS[("v6", placement)])
    info, params = load_model(GgufFile(raw), device="cpu")
    mega = _mega("v6", params, info, B)
    st = init_state(info, B, device="cpu")
    x = embed_tokens(params, torch.tensor(_tokens(B, 0)))[:, 0]
    mask = torch.ones(B)
    for step in range(2):  # the second step from a state the first left
        for i in range(mega["L"]):
            s_i = {k: v[i:i + 1] for k, v in st.items()}
            staged = {}
            x_i, _ = layer_scan56(mega_layers(mega, i, i + 1), s_i, x, mask, None, LN_EPS, GN_EPS,
                                  i, staged=staged)
            rep = replay_staged(mega, i, st, x, mask, LN_EPS, GN_EPS, staged)
            assert torch.equal(rep["y"], staged["y"]) and torch.equal(rep["khid"], staged["khid"])
            assert _rel(rep["x"], x_i) <= 1e-6
        x, st = layer_scan56(mega, st, x, mask, None, LN_EPS, GN_EPS)
