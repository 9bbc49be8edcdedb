"""The port's runtime against the JAX package's, on the CPU: the chunk
scheduler on the cases of tests/test_scheduler.py, and the Engine's
``infer`` / ``generate`` / state calls on the same GGUF bytes.

Tolerances: f32 dense, rtol = atol = 2e-4 on logits, as
tests/test_oracle.py:228 holds the JAX forward to its scalar oracle, and
atol = 2e-4·max|state| on the state, which reaches ~10² here (the two
packages' WKV scans sum in another order); greedy tokens identical (one
numerics class). Q4_K_M, atol =
3e-2·max|logit| as in tests/test_torch_forward.py (the JAX CPU path rounds
the whole dequantized Q4_K weight to bf16, the port follows the
gemv/GEMM classes of ``quant_matmul``). The largest errors seen are
recorded beside each test.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import web_rwkv_gguf_tpu.runtime.scheduler as jax_sched
from web_rwkv_gguf_tpu.gguf import GgufFile as JaxGgufFile
from web_rwkv_gguf_tpu.models import load_model as jax_load_model
from web_rwkv_gguf_tpu.runtime import Engine as JaxEngine
import web_rwkv_gguf_tpu_torch.runtime.scheduler as port_sched
from web_rwkv_gguf_tpu_torch.errors import EngineError, TensorError
from web_rwkv_gguf_tpu_torch.gguf import GgufFile
from web_rwkv_gguf_tpu_torch.models import load_model
from web_rwkv_gguf_tpu_torch.quant.ggml import GgmlDType
from web_rwkv_gguf_tpu_torch.runtime import Engine, RnnInput, RnnInputBatch, RnnOption, softmax
from web_rwkv_gguf_tpu_torch.utils.synthetic import make_v7_gguf

F32_TOL = 2e-4
Q4KM_LOGITS_TOL = 3e-2
CHUNK = 32

# ---------------------------------------------------------------------------
# scheduler: each case runs against a scheduler module and returns plain data
# ---------------------------------------------------------------------------

L, F = "last", "full"


def _plans(plan):
    return [(p.len, None if p.option is None else p.option.value) for p in plan]


def _mk(S, batches, chunk):
    return S.RnnInput([S.RnnInputBatch([0] * n, S.RnnOption(o)) for n, o in batches],
                      token_chunk_size=chunk)


def _case_run_iter(S):
    it = S.RnnIter(_mk(S, [(139, L), (1, L), (0, F), (65, F)], 128))
    return [_plans(next(it)) for _ in range(5)]


def _case_advance(S):
    run = _mk(S, [(139, L), (1, L), (0, F), (65, F)], 128)
    run.step()
    return _plans(run.plan()), _plans(_mk(S, [(61, L), (1, L), (0, F), (3, F)], 128).plan())


def _case_redirect(S):
    out = []
    for batches, chunk in (([(61, L), (0, L), (0, F), (3, F)], 128),
                           ([(11, L), (8, L), (9, L), (4, L)] * 2, 32)):
        r = S.redirect(_mk(S, batches, chunk).plan())
        out.append((r.headers, r.inputs, r.outputs))
    return out


def _case_min_chunk_rounding(S):
    return S.MIN_TOKEN_CHUNK_SIZE, [
        S.RnnInput([S.RnnInputBatch([0] * 5)], token_chunk_size=c).token_chunk_size
        for c in (1, 32, 33, 128, 129)]


def _case_randomized(S):
    """Every plan of 200 random workloads, drained chunk by chunk."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(200):
        n_batch = int(rng.integers(1, 6))
        lens = [int(rng.integers(0, 90)) for _ in range(n_batch)]
        opts = [L if rng.random() < 0.7 else F for _ in range(n_batch)]
        run = _mk(S, list(zip(lens, opts)), int(rng.choice([32, 64, 128])))
        while run.num_token:
            plan = run.plan()
            out.append((_plans(plan), S.plan_chunk(
                [len(b.tokens) for b in run.batches], [b.option for b in run.batches],
                run.token_chunk_size) == plan))
            run.step(plan)
    return out


@pytest.mark.parametrize("case", [_case_run_iter, _case_advance, _case_redirect,
                                  _case_min_chunk_rounding, _case_randomized],
                         ids=lambda c: c.__name__[len("_case_"):])
def test_scheduler_matches_jax(case):
    assert case(port_sched) == case(jax_sched)


# ---------------------------------------------------------------------------
# the Engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def f32_models():
    raw = make_v7_gguf(n_layer=2, n_emb=128, head_size=32, n_vocab=64, seed=21)
    return (jax_load_model(JaxGgufFile(raw), dtype=jnp.float32),
            load_model(GgufFile(raw), dtype=torch.float32, device="cpu"))


def _engines(models, num_batch, **kw):
    (jinfo, jparams), (info, params) = models
    return (JaxEngine(jinfo, jparams, num_batch, token_chunk_size=CHUNK, **kw),
            Engine(info, params, num_batch, token_chunk_size=CHUNK, device="cpu", **kw))


def _tokens(n, seed, vocab):
    return [int(t) for t in np.random.default_rng(seed).integers(0, vocab, n)]


def _close(got, want, tol=F32_TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


def _close_states(eng, jeng, lanes):
    for b in range(lanes):
        for key, want in jeng.back_state(b).items():
            np.testing.assert_allclose(eng.back_state(b)[key], want, rtol=0,
                                       atol=F32_TOL * np.abs(want).max())


def test_engine_infer_matches_jax(f32_models):
    """A LAST lane of 45 tokens and a FULL lane of 20 through chunked
    ``infer`` (T = 32, 32, 1), then one decode token per lane: every
    chunk's logits rows and the final state (largest error seen: 7.0e-5
    absolute on logits, 2.2e-6 of max|state| on the state)."""
    jeng, eng = _engines(f32_models, 2)
    lanes = [(_tokens(45, 1, 64), "last"), (_tokens(20, 2, 64), "full")]
    jinp = jax_sched.RnnInput([jax_sched.RnnInputBatch(list(t), jax_sched.RnnOption(o))
                               for t, o in lanes], CHUNK)
    inp = RnnInput([RnnInputBatch(list(t), RnnOption(o)) for t, o in lanes], CHUNK)
    calls = 0
    while inp.num_token:
        jout, out = jeng.infer(jinp), eng.infer(inp)
        calls += 1
        assert [o.shape for o in out] == [o.shape for o in jout]
        for o, jo in zip(out, jout):
            _close(o, jo)
    assert calls == 3 and jinp.num_token == 0
    for b in range(2):
        jinp.batches[b].option = jax_sched.RnnOption.LAST
        inp.batches[b].option = RnnOption.LAST
        jinp.batches[b].push(5 + b)
        inp.batches[b].push(5 + b)
    for o, jo in zip(eng.infer(inp), jeng.infer(jinp)):
        assert o.shape == (1, 64)
        _close(o, jo)
        e = np.exp(jo - jo.max(-1, keepdims=True))
        _close(softmax(o), e / e.sum(-1, keepdims=True))
    _close_states(eng, jeng, 2)


def test_engine_generate_matches_jax(f32_models):
    """Greedy ``generate`` on prompts of 40 and 9 tokens (prefill over two
    chunks, then 4-token segments): identical tokens and final state
    (largest state error seen: 1.4e-6 of max|state|)."""
    jeng, eng = _engines(f32_models, 2)
    prompts = [_tokens(40, 3, 64), _tokens(9, 4, 64)]
    want = jeng.generate(prompts, 7, segment=4)
    got = eng.generate(prompts, 7, segment=4)
    assert got == want
    assert [len(t) for t in got] == [7, 7]
    _close_states(eng, jeng, 2)


def test_engine_state_round_trip(f32_models):
    """``back_state`` / ``load_state`` restore a lane exactly; ``reset_state``
    restores one lane (or all) to the initial state, ``initial_wkv``
    included."""
    info = f32_models[1][0]
    L, H, hs = info.num_layer, info.num_head, info.head_size
    wkv0 = np.random.default_rng(5).normal(size=(L, H, hs, hs)).astype(np.float32)
    _, eng = _engines(f32_models, 2, initial_wkv=wkv0)
    np.testing.assert_array_equal(eng.back_state(1)["wkv"], wkv0)
    inp = RnnInput([RnnInputBatch(_tokens(10, 6, 64)), RnnInputBatch(_tokens(7, 7, 64))],
                   CHUNK)
    eng.infer(inp)
    snap = eng.back_state(1)
    inp.batches[1].append([3, 4])
    eng.infer(inp)
    assert not np.array_equal(eng.back_state(1)["wkv"], snap["wkv"])
    eng.load_state(1, snap)
    for key, a in snap.items():
        np.testing.assert_array_equal(eng.back_state(1)[key], a)
    lane0 = eng.back_state(0)
    eng.reset_state(1)
    np.testing.assert_array_equal(eng.back_state(1)["wkv"], wkv0)
    np.testing.assert_array_equal(eng.back_state(1)["att_shift"], 0)
    np.testing.assert_array_equal(eng.back_state(0)["wkv"], lane0["wkv"])
    eng.reset_state()
    np.testing.assert_array_equal(eng.back_state(0)["wkv"], wkv0)


def test_engine_typed_errors(f32_models):
    _, eng = _engines(f32_models, 2)
    with pytest.raises(TensorError) as e:
        eng.infer(RnnInput([RnnInputBatch([1, 2])], CHUNK))
    assert e.value.kind == "batch"
    with pytest.raises(TensorError):
        eng.generate([[1, 2]], 3)
    with pytest.raises(EngineError):
        eng.generate([[1, 2], []], 3)
    # an embedding token (Token::Embed) must be one row of the model's width
    with pytest.raises(TensorError) as e:
        eng.infer(RnnInput([RnnInputBatch([1, np.zeros(129, np.float32)]),
                            RnnInputBatch([2])], CHUNK))
    assert e.value.kind == "size"


def test_engine_q4km_logits_match_jax():
    """Q4_K_M (Q4_K layers, Q6_K head): a 40-token prompt prefilled in two
    chunks (the port's dequant-GEMM and WKV scan, plain on the CPU), then
    one decode token: LAST logits at the stated tolerance (largest error
    seen: 1.2e-2 of max|logit|)."""
    raw = make_v7_gguf(n_layer=2, n_emb=256, head_size=64, n_vocab=512, n_hidden=1024,
                       quantize=GgmlDType.Q4_K, head_quantize=GgmlDType.Q6_K, seed=12)
    jeng, eng = _engines((jax_load_model(JaxGgufFile(raw)),
                          load_model(GgufFile(raw), device="cpu")), 1)
    prompt = _tokens(40, 8, 512)
    jinp = jax_sched.RnnInput([jax_sched.RnnInputBatch(list(prompt))], CHUNK)
    inp = RnnInput([RnnInputBatch(list(prompt))], CHUNK)
    for step in range(3):
        if step == 2:
            jinp.batches[0].push(17)
            inp.batches[0].push(17)
        jout, out = jeng.infer(jinp), eng.infer(inp)
        assert out[0].shape == jout[0].shape
        if len(jout[0]):
            want = np.asarray(jout[0])
            np.testing.assert_allclose(out[0], want, rtol=0,
                                       atol=Q4KM_LOGITS_TOL * np.abs(want).max())


def test_engine_generate_honours_rescale():
    """``Engine(rescale=1)`` on a file loaded with ``rescale=1`` (every
    layer's output and FFN value matrices pre-multiplied by 2^-i, the
    residual halved after every layer): the port's ``generate`` (greedy,
    one-token segments) against a JAX decode driven token by token
    through ``Engine.infer``, which honours ``rescale`` at every chunk:
    identical tokens and final state (largest state error seen: 2.5e-6
    of max|state|).

    The JAX package's own ``Engine.generate`` is not the reference here:
    it builds its generator without the engine's ``rescale``
    (web_rwkv_gguf_tpu/runtime/engine.py:731-734) while its prefill
    passes it (:305), so after the prompt it decodes with the residual
    never halved; on this file it picks other tokens, asserted below so
    that the mismatch stays on record. The port passes ``rescale`` to
    both (web_rwkv_gguf_tpu_torch/runtime/engine.py, ``generate``)."""
    raw = make_v7_gguf(n_layer=2, n_emb=128, head_size=32, n_vocab=64, seed=22)
    models = (jax_load_model(JaxGgufFile(raw), dtype=jnp.float32, rescale=1),
              load_model(GgufFile(raw), dtype=torch.float32, rescale=1, device="cpu"))
    jeng, eng = _engines(models, 2, rescale=1)
    prompts = [_tokens(40, 3, 64), _tokens(9, 4, 64)]
    got = eng.generate(prompts, 5, segment=1)
    jinp = jax_sched.RnnInput([jax_sched.RnnInputBatch(list(p)) for p in prompts], CHUNK)
    last = [None, None]  # each lane's logits after its prompt's last chunk
    while jinp.num_token:
        for b, o in enumerate(jeng.infer(jinp)):
            if len(o):
                last[b] = o[-1]
    want = [[int(np.argmax(o))] for o in last]
    for _ in range(4):
        for b, toks in enumerate(want):
            jinp.batches[b].push(toks[-1])
        for b, o in enumerate(jeng.infer(jinp)):
            want[b].append(int(np.argmax(o[-1])))
    assert got == want
    _close_states(eng, jeng, 2)
    jeng.reset_state()
    assert jeng.generate(prompts, 5, segment=1) != want
