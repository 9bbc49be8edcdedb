"""The compiled step (``runtime/graph.py``) on the CPU.

``runtime.graph.CAPTURE`` is replaced by a recorder: it calls the step's
closure once at "capture" and again at each "replay", so the graph path
(static inputs and state, the in-place commit, the restore after the
warm-up, the counts a replay adds) runs here as on the card, and a closure
that read anything but its static buffers would give other numbers than
the eager step. Through it, on two-layer RWKV-7 and RWKV-6 models:

- ``Engine(graph=True)`` and an ``EnginePool`` of two equal
  ``graph=False`` bit for bit (one device, the same ops in the same
  order), ``reset_state``, ``load_state`` and a caller's assignment of
  ``engine.state`` between chunks included;
- the replayed Engine equals the JAX package's Engine on the same GGUF
  bytes at tests/test_torch_runtime.py's tolerances: f32 dense rtol =
  atol = 2e-4 on logits, 2e-4·max|state| on the state, greedy tokens
  identical; Q4_K_M 3e-2·max|logit|;
- the generator of a sampling config is captured once.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import web_rwkv_gguf_tpu.runtime.scheduler as jax_sched
from web_rwkv_gguf_tpu.gguf import GgufFile as JaxGgufFile
from web_rwkv_gguf_tpu.models import load_model as jax_load_model
from web_rwkv_gguf_tpu.runtime import Engine as JaxEngine
from web_rwkv_gguf_tpu_torch.errors import UnsupportedFeature
from web_rwkv_gguf_tpu_torch.gguf import GgufFile
from web_rwkv_gguf_tpu_torch.models import init_state, load_model, make_generator
from web_rwkv_gguf_tpu_torch.ops.cuda import matmul as mm
from web_rwkv_gguf_tpu_torch.ops.cuda import wkv7
from web_rwkv_gguf_tpu_torch.quant.ggml import GgmlDType
from web_rwkv_gguf_tpu_torch.runtime import (
    Engine, EnginePool, RnnInput, RnnInputBatch, RnnOption, graph,
)
from web_rwkv_gguf_tpu_torch.utils.synthetic import make_v6_gguf, make_v7_gguf

F32_TOL = 2e-4
Q4KM_LOGITS_TOL = 3e-2
CHUNK = 32
VOCAB = 64


class Recorder:
    """A stand-in for ``capture_cuda``: ``fn`` runs once at capture (the
    sampling generators put back after it, as a CUDA capture leaves them)
    and again at each replay, the launch counts put back after it (a
    replay runs no host code). ``captures`` counts the captures."""

    def __init__(self):
        self.captures = 0
        self.pools = []

    def __call__(self, fn, pool, stream, generators):
        self.captures += 1
        self.pools.append(pool)
        rng = [g.get_state() for g in generators]
        fn()
        for g, st in zip(generators, rng):
            g.set_state(st)

        def replay():
            counts = graph.launch_counts()
            out = fn()
            graph.set_launch_counts(counts)
            return out

        return replay


@pytest.fixture
def recorder(monkeypatch):
    rec = Recorder()
    monkeypatch.setattr(graph, "CAPTURE", rec)
    return rec


FILES = {
    "v7": lambda: make_v7_gguf(n_layer=2, n_emb=128, head_size=32, n_vocab=VOCAB, seed=21),
    "v6": lambda: make_v6_gguf(n_layer=2, n_emb=64, head_size=16, n_vocab=VOCAB, rank_tm=4,
                               rank_td=8, seed=11),
}


@pytest.fixture(scope="module", params=sorted(FILES))
def f32_file(request):
    return FILES[request.param]()


def _tokens(n, seed):
    return [int(t) for t in np.random.default_rng(seed).integers(0, VOCAB, n)]


def _state(eng):
    return {k: v.clone() for k, v in eng.state.items()}


def _traffic(eng):
    """Chunks of LAST and FULL lanes with the state reset, loaded and
    assigned between them, then greedy and sampled ``generate``: every
    output and state on the way."""
    out = []
    inp = RnnInput([RnnInputBatch(_tokens(45, 1)), RnnInputBatch(_tokens(20, 2), RnnOption.FULL),
                    RnnInputBatch(_tokens(3, 3))], CHUNK)
    out.append(eng.infer(inp).batches)  # T = 32, LAST and FULL lanes
    snap = eng.back_state(0)
    out.append(eng.infer(inp).batches)  # T = 16
    eng.reset_state(2)
    eng.load_state(0, snap)
    out.append(_state(eng))
    inp.batches[0].append(_tokens(5, 4))
    inp.batches[2].append(_tokens(9, 5))
    out.append(eng.infer(inp).batches)  # T = 16 again: a replay
    # a caller's state, assigned between chunks
    eng.state = {k: v * 0.5 for k, v in eng.state.items()}
    inp.batches[1].append(_tokens(7, 6))
    out.append(eng.infer(inp).batches)
    out.append(_state(eng))
    eng.reset_state()
    prompts = [_tokens(40, 7), _tokens(9, 8), _tokens(1, 9)]
    out.append(eng.generate(prompts, 9, segment=4))
    out.append(_state(eng))
    out.append(eng.generate(prompts, 9, segment=4, temperature=1.0, top_k=8, seed=3))
    out.append(eng.generate(prompts, 6, segment=4, temperature=0.8, top_p=0.7, seed=4,
                            stop_tokens={3, 17}))
    out.append(_state(eng))
    return out


def _same(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, np.ndarray):
        return a.shape == b.shape and np.array_equal(a, b)
    return a == b


def test_graph_engine_equals_eager(recorder, f32_file):
    info, params = load_model(GgufFile(f32_file), dtype=torch.float32, device="cpu")
    got_eng = Engine(info, params, 3, token_chunk_size=CHUNK, graph=True, device="cpu")
    got = _traffic(got_eng)
    want = _traffic(Engine(info, params, 3, token_chunk_size=CHUNK, graph=False, device="cpu"))
    assert _same(got, want)
    # the engine's state is the graphs' static buffers; one capture a key
    assert all(a is got_eng._graphs.state[k] for k, a in got_eng.state.items())
    assert ("full", 32) in got_eng._graphs.graphs
    assert recorder.captures == len(got_eng._graphs.graphs)


def test_graph_pool_equals_eager(recorder):
    """An ``EnginePool`` of two engines of two lanes: tokens equal the
    eager pool's; each engine has its own graphs and state, both one pool."""
    info, params = load_model(GgufFile(FILES["v7"]()), dtype=torch.float32, device="cpu")
    prompts = [_tokens(n, 10 + n) for n in (30, 5, 12, 1)]
    runs = []
    for g in (True, False):
        pool = EnginePool(info, params, 4, lanes_per_engine=2, token_chunk_size=CHUNK,
                          graph=g, device="cpu")
        runs.append((pool.generate(prompts, 7, segment=3),
                     pool.generate(prompts, 7, segment=3, temperature=1.0, seed=5),
                     [_state(e) for e in pool.engines]))
        if g:
            a, b = pool.engines
            assert a._graphs.pool is b._graphs.pool and a._graphs is not b._graphs
            assert set(recorder.pools) == {a._graphs.pool}
    assert _same(*runs)


def test_generator_cache_captures_once_per_config(recorder):
    info, params = load_model(GgufFile(FILES["v7"]()), dtype=torch.float32, device="cpu")
    eng = Engine(info, params, 2, token_chunk_size=CHUNK, graph=True, device="cpu")
    prompts = [_tokens(5, 1), _tokens(3, 2)]

    def segments():
        return sum(k[0] == "segment" for k in eng._graphs.graphs)

    first = eng.generate(prompts, 9, segment=4)
    assert segments() == 1 and len(eng._gen_cache) == 1
    n = recorder.captures
    eng.reset_state()
    assert eng.generate(prompts, 9, segment=4) == first
    assert recorder.captures == n  # the prefill's and the segment's graphs replayed
    eng.generate(prompts, 5, segment=4, temperature=1.0, seed=1)
    eng.generate(prompts, 5, segment=4, temperature=1.0, seed=2)
    assert segments() == 2 and recorder.captures == n + 1
    eng.generate(prompts, 5, segment=2)  # another config: another segment
    assert segments() == 3
    # other params: every graph is dropped and captured again
    eng.params = dict(eng.params)
    eng.reset_state()
    assert eng.generate(prompts, 9, segment=4) == first
    assert segments() == 1


def test_replay_adds_the_capture_counts(recorder):
    """The warm-up's and the capture's launches are taken back; each
    replay adds what the capture counted, by kernel and shape."""
    state = {"s": torch.zeros(3)}
    graphs = graph.StepGraphs(state)
    before = graph.launch_counts()

    def make(static, st):
        def fn():
            mm.q4k_gemv.launches += 2
            mm.q4k_gemv.shapes[(1, 8, 256)] += 2
            wkv7.wkv7_scan.launches += 1
            wkv7.wkv7_scan.shapes[(1, 4, 2, 64)] += 1
            graph.commit(st, {"s": st["s"] + static["x"]})
            return (st["s"] * 2,)
        return fn

    for i in range(3):
        (out,), state = graphs.run("k", None, make, {"x": torch.full((3,), float(i))}, state)
    assert torch.equal(state["s"], torch.full((3,), 3.0)) and torch.equal(out, state["s"] * 2)
    delta = graph.count_delta(before, graph.launch_counts())
    assert delta == {"q4k_gemv": (6, {(1, 8, 256): 6}), "wkv7_scan": (3, {(1, 4, 2, 64): 3})}
    graph.set_launch_counts(before)
    assert graph.count_delta(before, graph.launch_counts()) == {}
    assert recorder.captures == 1


def test_standalone_generator_keeps_the_callers_state(recorder):
    """``make_generator(graph=True)``: the segment runs on static buffers
    of its own, so two calls from one state give the same greedy tokens,
    and the eager segment's; the sampled one advances the generator."""
    info, params = load_model(GgufFile(FILES["v7"]()), dtype=torch.float32, device="cpu")
    state = init_state(info, 2, device="cpu")
    tok = torch.tensor([[5], [9]])
    eager = make_generator(info, steps=6, graph=False)(params, state, tok)
    run = make_generator(info, steps=6, graph=True)
    for _ in range(2):
        got = run(params, state, tok)
        assert _same(got[0], eager[0]) and _same(got[2], eager[2]) and _same(got[4], eager[4])
    assert torch.equal(state["wkv"], init_state(info, 2, device="cpu")["wkv"])
    sampled = make_generator(info, steps=6, temperature=1.0, graph=True)
    gen = torch.Generator().manual_seed(1)
    a = sampled(params, state, tok, gen)[0]
    b = sampled(params, state, tok, gen)[0]
    ref = torch.Generator().manual_seed(1)
    eager_sampled = make_generator(info, steps=6, temperature=1.0, graph=False)
    assert torch.equal(a, eager_sampled(params, state, tok, ref)[0])
    assert torch.equal(b, eager_sampled(params, state, tok, ref)[0])
    assert torch.equal(gen.get_state(), ref.get_state())


def test_eager_paths_by_rule(recorder):
    """The rule: a mesh stays eager (graph=True with a mesh of one rank
    raises) and a CPU engine is eager by default; hooks and embedding
    chunks are captured (graph=True takes hooks, in the Engine and in
    make_generator, and a chunk holding an embedding vector replays its
    ("embeds", T) graph, equal to the eager step bit for bit)."""
    from web_rwkv_gguf_tpu_torch.parallel import make_mesh

    info, params = load_model(GgufFile(FILES["v7"]()), dtype=torch.float32, device="cpu")
    assert Engine(info, params, 1, device="cpu").graph is False
    with pytest.raises(UnsupportedFeature):
        Engine(info, params, 1, mesh=make_mesh(1, 1, device="cpu"), graph=True, device="cpu")
    assert Engine(info, params, 1, mesh=make_mesh(1, 1, device="cpu"), device="cpu").graph is False
    assert Engine(info, params, 1, hooks={}, graph=True, device="cpu").graph is True
    make_generator(info, steps=2, hooks={}, graph=True)
    with pytest.raises(UnsupportedFeature):
        make_generator(info, steps=2, step=lambda *a: None, graph=True)
    eng = Engine(info, params, 1, token_chunk_size=CHUNK, graph=True, device="cpu")
    ref = Engine(info, params, 1, token_chunk_size=CHUNK, graph=False, device="cpu")
    vec = np.random.default_rng(0).normal(size=info.num_emb).astype(np.float32)
    got, want = (e.infer(RnnInput([RnnInputBatch([3, vec, 4])], CHUNK))[0] for e in (eng, ref))
    assert np.array_equal(got, want)
    assert list(eng._graphs.graphs) == [("embeds", 4)] and recorder.captures == 1


def _jax_engines(raw, num_batch, dtype):
    jinfo, jparams = jax_load_model(JaxGgufFile(raw), **(
        {"dtype": jnp.float32} if dtype == torch.float32 else {}))
    info, params = load_model(GgufFile(raw), dtype=dtype, device="cpu")
    return (JaxEngine(jinfo, jparams, num_batch, token_chunk_size=CHUNK),
            Engine(info, params, num_batch, token_chunk_size=CHUNK, graph=True, device="cpu"))


def test_graph_engine_matches_jax(recorder, f32_file):
    """f32 dense: a LAST and a FULL lane through ``infer`` (T = 32, 16),
    then greedy ``generate``: logits at 2e-4, tokens identical, the state
    at 2e-4·max|state|."""
    jeng, eng = _jax_engines(f32_file, 2, torch.float32)
    lanes = [(_tokens(45, 1), "last"), (_tokens(20, 2), "full")]
    jinp = jax_sched.RnnInput([jax_sched.RnnInputBatch(list(t), jax_sched.RnnOption(o))
                               for t, o in lanes], CHUNK)
    inp = RnnInput([RnnInputBatch(list(t), RnnOption(o)) for t, o in lanes], CHUNK)
    while inp.num_token:
        for o, jo in zip(eng.infer(inp), jeng.infer(jinp)):
            assert o.shape == jo.shape
            np.testing.assert_allclose(o, np.asarray(jo), rtol=F32_TOL, atol=F32_TOL)
    prompts = [_tokens(40, 3), _tokens(9, 4)]
    assert eng.generate(prompts, 7, segment=4) == jeng.generate(prompts, 7, segment=4)
    for b in range(2):
        for key, want in jeng.back_state(b).items():
            np.testing.assert_allclose(eng.back_state(b)[key], want, rtol=0,
                                       atol=F32_TOL * np.abs(want).max())


def test_graph_engine_q4km_matches_jax(recorder):
    """Q4_K_M (Q4_K layers, Q6_K head): a 40-token prompt in two chunks,
    then one decode token: LAST logits at 3e-2·max|logit|."""
    raw = make_v7_gguf(n_layer=2, n_emb=256, head_size=64, n_vocab=512, n_hidden=1024,
                       quantize=GgmlDType.Q4_K, head_quantize=GgmlDType.Q6_K, seed=12)
    jeng, eng = _jax_engines(raw, 1, torch.bfloat16)
    prompt = _tokens(40, 8)
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
    assert recorder.captures == 3  # last T=32, T=8 and T=1
