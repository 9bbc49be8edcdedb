"""Hooks and embedding chunks in the compiled step (``runtime/graph.py``)
on the CPU.

``runtime.graph.CAPTURE`` is replaced by tests/test_torch_graph.py's
``Recorder`` (the closure runs once at "capture" and again at each
"replay"), so a hooked step and an embedding chunk go through the graph
path as on the card. On f32 files at L=2, C=32, head size 8, V=64:

- every modifying hook of tests/test_torch_hooks.py through
  ``Engine(hooks=, graph=True)`` against ``graph=False``: prefill, FULL
  ``infer`` and ``generate`` (greedy, sampled, with stop tokens), tokens,
  logits and state bit for bit;
- the othello and puzzle15 hooks on a graph Engine against the JAX
  Engine with the same hooks: f32 rtol = atol = 2e-4 on logits,
  2e-4·max|state| on the state (tests/test_torch_runtime.py's class);
- a hooked ``make_generator(graph=True)`` segment against ``graph=False``;
- Token::Embed lanes on a graph Engine against ``graph=False`` bit for
  bit and the JAX Engine at 2e-4, one capture a ``("embeds", T)`` bucket;
- a capture that fails (as a hook that reads the host fails on the card)
  raises ``UnsupportedFeature`` with the state as it was;
- every mesh plan of one rank refuses ``graph=True`` and is eager by
  default.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_graph import Recorder, _same, _tokens, _traffic, recorder  # noqa: F401
from test_torch_hooks import MODIFYING

import web_rwkv_gguf_tpu.runtime.scheduler as jax_sched
from web_rwkv_gguf_tpu.gguf import GgufFile as JaxGgufFile
from web_rwkv_gguf_tpu.models import load_model as jax_load_model
from web_rwkv_gguf_tpu.runtime import Engine as JaxEngine
from web_rwkv_gguf_tpu_torch.errors import UnsupportedFeature
from web_rwkv_gguf_tpu_torch.gguf import GgufFile
from web_rwkv_gguf_tpu_torch.models import init_state, load_model, make_generator
from web_rwkv_gguf_tpu_torch.parallel import make_mesh
from web_rwkv_gguf_tpu_torch.runtime import (
    DistributedEngine, Engine, RnnInput, RnnInputBatch, RnnOption, graph,
)
from web_rwkv_gguf_tpu_torch.utils import synthetic

F32_TOL = 2e-4
CHUNK = 32
VOCAB = 64
SEEDS = {"v4": 80, "v5": 81, "v6": 82, "v7": 83}


def _raw(ver):
    make = getattr(synthetic, f"make_{ver}_gguf")
    kw = {} if ver == "v4" else {"head_size": 8}
    return make(n_layer=2, n_emb=32, n_vocab=VOCAB, seed=SEEDS[ver], **kw)


@pytest.fixture(scope="module")
def models():
    """Both packages' f32 models by version, each loaded at first use."""
    cache = {}

    def get(ver):
        if ver not in cache:
            raw = _raw(ver)
            cache[ver] = (jax_load_model(JaxGgufFile(raw), dtype=jnp.float32),
                          load_model(GgufFile(raw), dtype=torch.float32, device="cpu"))
        return cache[ver]

    return get


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=F32_TOL, atol=F32_TOL)


def _close_state(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL * np.abs(want).max())


@pytest.mark.parametrize("case", list(MODIFYING))
def test_hooked_engine_graph_equals_eager(recorder, models, case):
    """A modifying hook on a graph Engine: tests/test_torch_graph.py's
    traffic (LAST and FULL chunks, the state reset, loaded and assigned,
    greedy and sampled ``generate``) equals ``graph=False`` bit for bit, and
    every step of it was captured with the hook: the LAST and FULL buckets
    and the decode segments."""
    ver, _, port_hooks = MODIFYING[case]
    info, params = models(ver)[1]
    got_eng = Engine(info, params, 3, token_chunk_size=CHUNK, hooks=port_hooks(), graph=True,
                     device="cpu")
    got = _traffic(got_eng)
    want = _traffic(Engine(info, params, 3, token_chunk_size=CHUNK, hooks=port_hooks(),
                           graph=False, device="cpu"))
    assert _same(got, want)
    kinds = {k[0] for k in got_eng._graphs.graphs}
    assert {"full", "last", "segment"} <= kinds
    assert recorder.captures == len(got_eng._graphs.graphs)


EXAMPLES = ["othello_v7", "puzzle15_v6"]


@pytest.mark.parametrize("case", EXAMPLES)
def test_example_hooks_graph_engine_matches_jax(recorder, models, case):
    """The apps' hooks on a graph Engine against the JAX Engine with the
    same hooks: a LAST and a FULL lane through ``infer`` (T = 32, 16), then
    three greedy tokens pushed back through ``infer`` (the JAX
    ``generate`` decodes unhooked, tests/test_torch_hooks.py): logits at
    2e-4, the state at 2e-4·max|state|."""
    ver, jax_hooks, port_hooks = MODIFYING[case]
    jmodel, model = models(ver)
    eng = Engine(*model, 2, token_chunk_size=CHUNK, hooks=port_hooks(), graph=True,
                 device="cpu")
    jeng = JaxEngine(*jmodel, 2, token_chunk_size=CHUNK, hooks=jax_hooks())
    lanes = [(_tokens(45, 1), "last"), (_tokens(20, 2), "full")]
    inp = RnnInput([RnnInputBatch(list(t), RnnOption(o)) for t, o in lanes], CHUNK)
    jinp = jax_sched.RnnInput([jax_sched.RnnInputBatch(list(t), jax_sched.RnnOption(o))
                               for t, o in lanes], CHUNK)
    last = [None, None]
    while inp.num_token:
        for b, (o, jo) in enumerate(zip(eng.infer(inp), jeng.infer(jinp))):
            assert o.shape == jo.shape
            _close(o, jo)
            if len(o):
                last[b] = o[-1]
    for _ in range(3):
        for b in range(2):
            tok = int(np.argmax(last[b]))
            inp.batches[b].push(tok)
            jinp.batches[b].push(tok)
        for b, (o, jo) in enumerate(zip(eng.infer(inp), jeng.infer(jinp))):
            _close(o, jo)
            last[b] = o[-1]
    for b in range(2):
        for key, want in jeng.back_state(b).items():
            _close_state(eng.back_state(b)[key], want)
    assert ("last", 1) in eng._graphs.graphs or ("full", 1) in eng._graphs.graphs


@pytest.mark.parametrize("case", EXAMPLES)
def test_hooked_generator_graph_equals_eager(recorder, models, case):
    """``make_generator(hooks=, graph=True)``: the greedy segment's tokens,
    logits, state and done flags, and a sampled segment's tokens and
    generator state, equal ``graph=False``'s bit for bit; the hook runs in
    the captured segment (a hooked segment differs from the unhooked)."""
    ver, _, port_hooks = MODIFYING[case]
    info, params = models(ver)[1]
    state = init_state(info, 2, device="cpu")
    tok = torch.tensor([[5], [9]])
    outs = {}
    for g in (True, False):
        greedy = make_generator(info, steps=5, hooks=port_hooks(), stop_ids=(3,), graph=g)
        toks, logits, st, _, done = greedy(params, state, tok)
        sampled = make_generator(info, steps=5, temperature=1.0, hooks=port_hooks(), graph=g)
        gen = torch.Generator().manual_seed(4)
        draws = [sampled(params, state, tok, gen)[0].clone() for _ in range(2)]
        outs[g] = (toks, logits, {k: v.clone() for k, v in st.items()}, done, draws,
                   gen.get_state())
        if g:
            assert greedy.graphs is not None and sampled.graphs is not None
    assert _same(outs[True], outs[False])
    plain = make_generator(info, steps=5, graph=False)(params, state, tok)
    assert not torch.equal(plain[1], outs[True][1])


def _embed_lanes(emb, seed):
    """Four lanes of 8 tokens (one chunk of 32), as chip_smoke.py's embeds phase makes them:
    ids; the same tokens as embedding rows; the two in turn; ids of another
    prompt."""
    ids, other = _tokens(8, seed), _tokens(8, seed + 1)
    rows = [emb[t] for t in ids]
    return [ids, rows, [t if i % 2 == 0 else rows[i] for i, t in enumerate(ids)], other]


@pytest.mark.parametrize("ver", ["v7", "v6"])
def test_embed_lanes_graph_engine(recorder, models, ver):
    """Token::Embed lanes (LAST, LAST, FULL, LAST) through a graph Engine:
    bit for bit ``graph=False``'s logits and state, the JAX Engine's at
    2e-4; one capture for the ``("embeds", 8)`` bucket, which a second
    call from a reset state replays; then a token chunk on the same
    engine replays its own graph beside it."""
    jmodel, model = models(ver)
    lanes = _embed_lanes(model[1]["emb"].float().numpy(), 11)
    opts = [RnnOption.LAST, RnnOption.LAST, RnnOption.FULL, RnnOption.LAST]

    def run(eng, sched=None):
        out = []
        for _ in range(2):
            eng.reset_state()
            if sched is None:
                inp = RnnInput([RnnInputBatch(list(t), o) for t, o in zip(lanes, opts)], CHUNK)
            else:
                inp = sched.RnnInput([sched.RnnInputBatch(list(t), sched.RnnOption(o.value))
                                      for t, o in zip(lanes, opts)], CHUNK)
            out.append([np.asarray(o) for o in eng.infer(inp)])
            out.append([{k: np.asarray(v) for k, v in eng.back_state(b).items()}
                        for b in range(4)])
        return out

    eng = Engine(*model, 4, token_chunk_size=CHUNK, graph=True, device="cpu")
    got = run(eng)
    assert list(eng._graphs.graphs) == [("embeds", 8)] and recorder.captures == 1
    assert _same(got, run(Engine(*model, 4, token_chunk_size=CHUNK, graph=False,
                                 device="cpu")))
    assert [len(o) for o in got[0]] == [1, 1, 8, 1]
    assert np.array_equal(got[0][0], got[0][1])
    want = run(JaxEngine(*jmodel, 4, token_chunk_size=CHUNK), jax_sched)
    for b in range(4):
        _close(got[0][b], want[0][b])
        for key, ref in want[1][b].items():
            _close_state(got[1][b][key], ref)
    eng.infer(RnnInput([RnnInputBatch(_tokens(3, b)) for b in range(4)], CHUNK))
    assert set(eng._graphs.graphs) == {("embeds", 8), ("last", 4)}


class FailingCapture:
    """A stand-in for ``capture_cuda`` whose capture fails as a hook that
    reads the host fails under a CUDA capture."""

    def __init__(self):
        self.calls = 0

    def __call__(self, fn, pool, stream, generators):
        self.calls += 1
        fn()
        raise RuntimeError("CUDA error: operation not permitted when stream is capturing")


def test_a_failed_capture_raises_with_the_state_put_back(monkeypatch, models):
    """Where the capture fails, the Engine and the captured segment raise
    ``UnsupportedFeature`` naming ``graph=False`` and keep no graph; the
    warm-up's state, launch counts and sampler draws are put back, so the
    Engine's state is what it was; nothing falls back to the eager step."""
    failing = FailingCapture()
    monkeypatch.setattr(graph, "CAPTURE", failing)
    ver, _, port_hooks = MODIFYING["othello_v7"]
    info, params = models(ver)[1]
    eng = Engine(info, params, 2, token_chunk_size=CHUNK, hooks=port_hooks(), graph=True,
                 device="cpu")
    eng.state = {k: v + 0.25 for k, v in eng.state.items()}
    before = {k: v.clone() for k, v in eng.state.items()}
    counts = graph.launch_counts()
    with pytest.raises(UnsupportedFeature, match="graph=False"):
        eng.infer(RnnInput([RnnInputBatch([3, 17, 40]), RnnInputBatch([9])], CHUNK))
    for st in (eng.state, eng._graphs.state):  # the caller's and the static buffers
        assert _same({k: v.clone() for k, v in st.items()}, before)
    assert eng._graphs.graphs == {} and failing.calls == 1
    assert graph.launch_counts() == counts
    gen = torch.Generator().manual_seed(2)
    rng = gen.get_state()
    run = make_generator(info, steps=3, temperature=1.0, hooks=port_hooks(), graph=True)
    with pytest.raises(UnsupportedFeature, match="graph=False"):
        run(params, init_state(info, 2, device="cpu"), torch.tensor([[5], [9]]), gen)
    assert torch.equal(gen.get_state(), rng) and failing.calls == 2


MESH_PLANS = {"gspmd": {"tp_mode": "gspmd"}, "shard_map": {"tp_mode": "shard_map"},
              "pipeline": {"pipeline_microbatches": 1}, "sequence": {"seq_parallel": True}}


@pytest.mark.parametrize("plan", list(MESH_PLANS))
def test_graph_true_refuses_a_mesh_of_one_rank(recorder, models, plan):
    """A mesh of one rank (every collective the identity): ``graph=True``
    raises ``UnsupportedFeature`` on every plan, ``graph=None`` resolves to
    the eager step, and so does ``DistributedEngine`` on the mesh; the
    eager mesh Engine still serves a hooked chunk without a capture."""
    ver, _, port_hooks = MODIFYING["othello_v7"]
    info, params = models(ver)[1]
    mesh = make_mesh(1, 1, device="cpu")
    with pytest.raises(UnsupportedFeature, match="mesh"):
        Engine(info, params, 2, mesh=mesh, graph=True, device="cpu", **MESH_PLANS[plan])
    eng = Engine(info, params, 2, mesh=mesh, token_chunk_size=CHUNK, device="cpu",
                 hooks=port_hooks() if plan in ("gspmd", "shard_map") else None,
                 **MESH_PLANS[plan])
    assert eng.graph is False
    out = eng.infer(RnnInput([RnnInputBatch(_tokens(5, 3)), RnnInputBatch(_tokens(2, 4))],
                             CHUNK))
    assert [len(o) for o in out] == [1, 1] and eng._graphs is None
    assert DistributedEngine(info, params, 2, mesh=mesh, device="cpu").engine.graph is False
    assert recorder.captures == 0
