"""The port's serving runtime against the JAX package's, on the CPU: the
dense weight copies (``dense_cache_bytes``, ``densify_matrices``), the
dense prefill and decode policies, ``Engine(prefill_dense=,
decode_dense=)`` and ``EnginePool``, on the same GGUF bytes.

Widths: 2 layers, C = 64 (head size 16), vocabulary 64; the whole-stack
decode kernel's dense slot needs head size 64 and C, FFN width multiples
of 256, so the cases that reach it load C = 256.

Tolerances: the dense copies bit for bit against the JAX package's bf16
(an element may differ by one bf16 step where the two packages' f32
dequantization rounds a tie apart; the count is asserted); the policies
exactly; logits of quantized files at 3e-2·max|logit|, as
tests/test_torch_runtime.py holds the Engine; pool tokens exactly
against standalone port engines (one numerics class). The largest
errors seen are recorded beside each test.

Three reference faults of the JAX package's engine are not
copied, each held by a test named for it: auto dense decode promoting
params that already carry whole-stack blocks (engine.py:223), a cold
quantized copy kept where the params hold no quantized matrix
(engine.py:235), and a pool building one dense prefill cache per engine
(engine.py:847).
"""

import jax
import numpy as np
import pytest
import torch

import web_rwkv_gguf_tpu.runtime.engine as jax_engine
import web_rwkv_gguf_tpu.runtime.scheduler as jax_sched
from web_rwkv_gguf_tpu.gguf import GgufFile as JaxGgufFile
from web_rwkv_gguf_tpu.models import load_model as jax_load_model
from web_rwkv_gguf_tpu.models.loader import dense_cache_bytes as jax_dense_cache_bytes
from web_rwkv_gguf_tpu.models.loader import densify_matrices as jax_densify_matrices
from web_rwkv_gguf_tpu.quant.formats import QuantScheme as JaxQuantScheme
import web_rwkv_gguf_tpu_torch.runtime.engine as engine_mod
from web_rwkv_gguf_tpu_torch.gguf import GgufFile
from web_rwkv_gguf_tpu_torch.models import (
    Matrix, dense_cache_bytes, densify_matrices, load_model, params_from_numpy,
    prepare_decode)
from web_rwkv_gguf_tpu_torch.models import loader as loader_mod
from web_rwkv_gguf_tpu_torch.ops.cuda import layer7 as l7
from web_rwkv_gguf_tpu_torch.quant.formats import QuantScheme
from web_rwkv_gguf_tpu_torch.quant.ggml import GgmlDType
from web_rwkv_gguf_tpu_torch.runtime import (
    DECODE_DENSE_MIN_B, Engine, EnginePool, auto_decode_dense, auto_prefill_dense,
    memory_limit)
from web_rwkv_gguf_tpu_torch.utils.synthetic import make_v7_gguf

QUANT_TOL = 3e-2
SMALL = dict(n_layer=2, n_emb=64, head_size=16, n_vocab=64, n_hidden=256)
# the whole-stack kernel's widths (head size 64, C and hidden multiples of 256)
STACK = dict(n_layer=2, n_emb=256, head_size=64, n_vocab=64, n_hidden=256)
GB = 1 << 30

# file kinds: (make_v7_gguf arguments, load_model quant= by scheme name)
KINDS = {
    "q4k": (dict(quantize="Q4_K", head_quantize="Q6_K"), None),
    "q5k": (dict(quantize="Q5_K", head_quantize="Q6_K"), None),
    "q8_0": (dict(quantize="Q8_0"), None),
    "int8": (dict(dtype=np.float16), "INT8"),
    "nf4": (dict(dtype=np.float16), "NF4"),
    "f16": (dict(dtype=np.float16), None),
    "list": (dict(dtype=np.float16), {0: "INT8"}),  # layer 0 Int8, layer 1 dense
}


def raw_file(kind, widths=SMALL, seed=31):
    kw, _ = KINDS[kind]
    kw = {k: GgmlDType[v] if k.endswith("quantize") else v for k, v in kw.items()}
    return make_v7_gguf(**widths, **kw, seed=seed)


def _quant(kind, enum):
    q = KINDS[kind][1]
    if isinstance(q, dict):
        return {i: enum[s] for i, s in q.items()}
    return None if q is None else enum[q]


def load_both(kind, widths=SMALL, seed=31):
    """The same file through both packages' loaders (the port's on the CPU)."""
    raw = raw_file(kind, widths, seed)
    return (jax_load_model(JaxGgufFile(raw), quant=_quant(kind, JaxQuantScheme)),
            load_model(GgufFile(raw), quant=_quant(kind, QuantScheme), device="cpu"))


def _tokens(n, seed, vocab=64):
    return [int(t) for t in np.random.default_rng(seed).integers(0, vocab, n)]


def _matrices(tree, path="params"):
    if isinstance(tree, Matrix) or hasattr(tree, "arrays"):
        yield path, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _matrices(tree[k], f"{path}.{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _matrices(v, f"{path}[{i}]")


# ---------------------------------------------------------------------------
# dense copies
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_dense_cache_bytes_matches_jax(kind):
    """The bytes the dense copy would add: the JAX package's integer."""
    (_, jparams), (_, params) = load_both(kind)
    want = jax_dense_cache_bytes(jparams)
    assert dense_cache_bytes(params) == want
    assert (want == 0) == (kind == "f16")
    if kind == "list":
        assert isinstance(params["blocks"], list)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_densify_matrices_matches_jax(kind):
    """Every matrix of the dense copy against the JAX package's
    ``densify_matrices``: dense bf16, same keys, the weights equal bit for
    bit (at most one bf16 step apart where the packages' f32
    dequantization rounds a tie apart: 0 elements in every kind here)."""
    (_, jparams), (_, params) = load_both(kind)
    want = params_from_numpy(jax.device_get(jax_densify_matrices(jparams)), device="cpu")
    got = densify_matrices(params)
    got_m, want_m = dict(_matrices(got)), dict(_matrices(want))
    assert sorted(got_m) == sorted(want_m)
    differ = 0
    for path, w in want_m.items():
        g = got_m[path]
        assert g.kind == w.kind == "dense", path
        a, b = g.arrays["w"], w.arrays["w"]
        assert a.dtype == b.dtype == torch.bfloat16 and a.shape == b.shape, path
        d = (a.float() - b.float()).abs()
        step = torch.maximum(a.float().abs(), b.float().abs()) * 2.0 ** -7
        assert bool((d <= step).all()), path
        differ += int((d > 0).sum())
    assert differ == 0


def test_densify_drops_the_decode_blocks():
    """The dense copy of prepared params holds no whole-stack blocks or
    grouped gemv operands (``prepare_decode`` rebuilds them from it); the
    quantized params are left as they were."""
    info, params = load_model(GgufFile(raw_file("q4k", STACK)), device="cpu")
    prepared = prepare_decode(params, info, batch_hint=4)
    assert "mega7" in prepared
    dense = densify_matrices(prepared)
    assert "mega7" not in dense and "mega7" in prepared
    assert params["blocks"]["att"]["Wk"].kind == "qk"
    redone = prepare_decode(dense, info, batch_hint=4)
    assert set(redone["mega7"]["forms"].values()) == {l7.descriptor(l7.FORM_DENSE, 0, 0)}
    unrolled = densify_matrices(loader_mod.unroll_params(params))
    assert not any("Wrkv_g" in blk["att"] for blk in unrolled["blocks"])


def test_densify_goes_layer_and_rows_at_a_time(monkeypatch):
    """With blocks of 96 elements (so every matrix takes several row
    blocks), the copy equals each layer dequantized whole and rounded to
    bf16, bit for bit: in NF4 (a per-layer codebook) and Q4_K."""
    monkeypatch.setattr(loader_mod, "_DENSIFY_ELEMENTS", 96)
    for kind in ("nf4", "q4k"):
        _, params = load_both(kind)[1]
        dense = densify_matrices(params)
        for part, name in (("att", "Wk"), ("ffn", "Wv")):
            mat = params["blocks"][part][name]
            want = torch.stack([mat.layer(i).dequantize().to(torch.bfloat16) for i in range(2)])
            assert torch.equal(dense["blocks"][part][name].arrays["w"], want), (kind, name)
        assert torch.equal(dense["head"].arrays["w"],
                           params["head"].dequantize().to(torch.bfloat16))


# ---------------------------------------------------------------------------
# policies
# ---------------------------------------------------------------------------

LIMITS = (None, 0, 4 * GB, 16 * GB, 80 * GB)
EXTRAS = (0, 1, GB, 3 * GB, 5 * GB, 20 * GB)


def test_policies_match_jax():
    """Both dense policies equal the JAX package's for a given limit (its
    ``bytes_limit`` off the TPU, whose 8 GiB floor has no counterpart),
    over every pair of limit and extra bytes and batches around
    ``DECODE_DENSE_MIN_B``; the CPU has no limit, so both stay off."""
    assert DECODE_DENSE_MIN_B == jax_engine.DECODE_DENSE_MIN_B == 8
    for limit in LIMITS:
        stats = None if limit is None else {"bytes_limit": limit}
        for extra in EXTRAS:
            assert auto_prefill_dense(extra, limit) == jax_engine.auto_prefill_dense(
                extra, stats, "gpu"), (limit, extra)
            for b in (1, 4, 7, 8, 9, 16, 17, 32):
                assert auto_decode_dense(b, extra, limit) == jax_engine.auto_decode_dense(
                    b, extra, stats, "gpu"), (limit, extra, b)
    assert memory_limit("cpu") is None
    assert not auto_prefill_dense(GB, memory_limit("cpu"))


def test_engine_defaults_follow_the_limit(monkeypatch):
    """``Engine()`` on the CPU builds no dense copy; given a card's limit
    (80 GB) the same Engine caches dense prefill weights, and at 8 lanes
    also decodes on dense weights; a limit the copy does not clearly fit
    leaves both off."""
    info, params = load_model(GgufFile(raw_file("q4k", STACK)), device="cpu")
    eng = Engine(info, params, 8, device="cpu")
    assert eng._params_prefill is None and eng.params_quantized is None
    monkeypatch.setattr(engine_mod, "memory_limit", lambda device: 80 * GB)
    eng = Engine(info, params, 4, device="cpu")
    assert eng._params_prefill is not None and eng.params_quantized is None
    assert eng.params["blocks"]["att"]["Wk"].kind == "qk"
    eng = Engine(info, params, 8, device="cpu")
    assert eng._params_prefill is None and eng.params_quantized is params
    assert eng.params["blocks"]["att"]["Wk"].kind == "dense"
    tight = int(2.3 * dense_cache_bytes(params) / 0.6)
    monkeypatch.setattr(engine_mod, "memory_limit", lambda device: tight)
    eng = Engine(info, params, 8, device="cpu")
    assert eng._params_prefill is None and eng.params_quantized is None


def test_engine_unroll_false_keeps_the_params():
    """``Engine(unroll=False)`` decodes on the params as given (the JAX
    Engine's ``unroll``): no whole-stack blocks attached, where the default
    attaches them; in a pool too."""
    info, params = load_model(GgufFile(raw_file("q4k", STACK)), device="cpu")
    assert Engine(info, params, 2, unroll=False, device="cpu").params is params
    assert "mega7" in Engine(info, params, 2, device="cpu").params
    pool = EnginePool(info, params, 4, lanes_per_engine=2, unroll=False, device="cpu")
    assert pool.params is params and all(e.params is params for e in pool.engines)


# ---------------------------------------------------------------------------
# the Engine on dense weights
# ---------------------------------------------------------------------------


def _drive(eng, S, prompts, chunk, extra=()):
    """Each lane's LAST logits after its prompt, then one token a lane per
    ``extra`` step; every output the engine gives, in order."""
    inp = S.RnnInput([S.RnnInputBatch(list(p)) for p in prompts], chunk)
    outs = []
    while inp.num_token:
        outs.append([np.asarray(o) for o in eng.infer(inp)])
    for step in extra:
        for b, t in enumerate(step):
            inp.batches[b].push(t)
        outs.append([np.asarray(o) for o in eng.infer(inp)])
    return outs


def _close_outputs(got, want, tol=QUANT_TOL):
    worst = 0.0
    assert len(got) == len(want)
    for g_step, w_step in zip(got, want):
        for g, w in zip(g_step, w_step):
            assert g.shape == w.shape
            if w.size:
                err = np.abs(g - w).max() / np.abs(w).max()
                worst = max(worst, err)
    assert worst <= tol, worst
    return worst


def test_engine_prefill_dense_matches_jax():
    """``Engine(prefill_dense=True, prefill_dense_min_t=32)`` on Q4_K_M:
    prompts of 40 and 6 tokens in chunks of T = 32 (dense) and 16
    (quantized), then two decode tokens (T = 1, quantized): every LAST
    logits row against the
    JAX Engine with the same arguments (largest error seen: 2.9e-7 of
    max|logit|), and the dense copy was taken exactly by the chunk of
    T ≥ 32."""
    (jinfo, jparams), (info, params) = load_both("q4k")
    prompts = [_tokens(40, 1), _tokens(6, 2)]
    extra = [(3, 4), (5, 6)]
    kw = dict(prefill_dense=True, prefill_dense_min_t=32, token_chunk_size=32)
    want = _drive(jax_engine.Engine(jinfo, jparams, 2, **kw), jax_sched, prompts, 32, extra)
    eng = Engine(info, params, 2, device="cpu", **kw)
    seen = []
    fwd = engine_mod.forward_chunk

    def spy(info_, p, state, tok, ln, **k):
        seen.append((tok.shape[1], p is eng._params_prefill))
        return fwd(info_, p, state, tok, ln, **k)

    engine_mod.forward_chunk = spy
    try:
        got = _drive(eng, engine_mod, prompts, 32, extra)
    finally:
        engine_mod.forward_chunk = fwd
    _close_outputs(got, want)
    _close_outputs(got[:1], want[:1], 2e-4)  # the dense chunk
    assert seen == [(32, True), (16, False), (1, False), (1, False)]
    # against the quantized engine: the same function, bf16 weights
    quant = _drive(Engine(info, params, 2, prefill_dense=False, token_chunk_size=32,
                          device="cpu"), engine_mod, prompts, 32, extra)
    _close_outputs(got, quant)


def test_engine_generate_prefills_on_the_dense_copy():
    """``generate``'s prefill routes each chunk as ``infer`` does (the JAX
    package's engine.py:665-670): T ≥ ``prefill_dense_min_t`` on the dense
    copy, its head included, shorter chunks on the quantized params; its
    first tokens are the argmax of ``infer``'s last logits on an engine of
    the same arguments (which the test above holds against the JAX
    Engine)."""
    _, (info, params) = load_both("q4k")
    prompts = [_tokens(40, 3), _tokens(5, 4)]
    kw = dict(prefill_dense=True, prefill_dense_min_t=32, token_chunk_size=32, device="cpu")
    eng = Engine(info, params, 2, **kw)
    heads = []
    head = engine_mod.logits_head
    engine_mod.logits_head = lambda p, rows: heads.append(p is eng._params_prefill) or head(
        p, rows)
    try:
        got = eng.generate(prompts, 5, segment=4)
    finally:
        engine_mod.logits_head = head
    assert heads == [True, False]  # chunk T=32, then T=16
    last = [None, None]
    for step in _drive(Engine(info, params, 2, **kw), engine_mod, prompts, 32):
        for b, o in enumerate(step):
            if len(o):
                last[b] = o[-1]
    assert [t[0] for t in got] == [int(np.argmax(o)) for o in last]
    assert [len(t) for t in got] == [5, 5]


def test_engine_decode_dense_matches_jax():
    """``Engine(decode_dense=True)``: the quantized params are the cold
    copy, every matrix decodes dense; per-step ``infer`` logits (a prompt,
    then three decode tokens a lane) against the JAX Engine with the same
    argument, at 2e-4 (both decode on bf16 weights with f32 products;
    largest error seen: 4.7e-6 of max|logit|)."""
    (jinfo, jparams), (info, params) = load_both("q8_0")
    prompts = [_tokens(5, 5), _tokens(3, 6)]
    extra = [(1, 2), (3, 4), (5, 6)]
    eng = Engine(info, params, 2, decode_dense=True, token_chunk_size=8, device="cpu")
    assert eng.params_quantized is params and eng._params_prefill is None
    assert {m.kind for _, m in _matrices(eng.params)} == {"dense"}
    want = _drive(jax_engine.Engine(jinfo, jparams, 2, decode_dense=True, token_chunk_size=8),
                  jax_sched, prompts, 8, extra)
    _close_outputs(_drive(eng, engine_mod, prompts, 8, extra), want, 2e-4)


def test_engine_decode_dense_takes_the_dense_stack_slot():
    """At the whole-stack widths, dense decode attaches the whole-stack
    blocks in the dense slot, and its per-step logits match the quantized
    engine's (largest error seen: 1.7e-2 of max|logit|) and the JAX
    Engine's with ``decode_dense=True`` (its CPU decodes layer by layer;
    largest error seen: 4.3e-3), at 3e-2."""
    (jinfo, jparams), (info, params) = load_both("q4k", STACK)
    eng = Engine(info, params, 2, decode_dense=True, token_chunk_size=8, device="cpu")
    assert set(eng.params["mega7"]["forms"].values()) == {l7.descriptor(l7.FORM_DENSE, 0, 0)}
    prompts = [_tokens(4, 7), _tokens(2, 8)]
    extra = [(9, 10), (11, 12)]
    got = _drive(eng, engine_mod, prompts, 8, extra)
    quant = _drive(Engine(info, params, 2, decode_dense=False, token_chunk_size=8,
                          device="cpu"), engine_mod, prompts, 8, extra)
    _close_outputs(got, quant)
    want = _drive(jax_engine.Engine(jinfo, jparams, 2, decode_dense=True, token_chunk_size=8),
                  jax_sched, prompts, 8, extra)
    _close_outputs(got, want)


# ---------------------------------------------------------------------------
# EnginePool
# ---------------------------------------------------------------------------

POOL_GRID = [(1, None), (5, 3), (7, 2), (9, 9), (10, 4), (16, None), (17, None),
             (31, None), (32, None), (33, 16), (40, 16)]


@pytest.fixture(scope="module")
def small_models():
    return load_both("q4k")


@pytest.mark.parametrize("lanes,per", POOL_GRID, ids=lambda v: str(v))
def test_pool_group_sizes_match_jax(small_models, lanes, per):
    """Near-equal groups of at most ``lanes_per_engine`` (default the
    whole-stack kernel's 16 lanes), as the JAX pool splits them."""
    (jinfo, jparams), (info, params) = small_models
    kw = {} if per is None else {"lanes_per_engine": per}
    want = jax_engine.EnginePool(jinfo, jparams, lanes, decode_dense=False, **kw).group_sizes
    pool = EnginePool(info, params, lanes, device="cpu", **kw)
    assert pool.group_sizes == want and pool.num_lanes == lanes
    assert len(pool.engines) == len(want)
    assert [e.num_batch for e in pool.engines] == want


def test_pool_shares_params_and_prefill_cache(small_models):
    """Every engine of a pool holds the pool's one params object and its
    one dense prefill copy; with dense decode, one dense params object and
    the quantized params as the pool's cold copy."""
    _, (info, params) = small_models
    pool = EnginePool(info, params, 7, lanes_per_engine=3, prefill_dense=True,
                      prefill_dense_min_t=16, device="cpu")
    prefill = pool.engines[0]._params_prefill
    assert prefill is not None and prefill is not params
    for eng in pool.engines:
        assert eng.params is pool.params
        assert eng._params_prefill is prefill and eng._prefill_min_t == 16
        assert eng.params_quantized is None
    pool = EnginePool(info, params, 4, lanes_per_engine=2, decode_dense=True, device="cpu")
    assert pool.params_quantized is params
    assert {m.kind for _, m in _matrices(pool.params)} == {"dense"}
    for eng in pool.engines:
        assert eng.params is pool.params and eng._params_prefill is None


@pytest.mark.parametrize("sampling", [dict(), dict(temperature=1.0, top_p=0.9)],
                         ids=["greedy", "nucleus"])
def test_pool_lanes_match_standalone_engines(small_models, sampling):
    """Pool tokens lane for lane equal standalone engines of the same group
    sizes, engine i seeded with seed + i (greedy, and nucleus sampling
    where the seed matters)."""
    _, (info, params) = small_models
    prompts = [_tokens(3 + i, 20 + i) for i in range(5)]
    pool = EnginePool(info, params, 5, lanes_per_engine=3, token_chunk_size=8, device="cpu")
    assert pool.group_sizes == [3, 2]
    got = pool.generate(prompts, 9, segment=4, seed=11, **sampling)
    want = (Engine(info, params, 3, token_chunk_size=8, device="cpu").generate(
                prompts[:3], 9, segment=4, seed=11, **sampling)
            + Engine(info, params, 2, token_chunk_size=8, device="cpu").generate(
                prompts[3:], 9, segment=4, seed=12, **sampling))
    assert got == want
    assert [len(t) for t in got] == [9] * 5


def test_pool_stops_when_every_lane_stops(small_models):
    """With stop tokens, each lane is trimmed after its stop token, as
    standalone engines of the pool's group sizes trim theirs."""
    _, (info, params) = small_models
    prompts = [_tokens(4, 30 + i) for i in range(4)]
    free = EnginePool(info, params, 4, lanes_per_engine=2, device="cpu").generate(
        prompts, 12, segment=2)
    stop = {free[0][2], free[3][1]}
    pool = EnginePool(info, params, 4, lanes_per_engine=2, device="cpu")
    got = pool.generate(prompts, 12, segment=2, stop_tokens=stop)
    want = (Engine(info, params, 2, device="cpu").generate(prompts[:2], 12, segment=2,
                                                            stop_tokens=stop)
            + Engine(info, params, 2, device="cpu").generate(prompts[2:], 12, segment=2,
                                                              stop_tokens=stop, seed=1))
    assert got == want
    assert len(got[0]) <= 3 and len(got[3]) <= 2


# ---------------------------------------------------------------------------
# the JAX package's engine faults, not copied
# ---------------------------------------------------------------------------


def test_fault_223_auto_decode_dense_keeps_prepared_params(monkeypatch):
    """engine.py:223: the JAX Engine's auto dense decode densifies params
    that already carry the quantized whole-stack blocks. The port's auto
    policy leaves prepared params as they are (their blocks decode), and
    promotes unprepared ones."""
    monkeypatch.setattr(engine_mod, "memory_limit", lambda device: 80 * GB)
    info, params = load_model(GgufFile(raw_file("q4k", STACK)), device="cpu")
    prepared = prepare_decode(params, info, batch_hint=8)
    eng = Engine(info, prepared, 8, prefill_dense=False, device="cpu")
    assert eng.params is prepared and eng.params_quantized is None
    assert eng.params["mega7"] is prepared["mega7"]
    promoted = Engine(info, params, 8, prefill_dense=False, device="cpu")
    assert promoted.params_quantized is params
    assert set(promoted.params["mega7"]["forms"].values()) == {
        l7.descriptor(l7.FORM_DENSE, 0, 0)}


def test_fault_235_cold_copy_only_of_quantized_params(monkeypatch):
    """engine.py:235: the JAX Engine keeps already-dense params as its
    'cold quantized copy'. The port keeps ``params_quantized`` only where
    the params hold a quantized matrix: not for an f16 file's dense
    params, not in a pool's engines (the pool keeps it once)."""
    _, (info, dense) = load_both("f16")
    eng = Engine(info, dense, 2, decode_dense=True, device="cpu")
    assert eng.params_quantized is None
    monkeypatch.setattr(engine_mod, "memory_limit", lambda device: 80 * GB)
    assert Engine(info, dense, 8, device="cpu").params_quantized is None
    _, (info, params) = load_both("q4k")
    assert Engine(info, params, 2, decode_dense=True, device="cpu").params_quantized is params
    pool = EnginePool(info, params, 6, lanes_per_engine=3, decode_dense=True, device="cpu")
    assert pool.params_quantized is params
    assert all(e.params_quantized is None for e in pool.engines)


def test_fault_847_pool_builds_one_prefill_cache(monkeypatch, small_models):
    """engine.py:847: the JAX pool builds a dense prefill cache in every
    engine and only then keeps the first. The port's pool densifies once,
    before its engines, and hands that one copy to each."""
    _, (info, params) = small_models
    calls = []
    densify = engine_mod.densify_matrices
    monkeypatch.setattr(engine_mod, "densify_matrices",
                        lambda p: calls.append(p) or densify(p))
    pool = EnginePool(info, params, 9, lanes_per_engine=3, prefill_dense=True, device="cpu")
    assert len(calls) == 1 and calls[0] is params
    assert len({id(e._params_prefill) for e in pool.engines}) == 1
    monkeypatch.setattr(engine_mod, "memory_limit", lambda device: 80 * GB)
    calls.clear()
    pool = EnginePool(info, params, 9, lanes_per_engine=3, device="cpu")
    assert len(calls) == 1  # the auto policy: one copy as well
    assert all(e._params_prefill is pool.engines[0]._params_prefill for e in pool.engines)
