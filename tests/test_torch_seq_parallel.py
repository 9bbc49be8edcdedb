"""The port's sequence-parallel prefill (``parallel/sequence.py``) and
``Engine(seq_parallel=)`` against the JAX package's, on the CPU.

One spawn of four gloo ranks (``parallel/launch.py``, as
tests/test_torch_pipeline.py) runs every case on the meshes (1, 4), a
chunk's tokens over four ranks, and (2, 2), over two with the lanes
split over ``data``; the tests here hold the ranks' results against the
JAX package's ``make_seq_parallel_prefill`` and ``Engine(seq_parallel=)``
on a mesh of the same size, run in this process, and against the port's
meshless forward and Engine. The ranks import no JAX.

Models, tokens and tolerances are the JAX package's
tests/test_seq_parallel.py's, with both packages loading the same bytes
in f32: RWKV-7 (L = 2, C = 32, head size 8), RWKV-6 and -5 (C = 16, head
size 4) and RWKV-4 (C = 16), B = 2 lanes of T = 128; the carried state
at rtol = atol = 1e-3, x of the first 32 tokens at 1e-3, and (RWKV-7) the
whole x's mean relative distance below 0.02; the Engines' logits at
5e-2·max(1, |ref|) after two chained chunks of 128. A recurrent net
amplifies f32 reassociation along the tokens, so a comparison across
algorithms loosens with T (the JAX module's note).

Without a spawn: the RWKV-7 block transition against the chunk form's
final state, a one-rank mesh's Engine, and the errors.
"""

import numpy as np
import pytest
import torch

from web_rwkv_gguf_tpu_torch.errors import EngineError, UnsupportedFeature
from web_rwkv_gguf_tpu_torch.gguf import GgufFile
from web_rwkv_gguf_tpu_torch.models import forward_chunk, init_state, load_model
from web_rwkv_gguf_tpu_torch.ops.wkv_chunked import wkv7_chunked
from web_rwkv_gguf_tpu_torch.parallel import make_mesh, make_seq_parallel_prefill
from web_rwkv_gguf_tpu_torch.parallel.sequence import _wkv7_transition
from web_rwkv_gguf_tpu_torch.runtime import Engine, EnginePool, RnnInput, RnnInputBatch

STATE_TOL = 1e-3
X_TOL = 1e-3
ENGINE_TOL = 5e-2
B, T = 2, 128
# name -> (maker, arguments, token seed): tests/test_seq_parallel.py's
MODELS = {
    "v7": ("make_v7_gguf", dict(n_layer=2, n_emb=32, head_size=8, n_vocab=64), 0),
    "v6": ("make_v6_gguf", dict(n_layer=2, n_emb=16, head_size=4, n_vocab=32), 2),
    "v5": ("make_v5_gguf", dict(n_layer=2, n_emb=16, head_size=4, n_vocab=32), 3),
    "v4": ("make_v4_gguf", dict(n_layer=2, n_emb=16, n_vocab=32), 4),
    "engine": ("make_v7_gguf", dict(n_layer=2, n_emb=32, head_size=4, n_vocab=64), 7),
}
VERSIONS = ("v7", "v6", "v5", "v4")
RESCALE = 1
GEN_TOKENS = 6


def model_bytes(name: str) -> bytes:
    from web_rwkv_gguf_tpu_torch.utils import synthetic

    maker, kw, _ = MODELS[name]
    return bytes(getattr(synthetic, maker)(**kw))


def prefill_tokens(name):
    vocab = MODELS[name][1]["n_vocab"]
    return np.random.default_rng(MODELS[name][2]).integers(0, vocab, (B, T))


def engine_prompt():
    return [int(t) for t in np.random.default_rng(7).integers(1, 60, 256)]


# the (2, 2) Engine's two full lanes of 64 tokens: one chunk of 64 a lane
# (the scheduler fills a chunk of 128 tokens lane by lane, so that a lane
# is full only where the chunk holds every lane's tokens)
LANES = [[int(t) for t in np.random.default_rng(s).integers(1, 60, 64)] for s in (8, 9)]


def _port_model(workdir, name, **kw):
    raw = open(f"{workdir}/{name}.gguf", "rb").read()
    return load_model(GgufFile(raw), dtype=torch.float32, device="cpu", **kw)


def drive(eng, prompts, chunk):
    """Every chunk of ``prompts`` through ``eng.infer``: each lane's last
    logits row and the number of chunks."""
    inp = RnnInput([RnnInputBatch(list(p)) for p in prompts], chunk)
    last, n = [None] * len(prompts), 0
    while inp.num_token:
        for b, rows in enumerate(eng.infer(inp).batches):
            if len(rows):
                last[b] = np.asarray(rows[-1])
        n += 1
    return np.stack(last), n


def _counted(eng):
    """Count the engine's sequence-parallel prefill calls in ``eng.sp_calls``."""
    fn, eng.sp_calls = eng._spf, 0

    def call(*args):
        eng.sp_calls += 1
        return fn(*args)

    eng._spf = call
    return eng


def rank_main(rank, world, workdir):
    """Every case on this rank (imported by the spawned ranks: no JAX)."""
    m14, m22 = make_mesh(1, 4, device="cpu"), make_mesh(2, 2, device="cpu")
    out = {"index": m14.coord("model")}
    for name in VERSIONS:
        info, params = _port_model(workdir, name)
        x, st = make_seq_parallel_prefill(info, m14)(
            params, init_state(info, B, device="cpu"), torch.from_numpy(prefill_tokens(name)))
        out["prefill", name] = (x.numpy(), {k: v.numpy() for k, v in st.items()})

    info, params = _port_model(workdir, "engine")
    for plan in ("gspmd", "shard_map"):
        eng = _counted(Engine(info, params, 1, token_chunk_size=128, mesh=m14, tp_mode=plan,
                              seq_parallel=True, seq_parallel_min_t=128))
        out["engine", plan] = (*drive(eng, [engine_prompt()], 128), eng.sp_calls)
    info_r, params_r = _port_model(workdir, "engine", rescale=RESCALE)
    eng = Engine(info_r, params_r, 1, token_chunk_size=128, mesh=m14, seq_parallel=True,
                 seq_parallel_min_t=128, rescale=RESCALE)
    out["rescale"] = drive(eng, [engine_prompt()], 128)[0]

    eng = _counted(Engine(info, params, 2, token_chunk_size=128, mesh=m22, seq_parallel=True,
                          seq_parallel_min_t=32))
    rows = drive(eng, LANES, 128)[0]
    snap = [eng.back_state(b) for b in range(2)]
    eng.reset_state(1)
    reset = eng.back_state(1)
    eng.load_state(1, snap[1])
    loaded = eng.back_state(1)
    after = drive(eng, [[7], [8]], 128)[0]
    out["state"] = (rows, snap, reset, loaded, after, eng.sp_calls)
    eng = _counted(Engine(info, params, 2, token_chunk_size=128, mesh=m22, seq_parallel=True,
                          seq_parallel_min_t=32))
    out["generate"] = (eng.generate(LANES, GEN_TOKENS), eng.sp_calls)
    pool = EnginePool(info, params, 4, lanes_per_engine=2, mesh=m22, seq_parallel=True,
                      seq_parallel_min_t=32, token_chunk_size=128)
    out["pool"] = pool.generate(LANES * 2, GEN_TOKENS)

    eng = _counted(Engine(info, params, 4, token_chunk_size=256, mesh=m22, seq_parallel=True,
                          seq_parallel_min_t=32, pipeline_microbatches=2))
    rows = drive(eng, LANES * 2, 256)[0]
    after = drive(eng, [[7], [8], [9], [10]], 256)[0]
    snap = [eng.back_state(b) for b in range(4)]
    eng = _counted(Engine(info, params, 4, token_chunk_size=256, mesh=m22, seq_parallel=True,
                          seq_parallel_min_t=32, pipeline_microbatches=2))
    out["with_pipeline"] = (rows, after, snap, eng.generate(LANES * 2, GEN_TOKENS),
                            eng.sp_calls)
    return out


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("sp")
    for name in MODELS:
        (d / f"{name}.gguf").write_bytes(model_bytes(name))
    return str(d)


@pytest.fixture(scope="module")
def ranks(workdir):
    from web_rwkv_gguf_tpu_torch.parallel.launch import launch

    return launch(f"{__name__}:rank_main", 4, args=(workdir,), deadline=120, timeout=60)


class _Jax:
    """The JAX package's results, each computed once on four CPU devices."""

    def __init__(self, workdir):
        self.workdir, self.cache = workdir, {}

    def model(self, name, rescale=None):
        import jax.numpy as jnp

        from web_rwkv_gguf_tpu.gguf import GgufFile as JaxGgufFile
        from web_rwkv_gguf_tpu.models import load_model as jax_load_model

        raw = open(f"{self.workdir}/{name}.gguf", "rb").read()
        return jax_load_model(JaxGgufFile(raw), dtype=jnp.float32, rescale=rescale)

    def mesh(self):
        import jax

        from web_rwkv_gguf_tpu.parallel import make_mesh as jax_make_mesh

        return jax_make_mesh(1, 4, devices=jax.devices()[:4])

    def prefill(self, name):
        key = ("prefill", name)
        if key not in self.cache:
            import jax.numpy as jnp

            from web_rwkv_gguf_tpu.models import init_state as jinit
            from web_rwkv_gguf_tpu.parallel.sequence import make_seq_parallel_prefill as jspf

            info, params = self.model(name)
            x, st = jspf(info, self.mesh(), axis="model")(
                params, jinit(info, B), jnp.asarray(prefill_tokens(name), jnp.int32))
            self.cache[key] = (np.asarray(x), {k: np.asarray(v) for k, v in st.items()})
        return self.cache[key]

    def engine_with_pipeline(self):
        """The JAX Engine with ``seq_parallel`` and ``pipeline_microbatches=2``
        on a (2, 2) mesh: four full lanes of 64 tokens, then one token a
        lane; each chunk's last logits."""
        if "with_pipeline" not in self.cache:
            import jax

            from web_rwkv_gguf_tpu.parallel import make_mesh as jax_make_mesh
            from web_rwkv_gguf_tpu.runtime import Engine as JaxEngine

            info, params = self.model("engine")
            eng = JaxEngine(info, params, num_batch=4, token_chunk_size=256,
                            mesh=jax_make_mesh(2, 2, devices=jax.devices()[:4]),
                            seq_parallel=True, seq_parallel_min_t=32, pipeline_microbatches=2)
            self.cache["with_pipeline"] = (drive(eng, LANES * 2, 256),
                                           drive(eng, [[7], [8], [9], [10]], 256))
        return self.cache["with_pipeline"]

    def engine(self, seq_parallel=False, tp_mode="gspmd", rescale=None):
        key = ("engine", seq_parallel, tp_mode, rescale)
        if key not in self.cache:
            from web_rwkv_gguf_tpu.runtime import Engine as JaxEngine

            info, params = self.model("engine", rescale)
            kw = (dict(mesh=self.mesh(), tp_mode=tp_mode, seq_parallel=True,
                       seq_parallel_min_t=128) if seq_parallel else {})
            eng = JaxEngine(info, params, num_batch=1, token_chunk_size=128, rescale=rescale,
                            **kw)
            self.cache[key] = drive(eng, [engine_prompt()], 128)
        return self.cache[key]


@pytest.fixture(scope="module")
def jax_ref(workdir):
    return _Jax(workdir)


def test_wkv7_transition_matches_chunked_state():
    """``(M, O)`` applied to any S0 equals the chunk form's final state (the
    JAX package's test, on the port's ``wkv7_chunked``)."""
    rng = np.random.default_rng(0)
    Bb, Tt, H, K = 2, 48, 3, 8
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32) * 0.3)  # noqa: E731
    r, k, v = f(Bb, Tt, H, K), f(Bb, Tt, H, K), f(Bb, Tt, H, K)
    w = torch.from_numpy(np.exp(-0.606531 / (1 + np.exp(-rng.normal(size=(Bb, Tt, H, K)))))
                         .astype(np.float32))
    kk = rng.normal(size=(Bb, Tt, H, K)).astype(np.float32)
    kk = torch.from_numpy(kk / (np.linalg.norm(kk, axis=-1, keepdims=True) + 1e-9))
    a, b = -kk, kk * 0.7
    M, O = _wkv7_transition(r, w, k, v, a, b)
    mask = torch.ones(Bb, Tt, dtype=torch.bool)
    for seed in (1, 2):
        S0 = torch.from_numpy(np.random.default_rng(seed).normal(size=(Bb, H, K, K))
                              .astype(np.float32) * 0.3)
        _, want = wkv7_chunked(S0, r, w, k, v, a, b, mask)
        np.testing.assert_allclose((M @ S0 + O).numpy(), want.numpy(), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("name", VERSIONS)
def test_seq_parallel_prefill_matches(ranks, jax_ref, workdir, name):
    """Four ranks, 32 tokens each: every rank's state (the last rank's,
    broadcast) and its block of x against the JAX package's prefill on four
    devices and against the port's meshless forward."""
    want_x, want_st = jax_ref.prefill(name)
    info, params = _port_model(workdir, name)
    tok = torch.from_numpy(prefill_tokens(name))
    x_p, st_p = forward_chunk(info, params, init_state(info, B, device="cpu"), tok,
                              torch.full((B,), T))
    t_loc = T // 4
    for res in ranks:
        x, st = res["prefill", name]
        i = res["index"]
        for ref_x, ref_st in ((want_x, want_st), (x_p.numpy(), {k: v.numpy()
                                                               for k, v in st_p.items()})):
            for k in ref_st:
                np.testing.assert_allclose(st[k], ref_st[k], rtol=STATE_TOL, atol=STATE_TOL,
                                           err_msg=k)
            block = ref_x[:, i * t_loc:(i + 1) * t_loc]
            if i == 0:  # the first 32 tokens, before the chaos grows
                np.testing.assert_allclose(x, block, rtol=X_TOL, atol=X_TOL)
            if name == "v7":
                assert np.abs(x - block).mean() / np.abs(block).mean() < 0.02


def _close(got, want, tol):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("tp_mode", ["gspmd", "shard_map"])
def test_engine_seq_parallel_matches(ranks, jax_ref, workdir, tp_mode):
    """``Engine(mesh=(1, 4), seq_parallel=True, seq_parallel_min_t=128)``
    over a 256-token prompt: two chunks, both through the sequence-parallel
    prefill, and the last logits against the port's meshless Engine and the
    JAX package's sequence-parallel Engine on four devices (5e-2·max).
    Under ``tp_mode="shard_map"`` too, which places no tensor-parallel plan
    here; the JAX Engine hands its shard_map params to its prefill and
    computes the meshless Engine's logits as well (ROADMAP, queue 3: no
    fault)."""
    info, params = _port_model(workdir, "engine")
    want, n = drive(Engine(info, params, 1, token_chunk_size=128, unroll=False, device="cpu"),
                    [engine_prompt()], 128)
    want_jax, n_jax = jax_ref.engine(seq_parallel=True, tp_mode=tp_mode)
    assert n == n_jax == 2
    _close(want_jax, jax_ref.engine()[0], ENGINE_TOL)
    for res in ranks:
        got, n_got, sp_calls = res["engine", tp_mode]
        assert (n_got, sp_calls) == (2, 2)
        assert int(np.argmax(got)) == int(np.argmax(want))
        _close(got, want, ENGINE_TOL)
        _close(got, want_jax, ENGINE_TOL)


def test_engine_seq_parallel_honours_rescale(ranks, jax_ref, workdir):
    """A model loaded with ``rescale=1``: the port's sequence-parallel
    Engine halves the residual after every layer and gives its meshless
    Engine's logits; the JAX package's ``make_seq_parallel_prefill`` takes
    no rescale, so its Engine leaves the meshless JAX Engine (a reference
    fault, ROADMAP queue 3)."""
    info, params = _port_model(workdir, "engine", rescale=RESCALE)
    want, _ = drive(Engine(info, params, 1, token_chunk_size=128, rescale=RESCALE,
                           unroll=False, device="cpu"), [engine_prompt()], 128)
    jax_sp = jax_ref.engine(seq_parallel=True, rescale=RESCALE)[0]
    jax_plain = jax_ref.engine(rescale=RESCALE)[0]
    assert np.abs(jax_sp - jax_plain).max() > ENGINE_TOL * np.abs(jax_plain).max()
    _close(want, jax_plain, ENGINE_TOL)
    for res in ranks:
        _close(res["rescale"], want, ENGINE_TOL)


def test_engine_seq_parallel_state_round_trip(ranks, workdir):
    """On (2, 2), one full lane of 64 tokens a data rank, its chunk over two
    ranks: the logits; every lane's ``back_state`` whole on every rank;
    ``reset_state`` and ``load_state`` of one lane; the next (decode) chunk
    through the per-layer forward on the whole weights; all against the
    meshless Engine."""
    info, params = _port_model(workdir, "engine")
    plain = Engine(info, params, 2, token_chunk_size=128, unroll=False, device="cpu")
    want_rows = drive(plain, LANES, 128)[0]
    want_snap = [plain.back_state(b) for b in range(2)]
    want_after = drive(plain, [[7], [8]], 128)[0]
    fresh = Engine(info, params, 2, unroll=False, device="cpu").back_state(1)
    for res in ranks:
        rows, snap, reset, loaded, after, sp_calls = res["state"]
        assert sp_calls == 1
        _close(rows, want_rows, ENGINE_TOL)
        for got, want in zip(snap, want_snap):
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=STATE_TOL, atol=STATE_TOL)
        for k in fresh:
            np.testing.assert_array_equal(reset[k], fresh[k])
            np.testing.assert_array_equal(loaded[k], snap[1][k])
        _close(after, want_after, ENGINE_TOL)


def test_engine_seq_parallel_generates(ranks, workdir):
    """``generate`` on the (2, 2) sequence-parallel Engine (its prefill
    through ``infer`` and the sequence-parallel chunk, its decode on the
    whole weights) and on a pool of two gives the meshless greedy tokens."""
    info, params = _port_model(workdir, "engine")
    want = Engine(info, params, 2, token_chunk_size=128, unroll=False,
                  device="cpu").generate(LANES, GEN_TOKENS)
    want_pool = EnginePool(info, params, 4, lanes_per_engine=2, token_chunk_size=128,
                           unroll=False, device="cpu").generate(LANES * 2, GEN_TOKENS)
    for res in ranks:
        assert res["generate"] == (want, 1)
        assert res["pool"] == want_pool


def test_engine_seq_parallel_with_pipeline(ranks, jax_ref, workdir):
    """``Engine(mesh=(2, 2), seq_parallel=True, pipeline_microbatches=2)``:
    four full lanes of 64 tokens take the sequence-parallel prefill (once)
    on the two stages' state gathered into both layers, the next chunk of
    one token a lane the pipeline; both chunks' logits against the port's
    meshless Engine and the JAX Engine with the same options (5e-2·max),
    every lane's ``back_state`` against the meshless Engine's, and
    ``generate`` (its prefill through the sequence-parallel chunk, its
    decode through the pipeline) against the meshless greedy tokens."""
    info, params = _port_model(workdir, "engine")
    plain = Engine(info, params, 4, token_chunk_size=256, unroll=False, device="cpu")
    want_rows, n = drive(plain, LANES * 2, 256)
    want_after = drive(plain, [[7], [8], [9], [10]], 256)[0]
    want_snap = [plain.back_state(b) for b in range(4)]
    want_gen = Engine(info, params, 4, token_chunk_size=256, unroll=False,
                      device="cpu").generate(LANES * 2, GEN_TOKENS)
    (jax_rows, n_jax), (jax_after, _) = jax_ref.engine_with_pipeline()
    assert n == n_jax == 1
    _close(jax_rows, want_rows, ENGINE_TOL)
    _close(jax_after, want_after, ENGINE_TOL)
    for res in ranks:
        rows, after, snap, gen, sp_calls = res["with_pipeline"]
        assert sp_calls == 1
        _close(rows, want_rows, ENGINE_TOL)
        _close(rows, jax_rows, ENGINE_TOL)
        _close(after, want_after, ENGINE_TOL)
        _close(after, jax_after, ENGINE_TOL)
        for got, want in zip(snap, want_snap):
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=STATE_TOL, atol=STATE_TOL)
        assert gen == want_gen


def test_engine_seq_parallel_one_rank(workdir):
    """A mesh of one rank: a chunk of two full lanes of 16 tokens takes the
    prefill, the others the per-layer forward; the meshless Engine's
    logits and greedy tokens."""
    info, params = _port_model(workdir, "engine")
    mesh = make_mesh(1, 1, device="cpu")
    eng = _counted(Engine(info, params, 2, token_chunk_size=32, mesh=mesh, seq_parallel=True,
                          seq_parallel_min_t=16))
    prompts = [LANES[0][:48], LANES[1][:48]]
    got, n = drive(eng, prompts, 32)
    plain = Engine(info, params, 2, token_chunk_size=32, unroll=False, device="cpu")
    want, _ = drive(plain, prompts, 32)
    assert (n, eng.sp_calls) == (3, 1)  # lanes' tokens (32, 0), (16, 16), (0, 32)
    _close(got, want, 1e-4)
    eng = Engine(info, params, 2, mesh=mesh, seq_parallel=True, seq_parallel_min_t=16)
    want = Engine(info, params, 2, unroll=False, device="cpu").generate(prompts, GEN_TOKENS)
    assert eng.generate(prompts, GEN_TOKENS) == want


def test_engine_seq_parallel_errors(workdir):
    """The JAX Engine's errors: no mesh (EngineError), hooks
    (UnsupportedFeature); the prefill's own: T not a multiple of the ranks
    × 16."""
    info, params = _port_model(workdir, "engine")
    mesh = make_mesh(1, 1, device="cpu")
    with pytest.raises(EngineError, match="requires a mesh"):
        Engine(info, params, 1, seq_parallel=True, device="cpu")
    with pytest.raises(UnsupportedFeature, match="hooks"):
        Engine(info, params, 1, mesh=mesh, seq_parallel=True,
               hooks={"post_att": lambda layer, **t: None})
    with pytest.raises(EngineError, match="divide"):
        make_seq_parallel_prefill(info, mesh)(params, init_state(info, 1, device="cpu"),
                                              torch.zeros(1, 24, dtype=torch.long))
