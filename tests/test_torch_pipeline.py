"""The port's GPipe forward (``parallel/pipeline.py``) and
``Engine(pipeline_microbatches=)`` against the JAX package's, on the CPU.

One spawn of four gloo ranks (``parallel/launch.py``: a ``file://``
rendezvous, a 60 s collective timeout, a 120 s deadline) runs every case
on the meshes (1, 4), four stages of one layer, and (2, 2), two stages
of two layers with the lanes split over ``data``; the ranks write their
results, which the tests here hold against the JAX package's functions
run in this process on its CPU devices (``make_pipeline_forward`` on
``make_mesh(1, 4)``, its ``Engine(pipeline_microbatches=)``) and against
the port's own meshless forward and Engine. The ranks import no JAX:
this module imports it only inside the parent's functions.

Models (``utils/synthetic``, the same bytes for both packages): RWKV-7,
-6, -5 (head size 8) and -4 at L = 4, C = 32, V = 64 in f32 (the JAX
package's tests/test_pipeline.py widths), RWKV-7 at L = 2 for the bad
config, and RWKV-7 at L = 2, C = 256 in Q4_K with a Q6_K head (at L = 4
the two packages' meshless forwards already part by 4.9e-2·max in the
WKV state: tests/test_torch_parallel.py). Traffic:
M = 3 microbatches of B = 2 lanes of T = 8 tokens, ragged lengths.

Tolerances: f32 rtol = atol = 2e-4 against the port's meshless forward
(the same layer functions in another grouping of lanes), and rtol = 2e-4,
atol = 2e-4·max(1, |ref|) against JAX (on these random weights x reaches
|x| ≈ 900, and the two packages' meshless forwards already part by up to
5.4e-3 there, elementwise 2e-3 relative); quantized 3e-2·max|ref| (the
JAX package's CPU path rounds dequantized weights to bf16, the port's
plain versions multiply them in f32: tests/test_torch_parallel.py); the
Engines against JAX's
2e-3·max(1, |ref|) (tests/test_pipeline.py's).

Without a spawn: a one-rank mesh's pipeline Engine and pool against the
meshless ones, and the errors of the Engine's options.
"""

import numpy as np
import pytest
import torch

from web_rwkv_gguf_tpu_torch.errors import EngineError, UnsupportedFeature
from web_rwkv_gguf_tpu_torch.gguf import GgufFile
from web_rwkv_gguf_tpu_torch.models import forward_chunk, init_state, load_model
from web_rwkv_gguf_tpu_torch.parallel import make_mesh, make_pipeline_forward, pipeline_state
from web_rwkv_gguf_tpu_torch.parallel.pipeline import stage_params
from web_rwkv_gguf_tpu_torch.parallel.sharding import all_gather
from web_rwkv_gguf_tpu_torch.quant.ggml import GgmlDType
from web_rwkv_gguf_tpu_torch.runtime import Engine, EnginePool, RnnInput, RnnInputBatch, RnnOption

F32_TOL = 2e-4
QUANT_TOL = 3e-2
ENGINE_TOL = 2e-3
M, B, T = 3, 2, 8
VERSIONS = ("v7", "v6", "v5", "v4")
_SMALL = dict(n_layer=4, n_emb=32, n_vocab=64)
# name -> (maker, arguments, f32 weights)
MODELS = {
    "v7": ("make_v7_gguf", dict(_SMALL, head_size=8), True),
    "v6": ("make_v6_gguf", dict(_SMALL, head_size=8), True),
    "v5": ("make_v5_gguf", dict(_SMALL, head_size=8), True),
    "v4": ("make_v4_gguf", dict(_SMALL), True),
    "v7l2": ("make_v7_gguf", dict(n_layer=2), True),
    "v7q4k": ("make_v7_gguf", dict(n_layer=2, n_emb=256, head_size=16, n_vocab=64,
                                   n_hidden=512, seed=42, quantize=GgmlDType.Q4_K,
                                   head_quantize=GgmlDType.Q6_K), False),
}
PROMPTS2 = [[1, 2, 3, 4, 5], [9, 8, 7]]
PROMPTS4 = [[1, 2, 3, 4, 5], [9, 8, 7], [33, 4, 60, 2, 2, 7, 1], [12]]
OPTIONS4 = [RnnOption.FULL, RnnOption.LAST, RnnOption.LAST, RnnOption.FULL]
CHUNK = 4  # token_chunk_size: the prompts take two chunks
RESCALE = 2
GEN_TOKENS = 6


def model_bytes(name: str) -> bytes:
    from web_rwkv_gguf_tpu_torch.utils import synthetic

    maker, kw, _ = MODELS[name]
    return bytes(getattr(synthetic, maker)(**kw))


def tokens_and_lens(vocab, m=M, b=B, t=T, seed=0, ragged=True):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, vocab, (m, b, t))
    lens = rng.integers(3, t + 1, (m, b)) if ragged else np.full((m, b), t)
    return tok, lens


def _port_model(workdir, name, **kw):
    raw = open(f"{workdir}/{name}.gguf", "rb").read()
    dtype = torch.float32 if MODELS[name][2] else torch.bfloat16
    return load_model(GgufFile(raw), dtype=dtype, device="cpu", **kw)


def drive(eng, prompts, options=None):
    """Every chunk of ``prompts`` through ``eng.infer``: the rows each lane
    produced, in order."""
    options = options or [RnnOption.LAST] * len(prompts)
    inp = RnnInput([RnnInputBatch(list(p), o) for p, o in zip(prompts, options)], CHUNK)
    rows = [[] for _ in prompts]
    while inp.num_token:
        for b, r in enumerate(eng.infer(inp).batches):
            rows[b].extend(np.asarray(r))
    return [np.stack(r) for r in rows]


def _whole(state, mesh, lane_dim):
    """A pipeline rank's state with every stage's layers and every data
    rank's lanes."""
    return {k: all_gather(mesh, "data", all_gather(mesh, "model", a, dim=0), dim=lane_dim)
            .numpy() for k, a in state.items()}


def embed_prompts():
    """PROMPTS4 with embedding vectors (Token::Embed) in place of three ids:
    the first chunk mixes vectors and ids, the second holds ids only."""
    vecs = np.random.default_rng(5).standard_normal((3, _SMALL["n_emb"])).astype(np.float32)
    prompts = [list(p) for p in PROMPTS4]
    prompts[0][1], prompts[2][0], prompts[2][5] = vecs
    return prompts


def _snap(eng, lanes):
    return [eng.back_state(b) for b in lanes]


def rank_main(rank, world, workdir):
    """Every case on this rank (imported by the spawned ranks: no JAX)."""
    m14, m22 = make_mesh(1, 4, device="cpu"), make_mesh(2, 2, device="cpu")
    out = {}
    for name in VERSIONS:
        info, params = _port_model(workdir, name)
        tok, lens = (torch.from_numpy(a) for a in tokens_and_lens(info.num_vocab))
        fn = make_pipeline_forward(info, m14, num_microbatch=M)
        x, st = fn(params, pipeline_state(info, M, B, mesh=m14), tok, lens)
        x2, st2 = fn(stage_params(params, info, m14), pipeline_state(info, M, B, mesh=m14),
                     tok, lens)
        same = torch.equal(x, x2) and all(torch.equal(st[k], st2[k]) for k in st)
        out["fwd", name] = (x.numpy(), _whole(st, m14, 2), same)

    info, params = _port_model(workdir, "v7")
    tok, lens = (torch.from_numpy(a) for a in tokens_and_lens(64, 2, 4, T, 1, False))
    x, st = make_pipeline_forward(info, m22, num_microbatch=2)(
        params, pipeline_state(info, 2, 4, mesh=m22), tok, lens)
    out["data"] = (x.numpy(), _whole(st, m22, 2))

    try:
        make_pipeline_forward(_port_model(workdir, "v7l2")[0], m14)
        out["bad"] = None
    except EngineError as e:
        out["bad"] = str(e)

    info_q, params_q = _port_model(workdir, "v7q4k")
    tok, lens = (torch.from_numpy(a) for a in tokens_and_lens(64, 2, B, T, 2))
    x, st = make_pipeline_forward(info_q, m22, num_microbatch=2)(
        params_q, pipeline_state(info_q, 2, B, mesh=m22), tok, lens)
    out["q4k"] = (x.numpy(), _whole(st, m22, 2))

    for plan in ("gspmd", "shard_map"):
        eng = Engine(info, params, 2, token_chunk_size=CHUNK, mesh=m14, tp_mode=plan,
                     pipeline_microbatches=2)
        out["engine", plan] = drive(eng, PROMPTS2)
    eng = Engine(info, params, 2, mesh=m14, pipeline_microbatches=2)
    out["generate"] = eng.generate(PROMPTS2, GEN_TOKENS)
    eng = Engine(info, params, 4, token_chunk_size=CHUNK, mesh=m14, pipeline_microbatches=2)
    out["embeds"] = drive(eng, embed_prompts(), OPTIONS4)

    eng = Engine(info, params, 4, token_chunk_size=CHUNK, mesh=m22, pipeline_microbatches=2)
    rows = drive(eng, PROMPTS4, OPTIONS4)
    snap = _snap(eng, range(4))
    eng.reset_state(1)
    reset = _snap(eng, [1])[0]
    eng.load_state(1, snap[1])
    loaded = _snap(eng, [1])[0]
    after = drive(eng, [[7], [8], [9], [10]])
    out["state"] = (rows, snap, reset, loaded, after)

    info_r, params_r = _port_model(workdir, "v7", rescale=RESCALE)
    eng = Engine(info_r, params_r, 2, token_chunk_size=CHUNK, mesh=m14,
                 pipeline_microbatches=2, rescale=RESCALE)
    out["rescale"] = drive(eng, PROMPTS2)

    pool = EnginePool(info, params, 4, lanes_per_engine=2, mesh=m14, pipeline_microbatches=2)
    out["pool"] = pool.generate(PROMPTS4, GEN_TOKENS)
    return out


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("pp")
    for name in MODELS:
        (d / f"{name}.gguf").write_bytes(model_bytes(name))
    return str(d)


@pytest.fixture(scope="module")
def ranks(workdir):
    from web_rwkv_gguf_tpu_torch.parallel.launch import launch

    return launch(f"{__name__}:rank_main", 4, args=(workdir,), deadline=120, timeout=60)


class _Jax:
    """The JAX package's results, each computed once on its CPU devices."""

    def __init__(self, workdir):
        self.workdir, self.cache = workdir, {}

    def model(self, name, rescale=None):
        import jax.numpy as jnp

        from web_rwkv_gguf_tpu.gguf import GgufFile as JaxGgufFile
        from web_rwkv_gguf_tpu.models import load_model as jax_load_model

        key = ("model", name, rescale)
        if key not in self.cache:
            raw = open(f"{self.workdir}/{name}.gguf", "rb").read()
            kw = dict(dtype=jnp.float32) if MODELS[name][2] else {}
            self.cache[key] = jax_load_model(JaxGgufFile(raw), rescale=rescale, **kw)
        return self.cache[key]

    def pipeline(self, name, mesh_shape, tok, lens):
        import jax
        import jax.numpy as jnp

        from web_rwkv_gguf_tpu.parallel import make_mesh as jax_make_mesh
        from web_rwkv_gguf_tpu.parallel.pipeline import make_pipeline_forward as jppf
        from web_rwkv_gguf_tpu.parallel.pipeline import pipeline_state as jstate

        info, params = self.model(name)
        n = mesh_shape[0] * mesh_shape[1]
        mesh = jax_make_mesh(*mesh_shape, devices=jax.devices()[:n])
        m, b = tok.shape[:2]
        x, st = jppf(info, mesh, axis="model", num_microbatch=m)(
            params, jstate(info, m, b), jnp.asarray(tok, jnp.int32), jnp.asarray(lens, jnp.int32))
        return np.asarray(x), {k: np.asarray(v) for k, v in st.items()}

    def engine(self, pipeline=False, tp_mode="gspmd", rescale=None):
        key = ("engine", pipeline, tp_mode, rescale)
        if key not in self.cache:
            import jax

            from web_rwkv_gguf_tpu.parallel import make_mesh as jax_make_mesh
            from web_rwkv_gguf_tpu.runtime import Engine as JaxEngine

            info, params = self.model("v7", rescale)
            kw = {}
            if pipeline:
                kw = dict(mesh=jax_make_mesh(1, 4, devices=jax.devices()[:4]), tp_mode=tp_mode,
                          pipeline_microbatches=2)
            eng = JaxEngine(info, params, num_batch=2, token_chunk_size=CHUNK,
                            rescale=rescale, **kw)
            self.cache[key] = drive(eng, PROMPTS2)
        return self.cache[key]


@pytest.fixture(scope="module")
def jax_ref(workdir):
    return _Jax(workdir)


def _close_jax(got, want, err_msg=""):
    np.testing.assert_allclose(got, want, rtol=F32_TOL,
                               atol=F32_TOL * max(1.0, np.abs(want).max()), err_msg=err_msg)


def _masked(x, lens):
    """``x`` ``[M, B, T, C]`` with the padded positions zeroed."""
    return x * (np.arange(x.shape[2])[None, None, :] < lens[..., None])[..., None]


@pytest.mark.parametrize("name", VERSIONS)
def test_pipeline_forward_matches_jax(ranks, jax_ref, workdir, name):
    """Every rank's x (at the lanes' positions) and whole state against the
    JAX package's pipeline and the port's meshless forward, microbatch by
    microbatch; the stage's own copied params give the same, bit for
    bit."""
    tok, lens = tokens_and_lens(64)
    want_x, want_st = jax_ref.pipeline(name, (1, 4), tok, lens)
    info, params = _port_model(workdir, name)
    for x, st, same in (res["fwd", name] for res in ranks):
        assert same
        _close_jax(_masked(x, lens), _masked(want_x, lens))
        for k in want_st:
            _close_jax(st[k], want_st[k], k)
        for m in range(M):
            xw, sw = forward_chunk(info, params, init_state(info, B, device="cpu"),
                                   torch.from_numpy(tok[m]), torch.from_numpy(lens[m]))
            np.testing.assert_allclose(_masked(x, lens)[m], _masked(xw.numpy()[None],
                                                                    lens[m:m + 1])[0],
                                       rtol=F32_TOL, atol=F32_TOL)
            for k in sw:
                np.testing.assert_allclose(st[k][:, m], sw[k].numpy(), rtol=F32_TOL,
                                           atol=F32_TOL, err_msg=k)


def test_pipeline_composes_with_data(ranks, jax_ref):
    """The (2, 2) mesh: two stages, each microbatch's lanes split over
    ``data``; x and the gathered state against the JAX package on its
    (2, 2) mesh."""
    tok, lens = tokens_and_lens(64, 2, 4, T, 1, False)
    want_x, want_st = jax_ref.pipeline("v7", (2, 2), tok, lens)
    for res in ranks:
        x, st = res["data"]
        _close_jax(x, want_x)
        for k in want_st:
            _close_jax(st[k], want_st[k], k)


def test_pipeline_rejects_bad_config(ranks):
    """Two layers over four stages: the JAX package's EngineError."""
    for res in ranks:
        assert res["bad"] is not None and "divide" in res["bad"]


def test_pipeline_quantized_matches_jax(ranks, jax_ref):
    """Q4_K with a Q6_K head over two stages (and two data ranks) against
    the JAX package's pipeline, at 3e-2·max."""
    tok, lens = tokens_and_lens(64, 2, B, T, 2)
    want_x, want_st = jax_ref.pipeline("v7q4k", (1, 2), tok, lens)
    for res in ranks:
        x, st = res["q4k"]
        want = _masked(want_x, lens)
        np.testing.assert_allclose(_masked(x, lens), want, rtol=0,
                                   atol=QUANT_TOL * np.abs(want).max())
        for k in want_st:
            np.testing.assert_allclose(st[k], want_st[k], rtol=0,
                                       atol=QUANT_TOL * np.abs(want_st[k]).max(), err_msg=k)


def _plain(workdir, num_batch, rescale=None):
    info, params = _port_model(workdir, "v7", rescale=rescale)
    return Engine(info, params, num_batch, token_chunk_size=CHUNK, rescale=rescale,
                  unroll=False, device="cpu")


def _close_engine(got, want, tol):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol * max(1.0, np.abs(w).max()))


@pytest.mark.parametrize("tp_mode", ["gspmd", "shard_map"])
def test_engine_pipeline_matches(ranks, jax_ref, workdir, tp_mode):
    """``Engine(mesh=(1, 4), pipeline_microbatches=2)`` over two chained
    chunks a prompt: every rank's last logits against the port's meshless
    Engine (2e-4) and the JAX package's pipeline Engine (2e-3·max). Under
    ``tp_mode="shard_map"`` too, which places no tensor-parallel plan here:
    the JAX Engine hands its shard_map params to the pipeline and computes
    the meshless Engine's logits as well (the finding recorded in ROADMAP,
    queue 3: no fault)."""
    want = [r[-1:] for r in drive(_plain(workdir, 2), PROMPTS2)]
    want_jax = [r[-1:] for r in jax_ref.engine(pipeline=True, tp_mode=tp_mode)]
    _close_engine(want_jax, [r[-1:] for r in jax_ref.engine()], ENGINE_TOL)
    for res in ranks:
        got = [r[-1:] for r in res["engine", tp_mode]]
        _close_engine(got, want, F32_TOL)
        _close_engine(got, want_jax, ENGINE_TOL)
        for g, w in zip(got, want_jax):
            assert int(np.argmax(g)) == int(np.argmax(w))


def test_engine_pipeline_generates(ranks, workdir):
    """``generate`` on the pipeline Engine (its prefill through ``infer``,
    every decode step through the pipeline) gives the meshless Engine's
    greedy tokens, and so does an ``EnginePool`` of two pipeline Engines."""
    info, params = _port_model(workdir, "v7")
    want = Engine(info, params, 2, unroll=False, device="cpu").generate(PROMPTS2, GEN_TOKENS)
    want_pool = EnginePool(info, params, 4, lanes_per_engine=2, unroll=False,
                           device="cpu").generate(PROMPTS4, GEN_TOKENS)
    for res in ranks:
        assert res["generate"] == want
        assert res["pool"] == want_pool


def test_engine_pipeline_embeds(ranks, workdir):
    """Token::Embed on the (1, 4) pipeline Engine of four lanes, two a
    microbatch: the chunk with vectors runs through the pipeline (stage 0
    takes ln0 of the raw rows and zeroes the padding), its FULL and LAST
    rows against the meshless Engine's (2e-4). The JAX Engine sends such a
    chunk to its whole-model forward instead; both compute one function."""
    want = drive(_plain(workdir, 4), embed_prompts(), OPTIONS4)
    for res in ranks:
        _close_engine(res["embeds"], want, F32_TOL)


def test_engine_pipeline_state_round_trip(ranks, workdir):
    """On (2, 2) with four lanes, two a data rank: FULL and LAST rows
    against the meshless Engine; every lane's ``back_state`` whole on every
    rank; ``reset_state`` of one lane gives the fresh state, ``load_state``
    brings it back; the next chunk's logits then match."""
    plain = _plain(workdir, 4)
    want_rows = drive(plain, PROMPTS4, OPTIONS4)
    want_snap = _snap(plain, range(4))
    want_after = drive(plain, [[7], [8], [9], [10]])
    fresh = _snap(_plain(workdir, 4), [1])[0]
    for res in ranks:
        rows, snap, reset, loaded, after = res["state"]
        _close_engine(rows, want_rows, F32_TOL)
        for got, want in zip(snap, want_snap):
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=F32_TOL, atol=F32_TOL)
        for k in fresh:
            np.testing.assert_array_equal(reset[k], fresh[k])
            np.testing.assert_array_equal(loaded[k], snap[1][k])
        _close_engine(after, want_after, F32_TOL)


def test_engine_pipeline_honours_rescale(ranks, jax_ref, workdir):
    """A model loaded with ``rescale=2``: the port's pipeline Engine halves
    the residual every two global layers and gives its meshless Engine's
    logits; the JAX package's ``make_pipeline_forward`` takes no rescale,
    so its pipeline Engine leaves the meshless JAX Engine (a reference
    fault, ROADMAP queue 3)."""
    want = [r[-1:] for r in drive(_plain(workdir, 2, RESCALE), PROMPTS2)]
    jax_pp = jax_ref.engine(pipeline=True, rescale=RESCALE)
    jax_plain = jax_ref.engine(rescale=RESCALE)
    gap = max(np.abs(a[-1] - b[-1]).max() for a, b in zip(jax_pp, jax_plain))
    assert gap > ENGINE_TOL * max(np.abs(b).max() for b in jax_plain)
    _close_engine(want, [r[-1:] for r in jax_plain], ENGINE_TOL)
    for res in ranks:
        _close_engine([r[-1:] for r in res["rescale"]], want, F32_TOL)


def test_engine_pipeline_one_rank(workdir):
    """A pipeline Engine on a mesh of one rank (one stage, two
    microbatches): the meshless Engine's rows and its greedy tokens."""
    info, params = _port_model(workdir, "v7")
    mesh = make_mesh(1, 1, device="cpu")
    eng = Engine(info, params, 4, token_chunk_size=CHUNK, mesh=mesh, pipeline_microbatches=2)
    _close_engine(drive(eng, PROMPTS4, OPTIONS4), drive(_plain(workdir, 4), PROMPTS4, OPTIONS4),
                  F32_TOL)
    eng = Engine(info, params, 4, mesh=mesh, pipeline_microbatches=2)
    want = Engine(info, params, 4, unroll=False, device="cpu").generate(PROMPTS4, GEN_TOKENS)
    assert eng.generate(PROMPTS4, GEN_TOKENS) == want


def test_engine_pipeline_errors(workdir):
    """The JAX Engine's errors for its bad cases: no mesh, lanes that do
    not divide by the microbatches (EngineError), hooks
    (UnsupportedFeature), on the pipeline alone and beside
    ``seq_parallel``."""
    info, params = _port_model(workdir, "v7")
    mesh = make_mesh(1, 1, device="cpu")
    with pytest.raises(EngineError, match="requires a mesh"):
        Engine(info, params, 2, pipeline_microbatches=2, device="cpu")
    with pytest.raises(EngineError, match="divide"):
        Engine(info, params, 3, mesh=mesh, pipeline_microbatches=2)
    with pytest.raises(UnsupportedFeature, match="hooks"):
        Engine(info, params, 2, mesh=mesh, pipeline_microbatches=2,
               hooks={"post_att": lambda layer, **t: None})
    with pytest.raises(UnsupportedFeature, match="hooks"):
        Engine(info, params, 2, mesh=mesh, pipeline_microbatches=2, seq_parallel=True,
               hooks={"post_att": lambda layer, **t: None})
    with pytest.raises(EngineError, match="divide"):
        Engine(info, params, 3, mesh=mesh, pipeline_microbatches=2, seq_parallel=True)
    with pytest.raises(EngineError, match="divide"):
        EnginePool(info, params, 3, lanes_per_engine=3, mesh=mesh, pipeline_microbatches=2)
