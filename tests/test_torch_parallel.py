"""The port's tensor parallelism (``web_rwkv_gguf_tpu_torch/parallel``)
against the JAX package's, on the CPU.

The port runs one process a rank: the mesh shapes (1, 2) and (2, 1) share
one spawn of two gloo ranks, (2, 2) is one of four (``parallel/launch.py``,
a ``file://`` rendezvous, a 60 s collective timeout, a 120 s deadline),
each running every case of its shapes; the ranks write their results,
which the tests here
hold against the JAX package's own functions run in this process on its
(2, 2) CPU mesh: ``shard_params`` with ``jax.jit(forward_chunk)`` for
``tp_mode="gspmd"``, ``make_tp_forward`` for ``"shard_map"``. The
function does not depend on the mesh, so one JAX mesh serves the three.
The ranks import no JAX: this module imports it only inside the parent's
functions.

Models (``utils/synthetic``, the same bytes for both packages): RWKV-7 at
L = 4, C = 256, head size 16, in f32, and at L = 2 in Q4_K with a Q6_K
head (at L = 4 the JAX package and the port, meshless, already part by
4.9e-2·max in the WKV state: its bf16-rounded weights);
RWKV-6, -5 (head size 16) and -4 at L = 2, C = 256, f32.

Tolerances: f32 rtol = atol = 2e-4 (tests/test_sharding.py's);
quantized 3e-2·max|ref| (the JAX package's CPU path rounds dequantized
Q4_K weights to bf16, the port's kernels multiply them in f32:
tests/test_torch_forward.py). Largest errors seen are noted by each test.

Without a spawn: the slicing rule per kind (every cut of a matrix
dequantizes to the same cut of the whole matrix, exactly), the placement
of every kind ``load_model`` takes at the RWKV-7 0.1B widths, that a
rank-local matrix routes to the same kernel as the whole one, and a
mesh of one rank against the meshless Engine, bit for bit.
"""

import numpy as np
import pytest
import torch

from web_rwkv_gguf_tpu_torch.gguf import GgufFile
from web_rwkv_gguf_tpu_torch.models import init_state, load_model
from web_rwkv_gguf_tpu_torch.models import matrix as matrix_mod
from web_rwkv_gguf_tpu_torch.models.matrix import Matrix
from web_rwkv_gguf_tpu_torch.parallel import (
    gather_state, make_mesh, make_tp_forward, shard_params, shard_params_tp, shard_state)
from web_rwkv_gguf_tpu_torch.parallel.sharding import (
    col_shard, k_block, row_shard, row_shardable)
from web_rwkv_gguf_tpu_torch.parallel.tensor import placement
from web_rwkv_gguf_tpu_torch.quant import ggml
from web_rwkv_gguf_tpu_torch.quant.formats import QuantScheme
from web_rwkv_gguf_tpu_torch.quant.ggml import GgmlDType

F32_TOL = 2e-4
QUANT_TOL = 3e-2
MESHES = [(1, 2), (2, 1), (2, 2)]
PLANS = ("gspmd", "shard_map")
B, T = 4, 6
LENS = [6, 4, 6, 3]
# name -> (maker, arguments, f32 weights)
MODELS = {
    "v7": ("make_v7_gguf", dict(n_layer=4, n_emb=256, head_size=16, n_vocab=64,
                                n_hidden=512, seed=41), True),
    "v7q4k": ("make_v7_gguf", dict(n_layer=2, n_emb=256, head_size=16, n_vocab=64,
                                   n_hidden=512, seed=42, quantize=GgmlDType.Q4_K,
                                   head_quantize=GgmlDType.Q6_K), False),
    "v6": ("make_v6_gguf", dict(n_layer=2, n_emb=256, head_size=16, n_vocab=64,
                                n_hidden=512, seed=43), True),
    "v5": ("make_v5_gguf", dict(n_layer=2, n_emb=256, head_size=16, n_vocab=64,
                                n_hidden=512, seed=44), True),
    "v4": ("make_v4_gguf", dict(n_layer=2, n_emb=256, n_vocab=64, n_hidden=512,
                                seed=45), True),
}


def model_bytes(name: str) -> bytes:
    from web_rwkv_gguf_tpu_torch.utils import synthetic

    maker, kw, _ = MODELS[name]
    return bytes(getattr(synthetic, maker)(**kw))


def tokens_and_lens(vocab: int):
    tok = np.random.default_rng(0).integers(1, vocab, (B, T))
    return tok, np.asarray(LENS)


def _port_model(workdir, name):
    raw = open(f"{workdir}/{name}.gguf", "rb").read()
    f32 = MODELS[name][2]
    return load_model(GgufFile(raw), dtype=torch.float32 if f32 else torch.bfloat16,
                      device="cpu")


def rank_main(rank, world, workdir, meshes):
    """A rank's cases on each of ``meshes`` over the same ranks (imported
    by the spawned ranks: no JAX here)."""
    meshes = {shape: make_mesh(*shape, device="cpu") for shape in meshes}
    out = {shape: {} for shape in meshes}
    for name in MODELS:
        info, params = _port_model(workdir, name)
        tok, lens = (torch.from_numpy(a) for a in tokens_and_lens(info.num_vocab))
        for shape, mesh in meshes.items():
            for plan in PLANS:
                out[shape].update(_mesh_cases(name, info, params, mesh, plan, tok, lens))
    return out


def _mesh_cases(name, info, params, mesh, plan, tok, lens):
    local = (shard_params if plan == "gspmd" else shard_params_tp)(params, mesh, info)
    fwd = make_tp_forward(info, mesh, local)
    logits, st = fwd(local, shard_state(init_state(info, B, device="cpu"), mesh), tok, lens)
    out = {(name, plan): (logits.numpy(),
                          {k: v.numpy() for k, v in gather_state(st, mesh).items()})}
    if name == "v7":
        fired = []
        hooks = {"post_att": lambda layer, **t: fired.append(layer)}
        fwd = make_tp_forward(info, mesh, local, full_output=True, hooks=hooks)
        x, _ = fwd(local, shard_state(init_state(info, B, device="cpu"), mesh), tok, lens)
        emb = params["emb"][tok].float()
        fwd = make_tp_forward(info, mesh, local, full_output=True, input_embeds=True)
        xe, _ = fwd(local, shard_state(init_state(info, B, device="cpu"), mesh), emb, lens)
        out[name, plan, "hooks"] = (x.numpy(), xe.numpy(), sorted(set(fired)))
    return out


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp")
    for name in MODELS:
        (d / f"{name}.gguf").write_bytes(model_bytes(name))
    return str(d)


@pytest.fixture(scope="module")
def spawned():
    """Each world size's ranks, launched once for every mesh of that size
    (filled on first use)."""
    return {}


@pytest.fixture(scope="module", params=MESHES, ids=lambda m: f"mesh{m[0]}x{m[1]}")
def ranks(request, workdir, spawned):
    from web_rwkv_gguf_tpu_torch.parallel.launch import launch

    shape = request.param
    world = shape[0] * shape[1]
    if world not in spawned:
        meshes = [m for m in MESHES if m[0] * m[1] == world]
        spawned[world] = launch(f"{__name__}:rank_main", world, args=(workdir, meshes),
                                deadline=120, timeout=60)
    return shape, [res[shape] for res in spawned[world]]


class _Jax:
    """The JAX package's results, each computed once (on its (2, 2) CPU mesh)."""

    def __init__(self, workdir):
        self.workdir, self.cache = workdir, {}

    def model(self, name):
        import jax.numpy as jnp

        from web_rwkv_gguf_tpu.gguf import GgufFile as JaxGgufFile
        from web_rwkv_gguf_tpu.models import load_model as jax_load_model

        if name not in self.cache:
            raw = open(f"{self.workdir}/{name}.gguf", "rb").read()
            kw = dict(dtype=jnp.float32) if MODELS[name][2] else {}
            self.cache[name] = jax_load_model(JaxGgufFile(raw), **kw)
        return self.cache[name]

    def mesh(self):
        import jax

        from web_rwkv_gguf_tpu.parallel import make_mesh as jax_make_mesh

        return jax_make_mesh(2, 2, devices=jax.devices()[:4])

    def forward(self, name, plan):
        key = ("fwd", name, plan)
        if key not in self.cache:
            import jax
            import jax.numpy as jnp

            from web_rwkv_gguf_tpu.models import forward_chunk, init_state as jinit, logits_head
            from web_rwkv_gguf_tpu.parallel import shard_params as jshard
            from web_rwkv_gguf_tpu.parallel import shard_state as jshard_state
            from web_rwkv_gguf_tpu.parallel.tensor import make_tp_forward as jtp
            from web_rwkv_gguf_tpu.parallel.tensor import shard_params_tp as jshard_tp

            info, params = self.model(name)
            mesh = self.mesh()
            tok, lens = tokens_and_lens(info.num_vocab)
            tok, lens = jnp.asarray(tok, jnp.int32), jnp.asarray(lens, jnp.int32)
            state = jshard_state(jinit(info, B), mesh)
            if plan == "gspmd":
                def run(p, s, t, ln):
                    x, st = forward_chunk(info, p, s, t, ln)
                    rows = x[jnp.arange(B), jnp.clip(ln - 1, 0, T - 1)]
                    return logits_head(p, rows), st

                lg, st = jax.jit(run)(jshard(params, mesh, info), state, tok, lens)
            else:
                sp = jshard_tp(params, mesh, info)
                lg, st = jtp(info, mesh, sp)(sp, state, tok, lens)
            self.cache[key] = (np.asarray(lg), {k: np.asarray(v) for k, v in st.items()})
        return self.cache[key]

    def full(self, embeds: bool):
        key = ("full", embeds)
        if key not in self.cache:
            import jax.numpy as jnp

            from web_rwkv_gguf_tpu.models import init_state as jinit
            from web_rwkv_gguf_tpu.parallel import shard_state as jshard_state
            from web_rwkv_gguf_tpu.parallel.tensor import make_tp_forward as jtp
            from web_rwkv_gguf_tpu.parallel.tensor import shard_params_tp as jshard_tp

            info, params = self.model("v7")
            mesh = self.mesh()
            tok, lens = tokens_and_lens(info.num_vocab)
            sp = jshard_tp(params, mesh, info)
            inp = (jnp.asarray(np.asarray(params["emb"], np.float32)[tok]) if embeds
                   else jnp.asarray(tok, jnp.int32))
            fwd = jtp(info, mesh, sp, full_output=True, input_embeds=embeds)
            x, _ = fwd(sp, jshard_state(jinit(info, B), mesh), inp, jnp.asarray(lens, jnp.int32))
            self.cache[key] = np.asarray(x)
        return self.cache[key]


@pytest.fixture(scope="module")
def jax_ref(workdir):
    return _Jax(workdir)


def _close(got, want, f32):
    want = np.asarray(want)
    if f32:
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=QUANT_TOL * np.abs(want).max())


def _valid(x):
    """The rows of a ``[B, T, C]`` stream that a lane's length covers (a
    padded position is unspecified)."""
    return np.concatenate([x[b, :n] for b, n in enumerate(LENS)])


@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("name", list(MODELS))
def test_tp_forward_matches_jax(ranks, jax_ref, name, plan):
    """Every rank's gathered last-token logits and whole state against the
    JAX package's sharded forward (largest seen, f32: 3e-6 logits, 5e-5
    state; Q4_K: 1.3e-2·max logits)."""
    _, results = ranks
    want_lg, want_st = jax_ref.forward(name, plan)
    f32 = MODELS[name][2]
    for res in results:
        lg, st = res[name, plan]
        _close(lg, want_lg, f32)
        for k in want_st:
            w = want_st[k]
            if f32:
                # the delta rule carries the forward's f32 reassociation
                # into the state (tests/test_tensor_parallel.py's rationale)
                np.testing.assert_allclose(st[k], w, rtol=F32_TOL,
                                           atol=F32_TOL * max(1.0, np.abs(w).max()), err_msg=k)
            else:
                _close(st[k], w, False)


@pytest.mark.parametrize("plan", PLANS)
def test_tp_hooks_and_embeds(ranks, jax_ref, plan):
    """Hooks fire on every layer under TP, and ``input_embeds`` of the
    embedding rows gives the token path's stream; both against the JAX
    package's ``make_tp_forward(full_output=True)``, on the rows the
    lengths cover."""
    _, results = ranks
    want = _valid(jax_ref.full(False))
    want_e = _valid(jax_ref.full(True))
    for res in results:
        x, xe, fired = res["v7", plan, "hooks"]
        assert fired == list(range(MODELS["v7"][1]["n_layer"]))
        tol = dict(rtol=F32_TOL, atol=F32_TOL * max(1.0, np.abs(want).max()))
        np.testing.assert_allclose(_valid(x), want, **tol)
        np.testing.assert_allclose(_valid(xe), want_e, **tol)


def test_ranks_agree(ranks):
    """Every rank returns the same gathered results, bit for bit."""
    _, results = ranks
    for res in results[1:]:
        for key, val in res.items():
            a, b = results[0][key], val
            for x, y in zip(a[:2], b[:2]):
                if isinstance(x, dict):
                    for k in x:
                        assert np.array_equal(x[k], y[k]), (key, k)
                else:
                    assert np.array_equal(x, y), key


# -- no spawn: the slicing rule, placement and routes ------------------------

KINDS = ("f32", "Q4_K", "Q6_K", "Q8_0", "Q4_0", "NF4", "INT8")


def _matrix(kind: str, m: int, k: int, seed: int = 0) -> Matrix:
    w = (np.random.default_rng(seed).normal(size=(m, k)) * 0.1).astype(np.float32)
    if kind == "f32":
        return Matrix.dense(torch.from_numpy(w))
    if kind in ("NF4", "INT8", "SF4"):
        return Matrix.from_f16(w.astype(np.float16), QuantScheme[kind], device="cpu")
    dt = GgmlDType[kind]
    raw = np.frombuffer(getattr(ggml, f"quantize_{kind.lower()}")(w.reshape(-1)), np.uint8)
    return Matrix.from_gguf_blocks(dt, raw, (m, k), device="cpu")


@pytest.mark.parametrize("kind", KINDS)
def test_slicing_rule_per_kind(kind):
    """Every column cut (rows) and every whole row cut (K) of a matrix
    dequantizes to the same cut of the whole matrix, exactly; K splits
    only in whole :func:`k_block` units; the partial products of the K
    cuts add up to the whole product."""
    m, k = 64, 1024
    mat = _matrix(kind, m, k)
    full = mat.dequantize()
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(3, k)).astype(np.float32))
    for n in (2, 4, 8):
        parts = [col_shard(mat, r, n) for r in range(n)]
        assert torch.equal(torch.cat([p.dequantize() for p in parts]), full)
        assert row_shardable(mat, n) == ((k // n) % k_block(mat) == 0)
        if not row_shardable(mat, n):
            continue
        parts = [row_shard(mat, r, n) for r in range(n)]
        assert torch.equal(torch.cat([p.dequantize() for p in parts], dim=1), full)
        whole = x @ full.T
        got = sum(p.matmul(x[:, r * k // n:(r + 1) * k // n]) for r, p in enumerate(parts))
        np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=0,
                                   atol=1e-2 * whole.abs().max().item())
    # the rule, at the widths of the RWKV-7 0.1B model's Wo (K = 768)
    expect = {"f32": True, "Q4_K": False, "Q6_K": False, "Q8_0": True, "Q4_0": True,
              "NF4": True, "INT8": True}
    assert row_shardable(_matrix(kind, 16, 768), 2) == expect[kind]


ROUTES = {  # matrix-module wrappers by kind: (gemv, gemm)
    "f32": None, "Q4_K": ("q4k_gemv", "q4k_gemm"), "Q6_K": ("q6k_gemv", "q6k_gemm"),
    "Q8_0": ("qs_gemv", "qs_gemm"), "Q4_0": ("qs_gemv", "qs_gemm"),
    "NF4": ("nf4_gemv", "nf4_gemm"), "INT8": ("qs_gemv", "qs_gemm"),
}


@pytest.mark.parametrize("kind", KINDS)
def test_rank_local_matrices_take_the_whole_matrix_kernels(kind, monkeypatch):
    """The port's form of test_tp_shard_keeps_native_operands: a rank-local
    matrix (a column cut, and a whole K cut) calls the same kernel wrapper
    as the whole matrix, at decode (1 row) and prefill (64 rows), counted
    by spies on the wrappers ``Matrix.matmul`` calls."""
    calls = []
    for fn in {f for pair in ROUTES.values() if pair for f in pair}:
        orig = getattr(matrix_mod, fn)
        monkeypatch.setattr(matrix_mod, fn,
                            lambda *a, _f=fn, _o=orig, **kw: (calls.append(_f), _o(*a, **kw))[1])
    mat = _matrix(kind, 512, 2048)
    for rows in (1, 64):
        for piece in (mat, col_shard(mat, 1, 2), row_shard(mat, 1, 2)):
            calls.clear()
            piece.matmul(torch.ones(rows, piece.dims()[1]))
            want = [] if ROUTES[kind] is None else [ROUTES[kind][0 if mat.takes_gemv(rows) else 1]]
            assert calls == want, (kind, rows, piece.dims(), calls)


def _placement_matrices(kind):
    """The RWKV-7 0.1B model's layer matrices (C = 768, FFN 3072) and head
    (65536 × 768) in ``kind``, depth cut to 2, from random bytes (placement
    reads shapes and forms, not values)."""
    shapes = {("att", "Wr"): (768, 768), ("att", "Wo"): (768, 768),
              ("ffn", "Wk"): (3072, 768), ("ffn", "Wv"): (768, 3072)}
    rng = np.random.default_rng(0)
    out = {}
    for key, (m, k) in shapes.items():
        if kind in ("F32", "F16"):
            w = torch.zeros(2, m, k, dtype=torch.float32 if kind == "F32" else torch.bfloat16)
            out[key] = Matrix.dense(w)
        elif kind in ("INT8", "NF4", "SF4"):
            out[key] = Matrix.from_f16((rng.normal(size=(m, k)) * 0.1).astype(np.float16),
                                       QuantScheme[kind], device="cpu")
        else:
            dt = GgmlDType[kind]
            nbytes = m * k // ggml.GGML_BLOCK_SIZES[dt] * ggml.GGML_TYPE_SIZES[dt]
            with np.errstate(all="ignore"):  # random f16 scales: NaN and inf among them
                out[key] = Matrix.from_gguf_blocks(dt, rng.integers(0, 256, nbytes, np.uint8),
                                                   (m, k), device="cpu")
    return out


# every kind load_model takes: the GGML types it reads directly, the f16 /
# f32 files (dense), and the requantization schemes
LOAD_KINDS = ("F32", "F16", "Q8_0", "Q4_0", "Q4_1", "Q5_0", "Q5_1", "Q2_K", "Q3_K", "Q4_K",
              "Q5_K", "Q6_K", "INT8", "NF4", "SF4")


@pytest.mark.parametrize("kind", LOAD_KINDS)
def test_placement_at_the_0_1b_widths(kind):
    """What each plan cuts and what it keeps whole, for n_model = 2 and 4,
    at the RWKV-7 0.1B widths. The K-quants' native factors split K only
    in whole 256-element super-blocks: their Wo (K = 768) stays whole and
    gathers its input under ``gspmd``; the FFN value (K = 3072) splits
    (1536 and 768 per rank). Int8 (128-element groups) splits Wo over 2
    ranks but not over 4 (192 a rank); every other kind splits K at both
    counts."""
    mats = _placement_matrices(kind)
    native = kind in ("Q2_K", "Q3_K", "Q4_K", "Q5_K", "Q6_K")
    head = Matrix.dense(torch.empty(65536, 1))  # only its rows count
    for n in (2, 4):
        wo_whole = native or (kind == "INT8" and n == 4)
        got = {key: placement(*key, mat, n, "gspmd") for key, mat in mats.items()}
        assert got == {("att", "Wr"): "col", ("ffn", "Wk"): "col",
                       ("att", "Wo"): "whole-gather-in" if wo_whole else "row-sum",
                       ("ffn", "Wv"): "row-sum"}, (kind, n)
        got = {key: placement(*key, mat, n, "shard_map") for key, mat in mats.items()}
        assert got == {("att", "Wr"): "col", ("ffn", "Wk"): "col",
                       ("att", "Wo"): "col-gather-in", ("ffn", "Wv"): "col-gather-in"}
        assert placement("head", "", head, n, "gspmd") == "col"
        for (part, name), mat in mats.items():
            how = placement(part, name, mat, n, "gspmd")
            if how.startswith("row"):
                assert row_shard(mat, 1, n).dims() == (mat.dims()[0], mat.dims()[1] // n)
            if how == "col":
                assert col_shard(mat, 1, n).dims() == (mat.dims()[0] // n, mat.dims()[1])
    assert placement("head", "", head, 1, "gspmd") == "whole"


@pytest.mark.parametrize("plan", PLANS)
def test_one_rank_mesh_equals_the_meshless_engine(plan):
    """World size 1, mesh (1, 1): no process group, every collective the
    identity, the same kernels on the same weights: the Engine's logits,
    generated tokens and state equal the meshless Engine's on the
    per-layer route (``unroll=False``) bit for bit."""
    from web_rwkv_gguf_tpu_torch.runtime import Engine, RnnInput, RnnInputBatch, RnnOption

    info, params = load_model(GgufFile(model_bytes("v7q4k")), device="cpu")
    mesh = make_mesh(1, 1, device="cpu")

    def run(eng):
        inp = RnnInput([RnnInputBatch([1, 2, 3, 4, 5], RnnOption.FULL),
                        RnnInputBatch([9, 8, 7])], 32)
        outs = []
        while inp.num_token:
            outs.extend(np.asarray(b) for b in eng.infer(inp).batches)
        toks = eng.generate([[3, 4], [5]], 4)
        return outs, toks, eng.back_state(1)

    got = run(Engine(info, params, 2, token_chunk_size=32, mesh=mesh, tp_mode=plan,
                     device="cpu"))
    want = run(Engine(info, params, 2, token_chunk_size=32, unroll=False, device="cpu"))
    assert all(np.array_equal(a, b) for a, b in zip(got[0], want[0]))
    assert got[1] == want[1]
    for k in want[2]:
        assert np.array_equal(got[2][k], want[2][k]), k


def test_engine_pool_places_the_weights_once():
    """``EnginePool(mesh=)``: the weights placed once, every engine holding
    the same rank-local params, and the pool's greedy tokens those of the
    meshless pool on the per-layer route (one rank, bit for bit)."""
    from web_rwkv_gguf_tpu_torch.parallel.tensor import LocalParams
    from web_rwkv_gguf_tpu_torch.runtime import EnginePool

    info, params = load_model(GgufFile(model_bytes("v7q4k")), device="cpu")
    mesh = make_mesh(1, 1, device="cpu")
    pool = EnginePool(info, params, 4, lanes_per_engine=2, mesh=mesh, tp_mode="shard_map",
                      device="cpu")
    assert isinstance(pool.params, LocalParams)
    assert all(e.params is pool.params for e in pool.engines)
    prompts = [[1, 2], [3], [4, 5, 6], [7]]
    want = EnginePool(info, params, 4, lanes_per_engine=2, unroll=False,
                      device="cpu").generate(prompts, 5)
    assert pool.generate(prompts, 5) == want
