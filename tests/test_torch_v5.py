"""The port's RWKV-5 path against the JAX package's, on the CPU, from the
same GGUF bytes (or the same synthetic parameters): the synthetic file,
the loader, the WKV through ``wkv6_scan``'s plain version (against
``wkv5_pallas`` in interpret mode), ``forward_chunk`` / ``logits_head``
at T = 37, 1, 1 and 128, the whole-stack decode step's version-5 body
(against the JAX ``layer_scan56`` in interpret mode and against the
port's per-layer path) and the Engine.

Tolerances:

- synthetic file and loader: byte-equal and bit-exact (the same numpy
  arithmetic on the same draws and bytes);
- the WKV: atol = 2e-5 on y and the state (the same f32 ops summed in
  another order; values of order 1-10);
- f32 dense forward and Engine: logits at rtol = atol = 2e-4, as
  tests/test_oracle.py:228 holds the JAX forward to its scalar oracle;
  the residual x and the states at atol = 2e-4·max. At T = 128 both
  sides run their chunk-parallel WKV: the JAX ``wkv6_chunked`` with w
  broadcast stays finite on this file's decays (the smallest is 1.1e-2);
  on the Q4_K_M file's (the smallest 9.4e-4, so 16 of them underflow
  f32) it returns NaN, and that test feeds the JAX side's T = 128 chunk
  to its scan (tests/test_torch_v6.py's ``jax_scan_wkv6``);
- Q4_K_M logits: atol = 3e-2·max|logit|, against the JAX forward with
  its quantized matmuls through ``quant_matmul`` in interpret mode, as
  tests/test_torch_v6.py;
- the whole-stack step against JAX: layer 0 at 1e-5·max, every output at
  3e-2·max (a bf16 operand rounding flipped in layer 0 carries into later
  layers); against the port's per-layer path, 1e-6·max.

The largest errors seen are recorded beside each test.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_v6 import (  # noqa: F401 (fixtures)
    LOADS, _assert_same_tree, _chunks, _close, _close_to_max, _run_both, _t, interpret_mode,
    jax_quant_matmul, jax_scan_wkv6,
)
from test_torch_v6_decode import _rel, _tokens
from web_rwkv_gguf_tpu.gguf import GgufFile as JaxGgufFile
from web_rwkv_gguf_tpu.models import init_state as jax_init_state
from web_rwkv_gguf_tpu.models import load_model as jax_load_model
from web_rwkv_gguf_tpu.models import logits_head as jax_logits_head
from web_rwkv_gguf_tpu.models.forward import embed_tokens as jax_embed
from web_rwkv_gguf_tpu.ops import wkv as jax_wkv
from web_rwkv_gguf_tpu.ops.pallas.layer56 import layer_scan56 as jax_layer_scan56
from web_rwkv_gguf_tpu.ops.pallas.layer56 import prep_decode56 as jax_prep_decode56
from web_rwkv_gguf_tpu.ops.pallas.wkv456 import wkv5_pallas
from web_rwkv_gguf_tpu.runtime import Engine as JaxEngine
from web_rwkv_gguf_tpu.runtime import scheduler as jax_scheduler
from web_rwkv_gguf_tpu.utils.synthetic import make_v5_gguf as jax_make_v5_gguf
from web_rwkv_gguf_tpu.utils.synthetic import synthetic_v56_params
from web_rwkv_gguf_tpu_torch.gguf import GgufFile
from web_rwkv_gguf_tpu_torch.models import (
    ModelInfo, ModelVersion, embed_tokens, forward_chunk, init_state, load_model,
    logits_head, make_generator, params_from_numpy, prepare_decode,
)
from web_rwkv_gguf_tpu_torch.models.forward import GN_EPS, LN_EPS, _wkv5
from web_rwkv_gguf_tpu_torch.ops.cuda.layer56 import layer_scan56, mega_layers
from web_rwkv_gguf_tpu_torch.ops.cuda.matmul import q4k_gemv_plain
from web_rwkv_gguf_tpu_torch.ops.cuda.wkv6 import wkv6_scan
from web_rwkv_gguf_tpu_torch.quant.ggml import GgmlDType
from web_rwkv_gguf_tpu_torch.runtime import Engine, RnnInput, RnnInputBatch, RnnOption
from web_rwkv_gguf_tpu_torch.utils.synthetic import make_v5_gguf

F32_TOL = 2e-4
Q4KM_LOGITS_TOL = 3e-2
SCAN_TOL = 2e-5
VOCAB = 300
# the slice's small shape: 3 layers, C = 256 (4 heads of 64)
SMALL = dict(n_layer=3, n_emb=256, head_size=64, n_vocab=VOCAB, n_hidden=512)


@pytest.fixture(scope="module")
def f32_models():
    raw = make_v5_gguf(**SMALL, seed=11)
    return (jax_load_model(JaxGgufFile(raw), dtype=jnp.float32),
            load_model(GgufFile(raw), dtype=torch.float32, device="cpu"))


@pytest.fixture(scope="module")
def q4km_models():
    raw = make_v5_gguf(**SMALL, seed=12, quantize=GgmlDType.Q4_K,
                       head_quantize=GgmlDType.Q6_K)
    return jax_load_model(JaxGgufFile(raw)), load_model(GgufFile(raw), device="cpu")


@pytest.mark.parametrize("kw", [dict(), dict(SMALL, seed=3), dict(n_layer=1, n_emb=128,
                                                                   head_size=32, seed=9)],
                         ids=["defaults", "small", "one-layer"])
def test_make_v5_gguf_bytes_match_jax(kw):
    """With no quantize, the bytes are the JAX package's (which writes f32)."""
    assert make_v5_gguf(**kw) == jax_make_v5_gguf(**kw)


def test_make_v5_gguf_writes_q4km():
    raw = make_v5_gguf(**SMALL, seed=1, quantize=GgmlDType.Q4_K,
                       head_quantize=GgmlDType.Q6_K)
    f = GgufFile(raw)
    assert f.tensors["output.weight"].dtype == GgmlDType.Q6_K
    assert f.tensors["blk.0.attn_g.weight"].dtype == GgmlDType.Q4_K
    assert f.tensors["blk.0.ffn_v.weight"].dtype == GgmlDType.Q4_K
    assert f.tensors["blk.0.attn_time_decay"].dtype == GgmlDType.F32
    # the draws do not depend on the placement: the f32 tensors are the same
    plain = GgufFile(make_v5_gguf(**SMALL, seed=1))
    assert np.array_equal(f.tensor("blocks.0.att.time_first"),
                          plain.tensor("blocks.0.att.time_first"))


@pytest.mark.parametrize("name", sorted(LOADS))
def test_load_model_matches_jax(name):
    """The port's load_model == params_from_numpy(JAX load_model) exactly:
    every array (values, dtype, shape) and ModelInfo."""
    file_kw, jax_kw, port_kw = LOADS[name]
    raw = make_v5_gguf(**SMALL, **file_kw)
    info, params = load_model(GgufFile(raw), device="cpu", **port_kw)
    jinfo, jparams = jax_load_model(JaxGgufFile(raw), **jax_kw)
    _assert_same_tree(params, params_from_numpy(jax.device_get(jparams), device="cpu"))
    mine, ref = dataclasses.asdict(info), dataclasses.asdict(jinfo)
    mine["version"], ref["version"] = mine["version"].value, ref["version"].value
    assert mine == ref and mine["version"] == "v5"
    att = params["blocks"]["att"]
    assert att["time_decay"].shape == (3, 4, 64) and att["time_first"].shape == (3, 4, 64)
    assert 0 < att["time_decay"].min() and att["time_decay"].max() < 1  # activated
    if name == "q4km":
        assert params["head"].kind == "qk_nomin"
        assert {att[k].kind for k in ("Wk", "Wv", "Wr", "Wg", "Wo")} == {"qk"}


def test_wkv5_through_wkv6_scan_matches_pallas(interpret_mode):
    """Ragged lengths (40, 23, 0) at T = 40: the port's V5 route (the V6
    scan, plain on the CPU, with the static w broadcast over T) against
    ``wkv5_pallas``, y at every position and the state (largest error
    seen: 2.4e-6)."""
    rng = np.random.default_rng(1)
    B, T, H, K = 3, 40, 4, 64
    f = lambda *s: (rng.normal(size=s) * 0.5).astype(np.float32)  # noqa: E731
    state, r, k, v, u = f(B, H, K, K), f(B, T, H, K), f(B, T, H, K), f(B, T, H, K), f(H, K)
    w = np.exp(-np.exp(rng.normal(size=(H, K)) * 0.5)).astype(np.float32)
    mask = np.arange(T)[None, :] < np.array([40, 23, 0])[:, None]
    jy, js = wkv5_pallas(*(jnp.asarray(a) for a in (state, r, k, v, u, w, mask)))
    y, s = wkv6_scan(_t(state), _t(r), _t(k), _t(v), _t(u), _t(w).expand(B, T, H, K),
                     _t(mask))
    _close(y, jy, SCAN_TOL)
    _close(s, js, SCAN_TOL)
    assert torch.equal(s[2], _t(state)[2])  # the empty lane keeps its state


def test_wkv6_scan_reads_the_static_decay_in_place():
    """The V5 route's static decay reaches the scan kernel without a
    [B, T, H, K] copy: ``decay_operand`` hands on the ``expand``ed [H, K]
    view itself, marked static (so is a [1, 1, H, K] decay); a contiguous
    f32 decay goes as it is; any other (bf16; keys not contiguous; a decay
    that repeats over lanes or tokens only) becomes a contiguous f32
    copy."""
    from web_rwkv_gguf_tpu_torch.ops.cuda.wkv6 import decay_operand

    B, T, H, K = 3, 5, 4, 64
    w = torch.rand(H, K)
    for view in (w.expand(B, T, H, K), w.expand(1, 1, H, K), w.expand(B, 1, H, K)):
        got, static = decay_operand(view)
        assert got.data_ptr() == w.data_ptr() and static
    full = torch.rand(B, T, H, K)
    got, static = decay_operand(full)
    assert got is full and not static
    for other in (full.bfloat16(), full.transpose(2, 3).contiguous().transpose(2, 3),
                  w.expand(B, T, H, K).bfloat16(), full[:, :1].expand(B, T, H, K)):
        got, static = decay_operand(other)
        assert got.is_contiguous() and got.dtype == torch.float32 and not static
        assert torch.equal(got, other.float())


@pytest.mark.parametrize("T", [1, 9, 128])
def test_wkv5_reference_matches_jax(T):
    """The port's V5 WKV route (``forward._wkv5``: the V6 scan's plain
    version below T = 128, the chunk-parallel ``wkv6_chunked`` from it,
    each with the static w broadcast) against the JAX package's XLA
    ``wkv5`` (and ``wkv5_step`` at T = 1), lane 1 padded at its last token
    (y at the valid tokens: the route's y at a padded one is unspecified;
    largest error seen: 1.4e-6 at T = 1 and 9, 3.3e-6 at T = 128)."""
    rng = np.random.default_rng(T)
    B, H, K = 2, 4, 64
    f = lambda *s: (rng.normal(size=s) * 0.5).astype(np.float32)  # noqa: E731
    mask = np.arange(T)[None, :] < np.array([T, T - 1])[:, None]
    args = (f(B, H, K, K), f(B, T, H, K), f(B, T, H, K), f(B, T, H, K), f(H, K),
            np.exp(-np.exp(f(H, K))), mask)
    y, s = _wkv5(*(_t(a) for a in args))
    for jax_fn in [jax_wkv.wkv5] + ([jax_wkv.wkv5_step] if T == 1 else []):
        jy, js = jax_fn(*(jnp.asarray(a) for a in args))
        _close(y[_t(mask)], np.asarray(jy)[mask], SCAN_TOL)
        _close(s, js, SCAN_TOL)


def test_forward_f32_matches_jax(f32_models):
    """A ragged T = 37 chunk, two T = 1 steps (one lane frozen), a ragged
    T = 128 chunk (both sides' chunk-parallel WKV): x at valid positions,
    last logits and every state array (largest errors seen: 2.7e-6 of max
    on x and the states, 5.9e-5 on logits)."""
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
        assert set(st) == set(jst) == {"att_shift", "wkv", "ffn_shift"}
        for key in jst:
            _close_to_max(st[key], jst[key], F32_TOL)


def test_forward_q4km_matches_jax(q4km_models, jax_scan_wkv6, jax_quant_matmul):
    """Q4_K_M: a ragged T = 37 chunk, a T = 1 step and a ragged T = 128
    chunk (the port's chunk-parallel WKV against the JAX scan); last
    logits at the stated tolerance (largest error seen: 4.8e-3 of
    max|logit|)."""
    jax_model, port_model = q4km_models
    chunks = [_chunks(6)[i] for i in (0, 1, 3)]
    for (toks, lens), (jx, x, _, _) in zip(chunks, _run_both(jax_model, port_model,
                                                             chunks, 2)):
        live = lens > 0
        last = np.maximum(lens - 1, 0)
        _close_to_max(logits_head(port_model[1], x[np.arange(2), last])[live],
                      np.asarray(jax_logits_head(jax_model[1], jx[np.arange(2), last]))[live],
                      Q4KM_LOGITS_TOL)


def test_engine_matches_jax(f32_models):
    """The Engine on f32 dense: chunked ``infer`` with a LAST and a FULL
    lane, the states of both lanes, then greedy ``generate`` (largest
    errors seen: 3.0e-4 on logits of up to ~10, inside rtol + atol; 1.9e-6
    of max|state|; tokens equal)."""
    (jinfo, jparams), (info, params) = f32_models
    jeng = JaxEngine(jinfo, jparams, 2, token_chunk_size=32)
    eng = Engine(info, params, 2, token_chunk_size=32, device="cpu")
    rng = np.random.default_rng(9)
    lanes = [([int(t) for t in rng.integers(0, VOCAB, 45)], "last"),
             ([int(t) for t in rng.integers(0, VOCAB, 20)], "full")]
    jinp = jax_scheduler.RnnInput([jax_scheduler.RnnInputBatch(list(t),
                                                               jax_scheduler.RnnOption(o))
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


# ---- the whole-stack decode step, version 5 ----------------------------------


def port_info(jinfo) -> ModelInfo:
    """The port's ModelInfo for a JAX package's one."""
    return ModelInfo(version=ModelVersion(jinfo.version.value), num_layer=jinfo.num_layer,
                     num_emb=jinfo.num_emb, num_hidden=jinfo.num_hidden,
                     num_vocab=jinfo.num_vocab, num_head=jinfo.num_head)


@pytest.fixture(scope="module")
def synthetic_v5():
    """``synthetic_v56_params`` (version 5, Q4_K) in both packages' forms."""
    jinfo, jparams = synthetic_v56_params(version=5, n_layer=3, n_emb=256, head_size=64,
                                          n_vocab=64, n_hidden=512, seed=2, quant="q4k")
    return (jinfo, jparams), (port_info(jinfo),
                              params_from_numpy(jax.device_get(jparams), device="cpu"))


@pytest.mark.parametrize("B", [1, 5])
def test_layer_scan56_v5_matches_jax(synthetic_v5, B, interpret_mode):
    """Two decode steps from a zero state, all lanes live (largest errors
    seen: layer 0 2.5e-6 of max, every output 1.0e-3)."""
    (jinfo, jparams), (info, params) = synthetic_v5
    mega = prepare_decode(params, info, B)["mega56"]
    assert mega["version"] == 5
    jmega = jax_prep_decode56(jparams, jinfo)
    st, jst = init_state(info, B, device="cpu"), jax_init_state(jinfo, B)
    for step in range(2):
        tok = _tokens(B, step) % 64  # the synthetic vocabulary
        x = embed_tokens(params, torch.tensor(tok))[:, 0]
        xo, st = layer_scan56(mega, st, x, torch.ones(B), None, LN_EPS, GN_EPS)
        jx = jax_embed(jparams, jnp.asarray(tok))[:, 0]
        jxo, jst = jax_layer_scan56(jmega, jst, jx, jnp.ones((B,), jnp.float32), None,
                                    LN_EPS, GN_EPS)
        assert _rel(xo, jxo) <= 3e-2
        assert set(st) == set(jst)
        for key in jst:
            assert _rel(st[key][0], jst[key][0]) <= 1e-5, key
            assert _rel(st[key], jst[key]) <= 3e-2, key


@pytest.mark.parametrize("B,rescale", [(1, None), (5, None), (5, 2)])
def test_layer_scan56_v5_matches_the_per_layer_path(q4km_models, B, rescale):
    """Three steps through ``forward_chunk`` with and without the decode
    blocks; at B=5 lane 2 is frozen on the second step (its state kept
    bit for bit, as the per-layer path keeps it; largest error seen: 0)."""
    _, (info, params) = q4km_models
    prepared = prepare_decode(params, info, B)
    assert prepared["mega56"]["version"] == 5
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


@pytest.mark.parametrize("rescale", [None, 2])
def test_layer_scan56_v5_slices_compose(q4km_models, rescale):
    """One-layer slices (``mega_layers`` with ``first_layer``), each fed
    the previous slice's x, give the whole stack exactly (the rescale
    counted by global layer)."""
    _, (info, params) = q4km_models
    mega = prepare_decode(params, info, 2)["mega56"]
    g = torch.Generator().manual_seed(3)
    L, C, H = info.num_layer, info.num_emb, info.num_head
    state = {"att_shift": torch.randn(L, 2, C, generator=g),
             "wkv": torch.randn(L, 2, H, 64, 64, generator=g),
             "ffn_shift": torch.randn(L, 2, C, generator=g)}
    x = embed_tokens(params, torch.tensor([[7], [9]]))[:, 0]
    mask = torch.tensor([1.0, 0.0])
    x_all, s_all = layer_scan56(mega, state, x, mask, rescale, LN_EPS, GN_EPS)
    x_l, parts = x, []
    for i in range(L):
        x_l, s_i = layer_scan56(mega_layers(mega, i, i + 1),
                                {k: v[i:i + 1] for k, v in state.items()},
                                x_l, mask, rescale, LN_EPS, GN_EPS, first_layer=i)
        parts.append(s_i)
    assert torch.equal(x_l, x_all)
    for key in state:
        assert torch.equal(torch.cat([p[key] for p in parts]), s_all[key])
        assert torch.equal(s_all[key][:, 1], state[key][:, 1])  # the frozen lane


def check_staged(info, params):
    """A one-layer ``layer_scan56`` (layer 1, B=2, a random state) with
    ``staged``: the operands come in the kernel's shapes and types, and
    the layer's x follows from them exactly (x + Wo·y + σ(rf)·(FFN value ·
    khid)), as chip_smoke replays the kernel's."""
    mega = prepare_decode(params, info, 2)["mega56"]
    C, hidden, i = mega["C"], mega["hidden"], 1
    g = torch.Generator().manual_seed(4)
    state = {k: torch.randn(1, *v.shape[1:], generator=g)
             for k, v in init_state(info, 2, device="cpu").items()}
    if "bb" in state:
        state["bb"] = state["bb"].abs() + 1
    x = torch.randn(2, C, generator=g)
    staged = {}
    xo, _ = layer_scan56(mega_layers(mega, i, i + 1), state, x, torch.ones(2), None, LN_EPS,
                         GN_EPS, first_layer=i, staged=staged)
    want = {"rkvg": ((4, 2, C), torch.float32), "y": ((2, C), torch.bfloat16),
            "khid": ((2, hidden), torch.bfloat16), "rf": ((2, C), torch.float32)}
    assert {k: (tuple(a.shape), a.dtype) for k, a in staged.items()} == want

    def mat(name, a):
        return q4k_gemv_plain(a.float(), *(f[i] for f in mega["mats"][name]))

    x_mid = x + mat("att.Wo", staged["y"])
    assert torch.equal(xo, x_mid + staged["rf"].sigmoid() * mat("ffn.Wv", staged["khid"]))


def test_layer_scan56_v5_stages_the_kernels_operands(q4km_models):
    check_staged(*q4km_models[1])


def test_engine_decodes_v5_through_the_whole_stack_step(q4km_models):
    """The Engine arranges the V5 decode blocks, and its greedy tokens
    equal the per-layer path's."""
    _, (info, params) = q4km_models
    eng = Engine(info, params, 2, token_chunk_size=32, device="cpu")
    assert "mega56" in eng.params and "mega56" not in params
    prompts = [[5, 9, 11, 2, 7, 8, 1, 0], [3, 1, 4, 1, 5, 9, 2, 6]]
    got = eng.generate(prompts, 6, segment=5)
    st = init_state(info, 2, device="cpu")
    x, st = forward_chunk(info, params, st, torch.tensor(prompts), torch.tensor([8, 8]))
    first = torch.argmax(logits_head(params, x[:, -1]), dim=-1)
    toks, *_ = make_generator(info, steps=5)(params, st, first[:, None])
    assert got == [[int(f)] + t for f, t in zip(first, toks.tolist())]


def test_prepare_decode_v5_takes_only_what_the_kernel_runs(q4km_models, f32_models):
    _, (info, params) = q4km_models
    assert "mega56" in prepare_decode(params, info, 16)
    assert "mega56" not in prepare_decode(params, info, 17)
    _, (info32, params32) = f32_models  # dense layers
    assert "mega56" not in prepare_decode(params32, info32, 1)
    # a head size of 32
    raw = make_v5_gguf(**{**SMALL, "n_layer": 1, "head_size": 32}, seed=2,
                       quantize=GgmlDType.Q4_K)
    info32h, params32h = load_model(GgufFile(raw), device="cpu")
    assert "mega56" not in prepare_decode(params32h, info32h, 1)
