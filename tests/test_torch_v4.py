"""The port's RWKV-4 path against the JAX package's, on the CPU, from the
same GGUF bytes (or the same synthetic parameters): the synthetic file,
the loader, the WKV scan's plain version (against ``wkv4_pallas`` in
interpret mode), ``forward_chunk`` / ``logits_head`` at T = 37, 1, 1 and
128, the whole-stack decode step's version-4 body (against the JAX
``layer_scan56`` in interpret mode and against the port's per-layer
path), the Engine and its typed error.

Tolerances:

- synthetic file and loader: byte-equal and bit-exact (the same numpy
  arithmetic on the same draws and bytes);
- the WKV scan: y, and aa and bb over the lanes that ran, at atol =
  2e-5·max (the same f32 ops; exp and the sigmoid may differ in the last
  ulp); pp absolutely at 2e-5 on those lanes (its scale is logarithmic,
  and a lane that never ran holds ``F32_MIN``, which makes a relative
  check empty); a lane of length 0 keeps its state bit for bit;
- the card kernel's split of the scan into segments (written in torch)
  against the plain scan: y, aa and bb at 1e-4·max, pp at 1e-4·max over
  the entries that left ``F32_MIN`` (the kernel's tolerance on the card:
  pp + n·w in place of n additions, and sums in another order);
- f32 dense forward and Engine: logits at rtol = atol = 2e-4, as
  tests/test_oracle.py:228 holds the JAX forward to its scalar oracle;
  the residual x and the states at atol = 2e-4·max (V4 has no
  chunk-parallel form: both sides scan at every T);
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

from test_torch_v5 import check_staged, port_info
from test_torch_v6 import (  # noqa: F401 (fixtures)
    LOADS, _assert_same_tree, _chunks, _close, _close_to_max, _run_both, _t, interpret_mode,
    jax_quant_matmul,
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
from web_rwkv_gguf_tpu.ops.pallas.wkv456 import wkv4_pallas
from web_rwkv_gguf_tpu.quant.ggml import GgmlDType as JaxGgmlDType
from web_rwkv_gguf_tpu.runtime import Engine as JaxEngine
from web_rwkv_gguf_tpu.runtime import scheduler as jax_scheduler
from web_rwkv_gguf_tpu.utils.synthetic import make_v4_gguf as jax_make_v4_gguf
from web_rwkv_gguf_tpu.utils.synthetic import synthetic_v56_params
from web_rwkv_gguf_tpu_torch.errors import UnsupportedFeature
from web_rwkv_gguf_tpu_torch.gguf import GgufFile
from web_rwkv_gguf_tpu_torch.models import (
    embed_tokens, forward_chunk, init_state, load_model,
    logits_head, make_generator, params_from_numpy, prepare_decode,
)
from web_rwkv_gguf_tpu_torch.models.forward import GN_EPS, LN_EPS
from web_rwkv_gguf_tpu_torch.ops.cuda.layer56 import layer_scan56, mega_layers
from web_rwkv_gguf_tpu_torch.ops.cuda.wkv4 import wkv4_scan, wkv4_scan_plain
from web_rwkv_gguf_tpu_torch.ops import wkv as W
from web_rwkv_gguf_tpu_torch.ops.wkv import F32_MIN
from web_rwkv_gguf_tpu_torch.quant.ggml import GgmlDType
from web_rwkv_gguf_tpu_torch.runtime import Engine, RnnInput, RnnInputBatch, RnnOption
from web_rwkv_gguf_tpu_torch.utils.synthetic import make_v4_gguf

F32_TOL = 2e-4
Q4KM_LOGITS_TOL = 3e-2
SCAN_TOL = 2e-5
VOCAB = 300
# the slice's small shape: 3 layers, C = 256 (one "head" of width C)
SMALL = dict(n_layer=3, n_emb=256, n_vocab=VOCAB, n_hidden=512)
STATE_KEYS = {"att_shift", "aa", "bb", "pp", "ffn_shift"}


@pytest.fixture(scope="module")
def f32_models():
    raw = make_v4_gguf(**SMALL, seed=11)
    return (jax_load_model(JaxGgufFile(raw), dtype=jnp.float32),
            load_model(GgufFile(raw), dtype=torch.float32, device="cpu"))


@pytest.fixture(scope="module")
def q4km_models():
    raw = make_v4_gguf(**SMALL, seed=12, quantize=GgmlDType.Q4_K,
                       head_quantize=GgmlDType.Q6_K)
    return jax_load_model(JaxGgufFile(raw)), load_model(GgufFile(raw), device="cpu")


FILES = {"f32": (dict(seed=3), None), "q4k": (dict(seed=4), "Q4_K")}


@pytest.mark.parametrize("name", sorted(FILES))
def test_make_v4_gguf_bytes_match_jax(name):
    """Without head_quantize, the bytes are the JAX package's for the
    same quantize (which there covers the head too)."""
    kw, q = FILES[name]
    mine = make_v4_gguf(**SMALL, **kw, quantize=q and GgmlDType[q])
    assert mine == jax_make_v4_gguf(**SMALL, **kw, quantize=q and JaxGgmlDType[q])


def test_make_v4_gguf_writes_q4km():
    raw = make_v4_gguf(**SMALL, seed=1, quantize=GgmlDType.Q4_K,
                       head_quantize=GgmlDType.Q6_K)
    f = GgufFile(raw)
    assert f.tensors["output.weight"].dtype == GgmlDType.Q6_K
    assert f.tensors["blk.0.attn_r.weight"].dtype == GgmlDType.Q4_K
    assert f.tensors["blk.0.ffn_v.weight"].dtype == GgmlDType.Q4_K
    assert f.tensors["blk.0.attn_time_first"].dtype == GgmlDType.F32


@pytest.mark.parametrize("name", sorted(LOADS))
def test_load_model_matches_jax(name):
    """The port's load_model == params_from_numpy(JAX load_model) exactly:
    every array (values, dtype, shape) and ModelInfo."""
    file_kw, jax_kw, port_kw = LOADS[name]
    raw = make_v4_gguf(**SMALL, **file_kw)
    info, params = load_model(GgufFile(raw), device="cpu", **port_kw)
    jinfo, jparams = jax_load_model(JaxGgufFile(raw), **jax_kw)
    _assert_same_tree(params, params_from_numpy(jax.device_get(jparams), device="cpu"))
    mine, ref = dataclasses.asdict(info), dataclasses.asdict(jinfo)
    mine["version"], ref["version"] = mine["version"].value, ref["version"].value
    assert mine == ref and mine["version"] == "v4" and mine["num_head"] == 1
    att = params["blocks"]["att"]
    assert att["time_decay"].shape == (3, 256) and att["time_first"].shape == (3, 256)
    assert att["time_decay"].max() < 0  # -exp(raw)
    if name == "q4km":
        assert params["head"].kind == "qk_nomin"
        assert {att[k].kind for k in ("Wk", "Wv", "Wr", "Wo")} == {"qk"}


def test_init_state_v4():
    info, _ = load_model(GgufFile(make_v4_gguf(**SMALL)), device="cpu")
    st = init_state(info, 2, device="cpu")
    assert set(st) == STATE_KEYS
    assert all(a.shape == (3, 2, 256) and a.dtype == torch.float32 for a in st.values())
    assert bool((st["pp"] == F32_MIN).all()) and not any(st[k].any() for k in ("aa", "bb"))


def test_wkv4_scan_plain_matches_pallas(interpret_mode):
    """Ragged lengths (40, 23, 0, 7) at T = 40 from the initial state (pp
    at F32_MIN) on lanes 0 and 2 and a random one on lanes 1 and 3 (lane
    2, of length 0, keeps its sentinel): the tolerances of the module
    docstring (largest errors seen: y 7.9e-8 of max, aa/bb 9.1e-8 of max,
    pp 0)."""
    rng = np.random.default_rng(1)
    B, T, C = 4, 40, 256
    f = lambda *s: (rng.normal(size=s) * 0.5).astype(np.float32)  # noqa: E731
    state = np.stack([f(B, C), np.abs(f(B, C)) + 0.1, f(B, C)], axis=-1)
    state[0::2] = np.array([0.0, 0.0, F32_MIN], np.float32)
    k, v, r, u = f(B, T, C), f(B, T, C), f(B, T, C), f(C)
    w = -np.exp(f(C))
    lens = np.array([40, 23, 0, 7])
    mask = np.arange(T)[None, :] < lens[:, None]
    args = (state, k, v, r, u, w, mask)
    jy, js = wkv4_pallas(*(jnp.asarray(a) for a in args))
    y, s = wkv4_scan(*(_t(a) for a in args))  # a CPU tensor takes the plain version
    jy, js = np.asarray(jy), np.asarray(js)
    _close_to_max(y.numpy()[mask], jy[mask], SCAN_TOL)
    ran = lens > 0
    _close_to_max(s.numpy()[ran][..., :2], js[ran][..., :2], SCAN_TOL)
    np.testing.assert_allclose(s.numpy()[ran][..., 2], js[ran][..., 2], rtol=0, atol=SCAN_TOL)
    assert torch.equal(s[2], _t(state)[2])  # the empty lane keeps its state, F32_MIN too


def _wkv4_split(state, k, v, r, u, w, mask, S):
    """The card kernel's split of a chunk (``csrc/wkv4_scan.cu``) written
    in torch: the T tokens in S segments of ceil(T / S); pass 1 folds each
    segment from the empty state (0, 0, F32_MIN) into its summary (sa, sb,
    sp) and its live count n; the combine applies the summaries in order,
    q = max(pp + n·w, sp), aa' = e^(pp + n·w - q)·aa + e^(sp - q)·sa (bb
    alike), pp' = q, an empty segment (n = 0) by a select; pass 2 replays
    each segment from its incoming state. The last segment's replay gives
    the chunk's state (its incoming state where it is empty)."""
    B, T, C = k.shape
    L = -(-T // S)
    segs = [slice(min(T, s * L), min(T, (s + 1) * L)) for s in range(S)]
    empty = torch.stack([torch.zeros(B, C), torch.zeros(B, C), torch.full((B, C), F32_MIN)], -1)
    st, ins = state.float(), []
    for g in segs:
        ins.append(st)
        if g.start == g.stop:
            continue
        sa, sb, sp = W.wkv4(empty, k[:, g], v[:, g], r[:, g], u, w, mask[:, g])[1].unbind(-1)
        n = mask[:, g].sum(1, keepdim=True).float()
        aa, bb, pp = st.unbind(-1)
        p1 = pp + n * w
        q = torch.maximum(p1, sp)
        e1, e2 = torch.exp(p1 - q), torch.exp(sp - q)
        st = torch.where((n > 0)[..., None],
                         torch.stack([e1 * aa + e2 * sa, e1 * bb + e2 * sb, q], -1), st)
    ys, final = [], ins[-1]
    for g, st in zip(segs, ins):
        if g.start < g.stop:
            y, final = W.wkv4(st, k[:, g], v[:, g], r[:, g], u, w, mask[:, g])
            ys.append(y)
    return torch.cat(ys, 1), final if segs[-1].start < segs[-1].stop else ins[-1]


@pytest.mark.parametrize("T", [1, 37, 64, 128])
@pytest.mark.parametrize("S", [1, 2, 8, 16])
def test_wkv4_split_matches_the_plain_scan(S, T):
    """The kernel's segment split (_wkv4_split) against ``wkv4_scan_plain``
    at C = 64 on five lanes: 0 from the initial state (pp at F32_MIN) and 1
    from a random one, both with holes in their masks; 2 (random) and 3
    (F32_MIN) with every token padded; 4 from F32_MIN with only its last
    token live, so that every earlier segment is empty. y at the live
    positions and aa/bb at 1e-4·max, pp at 1e-4·max over the entries that
    left F32_MIN and equal on the others; lanes 2 and 3 keep their state bit
    for bit (largest errors seen: y 1.5e-7 of max, aa/bb 1.3e-7, pp 0; with
    one decay step a segment in place of n, y is off by 0.41 of max)."""
    rng = np.random.default_rng(100 * S + T)
    B, C = 5, 64
    f = lambda *s: (rng.normal(size=s) * 0.5).astype(np.float32)  # noqa: E731
    state = np.stack([f(B, C), np.abs(f(B, C)) + 0.1, f(B, C)], axis=-1)
    state[[0, 3, 4]] = np.array([0.0, 0.0, F32_MIN], np.float32)
    mask = rng.random((B, T)) < 0.7
    mask[2:] = False
    mask[4, -1] = True
    args = [_t(a) for a in (state, f(B, T, C), f(B, T, C), f(B, T, C), f(C), -np.exp(f(C)),
                            mask)]
    y, s = _wkv4_split(*args, S)
    y0, s0 = wkv4_scan_plain(*args)
    live = args[-1]
    _close_to_max(y.numpy()[mask], y0.numpy()[mask], 1e-4)
    _close_to_max(s[..., :2].numpy(), s0[..., :2].numpy(), 1e-4)
    sentinel = s0[..., 2] == F32_MIN
    assert torch.equal(s[..., 2][sentinel], s0[..., 2][sentinel])
    _close_to_max(s[..., 2][~sentinel].numpy(), s0[..., 2][~sentinel].numpy(), 1e-4)
    assert torch.equal(s[2:4], args[0][2:4])  # every token padded: the state bit for bit
    assert bool(live[4, -1]) and not bool(sentinel[4].any())  # lane 4 left F32_MIN


@pytest.mark.parametrize("T", [1, 9])
def test_wkv4_reference_matches_jax(T):
    """The port's plain V4 recurrence (``ops/wkv.wkv4``, and ``wkv4_step``
    at T = 1) against the JAX package's XLA one, from the initial state
    on lane 0, lane 1 padded at its last token: y and aa/bb at 2e-5·max,
    pp at 2e-5 absolute on the lanes that ran (largest errors seen: 1.2e-7
    of max, pp 0)."""
    rng = np.random.default_rng(T)
    B, C = 2, 256
    f = lambda *s: (rng.normal(size=s) * 0.5).astype(np.float32)  # noqa: E731
    state = np.stack([f(B, C), np.abs(f(B, C)) + 0.1, f(B, C)], axis=-1)
    state[0] = np.array([0.0, 0.0, F32_MIN], np.float32)
    args = (state, f(B, T, C), f(B, T, C), f(B, T, C), f(C), -np.exp(f(C)),
            np.arange(T)[None, :] < np.array([T, T - 1])[:, None])
    fns = [(W.wkv4, jax_wkv.wkv4)] + ([(W.wkv4_step, jax_wkv.wkv4_step)] if T == 1 else [])
    ran = np.array([True, T > 1])
    for port_fn, jax_fn in fns:
        y, s = port_fn(*(_t(a) for a in args))
        jy, js = (np.asarray(a) for a in jax_fn(*(jnp.asarray(a) for a in args)))
        _close_to_max(y.numpy()[args[-1]], jy[args[-1]], SCAN_TOL)
        _close_to_max(s.numpy()[ran][..., :2], js[ran][..., :2], SCAN_TOL)
        np.testing.assert_allclose(s.numpy()[ran][..., 2], js[ran][..., 2], rtol=0,
                                   atol=SCAN_TOL)
        assert np.array_equal(s.numpy()[~ran], state[~ran])  # lane 1 at T=1: padded


def test_forward_f32_matches_jax(f32_models):
    """A ragged T = 37 chunk, two T = 1 steps (one lane frozen), a ragged
    T = 128 chunk: x at valid positions, last logits and every state
    array (largest errors seen: 1.3e-5 of max on x and the states, 4.5e-5
    on logits)."""
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
        assert set(st) == set(jst) == STATE_KEYS
        for key in jst:
            _close_to_max(st[key], jst[key], F32_TOL)


def test_forward_q4km_matches_jax(q4km_models, jax_quant_matmul):
    """Q4_K_M: a ragged T = 37 chunk, a T = 1 step and a ragged T = 128
    chunk; last logits at the stated tolerance (largest error seen:
    4.8e-3 of max|logit|)."""
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
    lane, the states of both lanes (the five V4 keys through
    ``back_state``), then greedy ``generate`` (largest errors seen: 6.2e-5
    on logits, 1.5e-5 of max|state|; tokens equal)."""
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
        back = eng.back_state(b)
        assert set(back) == STATE_KEYS
        for key, want in jeng.back_state(b).items():
            _close_to_max(back[key], want, F32_TOL)
    prompts = [[int(t) for t in rng.integers(0, VOCAB, n)] for n in (40, 9)]
    jeng.reset_state()
    eng.reset_state()
    assert bool((eng.state["pp"] == F32_MIN).all())
    assert eng.generate(prompts, 6, segment=4) == jeng.generate(prompts, 6, segment=4)
    for b in range(2):
        for key, want in jeng.back_state(b).items():
            _close_to_max(eng.back_state(b)[key], want, F32_TOL)


def test_engine_v4_state_round_trip(q4km_models):
    """``back_state`` / ``load_state`` / ``reset_state`` carry the five V4
    keys of one lane."""
    _, (info, params) = q4km_models
    eng = Engine(info, params, 2, token_chunk_size=32, device="cpu")
    eng.generate([[1, 2, 3], [4, 5]], 2, segment=1)
    snap = eng.back_state(1)
    assert set(snap) == STATE_KEYS and snap["pp"].shape == (3, 256)
    eng.reset_state(1)
    assert (eng.back_state(1)["pp"] == F32_MIN).all()
    assert not np.array_equal(eng.back_state(0)["pp"], eng.back_state(1)["pp"])
    eng.load_state(1, snap)
    for key, want in snap.items():
        assert np.array_equal(eng.back_state(1)[key], want)


def test_initial_wkv_on_v4_raises(q4km_models):
    """A pretrained time_state needs a matrix-state model, as the JAX
    Engine says."""
    _, (info, params) = q4km_models
    with pytest.raises(UnsupportedFeature, match="V4"):
        Engine(info, params, 1, initial_wkv=np.zeros((3, 1, 256, 256), np.float32),
               device="cpu")


# ---- the whole-stack decode step, version 4 ----------------------------------


@pytest.fixture(scope="module")
def synthetic_v4():
    """``synthetic_v56_params`` (version 4, Q4_K) in both packages' forms."""
    jinfo, jparams = synthetic_v56_params(version=4, n_layer=3, n_emb=256, head_size=64,
                                          n_vocab=64, n_hidden=512, seed=2, quant="q4k")
    return (jinfo, jparams), (port_info(jinfo),
                              params_from_numpy(jax.device_get(jparams), device="cpu"))


@pytest.mark.parametrize("B", [1, 5])
def test_layer_scan56_v4_matches_jax(synthetic_v4, B, interpret_mode):
    """Two decode steps from the initial state (pp at F32_MIN), all lanes
    live (largest errors seen: layer 0 6.1e-7 of max, every output
    1.1e-3)."""
    (jinfo, jparams), (info, params) = synthetic_v4
    mega = prepare_decode(params, info, B)["mega56"]
    assert mega["version"] == 4
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
        assert set(st) == set(jst) == STATE_KEYS
        for key in jst:
            assert _rel(st[key][0], jst[key][0]) <= 1e-5, key
            assert _rel(st[key], jst[key]) <= 3e-2, key


@pytest.mark.parametrize("B,rescale", [(1, None), (5, None), (5, 2)])
def test_layer_scan56_v4_matches_the_per_layer_path(q4km_models, B, rescale):
    """Three steps through ``forward_chunk`` with and without the decode
    blocks; at B=5 lane 2 is frozen on the second step (its state kept
    bit for bit, as the per-layer path keeps it; largest error seen: 0)."""
    _, (info, params) = q4km_models
    prepared = prepare_decode(params, info, B)
    assert prepared["mega56"]["version"] == 4
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


def test_layer_scan56_v4_mask_preserves_state(q4km_models):
    """A lane with mask 0 keeps aa, bb, pp and the shifts bit for bit, the
    F32_MIN sentinel included (as the JAX package's
    test_layer_scan56_mask_preserves_state checks on its kernel), from the
    initial state and from a random one; a live lane leaves the
    sentinel."""
    _, (info, params) = q4km_models
    mega = prepare_decode(params, info, 3)["mega56"]
    g = torch.Generator().manual_seed(4)
    L, C = info.num_layer, info.num_emb
    rand = {k: torch.randn(L, 3, C, generator=g) for k in STATE_KEYS}
    x = embed_tokens(params, torch.tensor([[1], [2], [3]]))[:, 0]
    for state in (init_state(info, 3, device="cpu"), rand):
        _, new = layer_scan56(mega, state, x, torch.tensor([1.0, 0.0, 1.0]), None, LN_EPS,
                              GN_EPS)
        for key in state:
            assert torch.equal(new[key][:, 1], state[key][:, 1])
            assert not torch.equal(new[key][:, 0], state[key][:, 0])


@pytest.mark.parametrize("rescale", [None, 2])
def test_layer_scan56_v4_slices_compose(q4km_models, rescale):
    """One-layer slices (``mega_layers`` with ``first_layer``), each fed
    the previous slice's x, give the whole stack exactly (the rescale
    counted by global layer)."""
    _, (info, params) = q4km_models
    mega = prepare_decode(params, info, 2)["mega56"]
    state = init_state(info, 2, device="cpu")
    x = embed_tokens(params, torch.tensor([[7], [9]]))[:, 0]
    mask = torch.tensor([1.0, 1.0])
    x_all, s_all = layer_scan56(mega, state, x, mask, rescale, LN_EPS, GN_EPS)
    x_l, parts = x, []
    for i in range(info.num_layer):
        x_l, s_i = layer_scan56(mega_layers(mega, i, i + 1),
                                {k: v[i:i + 1] for k, v in state.items()},
                                x_l, mask, rescale, LN_EPS, GN_EPS, first_layer=i)
        parts.append(s_i)
    assert torch.equal(x_l, x_all)
    for key in state:
        assert torch.equal(torch.cat([p[key] for p in parts]), s_all[key])


def test_layer_scan56_v4_stages_the_kernels_operands(q4km_models):
    """As for version 5 (``test_torch_v5.check_staged``); the g row of
    ``rkvg`` is zero (version 4 has no gate)."""
    check_staged(*q4km_models[1])


def test_engine_decodes_v4_through_the_whole_stack_step(q4km_models):
    """The Engine arranges the V4 decode blocks, and its greedy tokens
    equal the per-layer path's."""
    _, (info, params) = q4km_models
    eng = Engine(info, params, 2, token_chunk_size=32, device="cpu")
    assert eng.params["mega56"]["version"] == 4 and "mega56" not in params
    prompts = [[5, 9, 11, 2, 7, 8, 1, 0], [3, 1, 4, 1, 5, 9, 2, 6]]
    got = eng.generate(prompts, 6, segment=5)
    st = init_state(info, 2, device="cpu")
    x, st = forward_chunk(info, params, st, torch.tensor(prompts), torch.tensor([8, 8]))
    first = torch.argmax(logits_head(params, x[:, -1]), dim=-1)
    toks, *_ = make_generator(info, steps=5)(params, st, first[:, None])
    assert got == [[int(f)] + t for f, t in zip(first, toks.tolist())]


def test_prepare_decode_v4_takes_only_what_the_kernel_runs(q4km_models, f32_models):
    """Version 4 skips the head-size test (one "head" of width C = 256),
    but not the Q4_K and batch tests."""
    _, (info, params) = q4km_models
    assert info.head_size == 256
    assert "mega56" in prepare_decode(params, info, 16)
    assert "mega56" not in prepare_decode(params, info, 17)
    _, (info32, params32) = f32_models  # dense layers
    assert "mega56" not in prepare_decode(params32, info32, 1)
