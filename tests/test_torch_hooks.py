"""The port's hooks, embedding input and vision input against the JAX
package's, on the CPU, from the same GGUF bytes (f32 files at L=2, C=32,
head size 8, V=48).

Tolerances: the port against the JAX package, rtol = atol = 2e-4 on every
tensor a tap sees, on logits and on state (tests/test_oracle.py:228's f32
class); the port against itself (``hooks={}`` against ``hooks=None``, the
embedding rows against the token ids), atol = 1e-5·max|ref|, which the
same ops in the same order meet exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import web_rwkv_gguf_tpu.runtime.scheduler as jax_sched
from web_rwkv_gguf_tpu.apps.othello import make_othello_hooks
from web_rwkv_gguf_tpu.apps.puzzle15 import make_puzzle15_hooks
from web_rwkv_gguf_tpu.gguf import GgufFile as JaxGgufFile
from web_rwkv_gguf_tpu.models import forward_chunk as jax_forward_chunk
from web_rwkv_gguf_tpu.models import init_state as jax_init_state
from web_rwkv_gguf_tpu.models import load_model as jax_load_model
from web_rwkv_gguf_tpu.models import logits_head as jax_logits_head
from web_rwkv_gguf_tpu.models.forward import HOOK_NAMES as JAX_HOOK_NAMES
from web_rwkv_gguf_tpu.runtime import Engine as JaxEngine
from web_rwkv_gguf_tpu.runtime import VisionInput as JaxVisionInput
from web_rwkv_gguf_tpu.runtime import infer_vision as jax_infer_vision
from web_rwkv_gguf_tpu_torch.gguf import GgufFile
from web_rwkv_gguf_tpu_torch.models import (
    forward_chunk, init_state, load_model, logits_head, prepare_decode,
)
from web_rwkv_gguf_tpu_torch.models.forward import HOOK_NAMES
from web_rwkv_gguf_tpu_torch.ops.wkv import wkv7_act_w
from web_rwkv_gguf_tpu_torch.runtime import (
    Engine, RnnInput, RnnInputBatch, RnnOption, VisionInput, infer_vision,
)
from web_rwkv_gguf_tpu_torch.utils import synthetic

F32_TOL = 2e-4
SELF_TOL = 1e-5
VERSIONS = ["v4", "v5", "v6", "v7"]
TOKENS = [[3, 17, 40], [9, 1, 25]]
MODEL_TAPS = {"post_embed_loaded", "post_embed_layer_norm", "post_embed", "pre_head",
              "post_head_layer_norm", "post_head"}


def _raw(ver):
    make = getattr(synthetic, f"make_{ver}_gguf")
    kw = {} if ver == "v4" else {"head_size": 8}
    return make(n_layer=2, n_emb=32, n_vocab=48, seed=60 + VERSIONS.index(ver), **kw)


@pytest.fixture(scope="module")
def models():
    """Both packages' f32 models of every version, loaded once."""
    out = {}
    for ver in VERSIONS:
        raw = _raw(ver)
        out[ver] = (jax_load_model(JaxGgufFile(raw), dtype=jnp.float32),
                    load_model(GgufFile(raw), dtype=torch.float32, device="cpu"))
    return out


def _close(got, want, tol=F32_TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


def _close_to_max(got, want, rel=SELF_TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=rel * np.abs(want).max())


def _jax_run(jmodel, hooks, tokens=TOKENS, state=None, embeds=None):
    """A chunk through the JAX forward and head: (logits of the last
    rows, x, state), numpy."""
    info, params = jmodel
    B, T = len(tokens), len(tokens[0])
    state = jax_init_state(info, B) if state is None else state
    x, st = jax_forward_chunk(
        info, params, state, None if embeds is not None else jnp.asarray(tokens, jnp.int32),
        jnp.full((B,), T, jnp.int32), hooks=hooks,
        input_embeds=None if embeds is None else jnp.asarray(embeds))
    return np.asarray(jax_logits_head(params, x[:, -1], hooks=hooks)), np.asarray(x), st


def _run(model, hooks, tokens=TOKENS, state=None, embeds=None):
    """The same through the port."""
    info, params = model
    B, T = len(tokens), len(tokens[0])
    state = init_state(info, B, device="cpu") if state is None else state
    x, st = forward_chunk(
        info, params, state, None if embeds is not None else torch.tensor(tokens),
        torch.full((B,), T), hooks=hooks,
        input_embeds=None if embeds is None else torch.from_numpy(embeds))
    return logits_head(params, x[:, -1], hooks=hooks).numpy(), x.numpy(), st


def _recorder(names, to_np):
    """Taps on ``names`` that record each firing: ``seen[name]`` lists
    (layer, {key: numpy array})."""
    seen = {}

    def make(name):
        def tap(layer, **tensors):
            seen.setdefault(name, []).append(
                (layer, {k: to_np(v) for k, v in tensors.items()}))
        return tap

    return seen, {n: make(n) for n in names}


@pytest.mark.parametrize("ver", VERSIONS)
def test_hook_names_match_jax(models, ver):
    info = models[ver][1][0]
    assert HOOK_NAMES[info.version] == JAX_HOOK_NAMES[models[ver][0][0].version]
    assert len(HOOK_NAMES[info.version]) == {"v4": 26, "v5": 28, "v6": 38, "v7": 34}[ver]


@pytest.mark.parametrize("ver", VERSIONS)
def test_every_tap_matches_jax(models, ver):
    """Observer taps on every name (and the two legacy aliases) through a
    T=3 chunk of two lanes and then one T=1 step from its state: every tap
    fires at every layer (model-level taps at layer -1) with the JAX
    package's tensor names, and every tensor, the logits and the state
    match the JAX package's."""
    jmodel, model = models[ver]
    names = list(HOOK_NAMES[model[0].version]) + ["post_embed"]
    if ver == "v6":
        names.append("pre_att_decay_activate")
    jseen, jhooks = _recorder(names, np.asarray)
    seen, hooks = _recorder(names, lambda t: t.detach().numpy())
    jlg, _, jst = _jax_run(jmodel, jhooks)
    lg, _, st = _run(model, hooks)
    _close(lg, jlg)
    step = [[5], [44]]
    jlg1, _, jst1 = _jax_run(jmodel, jhooks, step, jst)
    lg1, _, st1 = _run(model, hooks, step, st)
    _close(lg1, jlg1)
    for key in jst1:
        _close(st1[key].numpy(), np.asarray(jst1[key]))
    L = model[0].num_layer
    for name in names:
        want_layers = [-1] if name in MODEL_TAPS else list(range(L))
        assert [layer for layer, _ in seen[name]] == want_layers * 2, name
        assert len(seen[name]) == len(jseen[name]), name
        for (layer, got), (jlayer, want) in zip(seen[name], jseen[name]):
            assert layer == jlayer and set(got) == set(want), (name, layer)
            for key in want:
                assert got[key].shape == want[key].shape, (name, layer, key)
                _close(got[key], want[key])


@pytest.mark.parametrize("T", [4, 1])
@pytest.mark.parametrize("ver", VERSIONS)
def test_empty_hooks_reproduce_unhooked(models, ver, T):
    """``hooks={}`` against ``hooks=None`` on the Engine's decode params
    (``prepare_decode``): x, logits and state, at T=4 and at T=1 from a
    prefilled state."""
    info, params = models[ver][1]
    params = prepare_decode(params, info, 2)
    tokens = [[7, 2, 30, 11], [4, 4, 9, 47]]
    _, _, state = _run((info, params), None, tokens)
    step = tokens if T == 4 else [[5], [44]]
    lg0, x0, s0 = _run((info, params), None, step, state)
    lg1, x1, s1 = _run((info, params), {}, step, state)
    _close_to_max(x1, x0)
    _close_to_max(lg1, lg0)
    for key in s0:
        _close_to_max(s1[key].numpy(), s0[key].numpy())


def _zero_layer0(xp):
    return lambda layer, x: {"x": xp.zeros_like(x)} if layer == 0 else None


def _half_gate(layer, x, g):
    return {"g": g * 0.5}


def _othello():
    def post_att_adapt(layer, *, w, a, g):
        return {"a": a * 2.0}

    def post_att_control(layer, *, k, kk, a, w):
        return {"a": wkv7_act_w(w) * a}

    return {"post_att_adapt": post_att_adapt, "post_att_control": post_att_control}


def _puzzle15():
    def pre_att_decay_activate(layer, *, w, k):
        return {"k": k * torch.exp(torch.clamp_max(w, 0.0)).reshape(k.shape)}

    return {"pre_att_decay_activate": pre_att_decay_activate}


MODIFYING = {
    "zero_att_v4": ("v4", lambda: {"post_att_time_mix": _zero_layer0(jnp)},
                    lambda: {"post_att_time_mix": _zero_layer0(torch)}),
    "zero_att_v7": ("v7", lambda: {"post_att_time_mix": _zero_layer0(jnp)},
                    lambda: {"post_att_time_mix": _zero_layer0(torch)}),
    "half_gate_v5": ("v5", lambda: {"pre_att_gate": _half_gate},
                     lambda: {"pre_att_gate": _half_gate}),
    "half_gate_v6": ("v6", lambda: {"pre_att_gate": _half_gate},
                     lambda: {"pre_att_gate": _half_gate}),
    "othello_v7": ("v7", lambda: make_othello_hooks(2), _othello),
    "puzzle15_v6": ("v6", lambda: make_puzzle15_hooks(2), _puzzle15),
}


@pytest.mark.parametrize("case", list(MODIFYING))
def test_modifying_hooks_match_jax(models, case):
    """A hook that changes a tensor changes the output, as the JAX
    package's does: logits and state after a T=3 chunk and a T=1 step."""
    ver, jax_hooks, port_hooks = MODIFYING[case]
    jmodel, model = models[ver]
    jh, h = jax_hooks(), port_hooks()
    jlg, _, jst = _jax_run(jmodel, jh)
    lg, _, st = _run(model, h)
    plain, _, _ = _run(model, None)
    assert np.abs(lg - plain).max() > 1e-3
    _close(lg, jlg)
    jlg1, _, jst1 = _jax_run(jmodel, jh, [[5], [44]], jst)
    lg1, _, st1 = _run(model, h, [[5], [44]], st)
    _close(lg1, jlg1)
    for key in jst1:
        _close(st1[key].numpy(), np.asarray(jst1[key]))


@pytest.mark.parametrize("ver", ["v4", "v7"])
def test_input_embeds_match_token_lookup_and_jax(models, ver):
    """Embedding rows as ``input_embeds`` (tokens None) give the token
    ids' x and state exactly, and the JAX package's ``input_embeds``."""
    jmodel, model = models[ver]
    embeds = model[1]["emb"][torch.tensor(TOKENS)].float().numpy()
    lg0, x0, s0 = _run(model, None)
    lg1, x1, s1 = _run(model, None, embeds=embeds)
    _close_to_max(x1, x0)
    for key in s0:
        _close_to_max(s1[key].numpy(), s0[key].numpy())
    jlg, jx, jst = _jax_run(jmodel, None, embeds=embeds)
    _close(x1, jx)
    _close(lg1, jlg)
    for key in jst:
        _close(s1[key].numpy(), np.asarray(jst[key]))


def _embed_lanes(emb):
    """Three lanes of the same five tokens: ids; their embedding rows as
    vectors; ids and rows mixed."""
    ids = [7, 31, 2, 40, 19]
    rows = [emb[t] for t in ids]
    return [ids, rows, [ids[0], rows[1], ids[2], rows[3], ids[4]]]


def test_engine_embed_lanes_match_jax(models):
    """Token::Embed: an Engine of three lanes (ids, the same tokens as
    embedding vectors, a mix; LAST, LAST and FULL) against the JAX Engine's
    ``infer``: every lane's logits and state; the ids lane and the vectors
    lane give equal logits."""
    jmodel, model = models["v7"]
    emb = model[1]["emb"].float().numpy()
    lanes = _embed_lanes(emb)
    opts = [RnnOption.LAST, RnnOption.LAST, RnnOption.FULL]
    eng = Engine(*model, 3, token_chunk_size=8, device="cpu")
    jeng = JaxEngine(*jmodel, 3, token_chunk_size=8)
    out = eng.infer(RnnInput([RnnInputBatch(list(t), o) for t, o in zip(lanes, opts)], 8))
    jout = jeng.infer(jax_sched.RnnInput(
        [jax_sched.RnnInputBatch(list(t), jax_sched.RnnOption(o.value))
         for t, o in zip(lanes, opts)], 8))
    assert [len(o) for o in out] == [1, 1, 5]
    np.testing.assert_array_equal(out[0], out[1])
    for b in range(3):
        _close(out[b], np.asarray(jout[b]))
        for key, want in jeng.back_state(b).items():
            _close(eng.back_state(b)[key], want)


def test_infer_vision_matches_jax(models):
    """``infer_vision`` on patches [4, 4, 2, 3] (4·4·2 = C, three patches):
    the last patch's embedding and the state against the JAX package's."""
    jmodel, model = models["v7"]
    patches = np.random.default_rng(0).normal(size=(4, 4, 2, 3)).astype(np.float32)
    emb, st = infer_vision(*model, VisionInput(patches))
    jemb, jst = jax_infer_vision(*jmodel, JaxVisionInput(patches))
    assert emb.shape == (32,)
    _close(emb, jemb)
    for key in jst:
        _close(st[key].numpy(), np.asarray(jst[key]))


def test_engine_generate_honours_hooks(models):
    """``Engine(hooks=)`` with the othello pair: the port's ``generate``
    (greedy, one-token segments) against a JAX decode driven token by
    token through the hooked JAX Engine's ``infer``: identical tokens and
    final state. The JAX package's own ``generate`` builds its generator
    without the hooks (web_rwkv_gguf_tpu/runtime/engine.py:722-735), so a
    hooked engine decodes unhooked after its prompt: its final state is
    asserted to differ, so that the mismatch stays on record."""
    jmodel, model = models["v7"]
    eng = Engine(*model, 2, token_chunk_size=8, hooks=_othello(), device="cpu")
    jeng = JaxEngine(*jmodel, 2, token_chunk_size=8, hooks=make_othello_hooks(2))
    prompts = [[3, 17, 40, 5, 9], [9, 1, 25]]
    got = eng.generate(prompts, 5, segment=1)
    jinp = jax_sched.RnnInput([jax_sched.RnnInputBatch(list(p)) for p in prompts], 8)
    last = [None, None]
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
    hooked = [jeng.back_state(b) for b in range(2)]
    for b in range(2):
        for key, ref in hooked[b].items():
            _close(eng.back_state(b)[key], ref)
    jeng.reset_state()
    jeng.generate(prompts, 5, segment=1)
    assert max(np.abs(jeng.back_state(b)["wkv"] - hooked[b]["wkv"]).max()
               for b in range(2)) > 1e-2
