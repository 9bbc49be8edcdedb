"""The port's whole-stack decode step (``ops/cuda/layer7``; its plain
version on the CPU) against the JAX package's ``layer7.layer_scan7``
(Pallas in interpret mode) and against the port's per-layer path, and
the Engine's use of it.

Tolerances: against JAX, layer 0's states at 1e-5·max (the same f32
function summed in another order; largest error seen 8.8e-7) and every
output at 3e-2·max, the Q4_K_M tolerance of tests/test_torch_forward.py:
this random-weight model carries a flipped bf16 operand rounding in
layer 0 into ~1e-2 differences two layers on (largest seen 1.2e-2, on
the WKV state of layer 2). Against the port's per-layer path, which
runs the same function at these sizes (every matrix in the gemv class),
1e-6·max (largest seen: 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from web_rwkv_gguf_tpu.gguf import GgufFile as JaxGgufFile
from web_rwkv_gguf_tpu.models import init_state as jax_init_state
from web_rwkv_gguf_tpu.models import load_model as jax_load_model
from web_rwkv_gguf_tpu.models.forward import embed_tokens as jax_embed
from web_rwkv_gguf_tpu.ops.pallas import config as pcfg
from web_rwkv_gguf_tpu.ops.pallas.layer7 import layer_scan7 as jax_layer_scan7
from web_rwkv_gguf_tpu.ops.pallas.layer7 import prep_decode7 as jax_prep_decode7
from web_rwkv_gguf_tpu_torch.gguf import GgufFile
from web_rwkv_gguf_tpu_torch.models import (
    embed_tokens, forward_chunk, init_state, load_model, logits_head, make_generator,
    prepare_decode,
)
from web_rwkv_gguf_tpu_torch.models.forward import GN_EPS, L2_EPS, LN_EPS
from web_rwkv_gguf_tpu_torch.ops.cuda.layer7 import (
    MAX_SCAN_BATCH, layer_scan7, layer_scan7_plain, mega_layers, prep_decode7, stack_matrix,
)
from web_rwkv_gguf_tpu_torch.quant.ggml import GgmlDType
from web_rwkv_gguf_tpu_torch.runtime import Engine
from web_rwkv_gguf_tpu_torch.utils.synthetic import make_v7_gguf

VOCAB = 64


@pytest.fixture(scope="module")
def q4k_file():
    return make_v7_gguf(n_layer=3, n_emb=256, head_size=64, n_vocab=VOCAB, n_hidden=512,
                        quantize=GgmlDType.Q4_K, head_quantize=GgmlDType.Q6_K, seed=5)


@pytest.fixture(scope="module")
def port_model(q4k_file):
    return load_model(GgufFile(q4k_file), device="cpu")


def _tokens(B, step):
    return (np.arange(B)[:, None] * 5 + 3 + 4 * step) % VOCAB


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("B", [1, 5])
def test_layer_scan7_matches_jax(q4k_file, port_model, B):
    """Two decode steps from a zero state, all lanes live."""
    info, params = port_model
    mega = prepare_decode(params, info, B)["mega7"]
    jinfo, jparams = jax_load_model(JaxGgufFile(q4k_file))
    jmega = jax_prep_decode7(jparams, jinfo)
    st, jst = init_state(info, B, device="cpu"), jax_init_state(jinfo, B)
    pcfg.interpret = True
    try:
        for step in range(2):
            tok = _tokens(B, step)
            x = embed_tokens(params, torch.tensor(tok))[:, 0]
            xo, st = layer_scan7(mega, st, x, torch.ones(B), None, LN_EPS, GN_EPS, L2_EPS)
            jx = jax_embed(jparams, jnp.asarray(tok))[:, 0]
            jxo, jst = jax_layer_scan7(jmega, jst, jx, jnp.ones((B,), jnp.float32), None,
                                       LN_EPS, GN_EPS, L2_EPS)
            assert _rel(xo, jxo) <= 3e-2
            for key in jst:
                assert _rel(st[key][0], jst[key][0]) <= 1e-5, key
                assert _rel(st[key], jst[key]) <= 3e-2, key
    finally:
        pcfg.interpret = False


@pytest.mark.parametrize("B,rescale", [(1, None), (5, None), (5, 2)])
def test_layer_scan7_matches_the_per_layer_path(port_model, B, rescale):
    """Three steps through ``forward_chunk`` with and without the decode
    blocks; at B=5 lane 2 is frozen on the second step (its state kept,
    as the per-layer path keeps it)."""
    info, params = port_model
    prepared = prepare_decode(params, info, B)
    assert "mega7" in prepared
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
def test_layer_scan7_slices_compose(port_model, rescale):
    """The pipeline-stage slice mode (``v0_carry``), which chip_smoke.py
    uses to hold the kernel layer by layer: one-layer slices, each fed the
    previous slice's x and layer 0's v, give the whole stack exactly
    (the rescale counted by global layer)."""
    info, params = port_model
    mega = prepare_decode(params, info, 2)["mega7"]
    L, C, H, hs = info.num_layer, info.num_emb, info.num_head, info.head_size
    g = torch.Generator().manual_seed(3)
    state = {"att_shift": torch.randn(L, 2, C, generator=g),
             "wkv": torch.randn(L, 2, H, hs, hs, generator=g),
             "ffn_shift": torch.randn(L, 2, C, generator=g)}
    x = embed_tokens(params, torch.tensor([[7], [9]]))[:, 0]
    mask = torch.tensor([1.0, 0.0])
    eps = (LN_EPS, GN_EPS, L2_EPS)
    x_all, s_all = layer_scan7(mega, state, x, mask, rescale, *eps)
    x_l, v_first, parts = x, None, []
    for i in range(L):
        x_l, s_i, v_first = layer_scan7(mega_layers(mega, i, i + 1),
                                        {k: v[i:i + 1] for k, v in state.items()},
                                        x_l, mask, rescale, *eps, v0_carry=(v_first, i))
        parts.append(s_i)
    assert torch.equal(x_l, x_all)
    for key in state:
        assert torch.equal(torch.cat([p[key] for p in parts]), s_all[key])
        assert torch.equal(s_all[key][:, 1], state[key][:, 1])  # the frozen lane


def test_layer_scan7_plain_takes_the_layernorm_outputs(port_model):
    """``ln_out``, which chip_smoke.py uses to hold the kernel's layers
    given its own LayerNorm outputs: the plain version's own outputs (its
    new shift states) give its result exactly; other outputs move only the
    lanes the mask keeps running, and a frozen lane keeps its state."""
    info, params = port_model
    mega = prepare_decode(params, info, 3)["mega7"]
    L, C, H, hs = info.num_layer, info.num_emb, info.num_head, info.head_size
    g = torch.Generator().manual_seed(4)
    state = {"att_shift": torch.randn(L, 3, C, generator=g),
             "wkv": torch.randn(L, 3, H, hs, hs, generator=g),
             "ffn_shift": torch.randn(L, 3, C, generator=g)}
    x = embed_tokens(params, torch.tensor([[7], [9], [11]]))[:, 0]
    mask = torch.tensor([1.0, 0.0, 1.0])
    eps = (LN_EPS, GN_EPS, L2_EPS)
    x0, s0 = layer_scan7_plain(mega, state, x, mask, None, *eps)
    x1, s1 = layer_scan7_plain(mega, state, x, mask, None, *eps,
                               ln_out=(s0["att_shift"], s0["ffn_shift"]))
    assert torch.equal(x1, x0) and all(torch.equal(s1[k], s0[k]) for k in s0)
    moved = (s0["att_shift"] * 1.01, s0["ffn_shift"])
    x2, s2 = layer_scan7_plain(mega, state, x, mask, None, *eps, ln_out=moved)
    assert not torch.equal(x2[0], x0[0]) and torch.equal(x2[1], x0[1])
    assert torch.equal(s2["wkv"][:, 1], state["wkv"][:, 1])


def _random_state7(info, B, seed):
    L, C, H, hs = info.num_layer, info.num_emb, info.num_head, info.head_size
    g = torch.Generator().manual_seed(seed)
    return {"att_shift": torch.randn(L, B, C, generator=g),
            "wkv": torch.randn(L, B, H, hs, hs, generator=g),
            "ffn_shift": torch.randn(L, B, C, generator=g)}


@pytest.mark.parametrize("which", [0, 1])
def test_layer_scan7_plain_takes_one_layernorm_output(port_model, which):
    """``ln_out`` with one of the two LayerNorm outputs given and the other
    None (the card test holds layer 0 given the kernel's first one only):
    the plain version's own output gives its result exactly; a moved one
    moves only the lanes the mask keeps running."""
    info, params = port_model
    mega = prepare_decode(params, info, 3)["mega7"]
    state = _random_state7(info, 3, 6 + which)
    x = embed_tokens(params, torch.tensor([[5], [8], [13]]))[:, 0]
    mask = torch.tensor([1.0, 0.0, 1.0])
    eps = (LN_EPS, GN_EPS, L2_EPS)
    key = ("att_shift", "ffn_shift")[which]
    x0, s0 = layer_scan7_plain(mega, state, x, mask, None, *eps)

    def given(t):
        return layer_scan7_plain(mega, state, x, mask, None, *eps,
                                 ln_out=(t, None) if which == 0 else (None, t))

    x1, s1 = given(s0[key])
    assert torch.equal(x1, x0) and all(torch.equal(s1[k], s0[k]) for k in s0)
    x2, s2 = given(s0[key] * 1.01)
    assert not torch.equal(x2[2], x0[2]) and torch.equal(x2[1], x0[1])
    assert all(torch.equal(s2[k][:, 1], state[k][:, 1]) for k in s0)


@pytest.mark.parametrize("B", [1, 3])
def test_layer_scan7_plain_takes_the_attention_output(port_model, monkeypatch, B):
    """``y_in``, Wo's input (the card test gives the kernel's own, read
    back through ``layer_scan7(..., staged=)``): the plain version's own
    attention output gives its result exactly, a frozen lane's entry is
    never read, and a moved entry moves only its lane's x; ``staged``
    receives the last layer's."""
    from web_rwkv_gguf_tpu_torch.ops.cuda import layer7

    info, params = port_model
    mega = prepare_decode(params, info, B)["mega7"]
    state = _random_state7(info, B, 20 + B)
    x = embed_tokens(params, torch.arange(B)[:, None] * 3 + 2)[:, 0]
    mask = torch.ones(B)
    if B >= 3:
        mask[1] = 0.0
    eps = (LN_EPS, GN_EPS, L2_EPS)
    ys = []
    core = layer7.att_core7_plain

    def record(*args):
        y, wkv = core(*args)
        ys.append(y.reshape(B, -1))
        return y, wkv

    monkeypatch.setattr(layer7, "att_core7_plain", record)
    x0, s0 = layer_scan7_plain(mega, state, x, mask, None, *eps)
    monkeypatch.setattr(layer7, "att_core7_plain", core)
    y = torch.stack(ys)
    assert y.shape == (info.num_layer, B, info.num_emb)
    if B >= 3:
        y_frozen = y.clone()
        y_frozen[:, 1] = 1e3
        xf, sf = layer_scan7_plain(mega, state, x, mask, None, *eps, y_in=y_frozen)
        assert torch.equal(xf[1], x0[1]) and all(torch.equal(sf[k], s0[k]) for k in s0)
    staged = {}
    xs, ss = layer_scan7_plain(mega, state, x, mask, None, *eps, y_in=y, staged=staged)
    assert torch.equal(xs, x0) and all(torch.equal(ss[k], s0[k]) for k in s0)
    assert torch.equal(staged["y"], y[-1])  # the last layer's, as Wo takes it
    moved = y.clone()
    moved[:, 0] *= 1.5
    xm, _ = layer_scan7_plain(mega, state, x, mask, None, *eps, y_in=moved)
    assert not torch.equal(xm[0], x0[0]) and torch.equal(xm[1:], x0[1:])


def test_layer_scan7_counters_are_kept_per_device_and_size(monkeypatch):
    """The split-K counters: one zero buffer a device and size, the same
    for every launch at that size (the kernel leaves it zero, so it is
    never cleared again), another zero one at another size; the RWKV-6/5/4
    kernel's wrapper takes its counters from the same buffers."""
    from web_rwkv_gguf_tpu_torch.ops.cuda import layer7, layer56

    monkeypatch.setattr(layer7, "_COUNTERS", {})
    dev = torch.device("cpu")
    a = layer7._counters(dev, 12)
    assert a.dtype == torch.int32 and a.numel() == 12 and not a.any()
    a[3] = 7
    assert layer7._counters(dev, 12) is a and a[3] == 7
    b = layer7._counters(dev, 40)
    assert b is not a and b.numel() == 40 and not b.any()
    assert layer7._counters(dev, 12) is a
    assert layer56._counters(dev, 12) is a and layer56._counters(dev, 40) is b


def test_prepare_decode_takes_only_what_the_kernel_runs(port_model):
    info, params = port_model
    prepared = prepare_decode(params, info, MAX_SCAN_BATCH)
    assert prepare_decode(prepared, info, 2) is prepared  # idempotent
    assert "mega7" not in prepare_decode(params, info, MAX_SCAN_BATCH + 1)
    blocks_list = {**params, "blocks": [params["blocks"]]}
    assert "mega7" not in prepare_decode(blocks_list, info, 1)
    # dense f32 layers: no slot takes them
    f32 = load_model(GgufFile(make_v7_gguf(n_layer=1, n_emb=64, head_size=16, n_vocab=32,
                                           seed=2)), dtype=torch.float32, device="cpu")
    assert "mega7" not in prepare_decode(f32[1], f32[0], 1)
    # dense bf16 layers take the dense slot, but not at a head size the kernel
    # refuses on the card (layer_scan7 takes 64 only)
    bf16 = load_model(GgufFile(make_v7_gguf(n_layer=2, n_emb=256, head_size=16, n_vocab=32,
                                            n_hidden=512, seed=2)), device="cpu")
    assert stack_matrix(bf16[1]["blocks"]["att"]["Wr"]) is not None
    assert prep_decode7(bf16[1], bf16[0]) is None
    assert "mega7" not in prepare_decode(bf16[1], bf16[0], 1)


def test_engine_decodes_through_the_whole_stack_step(port_model):
    """The Engine arranges the decode blocks, and its greedy tokens equal
    the per-layer path's: one chunk of prefill, then ``make_generator``
    on the loaded params."""
    info, params = port_model
    eng = Engine(info, params, 2, token_chunk_size=32, device="cpu")
    assert "mega7" in eng.params and "mega7" not in params
    prompts = [[5, 9, 11, 2, 7, 8, 1, 0], [3, 1, 4, 1, 5, 9, 2, 6]]
    got = eng.generate(prompts, 6, segment=5)
    st = init_state(info, 2, device="cpu")
    x, st = forward_chunk(info, params, st, torch.tensor(prompts), torch.tensor([8, 8]))
    first = torch.argmax(logits_head(params, x[:, -1]), dim=-1)
    toks, *_ = make_generator(info, steps=5)(params, st, first[:, None])
    want = [[int(f)] + t for f, t in zip(first, toks.tolist())]
    assert got == want
